"""The loops of the traffic kinds, one module a kind, found by the traffic
file's ``kind``."""
