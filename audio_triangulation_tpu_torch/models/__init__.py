"""Pipeline models."""
