"""Host runtime of the port: the cooperative scheduler, the native ingest
runtime (C++ through ctypes) and its live transports, the host-to-device
feeder and event pump, and the HTTP serving endpoint."""
