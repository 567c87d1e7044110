"""Frame sources of the port (Y4M video I/O)."""
