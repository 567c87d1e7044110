"""The benchmark harness of the port."""
