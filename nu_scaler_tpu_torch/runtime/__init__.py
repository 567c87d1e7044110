"""Frame pipelines of the port."""
