"""Device-mesh parallelism of the port: dp batches and sp row shards
(`parallel/mesh.py`)."""
