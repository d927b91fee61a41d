"""Checkpoints of the port: ``store.CheckpointStore`` (atomic, async, JSON
manifest + zlib)."""
