"""Data of the port: synthetic frames, the parent-training transforms and
batching."""
