"""Distributed pieces of the port (so far: the quantized-sync config)."""
