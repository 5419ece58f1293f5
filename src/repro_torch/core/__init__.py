"""Core lattice quantization, rotation, bucketing and error detection."""
