"""Kernels of the port: CUDA C++ sources, their wrappers and plain versions."""
