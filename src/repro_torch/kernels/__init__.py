"""Kernels of the port: CUDA C++ sources (``csrc/``), their wrappers, the
plain torch versions (``ref.py``) and the public entry points
(``ops.py``); counterpart of ``repro.kernels``.
"""
from repro_torch.kernels import ops
