"""PyTorch/CUDA port of the quantized distributed-mean system.

A second package beside the JAX reference ``repro``; it mirrors that
package's layout and names (``core/``, ``kernels/``, ``dist/``, ``agg/``,
``obs/``) so each module's counterpart is easy to find.  It imports torch,
numpy and the standard library only.

Its endpoints: the aggregation protocol of ``agg/`` — the client
(``AggClient``), the flat server (``AggServer``), the multi-round
anchored service (``AggService``), the continuous-round engine
(``AggEngine``), the sum-without-decode tree (``AggTree``), composed by
``AggConfig`` and driven by ``agg.sim``; the quantized mean collectives of
``dist.collectives``; the paper's algorithms in ``core``; and
``kernels.ops.flash_attention``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no explicit device they raise —
they never move to the CPU on their own.  On the CPU every kernel wrapper
runs its plain torch version (``repro_torch.kernels.ref``); on a CUDA
tensor it launches the hand-written kernel or raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is named.

    Raises when no CUDA device is present and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain torch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
