"""Distributed pieces of the port; counterpart of ``repro.dist``.

``collectives`` — the quantized mean collectives (star, butterfly,
                  recursive halving) over ``torch.distributed``.
``fsdp``        — the FSDP storage-size rule.
"""
from repro_torch.dist import collectives
from repro_torch.dist import fsdp
