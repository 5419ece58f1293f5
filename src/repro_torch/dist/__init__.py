"""Distributed pieces of the port: the quantized mean collectives over
``torch.distributed`` and the FSDP storage-size rule."""
