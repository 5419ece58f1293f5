"""Training of the port; counterpart of ``repro.train``.

``optim``      — shard-local AdamW / momentum.
``data``       — stateless-seeded synthetic batches (a rank draws its rows).
``checkpoint`` — the reference's logical on-disk format.
``trainer``    — the ZeRO-3 train step and the fault-tolerant loop.
"""
