"""Models of the port; counterpart of ``repro.models``.

``config``      — ``ModelConfig`` (a copy of the reference's).
``sharding``    — ``ShardCtx``, leaf metas, the ZeRO-3 storage layout and
                  the FSDP gather per leaf.
``layers``      — norms, rope, attention, MLP, embedding, cross entropy.
``transformer`` — metas and init for every family; the training forward
                  pass of the dense and VLM families.
"""
