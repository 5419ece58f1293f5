"""Models of the port; counterpart of ``repro.models``.

``config``      — ``ModelConfig`` (a copy of the reference's).
``sharding``    — ``ShardCtx``, leaf metas, the ZeRO-3 storage layout and
                  the FSDP gather per leaf.
``layers``      — norms, rope, attention, MLP, embedding, cross entropy.
``transformer`` — metas and init for every family; the training forward
                  pass of the dense, VLM, MoE, SSM and hybrid families.
``moe``         — the expert-parallel MoE MLP (router, capacity, TP
                  all-to-all).
``ssm``         — the Mamba-2 SSD mixer (chunked and one-token step).
``rglru``       — the RG-LRU recurrent block (parallel prefix scan).
``encdec``      — the encoder-decoder (whisper) metas, init and loss.
``serve``       — the serving path: caches, prefill and the sharded-KV
                  decode step of every family.
"""
