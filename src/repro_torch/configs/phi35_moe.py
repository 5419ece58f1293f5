"""phi3.5-moe-42b-a6.6b  [moe] 32L d4096 32H (GQA kv=8) ff6400 V32064,
16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(arch="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32,
                       d_model=4096, n_heads=32, n_kv=8, head_dim=128,
                       d_ff=6400, vocab=32064, act="swiglu",
                       n_experts=16, top_k=2)


def smoke_config() -> ModelConfig:
    return ModelConfig(arch="phi35-moe-smoke", family="moe", n_layers=2,
                       d_model=64, n_heads=4, n_kv=2, head_dim=16,
                       d_ff=64, vocab=257, act="swiglu", n_experts=4, top_k=2)
