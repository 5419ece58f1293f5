"""glm4-9b  [dense] 40L d4096 32H (GQA kv=2) ff13696 V151552 — RoPE, GQA.
[hf:THUDM/glm-4-9b]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(arch="glm4-9b", family="dense", n_layers=40,
                       d_model=4096, n_heads=32, n_kv=2, head_dim=128,
                       d_ff=13696, vocab=151552, act="swiglu",
                       rope_theta=10_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(arch="glm4-9b-smoke", family="dense", n_layers=2,
                       d_model=64, n_heads=4, n_kv=2, head_dim=16,
                       d_ff=128, vocab=257, act="swiglu")
