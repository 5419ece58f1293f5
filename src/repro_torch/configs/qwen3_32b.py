"""qwen3-32b  [dense] 64L d5120 64H (GQA kv=8) ff25600 V151936 — qk_norm.
[hf:Qwen/Qwen3-32B family]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(arch="qwen3-32b", family="dense", n_layers=64,
                       d_model=5120, n_heads=64, n_kv=8, head_dim=128,
                       d_ff=25600, vocab=151936, act="swiglu", qk_norm=True,
                       rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(arch="qwen3-32b-smoke", family="dense", n_layers=2,
                       d_model=64, n_heads=4, n_kv=2, head_dim=16,
                       d_ff=128, vocab=257, act="swiglu", qk_norm=True)
