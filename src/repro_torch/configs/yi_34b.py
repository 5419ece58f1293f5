"""yi-34b  [dense] 60L d7168 56H (GQA kv=8) ff20480 V64000 — llama-arch.
56 heads on tp=16 exercises the partial head-replication path (8 shards x 2).
[arXiv:2403.04652]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(arch="yi-34b", family="dense", n_layers=60,
                       d_model=7168, n_heads=56, n_kv=8, head_dim=128,
                       d_ff=20480, vocab=64000, act="swiglu",
                       rope_theta=5_000_000.0)


def smoke_config() -> ModelConfig:
    # 6 heads on tp>1 keeps the replication path exercised in smoke tests
    return ModelConfig(arch="yi-34b-smoke", family="dense", n_layers=2,
                       d_model=64, n_heads=6, n_kv=2, head_dim=16,
                       d_ff=128, vocab=257, act="swiglu")
