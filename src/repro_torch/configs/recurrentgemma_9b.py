"""recurrentgemma-9b  [hybrid] 38L d4096 16H (MQA kv=1) ff12288 V256000 —
RG-LRU + local attention 1:2 (window 2048).  [arXiv:2402.19427]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(arch="recurrentgemma-9b", family="hybrid", n_layers=38,
                       d_model=4096, n_heads=16, n_kv=1, head_dim=256,
                       d_ff=12288, vocab=256000, act="swiglu",
                       window=2048, lru_width=4096, conv_width=4,
                       pattern=("rec", "rec", "attn"))


def smoke_config() -> ModelConfig:
    return ModelConfig(arch="recurrentgemma-smoke", family="hybrid",
                       n_layers=5, d_model=64, n_heads=4, n_kv=1, head_dim=16,
                       d_ff=128, vocab=257, act="swiglu", window=16,
                       lru_width=64, conv_width=4,
                       pattern=("rec", "rec", "attn"))
