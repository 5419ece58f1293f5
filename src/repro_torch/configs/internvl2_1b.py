"""internvl2-1b  [vlm] InternViT (stub) + InternLM2 24L d896 14H (kv=2)
ff4864 V151655.  Patch embeddings precomputed by input_specs.
[arXiv:2404.16821]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(arch="internvl2-1b", family="vlm", n_layers=24,
                       d_model=896, n_heads=14, n_kv=2, head_dim=64,
                       d_ff=4864, vocab=151655, act="swiglu",
                       rope_theta=1_000_000.0, img_tokens=256)


def smoke_config() -> ModelConfig:
    return ModelConfig(arch="internvl2-smoke", family="vlm", n_layers=2,
                       d_model=64, n_heads=4, n_kv=2, head_dim=16,
                       d_ff=128, vocab=257, act="swiglu", img_tokens=8)
