"""whisper-small  [audio] enc-dec 12L each, d768 12H MHA ff3072 V51865.
Conv frontend STUBBED: input_specs feeds precomputed frame embeddings.
[arXiv:2212.04356]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(arch="whisper-small", family="encdec", n_layers=12,
                       d_model=768, n_heads=12, n_kv=12, head_dim=64,
                       d_ff=3072, vocab=51865, act="gelu",
                       enc_layers=12, enc_seq=1500)


def smoke_config() -> ModelConfig:
    return ModelConfig(arch="whisper-smoke", family="encdec", n_layers=2,
                       d_model=64, n_heads=4, n_kv=4, head_dim=16,
                       d_ff=128, vocab=257, act="gelu",
                       enc_layers=2, enc_seq=24)
