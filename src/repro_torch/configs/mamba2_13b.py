"""mamba2-1.3b  [ssm] 48L d2048 attn-free V50280, SSD state=128.
[arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(arch="mamba2-1.3b", family="ssm", n_layers=48,
                       d_model=2048, n_heads=0, n_kv=0, head_dim=0,
                       d_ff=0, vocab=50280, ssm_state=128, ssm_expand=2,
                       ssm_headdim=64, ssm_chunk=256, conv_width=4)


def smoke_config() -> ModelConfig:
    return ModelConfig(arch="mamba2-smoke", family="ssm", n_layers=2,
                       d_model=64, n_heads=0, n_kv=0, head_dim=0, d_ff=0,
                       vocab=257, ssm_state=16, ssm_expand=2, ssm_headdim=8,
                       ssm_chunk=16, conv_width=4)
