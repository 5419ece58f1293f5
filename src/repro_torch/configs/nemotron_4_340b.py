"""nemotron-4-340b  [dense] 96L d18432 96H (GQA kv=8) ff73728 V256000 —
squared-ReLU MLP.  [arXiv:2402.16819]"""
from repro_torch.models.config import ModelConfig

# 340B-class: bf16 optimizer moments + microbatching (see launch/dryrun.py)
TRAIN_OVERRIDES = {"opt_state_dtype": "bfloat16", "microbatch": 8,
                   "opt_name": "momentum"}


def config() -> ModelConfig:
    return ModelConfig(arch="nemotron-4-340b", family="dense", n_layers=96,
                       d_model=18432, n_heads=96, n_kv=8, head_dim=192,
                       d_ff=73728, vocab=256000, act="squared_relu",
                       rope_theta=10_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(arch="nemotron-smoke", family="dense", n_layers=2,
                       d_model=64, n_heads=4, n_kv=2, head_dim=16,
                       d_ff=256, vocab=257, act="squared_relu")
