"""Arch registry: --arch <id> -> config module."""
import importlib

ARCHS = {
    "glm4-9b": "glm4_9b",
    "qwen3-32b": "qwen3_32b",
    "nemotron-4-340b": "nemotron_4_340b",
    "yi-34b": "yi_34b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "whisper-small": "whisper_small",
    "mamba2-1.3b": "mamba2_13b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "internvl2-1b": "internvl2_1b",
}


def get(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")


def config(name: str):
    return get(name).config()


def smoke_config(name: str):
    return get(name).smoke_config()


def train_overrides(name: str) -> dict:
    return getattr(get(name), "TRAIN_OVERRIDES", {})
