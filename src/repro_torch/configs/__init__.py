"""Architecture registry: the 10 assigned architectures + the paper's own
decentralized-learning payload config (the port's copy of
``repro.configs``; the config files are data, copied unchanged).

Every entry cites its source; ``get_config(name)`` returns the full-size
ModelConfig, ``get_smoke_config(name)`` a reduced same-family variant
(<= 2 layers, d_model <= 512, <= 4 experts) for CPU smoke tests.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "llama3_405b",
    "yi_6b",
    "granite_8b",
    "deepseek_67b",
    "hymba_1_5b",
    "musicgen_large",
    "qwen2_vl_2b",
    "mamba2_1_3b",
    "deepseek_v2_236b",
    "dbrx_132b",
)

_ALIASES = {
    "llama3-405b": "llama3_405b",
    "yi-6b": "yi_6b",
    "granite-8b": "granite_8b",
    "deepseek-67b": "deepseek_67b",
    "hymba-1.5b": "hymba_1_5b",
    "musicgen-large": "musicgen_large",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "mamba2-1.3b": "mamba2_1_3b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "dbrx-132b": "dbrx_132b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def get_config(name: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    cfg: ModelConfig = mod.CONFIG
    if overrides:
        import dataclasses

        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    cfg: ModelConfig = mod.SMOKE
    if overrides:
        import dataclasses

        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
