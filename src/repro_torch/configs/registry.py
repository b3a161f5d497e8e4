"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS: dict[str, str] = {
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
}


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    cfg = importlib.import_module(ARCH_IDS[arch]).CONFIG
    if overrides:
        import dataclasses

        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_archs() -> list[str]:
    return sorted(ARCH_IDS)
