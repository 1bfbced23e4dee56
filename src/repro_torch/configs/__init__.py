"""Architecture config registry of the port.

``get_config(arch_id)`` returns the full ``ModelConfig``;
``get_smoke_config(arch_id)`` the reduced same-family variant the CPU
tests use. Only the architectures the port runs are listed.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, RWKVConfig

ARCH_IDS = ("qwen3-4b", "rwkv6-3b")


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}")
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


__all__ = ["ModelConfig", "RWKVConfig", "ARCH_IDS", "get_config",
           "get_smoke_config"]
