"""Architecture config registry of the port.

``get_config(arch_id)`` returns the full ``ModelConfig``;
``get_smoke_config(arch_id)`` the reduced same-family variant the CPU
tests use. Every architecture of the reference is listed: the dense
decoders, the two MoE decoders, rwkv6-3b and recurrentgemma-9b (the
hybrid griffin family). ``MESHES`` names the worker layouts
(``launch.mesh.mesh_from_config``), ``SHAPES`` the assigned input shapes.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    MESHES,
    HybridConfig,
    MeshConfig,
    ModelConfig,
    MoEConfig,
    PodRefreshConfig,
    RWKVConfig,
    SHAPES,
    ShapeConfig,
)

# the reference's ARCH_IDS, in its order
ARCH_IDS = (
    "rwkv6-3b",
    "qwen1.5-4b",
    "yi-9b",
    "musicgen-medium",
    "qwen3-moe-30b-a3b",
    "qwen3-4b",
    "internvl2-26b",
    "granite-3-8b",
    "recurrentgemma-9b",
    "granite-moe-3b-a800m",
)


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}")
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


__all__ = ["ModelConfig", "MoEConfig", "RWKVConfig", "HybridConfig",
           "MeshConfig", "MESHES", "PodRefreshConfig", "ShapeConfig",
           "SHAPES", "ARCH_IDS",
           "get_config", "get_smoke_config"]
