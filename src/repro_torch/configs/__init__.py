"""Architecture registry of the port: the configurations whose model the
port runs, for prefill and decode. ``smollm-360m`` (dense), ``zamba2-1.2b``
(hybrid Mamba2 with a shared attention block) and ``rwkv6-7b`` (RWKV6,
attention-free) are ported so far; the JAX package's other architectures
(MoE, MLA, multi-codebook) wait for their slices (ROADMAP §1)."""
from __future__ import annotations

from repro_torch.configs import rwkv6_7b, smollm_360m, zamba2_1_2b
from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME, ModelConfig,
                                      ShapeConfig, shape_applicable)

_MODULES = {"smollm-360m": smollm_360m, "zamba2-1.2b": zamba2_1_2b,
            "rwkv6-7b": rwkv6_7b}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    """The published configuration of `arch_id`."""
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """A reduced configuration of the same family, for CPU tests."""
    return _module(arch_id).smoke()


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "SHAPES_BY_NAME",
           "ARCH_IDS", "get_config", "get_smoke_config", "shape_applicable"]
