"""Architecture registry of the port: the configurations whose model the
port runs, all ten of the JAX package's. ``smollm-360m``, ``yi-6b``,
``deepseek-7b``, ``qwen1.5-4b`` (dense) and ``chameleon-34b`` (one early-
fusion token stream), ``musicgen-medium`` (dense over four codebooks),
``zamba2-1.2b`` (hybrid Mamba2 with a shared attention block),
``rwkv6-7b`` (RWKV6, attention-free), ``llama4-maverick-400b-a17b``
(interleaved MoE) and ``deepseek-v2-236b`` (MLA with a dense-prefix MoE)
prefill and decode; the dense and MoE families with (64, 64) heads also
train on the card (`launch.train`)."""
from __future__ import annotations

from repro_torch.configs import (chameleon_34b, deepseek_7b,
                                 deepseek_v2_236b, llama4_maverick_400b,
                                 musicgen_medium, qwen1_5_4b, rwkv6_7b,
                                 smollm_360m, yi_6b, zamba2_1_2b)
from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME, ModelConfig,
                                      ShapeConfig, shape_applicable)

_MODULES = {"smollm-360m": smollm_360m, "zamba2-1.2b": zamba2_1_2b,
            "rwkv6-7b": rwkv6_7b, "yi-6b": yi_6b, "deepseek-7b": deepseek_7b,
            "qwen1.5-4b": qwen1_5_4b, "chameleon-34b": chameleon_34b,
            "llama4-maverick-400b-a17b": llama4_maverick_400b,
            "deepseek-v2-236b": deepseek_v2_236b,
            "musicgen-medium": musicgen_medium}

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
