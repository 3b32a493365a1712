"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

The port knows the architectures whose family it runs: the hybrid
``hymba-1.5b``, the dense ``qwen2-72b``, ``chatglm3-6b``, ``gemma2-27b`` and
``qwen1.5-110b``, the MoE ``granite-moe-*`` and the VLM
``llava-next-mistral-7b``.  RWKV6 and Whisper raise
``NotImplementedError`` (ROADMAP Queue 1 items 11b.4 and 11b.5)."""
from __future__ import annotations

import importlib

from .base import ArchConfig, ShapeCell, SHAPES, applicable_shapes

_MODULES = {
    "hymba-1.5b": "hymba_1p5b",
    "qwen2-72b": "qwen2_72b",
    "chatglm3-6b": "chatglm3_6b",
    "gemma2-27b": "gemma2_27b",
    "qwen1.5-110b": "qwen15_110b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

# the JAX package's other LM architectures, not ported yet: id → item
_NOT_PORTED = {"rwkv6-1.6b": "11b.4", "whisper-tiny": "11b.5"}

ARCH_IDS = list(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        if arch in _NOT_PORTED:
            raise NotImplementedError(
                f"arch {arch!r} is not ported yet (ROADMAP Queue 1 item "
                f"{_NOT_PORTED[arch]}); the port runs {ARCH_IDS}")
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _mod(arch).CONFIG


def get_reduced(arch: str) -> ArchConfig:
    return _mod(arch).REDUCED
