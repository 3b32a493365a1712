"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

The port knows every LM architecture of the JAX package, in its order:
the hybrid ``hymba-1.5b``, the dense ``qwen2-72b``, ``chatglm3-6b``,
``gemma2-27b`` and ``qwen1.5-110b``, the RWKV6 ``rwkv6-1.6b``, the MoE
``granite-moe-*``, the encoder-decoder ``whisper-tiny`` and the VLM
``llava-next-mistral-7b``.  The GNN configs are modules of their own
(``configs/gcn.py`` and its siblings)."""
from __future__ import annotations

import importlib

from .base import ArchConfig, ShapeCell, SHAPES, applicable_shapes

_MODULES = {
    "hymba-1.5b": "hymba_1p5b",
    "qwen2-72b": "qwen2_72b",
    "chatglm3-6b": "chatglm3_6b",
    "gemma2-27b": "gemma2_27b",
    "qwen1.5-110b": "qwen15_110b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "whisper-tiny": "whisper_tiny",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ARCH_IDS = list(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _mod(arch).CONFIG


def get_reduced(arch: str) -> ArchConfig:
    return _mod(arch).REDUCED
