"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

The port knows the architectures whose family it runs: so far the hybrid
family's ``hymba-1.5b``.  The other LM ids raise ``NotImplementedError``
(ROADMAP Queue 1 item 11)."""
from __future__ import annotations

import importlib

from .base import ArchConfig, ShapeCell, SHAPES, applicable_shapes

_MODULES = {
    "hymba-1.5b": "hymba_1p5b",
}

# the JAX package's other LM architectures, not ported yet
_NOT_PORTED = ("qwen2-72b", "chatglm3-6b", "gemma2-27b", "qwen1.5-110b",
               "rwkv6-1.6b", "granite-moe-1b-a400m", "granite-moe-3b-a800m",
               "whisper-tiny", "llava-next-mistral-7b")

ARCH_IDS = list(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        if arch in _NOT_PORTED:
            raise NotImplementedError(
                f"arch {arch!r} is not ported yet (ROADMAP Queue 1 item 11); "
                f"the port runs {ARCH_IDS}")
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _mod(arch).CONFIG


def get_reduced(arch: str) -> ArchConfig:
    return _mod(arch).REDUCED
