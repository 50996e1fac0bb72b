"""Architecture registry: ``get("<arch-id>")`` resolves ``--arch``.

All 10 assigned architectures + the paper's own PPN kernel configs.
"""
from __future__ import annotations

from typing import Dict, List

from .base import (ArchBundle, ModelConfig, ParallelConfig, SHAPE_CELLS,
                   ShapeCell)

_REGISTRY: Dict[str, "ArchBundle"] = {}


def register(bundle: ArchBundle) -> ArchBundle:
    _REGISTRY[bundle.model.name] = bundle
    return bundle


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from . import (chameleon_34b, command_r_35b, dbrx_132b,          # noqa: F401
                   jamba_1_5_large_398b, llama3_405b, qwen2_7b,
                   qwen3_moe_30b_a3b, rwkv6_1_6b, smollm_135m,
                   whisper_medium)


def get(arch: str) -> ArchBundle:
    _ensure_loaded()
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch]


def arch_names() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)
