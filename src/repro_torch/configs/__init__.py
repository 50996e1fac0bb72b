"""Architecture registry: ``get("<arch-id>")`` resolves ``--arch``.

All 10 assigned architectures (`arch_names`, the reference's) + the paper's
own PPN kernel configs, and the models the port serves beyond them at their
published widths (`published_names`; `all_arch_names` lists both).
"""
from __future__ import annotations

from typing import Dict, List

from .base import (ArchBundle, ModelConfig, ParallelConfig, SHAPE_CELLS,
                   ShapeCell)

_REGISTRY: Dict[str, "ArchBundle"] = {}
_PUBLISHED: Dict[str, "ArchBundle"] = {}


def register(bundle: ArchBundle) -> ArchBundle:
    _REGISTRY[bundle.model.name] = bundle
    return bundle


def register_published(bundle: ArchBundle) -> ArchBundle:
    _PUBLISHED[bundle.model.name] = bundle
    return bundle


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from . import (chameleon_34b, command_r_35b, dbrx_132b,          # noqa: F401
                   jamba2_mini, jamba_1_5_large_398b, llama3_405b,
                   qwen2_7b, qwen3_moe_30b_a3b, rwkv6_1_6b, smollm_135m,
                   whisper_medium)


def get(arch: str) -> ArchBundle:
    _ensure_loaded()
    bundle = _REGISTRY.get(arch) or _PUBLISHED.get(arch)
    if bundle is None:
        raise KeyError(f"unknown arch {arch!r}; known: {all_arch_names()}")
    return bundle


def arch_names() -> List[str]:
    """The reference's assigned architectures."""
    _ensure_loaded()
    return sorted(_REGISTRY)


def published_names() -> List[str]:
    """The models served at published widths beyond the assigned set."""
    _ensure_loaded()
    return sorted(_PUBLISHED)


def all_arch_names() -> List[str]:
    return sorted(arch_names() + published_names())
