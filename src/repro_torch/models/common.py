"""Parameter plans: one source of truth for shapes, logical sharding axes and
initialization — consumed by `init_params` (real tensors), `abstract_params`
(``meta`` tensors: shapes and dtypes, no storage) and `partition_specs`.

The port of `repro.models.common`.  A plan is a tree of nested dicts with
`PSpec` leaves; parameters are the same tree with tensor leaves.
`params_from_numpy` carries the reference's parameters (nested dicts of
numpy arrays, bf16 ones included) over to that tree.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_map_with_path
from .sharding import Rules


def resolve_device(device=None) -> torch.device:
    """``device``, or the card where it is None.  A CUDA device on a host
    without one raises: an entry point runs on the CPU only when asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "model's plain PyTorch path on the CPU")
    return dev


@dataclass(frozen=True)
class PSpec:
    """Plan for one parameter tensor."""
    shape: Tuple[int, ...]
    names: Tuple[Optional[str], ...]        # logical axes, len == len(shape)
    init: str = "normal"                    # normal | zeros | ones | s4d | dt
    scale: float = 1.0                      # multiplier on fan-in init
    dtype: Any = torch.bfloat16

    def stacked(self, layers: int) -> "PSpec":
        return PSpec((layers,) + self.shape, (None,) + self.names,
                     self.init, self.scale, self.dtype)


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def plan_map(fn, plan):
    if is_pspec(plan):
        return fn(plan)
    return {k: plan_map(fn, v) for k, v in plan.items()}


def stack_plan(plan, layers: int):
    """Prepend a layer dimension to every parameter (scan-over-layers)."""
    return plan_map(lambda p: p.stacked(layers), plan)


def abstract_params(plan):
    return plan_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), plan)


def partition_specs(plan, rules: Rules):
    return plan_map(lambda p: rules.spec(p.shape, p.names), plan)


#: the most elements `_normal` draws at once where a slice could be split
_DRAW_ELEMENTS = 2 ** 28


def _slices(t: torch.Tensor):
    """``t`` one slice of its leading dimension at a time, and a slice of
    three or more dimensions past `_DRAW_ELEMENTS` again by its own leading
    one (the jamba super-block's stacked experts, (1, 4, 8, 8192, 24576),
    would be a 24 GiB float32 draw)."""
    for part in t:
        if part.dim() >= 3 and part.numel() > _DRAW_ELEMENTS:
            yield from _slices(part)
        else:
            yield part


def _normal(gen: torch.Generator, shape, std: float, out: torch.Tensor
            ) -> None:
    """``out`` ← std · N(0, 1) drawn in float32, then cast.  A leaf of three
    or more dimensions is drawn one slice of its leading (layer) dimension
    at a time (`_slices`), so the float32 draw of a stacked leaf never
    needs the whole leaf (qwen2-7b's MLP weights are 1.9e9 elements)."""
    slices = _slices(out) if len(shape) >= 3 else [out]
    for part in slices:
        draw = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                           device=out.device)
        part.copy_(draw.mul_(std))


def leaf_seed(seed: int, path: str, device_type: str) -> int:
    """The seed of one leaf's generator, from ``seed`` and the leaf's tree
    path.  The CPU generator keeps only the low 32 bits of its seed, so
    there both are folded into 32 bits, ``zlib.crc32`` of the path
    continued from the crc of the seed's digits: every seed draws other
    parameters.  A CUDA generator (Philox) takes all 64 bits of
    ``seed · 2**31 + crc32(path) mod 2**31``, which is kept as it is: the
    card's draws, on which `chip_smoke.py`'s loss gate was calibrated, do
    not change."""
    if device_type == "cpu":
        return zlib.crc32(path.encode(), zlib.crc32(str(int(seed)).encode()))
    return int(seed) * 2 ** 31 + zlib.crc32(path.encode()) % (2 ** 31)


def _s4d_real(shape, device) -> torch.Tensor:
    """Mamba's published ``A_log``: log(1 … d_state) along the last axis
    (S4D-real, A = −(n + 1))."""
    n = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device)
    return torch.log(n).expand(shape).contiguous()


def _dt_bias(gen: torch.Generator, shape, device, dt_min: float = 1e-3,
             dt_max: float = 0.1, floor: float = 1e-4) -> torch.Tensor:
    """Mamba's published dt bias: dt log-uniform on [dt_min, dt_max],
    floored, and the bias its inverse softplus, so softplus(bias) = dt."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    lo, hi = float(np.log(dt_min)), float(np.log(dt_max))
    dt = torch.exp(u * (hi - lo) + lo).clamp(min=floor)
    return dt + torch.log(-torch.expm1(-dt))


def init_params(seed: int, plan, device=None):
    """Deterministic init on ``device`` (the card where None): every leaf
    drawn by its own `torch.Generator` on the device, seeded by `leaf_seed`
    from ``seed`` and ``zlib.crc32`` of the leaf's tree path, spelt as
    ``jax.tree_util.keystr`` spells it (``['layers']['attn']['wq']``; a
    stable hash — Python's hash() is per-process randomized), with std =
    scale / sqrt(fan_in).  The card's generator draws other numbers than the
    CPU's from the same seed, and neither draws the reference's: parity
    between the packages runs on parameters carried over with
    `params_from_numpy`.  The published Mamba mixer's ``A_log`` (``"s4d"``)
    and dt bias (``"dt"``) take Mamba's published initialization."""
    dev = resolve_device(device)

    def one(path: str, p: PSpec) -> torch.Tensor:
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=p.dtype, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=p.dtype, device=dev)
        if p.init == "s4d":
            return _s4d_real(p.shape, dev).to(p.dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(leaf_seed(seed, path, dev.type))
        if p.init == "dt":
            return _dt_bias(gen, p.shape, dev).to(p.dtype)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        leaf = torch.empty(p.shape, dtype=p.dtype, device=dev)
        _normal(gen, p.shape, p.scale / float(np.sqrt(max(fan_in, 1))), leaf)
        return leaf

    return tree_map_with_path(one, plan)


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 (from ml_dtypes) is not a dtype torch reads: take
        # its bits as int16 and view them as torch's bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device=None, dtype=None):
    """The reference's parameters (or cache), nested dicts of numpy arrays,
    as the port's tree: the same keys and stacked shapes, on ``device``
    (the card where None); floating leaves cast to ``dtype`` where given."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    t = _tensor_from_numpy(tree)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(dev)


# ----------------------------------------------------------------- plan sugar

def linear(din: int, dout: int, dtype=torch.bfloat16,
           names: Tuple[Optional[str], Optional[str]] = ("wfsdp", "wtp"),
           scale: float = 1.0) -> PSpec:
    return PSpec((din, dout), names, "normal", scale, dtype)


def norm_scale(d: int, dtype=torch.bfloat16) -> PSpec:
    return PSpec((d,), ("norm",), "ones", dtype=dtype)


def bias(d: int, name: Optional[str] = "norm", dtype=torch.bfloat16) -> PSpec:
    return PSpec((d,), (name,), "zeros", dtype=dtype)
