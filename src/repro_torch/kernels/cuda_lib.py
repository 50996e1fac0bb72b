"""Build, load and launch the hand-written CUDA kernels of `repro_torch/csrc`.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/`` at
the repository root, then loaded with `ctypes` (no PyTorch headers, so a
build takes seconds).  The library's file name carries a hash of the source,
the shared headers and the flags, so an edited source is rebuilt and a stale one is never
loaded.  Nothing is built or loaded at import: a kernel builds at its first
launch, or all of them together (one ``nvcc`` each, in parallel) through
`build_all`.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrapper raises if it is not 0, because a refused launch never runs and
``torch.cuda.synchronize()`` would not report it.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "host with the CUDA toolkit")
    return found


class CudaKernel:
    """One C entry point of one ``csrc`` source.  ``launches`` counts the
    kernel launches its calls made (a plain integer a run may reset): one a
    call, or what the caller says a call queued."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence) -> None:
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.ptxas_log = ""
        self._fn = None

    @property
    def library(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in [self.source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(path.read_bytes())
        digest = h.hexdigest()
        return BUILD_DIR / f"{self.source.stem}-{digest[:12]}.so"

    def _build_cmd(self, tmp: Path):
        return [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]

    def _load(self) -> None:
        fn = getattr(ctypes.CDLL(str(self.library)), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def ensure_loaded(self) -> None:
        if self._fn is None:
            build_all([self])

    def __call__(self, *args, launches: int = 1) -> None:
        if self._fn is None:
            self.ensure_loaded()
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: launch failed with CUDA "
                               f"error {err}")
        self.launches += launches


def build_all(kernels: Sequence[CudaKernel]) -> Dict[str, float]:
    """Compile every kernel whose library is missing — one ``nvcc`` per
    source, all started together — and load them all.  Returns the build
    seconds per source (0.0 where the library was already built)."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for k in kernels:
        lib = k.library
        if not lib.exists() and lib not in pending:
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            pending[lib] = (k, tmp, time.perf_counter(), subprocess.Popen(
                k._build_cmd(tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    seconds = {k.source.name: 0.0 for k in kernels}
    failures = []
    for lib, (k, tmp, t0, proc) in pending.items():
        log, _ = proc.communicate()
        seconds[k.source.name] = time.perf_counter() - t0
        for other in kernels:
            if other.source == k.source:
                other.ptxas_log = log
        if proc.returncode != 0:
            failures.append(f"{k.source.name}:\n{log}")
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    for k in kernels:
        if k._fn is None:
            k._load()
    return seconds


def on_device(device):
    """A context that makes ``device`` (a torch.device) current, or none
    where it is: entering `torch.cuda.device` costs a wrapper call
    microseconds of host time."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def aligned(t):
    """``t`` contiguous and 16-byte aligned, as the kernels' 16-byte loads
    and tensor maps need (a view may start at any element)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def raw_stream(device) -> int:
    """The current stream of ``device``, as a C entry point takes it."""
    import torch

    index = torch.cuda.current_device() if device.index is None else \
        device.index
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:               # no Stream object to build
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


#: kernel 1 — the fused time-tiled ring stencil over one cluster or a
#: cooperative grid (`csrc/ring_stencil.cu`)
RING_STENCIL = CudaKernel("ring_stencil.cu", "ring_stencil_f32",
                          [_P, _P, _P] + [_I] * 15 + [_P])
#: the limits kernel 1's launch shape is cut to on a device (a query that
#: launches nothing: call it with ``launches=0``)
RING_LIMITS = CudaKernel("ring_stencil.cu", "ring_stencil_limits", [_I, _P])
#: kernel 2 — addressable time steps, one launch each, queued from C
#: (`csrc/addressable_step.cu`); a call counts the launches it queued
ADDRESSABLE_STEP = CudaKernel("addressable_step.cu", "addressable_steps_f32",
                              [_P, _P, _P, _I, _I, _I, _I, _I, _P])
#: kernel 3 — trace replay through a ring of slots (`csrc/replay.cu`)
REPLAY = CudaKernel("replay.cu", "replay_i32",
                    [_P, _P, _P, _I, _P, _I, _I, _P, _P])

#: kernel 4 — the hand-written Fig. 3 jacobi-1d (`csrc/stencil_fifo.cu`)
STENCIL_FIFO = CudaKernel("stencil_fifo.cu", "stencil_fifo_f32",
                          [_P, _P, _I, _I, _I, _I, _I, _P])
#: kernel 5 — blocked GQA flash attention (`csrc/flash_attention.cu`)
FLASH_ATTENTION = CudaKernel("flash_attention.cu", "flash_attention_fwd",
                             [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                              _I, _P])
#: kernel 6 — chunk-parallel GLA/RWKV-6 time-mix (`csrc/gla_timemix.cu`):
#: one call queues its three phases (counted as one launch)
GLA_TIMEMIX = CudaKernel("gla_timemix.cu", "gla_timemix_fwd",
                         [_P] * 7 + [_I] * 7 + [_P])

KERNELS = (RING_STENCIL, ADDRESSABLE_STEP, REPLAY, STENCIL_FIFO,
           FLASH_ATTENTION, GLA_TIMEMIX)
