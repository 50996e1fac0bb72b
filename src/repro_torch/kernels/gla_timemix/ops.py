"""Public wrapper of the GLA/RWKV-6 time-mix: the chunked kernel on the
card, the sequential oracle on the CPU.

The port of `repro.kernels.gla_timemix.ops`.  ``use_kernel=None`` picks by
device: `gla_timemix` (kernel 6) for a CUDA tensor, `timemix_ref` for a CPU
one.  ``True`` runs `gla_timemix` wherever r lies (its plain version on
the CPU); ``False`` runs `timemix_ref`."""
from __future__ import annotations

from .kernel import gla_timemix
from .ref import timemix_ref


def timemix_op(r, k, v, logw, u, chunk: int = 64, use_kernel=None):
    if use_kernel is None:
        use_kernel = r.device.type == "cuda"
    if use_kernel:
        return gla_timemix(r, k, v, logw, u, chunk=chunk)
    return timemix_ref(r, k, v, logw, u)
