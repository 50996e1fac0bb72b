"""Public wrapper of flash attention: the kernel on the card, the chunked
oracle on the CPU.

The port of `repro.kernels.flash_attention.ops`.  ``use_kernel=None``
picks by device: `flash_attention` (kernel 5) for a CUDA tensor,
`attention_ref` for a CPU one.  ``True`` runs `flash_attention` wherever q
lies (its plain version on the CPU); ``False`` runs `attention_ref`."""
from __future__ import annotations

from .kernel import flash_attention
from .ref import attention_ref


def attention_op(q, k, v, causal: bool = True, use_kernel=None):
    if use_kernel is None:
        use_kernel = q.device.type == "cuda"
    if use_kernel:
        return flash_attention(q, k, v, causal=causal)
    return attention_ref(q, k, v, causal=causal)
