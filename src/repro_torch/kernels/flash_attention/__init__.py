"""Blocked GQA flash attention (kernel 5), its wrapper and its oracle."""
from .kernel import flash_attention
from .ops import attention_op
from .ref import attention_ref, chunked_attention

__all__ = ["attention_op", "attention_ref", "chunked_attention",
           "flash_attention"]
