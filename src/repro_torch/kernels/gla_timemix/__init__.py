"""Chunkwise RWKV-6 / GLA time-mix (kernel 6), its wrapper and its oracle."""
from .kernel import gla_timemix
from .ops import timemix_op
from .ref import timemix_ref

__all__ = ["gla_timemix", "timemix_op", "timemix_ref"]
