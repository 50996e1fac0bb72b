"""rwkv6-1.6b (Finch) [ssm] — attention-free, data-dependent decay
[arXiv:2404.05892].  Head size 64 → 32 heads; time-mix state is
(heads, head_dim, head_dim) per sequence — O(1) decode state.
"""
from . import register
from .base import ArchBundle, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=7168, vocab_size=65536,
    norm="layernorm", act="relu_sq",
)

register(ArchBundle(MODEL, parallel={
    "": ParallelConfig(num_microbatches=1),
}))
