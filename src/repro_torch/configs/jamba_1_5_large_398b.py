"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave,
MoE 16 experts top-2 every other layer [arXiv:2403.19887].

72 layers = 9 super-blocks of 8 (1 attention + 7 Mamba); MoE replaces the
dense MLP on every second layer.
"""
from . import register
from .base import ArchBundle, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=24576, vocab_size=65536,
    num_experts=16, experts_per_token=2, moe_every=2, moe_offset=1,
    attn_period=8, ssm_state_dim=16, ssm_conv_width=4, ssm_expand=2,
    norm="rmsnorm", act="silu",
)

register(ArchBundle(MODEL, parallel={
    "": ParallelConfig(optimizer_state_dtype="int8", num_microbatches=16,
                   grad_accum_dtype="bfloat16", kv_cache_dtype="int8"),
}))
