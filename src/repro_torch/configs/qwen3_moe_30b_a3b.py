"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8, fine-grained d_ff=768
[hf:Qwen/Qwen3-30B-A3B]."""
from . import register
from .base import ArchBundle, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    head_dim=128, d_ff=768, vocab_size=151936,
    num_experts=128, experts_per_token=8, moe_every=1, moe_offset=0,
    norm="rmsnorm", act="silu", qk_norm=True, rope_theta=1e6,
)

register(ArchBundle(MODEL, parallel={
    "": ParallelConfig(num_microbatches=4, remat_block=8),
}))
