"""dbrx-132b [moe] — 16 experts, top-4, fine-grained [hf:databricks/dbrx-base]."""
from . import register
from .base import ArchBundle, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=10752, vocab_size=100352,
    num_experts=16, experts_per_token=4, moe_every=1, moe_offset=0,
    norm="layernorm", act="silu", rope_theta=5e5,
)

register(ArchBundle(MODEL, parallel={
    "": ParallelConfig(num_microbatches=8, remat_block=8),
}))
