"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from . import register
from .base import ArchBundle, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    head_dim=128, d_ff=53248, vocab_size=128256,
    norm="rmsnorm", act="silu", rope_theta=5e5,
)

register(ArchBundle(MODEL, parallel={
    # 8-bit optimizer states: 405B × (2B param + 2B grad + 2×~1B m/v) / 256
    # chips ≈ 9.7 GB/chip — fits 16 GB HBM; fp32 m/v would not (§DESIGN.md).
    "": ParallelConfig(optimizer_state_dtype="int8", num_microbatches=16, remat_block=9,
                   grad_accum_dtype="bfloat16", kv_cache_dtype="int8"),
    "train_4k": ParallelConfig(optimizer_state_dtype="int8", num_microbatches=16,
                               remat_block=9, grad_accum_dtype="bfloat16"),
}))
