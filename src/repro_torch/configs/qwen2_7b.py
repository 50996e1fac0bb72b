"""qwen2-7b [dense] — GQA with QKV bias [arXiv:2407.10671]."""
from . import register
from .base import ArchBundle, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    head_dim=128, d_ff=18944, vocab_size=152064,
    norm="rmsnorm", act="silu", qkv_bias=True, rope_theta=1e6,
)

# 28 heads / 4 kv heads don't divide the 16-way model axis: TP leaves head
# activations replicated (44 GiB/dev, memory term 89 s).  A 7B model with
# global_batch 256 = mesh size maps to pure 256-way DP + ZeRO-3 instead:
# measured 14.0 GiB/dev, memory term 6.7 s (13×) — EXPERIMENTS §Perf.
# Decode/prefill cells (batch < 256) fall back to data-axis batch sharding
# with the KV cache sequence-sharded over the idle model axis.
# serve cells (batch 32/128 < 256) keep the TP layout: the KV cache and
# 32k activations need the model axis.
register(ArchBundle(MODEL, parallel={
    "": ParallelConfig(num_microbatches=4, remat_block=7),
    "train_4k": ParallelConfig(batch_axes=("data", "model"), tp_axes=(),
                               fsdp_axes=("data", "model"),
                               num_microbatches=1),
}))
