"""whisper-medium [audio] — encoder-decoder transformer backbone; the conv
audio frontend is a STUB per the brief: ``input_specs()`` provides
precomputed frame embeddings (batch, frames, d_model) [arXiv:2212.04356].

vocab 51865 is padded to 51968 (multiple of 256) to shard on the 16-way
model axis; padded logits are masked.
"""
from . import register
from .base import ArchBundle, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    head_dim=64, d_ff=4096, vocab_size=51865, encoder_layers=24,
    norm="layernorm", act="gelu", rope_theta=0.0,
)

# 769M params on 256 chips: TP would replicate most activations; pure
# 256-way DP + ZeRO-3 measures 9.8 vs 22.8 GiB/dev and 0.24 vs 4.6 s of
# collective per step (EXPERIMENTS §Perf).
register(ArchBundle(MODEL, parallel={
    "": ParallelConfig(num_microbatches=1),
    "train_4k": ParallelConfig(batch_axes=("data", "model"), tp_axes=(),
                               fsdp_axes=("data", "model"),
                               num_microbatches=1),
}))
