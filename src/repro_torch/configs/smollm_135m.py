"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M].

9 heads / 3 KV heads do not divide the 16-way model axis: weights replicate
over "model" and the batch shards over (data, model) = 256-way pure DP.  With
global_batch=256 < 512 chips, the multi-pod cell shards the *sequence* over
the pod axis instead (see ParallelConfig defaults in base.py).
"""
from . import register
from .base import ArchBundle, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    head_dim=64, d_ff=1536, vocab_size=49152,
    norm="rmsnorm", act="silu", tie_embeddings=True,
)

_P = ParallelConfig(batch_axes=("data", "model"), tp_axes=(),
                    fsdp_axes=("data", "model"), kv_seq_axes=(),
                    num_microbatches=1)

register(ArchBundle(MODEL, parallel={"": _P}))
