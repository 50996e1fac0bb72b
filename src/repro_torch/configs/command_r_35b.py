"""command-r-35b [dense] — GQA, no-bias, parallel attn/mlp block, 256k vocab
[hf:CohereForAI/c4ai-command-r-v01]."""
from . import register
from .base import ArchBundle, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=22528, vocab_size=256000,
    norm="layernorm", act="silu", parallel_block=True, tie_embeddings=True,
)

register(ArchBundle(MODEL, parallel={
    "": ParallelConfig(num_microbatches=8, remat_block=8),
}))
