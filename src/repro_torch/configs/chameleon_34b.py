"""chameleon-34b [vlm] — early-fusion mixed-modal; VQ image tokens share the
65536-entry codebook vocabulary, so the backbone is a dense llama-style
transformer with qk-norm; the image tokenizer frontend is a stub per the
brief (inputs are token ids) [arXiv:2405.09818]."""
from . import register
from .base import ArchBundle, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="chameleon-34b", family="dense",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=22016, vocab_size=65536,
    norm="rmsnorm", act="silu", qk_norm=True,
)

register(ArchBundle(MODEL, parallel={
    "": ParallelConfig(num_microbatches=8, remat_block=8),
}))
