"""jamba2-mini [hybrid] — AI21-Jamba2-Mini at its published widths
[hf:ai21labs/AI21-Jamba2-Mini config.json; arXiv:2403.19887].

32 layers = 4 blocks of 8 (attention at offset 4, 7 Mamba-1 mixers), GQA
32 / 8 heads with no positional encoding; MoE on every other layer (offset
1): 16 experts of width 14336, top-2, routed without drops and gated by the
two softmax probabilities as they are; a dense SwiGLU of width 14336 on the
others.  The Mamba mixer is the published one: d_inner 8192 (expand 2),
d_state 16, dt_rank 256, conv 4 with bias, RMSNorms on dt, B and C.
Untied head over 65536 tokens, RMSNorm eps 1e-6.  51.6 B parameters, 12.1 B
active a token.
"""
from . import register_published
from .base import ArchBundle, ParallelConfig, PublishedModelConfig

MODEL = PublishedModelConfig(
    name="jamba2-mini", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=65536,
    num_experts=16, experts_per_token=2, moe_every=2, moe_offset=1,
    capacity_factor=None, moe_norm_topk=False,
    attn_period=8, ssm_state_dim=16, ssm_conv_width=4, ssm_expand=2,
    ssm_dt_rank=256,
    norm="rmsnorm", act="silu", rope_theta=0.0, tie_embeddings=False,
)

register_published(ArchBundle(MODEL, parallel={"": ParallelConfig()}))
