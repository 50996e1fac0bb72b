"""Config system: model + parallelism + run configs, and the assigned
input-shape cells.

Every assigned architecture is a `ModelConfig` in its own module under
`repro_torch.configs`; `repro_torch.configs.get("<arch-id>")` resolves the `--arch` flag.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1             # MoE MLP on layers with index % moe_every == moe_offset
    moe_offset: int = 1
    capacity_factor: float = 1.25
    # hybrid (jamba): one attention layer per `attn_period` layers, rest Mamba
    attn_period: int = 0
    # SSM
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    # flags
    qkv_bias: bool = False         # qwen2
    qk_norm: bool = False          # chameleon / qwen3
    parallel_block: bool = False   # command-r: attn and mlp in parallel
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "silu"              # silu (SwiGLU) | gelu (plain MLP)
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic (SSM/hybrid) families."""
        return self.family in ("ssm", "hybrid")

    def attn_layer_indices(self) -> Tuple[int, ...]:
        """Which layers are attention (hybrid archs); all for pure attn."""
        if self.family == "ssm":
            return ()
        if self.attn_period:
            return tuple(i for i in range(self.num_layers)
                         if i % self.attn_period == self.attn_period // 2)
        return tuple(range(self.num_layers))

    def padded_vocab(self, multiple: int = 256) -> int:
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS and sizing sanity checks."""
        D, F, V = self.d_model, self.d_ff, self.padded_vocab()
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim_
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        dense_mlp = 3 * D * F if self.act == "silu" else 2 * D * F
        total = 0
        attn_layers = set(self.attn_layer_indices())
        for i in range(self.num_layers):
            if self.family == "ssm":
                total += self._rwkv_layer_params()
                continue
            if self.family == "hybrid" and i not in attn_layers:
                total += self._mamba_layer_params()
            else:
                total += attn
            if self.num_experts and i % self.moe_every == self.moe_offset % self.moe_every:
                total += self.num_experts * dense_mlp + D * self.num_experts
            else:
                total += dense_mlp
            total += 2 * D                      # norms
        if self.encoder_layers:                 # whisper encoder + cross-attn
            total += self.encoder_layers * (attn + dense_mlp + 2 * D)
            total += self.num_layers * attn     # cross-attention
        total += V * D * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Active (per-token) params — MoE uses top-k of experts."""
        if not self.num_experts:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dense_mlp = 3 * D * F if self.act == "silu" else 2 * D * F
        inactive = (self.num_experts - self.experts_per_token) * dense_mlp
        moe_layers = sum(1 for i in range(self.num_layers)
                         if i % self.moe_every == self.moe_offset % self.moe_every)
        return self.param_count() - moe_layers * inactive

    def _mamba_layer_params(self) -> int:
        D = self.d_model
        di = self.ssm_expand * D
        ds = self.ssm_state_dim
        return (D * 2 * di + self.ssm_conv_width * di + di * ds * 2
                + di * 2 + di + di * D)

    def _rwkv_layer_params(self) -> int:
        D, F = self.d_model, self.d_ff
        return 4 * D * D + D * D // 2 + 2 * D * F + 8 * D


@dataclass(frozen=True)
class ParallelConfig:
    """How a step is laid out on the production mesh."""
    batch_axes: Tuple[str, ...] = ("data",)       # activation batch sharding
    seq_axes: Tuple[str, ...] = ()                # sequence parallelism (train)
    tp_axes: Tuple[str, ...] = ("model",)         # tensor parallel axis
    fsdp_axes: Tuple[str, ...] = ("data",)        # weight/optimizer sharding
    kv_seq_axes: Tuple[str, ...] = ("model",)     # decode KV-cache seq sharding
    num_microbatches: int = 1
    remat: str = "full"                           # full | none
    remat_block: int = 0                          # two-level (√L) remat block
    pipeline_stages: int = 1
    optimizer_state_dtype: str = "float32"        # float32 | int8
    grad_accum_dtype: str = "float32"             # float32 | bfloat16
    kv_cache_dtype: str = "bfloat16"              # bfloat16 | int8
    gradient_compression: bool = False            # int8 DP all-reduce (shard_map path)
    scan_layers: bool = True

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPE_CELLS: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchBundle:
    model: ModelConfig
    # per-(shape-cell) parallel overrides; key "" is the default
    parallel: Dict[str, ParallelConfig] = field(default_factory=dict)

    def parallel_for(self, cell: str, multi_pod: bool) -> ParallelConfig:
        p = self.parallel.get(cell, self.parallel.get("", ParallelConfig()))
        if multi_pod and "pod" not in (p.batch_axes + p.seq_axes + p.fsdp_axes):
            # default multi-pod rule: pod extends data parallelism — unless
            # the batch already consumes the model axis (global_batch too
            # small to split further, e.g. smollm)
            if p.batch_axes and p.batch_axes[0] == "data" \
                    and "model" not in p.batch_axes:
                # pod doubles the batch shards: keep ≥1 sample per shard per
                # microbatch (global_batch 256 / 32 shards caps m at 8 —
                # otherwise the divisibility fallback replicates activations)
                m = p.num_microbatches
                if m >= 16:
                    m = m // 2
                p = p.replace(batch_axes=("pod",) + p.batch_axes,
                              fsdp_axes=tuple(dict.fromkeys(("pod",) + p.fsdp_axes)),
                              kv_seq_axes=p.kv_seq_axes,
                              num_microbatches=m)
            else:
                # batch cannot take the pod axis (e.g. smollm's global_batch
                # 256 = data×model already): the pod axis still shards weights
                # and optimizer state (ZeRO-3 over pods)
                p = p.replace(fsdp_axes=tuple(dict.fromkeys(("pod",) + p.fsdp_axes)))
        return p


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test-sized config of the same family (tests run these on CPU)."""
    kw = dict(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
    )
    if cfg.num_experts:
        kw.update(num_experts=min(cfg.num_experts, 8),
                  experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.family == "hybrid":
        kw.update(attn_period=4, num_layers=8)
    if cfg.family == "ssm":
        kw.update(num_heads=4, num_kv_heads=4, head_dim=16)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2)
    return dataclasses.replace(cfg, **kw)
