"""Architecture + shape configuration schema.

One :class:`ArchConfig` per assigned architecture (exact public configs in the
sibling modules) plus a reduced ``smoke()`` variant per arch for CPU tests.
:class:`ShapeSpec` describes the assigned input shapes (train / prefill /
decode / long-context-decode).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                      # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int                         # dense-MLP hidden (0 if none)
    vocab_size: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    d_inner: int = 0                  # 0 → 2 * d_model
    ssm_conv: int = 4
    dt_rank: int = 0                  # 0 → ceil(d_model / 16)
    # --- attention details ---
    qkv_bias: bool = False
    mlp_act: str = "swiglu"           # swiglu | geglu
    pos_embed: str = "rope"           # rope | sinusoidal | none
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # 0 → full attention
    global_attn_layers: tuple = ()    # hybrid: layers using full attention
    # --- modality frontend stubs ---
    n_codebooks: int = 0              # audio: parallel EnCodec streams
    vision_tokens: int = 0            # vlm: precomputed patch embeddings
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # --- distribution / performance knobs (hillclimbed in §Perf) ---
    use_scan: bool = True             # lax.scan over layers
    remat: bool = True                # activation checkpointing per layer
    fsdp: bool = True                 # shard weights over the data axis too
    coded: bool = False               # SAC-coded contraction on MLP down-proj
    coded_K: int = 8                  # information dimension for coded layers
    loss_chunk: int = 4096            # CE loss token-chunking
    opt_dtype: str = "float32"        # AdamW moment dtype (bf16 for 1T-scale)
    source: str = ""                  # provenance tag [source; tier]
    # cost-extraction mode (dry-run only, never executed): unrolled layers,
    # materialized attention, python-loop CE — XLA's cost analysis counts
    # while-loop bodies once, so the real (scanned) program under-reports.
    cost_mode: bool = False

    # ------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def resolved_d_inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    def padded_vocab(self, mult: int = 16) -> int:
        """Embedding tables padded to the model-axis multiple (DESIGN §5)."""
        return _round_up(self.vocab_size, mult)

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / sliding-window-only attn."""
        return self.family in ("ssm", "hybrid") or (
            self.has_attention and self.sliding_window > 0
            and not self.global_attn_layers)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, L = self.d_model, self.n_layers
        n_emb = max(1, self.n_codebooks)
        total = n_emb * self.padded_vocab() * d              # embeddings
        if not self.tie_embeddings:
            total += n_emb * self.padded_vocab() * d         # LM head(s)
        per_layer = 2 * d                                    # norms
        if self.has_attention:
            hd, H, Hkv = self.resolved_head_dim, self.n_heads, self.n_kv_heads
            per_layer += d * H * hd + 2 * d * Hkv * hd + H * hd * d
        if self.has_ssm:
            di, s, r = self.resolved_d_inner, self.ssm_state, self.resolved_dt_rank
            per_layer += d * 2 * di + di * self.ssm_conv + di * (r + 2 * s) \
                + r * di + di * s + di + di * d
        if self.d_ff and not self.has_moe:
            per_layer += (2 if self.mlp_act == "gelu" else 3) * d * self.d_ff
        if self.has_moe:
            per_layer += d * self.n_experts                  # router
            per_layer += self.n_experts * 3 * d * self.d_ff_expert
            per_layer += self.n_shared_experts * 3 * d * self.d_ff_expert
        return total + L * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.has_moe:
            return self.param_count()
        inactive = (self.n_experts - self.experts_per_token) * 3 * \
            self.d_model * self.d_ff_expert * self.n_layers
        return self.param_count() - inactive

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}
