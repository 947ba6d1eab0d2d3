"""Architecture configuration covering every family of the reference:
dense / MoE / SSM / hybrid / VLM / enc-dec audio backbones.

The port's own copy of ``repro.models.config`` (pure dataclasses), so that
the port imports nothing of the reference package."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention
    attention: str = "gqa"           # gqa | mla | none
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False            # chameleon
    rope_theta: float = 10_000.0

    # MLA (MiniCPM3 / DeepSeek-style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba1 / mamba2-style)
    ssm: bool = False
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 1

    # hybrid (zamba2): one *shared* attention block applied every k layers
    hybrid_attn_every: int = 0

    # encoder-decoder (whisper): encoder layer count; frontend is a stub
    encdec: bool = False
    enc_layers: int = 0
    max_source_positions: int = 1500

    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"              # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm

    # systems knobs
    dtype: str = "bfloat16"
    remat: bool = True
    use_flash_kernel: str = "auto"   # auto | always | never
    sub_quadratic: bool = False      # True for ssm/hybrid (long_500k eligible)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    # -- derived -------------------------------------------------------------

    @property
    def kv_group(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count N (for 6·N·D roofline terms)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        per_layer = 0
        if self.attention != "none":
            if self.attention == "mla":
                qd = self.q_lora_rank or d
                per_layer += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.qk_rope_dim
                ) if self.q_lora_rank else d * self.n_heads * (
                    self.qk_nope_dim + self.qk_rope_dim
                )
                per_layer += d * (self.kv_lora_rank + self.qk_rope_dim)
                per_layer += self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.v_head_dim
                )
                per_layer += self.n_heads * self.v_head_dim * d
            else:
                per_layer += d * self.n_heads * hd          # Q
                per_layer += 2 * d * self.n_kv_heads * hd   # K, V
                per_layer += self.n_heads * hd * d          # O
        if self.ssm:
            di = self.ssm_expand * d
            per_layer += d * 2 * di + di * d               # in/out proj
            per_layer += di * (2 * self.ssm_state + 2)     # B, C, dt, A
            per_layer += self.ssm_conv * di
        if self.moe:
            per_layer += d * self.n_experts                # router
            per_layer += self.n_experts * 3 * d * self.expert_d_ff
        elif ff > 0:
            mult = 3 if self.act == "swiglu" else 2
            per_layer += mult * d * ff
        n += self.n_layers * per_layer
        if self.encdec:
            enc_per = 4 * d * self.n_heads * hd // max(self.n_heads, 1) * self.n_heads
            enc_per = 4 * d * d + (2 if self.act == "gelu" else 3) * d * ff
            n += self.enc_layers * enc_per
            n += self.n_layers * 4 * d * d                 # cross attention
        return n

    def active_param_count(self) -> int:
        """MoE: only top-k experts are active per token."""
        if not self.moe:
            return self.param_count()
        total = self.param_count()
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * self.d_model * self.expert_d_ff
        return total - inactive

    # -- reduced configs for CPU smoke tests ----------------------------------

    def reduced(self, **overrides) -> "ArchConfig":
        """Small same-family config: few layers, narrow width, tiny vocab."""
        small = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(self.n_heads, 1))),
            d_ff=0 if self.d_ff == 0 else 128,
            vocab=256,
            head_dim=16,
            remat=False,
            use_flash_kernel="never",
        )
        if self.attention == "mla":
            small.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8,
                         qk_rope_dim=8, v_head_dim=16)
        if self.moe:
            # ample capacity: token dropping depends on batch composition, so
            # reduced-config decode-vs-prefill equivalence needs no-drop routing
            small.update(n_experts=4, top_k=2, expert_d_ff=32,
                         moe_capacity_factor=8.0)
        if self.ssm:
            small.update(ssm_state=8, ssm_expand=2, ssm_conv=4)
        if self.hybrid_attn_every:
            small.update(n_layers=4, hybrid_attn_every=2)
        if self.encdec:
            small.update(enc_layers=2, max_source_positions=64)
        small.update(overrides)
        return dataclasses.replace(self, **small)


# -- input shape cells (assigned to every architecture) -----------------------


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_applicable(cfg: ArchConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell runs, with the skip reason.

    ``long_500k`` needs sub-quadratic attention — skipped for
    pure full-attention archs (noted in DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attn): long_500k requires sub-quadratic attention"
    return True, ""
