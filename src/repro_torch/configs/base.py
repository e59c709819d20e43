"""Base model configuration for all assigned architectures.

One frozen dataclass covers the six architecture families (dense / moe / ssm /
hybrid / vlm / audio).  Every field that a family does not use keeps its
neutral default, so a single model-builder (`repro.models.model`) can branch on
the populated fields instead of on per-family subclasses.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------------
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                    # citation bracket from the assignment

    # transformer backbone ----------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # flavour ------------------------------------------------------------------
    ffn_type: str = "gated_silu"        # gated_silu | gated_gelu | gelu | relu | relu2
    norm_type: str = "rmsnorm"          # rmsnorm | layernorm
    pos_type: str = "rope"              # rope | mrope | learned | none
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    tie_embeddings: bool = True
    max_seq_len: int = 131_072

    # sliding-window pattern (gemma3): `window_period` layers form one group,
    # the last layer of each group is global, the rest local with
    # `sliding_window` tokens.  0 disables the pattern (all layers global).
    window_period: int = 0
    sliding_window: int = 0

    # mixture-of-experts --------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1                  # MoE FFN every N layers (jamba: 2)
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01

    # state-space (mamba2 SSD) ---------------------------------------------------
    ssm_state_size: int = 0
    ssm_num_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 64

    # hybrid interleave (jamba): one attention layer per `attn_period` layers;
    # the remaining layers are SSD mixers.  0 means "pure" (all-attn or all-ssm).
    attn_period: int = 0

    # encoder-decoder (whisper) -----------------------------------------------
    is_encoder_decoder: bool = False
    enc_num_layers: int = 0
    enc_seq_len: int = 1500             # post-conv audio frames

    # modality frontend stub ------------------------------------------------------
    frontend: str = "none"              # none | audio_stub | vision_stub
    frontend_tokens: int = 0            # patch/frame embeddings prepended (vlm)

    dtype: str = "bfloat16"

    # ---------------------------------------------------------------- helpers
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm_num_heads == 0 and self.arch_type in ("ssm", "hybrid"):
            inner = self.ssm_expand * self.d_model
            object.__setattr__(self, "ssm_num_heads", inner // self.ssm_head_dim)

    @property
    def is_moe(self) -> bool:
        return self.moe_num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.attn_period > 1

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    # ---- layer pattern ------------------------------------------------------
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind: 'attn' | 'ssd'."""
        if self.arch_type == "ssm":
            return ("ssd",) * self.num_layers
        if self.is_hybrid:
            # one attention layer per period, placed mid-period (jamba puts it
            # at index 4 of 8; we use period//2 to match).
            kinds = []
            for i in range(self.num_layers):
                kinds.append("attn" if i % self.attn_period == self.attn_period // 2 else "ssd")
            return tuple(kinds)
        return ("attn",) * self.num_layers

    def layer_is_global(self) -> Tuple[bool, ...]:
        """True for full-context attention, False for sliding-window layers."""
        if self.window_period <= 0:
            return (True,) * self.num_layers
        return tuple((i + 1) % self.window_period == 0 for i in range(self.num_layers))

    def layer_is_moe(self) -> Tuple[bool, ...]:
        if not self.is_moe:
            return (False,) * self.num_layers
        return tuple(i % self.moe_every == (self.moe_every - 1) for i in range(self.num_layers))

    # ---- sizes ----------------------------------------------------------------
    def bytes_per_param(self) -> int:
        return 2 if self.dtype in ("bfloat16", "float16") else 4

    def num_params(self) -> int:
        """Analytic parameter count (embeddings + stacked layers)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        n = v * d                                     # embedding
        if not self.tie_embeddings:
            n += v * d
        gated = self.ffn_type.startswith("gated")
        ffn_dense = (3 if gated else 2) * d * f
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        ssd = 0
        if self.arch_type in ("ssm", "hybrid"):
            inner = self.ssm_inner
            # in/x+z proj, conv, dt/B/C proj, out proj (mamba2 fused layout)
            ssd = d * (2 * inner) + inner * self.ssm_conv_width \
                + d * (2 * self.ssm_state_size + self.ssm_num_heads) \
                + inner * d + 3 * self.ssm_num_heads
        for i, kind in enumerate(self.layer_kinds()):
            n += attn if kind == "attn" else ssd
            if f > 0:
                if self.layer_is_moe()[i]:
                    n += self.moe_num_experts * ffn_dense + d * self.moe_num_experts
                else:
                    n += ffn_dense
            n += 2 * d                                # two norms
        if self.is_encoder_decoder:
            enc_attn = 4 * d * d
            n += self.enc_num_layers * (enc_attn + ffn_dense + 2 * d)
            n += self.num_layers * (attn + d)         # cross-attention + norm
        return n

    def active_params(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if not self.is_moe:
            return self.num_params()
        d, f = self.d_model, self.d_ff
        gated = self.ffn_type.startswith("gated")
        ffn_dense = (3 if gated else 2) * d * f
        inactive = sum(
            (self.moe_num_experts - self.moe_top_k) * ffn_dense
            for i in range(self.num_layers) if self.layer_is_moe()[i]
        )
        return self.num_params() - inactive

    # S_ACT / S_KV per token per attention layer (paper Table 3 generalised)
    def act_bytes_per_token(self) -> int:
        return self.d_model * self.bytes_per_param()

    def kv_bytes_per_token(self) -> int:
        return 2 * self.kv_dim * self.bytes_per_param()


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=512, <=4 experts.

    Keeps the family structure (GQA ratio, window pattern, MoE, SSD interleave)
    while shrinking every dimension to CPU scale.
    """
    d_model = min(cfg.d_model, 256)
    head_dim = 32
    num_heads = max(2, min(cfg.num_heads, d_model // head_dim))
    # preserve the GQA ratio as closely as possible
    ratio = max(1, cfg.num_heads // max(1, cfg.num_kv_heads))
    num_kv_heads = max(1, num_heads // ratio)
    num_layers = 2
    if cfg.is_hybrid:
        num_layers = max(4, 2 * cfg.attn_period // 2)  # at least one attn + ssd mix
        num_layers = cfg.attn_period                    # one full period
    changes = dict(
        name=cfg.name + "-reduced",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        head_dim=head_dim,
        d_ff=0 if cfg.d_ff == 0 else min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        max_seq_len=4096,
        moe_num_experts=min(cfg.moe_num_experts, 4),
        moe_top_k=min(cfg.moe_top_k, 2),
        # ample capacity: no token drops at smoke scale, so incremental decode
        # is bit-comparable to the full forward in equivalence tests
        moe_capacity_factor=8.0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        window_period=min(cfg.window_period, 2) if cfg.window_period else 0,
        ssm_state_size=min(cfg.ssm_state_size, 32) if cfg.ssm_state_size else 0,
        ssm_head_dim=16 if cfg.ssm_state_size else cfg.ssm_head_dim,
        ssm_num_heads=0,                                # recomputed in __post_init__
        ssm_chunk=16 if cfg.ssm_state_size else cfg.ssm_chunk,
        enc_num_layers=2 if cfg.is_encoder_decoder else 0,
        enc_seq_len=32 if cfg.is_encoder_decoder else cfg.enc_seq_len,
        frontend_tokens=min(cfg.frontend_tokens, 16),
        dtype="float32",                                # exactness checks on CPU
    )
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
