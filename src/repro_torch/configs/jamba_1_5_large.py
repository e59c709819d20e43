"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE every 2 layers.
[arXiv:2403.19887]

Deviation note (DESIGN.md §4): Jamba uses Mamba-1 selective-scan mixers; we use
the Mamba-2 SSD mixer so the chunked-SSD Pallas kernel is shared with
mamba2-2.7b.  Interleave (one attention layer per 8) and the MoE-every-2
pattern follow the paper.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    source="arXiv:2403.19887",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    ffn_type="gated_silu",
    norm_type="rmsnorm",
    pos_type="none",             # jamba attention layers are NoPE
    max_seq_len=262_144,
    moe_num_experts=16,
    moe_top_k=2,
    moe_every=2,
    attn_period=8,               # 1 attention : 7 mamba
    ssm_state_size=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
)
