"""grok-1-314b [moe] — 8 experts, top-2 routing, every layer MoE.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072. [hf:xai-org/grok-1]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    source="hf:xai-org/grok-1",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab_size=131_072,
    ffn_type="gated_gelu",
    norm_type="rmsnorm",
    pos_type="rope",
    max_seq_len=8192,
    moe_num_experts=8,
    moe_top_k=2,
    moe_every=1,
)
