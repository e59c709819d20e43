"""dbrx-132b [moe] — 16 fine-grained experts, top-4 routing.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352. [hf:databricks/dbrx-base]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10_752,
    vocab_size=100_352,
    ffn_type="gated_silu",
    norm_type="layernorm",
    pos_type="rope",
    rope_theta=500_000.0,
    max_seq_len=32_768,
    moe_num_experts=16,
    moe_top_k=4,
    moe_every=1,
)
