"""gemma3-1b [dense] — 5:1 local:global sliding window, MQA (kv=1), 128k ctx.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144. [hf:google/gemma-3-1b-pt]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    ffn_type="gated_gelu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=1_000_000.0,
    qk_norm=True,
    max_seq_len=131_072,
    window_period=6,
    sliding_window=512,
)
