"""gemma3-27b [dense] — 5:1 local:global sliding-window attention, 128k ctx.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144. [hf:google/gemma-3-1b-pt]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    ffn_type="gated_gelu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=1_000_000.0,
    qk_norm=True,
    max_seq_len=131_072,
    window_period=6,             # 5 local : 1 global
    sliding_window=1024,
)
