"""yi-6b [dense] — llama-architecture GQA decoder.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000. [arXiv:2403.04652]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    arch_type="dense",
    source="arXiv:2403.04652",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11_008,
    vocab_size=64_000,
    ffn_type="gated_silu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    max_seq_len=32_768,
)
