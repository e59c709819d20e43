"""minitron-4b [dense] — pruned nemotron (squared-ReLU FFN, no gating).

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000. [arXiv:2407.14679]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    source="arXiv:2407.14679",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256_000,
    ffn_type="relu2",
    norm_type="layernorm",
    pos_type="rope",
    tie_embeddings=False,
    max_seq_len=4096,
)
