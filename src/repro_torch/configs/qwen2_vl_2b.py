"""qwen2-vl-2b [vlm] — M-RoPE, dynamic-resolution ViT frontend stubbed.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. [arXiv:2409.12191]
The vision encoder + projector is a STUB: input_specs() feeds precomputed
patch embeddings (batch, frontend_tokens, d_model) interleaved before text.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    source="arXiv:2409.12191",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    ffn_type="gated_silu",
    norm_type="rmsnorm",
    pos_type="mrope",            # 3-section multimodal RoPE (t/h/w)
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
    frontend="vision_stub",
    frontend_tokens=256,         # patch embeddings prepended to the text tokens
)
