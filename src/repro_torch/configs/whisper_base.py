"""whisper-base [audio] — enc-dec transformer, conv frontend stubbed.

6L d_model=512 8H (MHA, kv=8) d_ff=2048 vocab=51865.  [arXiv:2212.04356]
The mel-spectrogram + conv feature extractor is a STUB: input_specs() feeds
precomputed frame embeddings of shape (batch, enc_seq_len, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    source="arXiv:2212.04356",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    ffn_type="gelu",
    norm_type="layernorm",
    pos_type="learned",
    tie_embeddings=True,
    max_seq_len=32_768,          # config-scaled positions for the shape runs
    is_encoder_decoder=True,
    enc_num_layers=6,
    enc_seq_len=1500,
    frontend="audio_stub",
)
