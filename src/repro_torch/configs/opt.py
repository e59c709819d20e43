"""OPT family — the paper's own evaluation models [arXiv:2205.01068].

MHA (kv = heads), learned positions, LayerNorm, ReLU FFN.  These are the
configs HybridServe's figures are reproduced on; the ACT:KV byte ratio is the
paper's canonical 1:2.
"""
from repro_torch.configs.base import ModelConfig


def _opt(name, layers, d_model, heads, max_seq=32_768):
    # (positions config-scaled beyond OPT's native 2048 so the paper's own
    # models also lower at the assigned decode_32k shape)
    return ModelConfig(
        name=name,
        arch_type="dense",
        source="arXiv:2205.01068",
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=d_model // heads,
        d_ff=4 * d_model,
        vocab_size=50_272,
        ffn_type="relu",
        norm_type="layernorm",
        pos_type="learned",
        tie_embeddings=True,
        max_seq_len=max_seq,
        dtype="float16",
    )


OPT_6_7B = _opt("opt-6.7b", 32, 4096, 32)
OPT_13B = _opt("opt-13b", 40, 5120, 40)
OPT_30B = _opt("opt-30b", 48, 7168, 56)
OPT_66B = _opt("opt-66b", 64, 9216, 72)

CONFIGS = {c.name: c for c in (OPT_6_7B, OPT_13B, OPT_30B, OPT_66B)}
