"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality) stack.

64L d_model=2560 d_ff=0 vocab=50280 ssm_state=128. [arXiv:2405.21060]
No KV cache exists; the per-request state is O(1) (conv tail + SSD state), so
the paper's hybrid KV/ACT caching is inapplicable (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    source="arXiv:2405.21060",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                      # no FFN — SSD mixer only, like the reference stack
    vocab_size=50_280,
    ffn_type="gelu",
    norm_type="rmsnorm",
    pos_type="none",
    max_seq_len=1_048_576,
    ssm_state_size=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
)
