"""zamba2-2.7b [hybrid] — arXiv:2411.15242.

54 Mamba2 layers (d_state=64) with a SHARED attention+MLP block applied every
6th layer (9 occurrences, weights shared), d_model=2560, 32H MHA (kv=32)
head_dim=80, d_ff=10240, vocab=32000.  The shared attention block uses a
4096-token sliding window so the long_500k decode path stays sub-quadratic
(design note in DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    mlp_type="gelu",
    rope="full",
    causal=True,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=128),
    attn_period=6,
    attn_window=4096,
)
