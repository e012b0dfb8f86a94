"""rwkv6-7b [ssm] — arXiv:2404.05892 (Finch).

32L d_model=4096, attention-free (WKV6 time-mix with data-dependent decay),
channel-mix d_ff=14336, vocab=65536, head_size=64 (64 heads).
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    arch="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # d_model / head_size
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    mlp_type="gelu",     # channel-mix uses squared-relu; field unused by ssm path
    rope="none",
    causal=True,
    rwkv=RWKVConfig(head_size=64),
)
