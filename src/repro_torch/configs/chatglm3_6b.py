"""chatglm3-6b [dense] — arXiv:2406.12793.

28L d_model=4096 32H (GQA kv=2) head_dim=128 d_ff=13696 vocab=65024.
"RoPE 2d": rotary embedding applied to half of each head dim (rope="half").
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    mlp_type="swiglu",
    rope="half",
    causal=True,
)
