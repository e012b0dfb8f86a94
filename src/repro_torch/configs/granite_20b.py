"""granite-20b [dense] — arXiv:2405.04324 (Granite Code 20B).

52L d_model=6144 48H (MQA kv=1) head_dim=128 d_ff=24576 vocab=49152.
d_ff = 4*d_model => classic GELU MLP; llama-style RoPE attention per assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",
    rope="full",
    causal=True,
)
