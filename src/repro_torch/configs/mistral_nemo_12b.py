"""mistral-nemo-12b [dense] — hf:mistralai/Mistral-Nemo-Base-2407.

40L d_model=5120 32H (GQA kv=8) head_dim=128 d_ff=14336 vocab=131072, 128k ctx.
Nemo uses an explicit head_dim of 128 (q-proj 5120->4096).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    mlp_type="swiglu",
    rope="full",
    causal=True,
)
