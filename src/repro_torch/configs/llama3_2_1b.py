"""llama3.2-1b [dense] — hf:meta-llama/Llama-3.2-1B.

16L d_model=2048 32H (GQA kv=8) head_dim=64 d_ff=8192 vocab=128256.
Also serves as the ~1B-class end-to-end training example (tied embeddings).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    mlp_type="swiglu",
    rope="full",
    causal=True,
    tie_embeddings=True,
)
