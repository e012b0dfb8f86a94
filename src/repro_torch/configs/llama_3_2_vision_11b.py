"""llama-3.2-vision-11b [vlm] — hf:meta-llama/Llama-3.2-11B-Vision.

40L text backbone d_model=4096 32H (GQA kv=8) head_dim=128 d_ff=14336
vocab=128256, with a cross-attention image layer every 5th layer (8 of 40).
Vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (batch, n_media_tokens, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    mlp_type="swiglu",
    rope="full",
    causal=True,
    cross_attn_period=5,
    n_media_tokens=1600,
    frontend="tokens+patches",
)
