"""hubert-xlarge [audio] — arXiv:2106.07447.

Encoder-only (bidirectional) transformer backbone, same arch as wav2vec2:
48L d_model=1280 16H (MHA kv=16) head_dim=80 d_ff=5120 vocab=504 (targets).
The conv feature-extractor frontend is a STUB: input_specs() provides
precomputed frame embeddings (batch, frames, d_model).  No decode shapes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    mlp_type="gelu",
    rope="none",
    causal=False,
    frontend="frames",
)
