"""phi3.5-moe-42b-a6.6b [moe] — hf:microsoft/Phi-3.5-MoE-instruct.

32L d_model=4096 32H (GQA kv=8) head_dim=128, MoE 16 experts top-2 with
per-expert d_ff=6400, vocab=32064.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    mlp_type="swiglu",
    rope="full",
    causal=True,
    moe=MoEConfig(n_experts=16, top_k=2, expert_d_ff=6400),
)
