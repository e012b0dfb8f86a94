"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B.

48L d_model=2048 16H MHA (kv=16) head_dim=128, MoE 64 experts top-6 with
per-expert d_ff=1408, vocab=163840.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    mlp_type="swiglu",
    rope="full",
    causal=True,
    moe=MoEConfig(n_experts=64, top_k=6, expert_d_ff=1408),
)
