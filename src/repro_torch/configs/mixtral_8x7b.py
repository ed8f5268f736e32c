"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA-4096 [arXiv:2401.04088]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=32000,
    sliding_window=4096, rope_theta=1e6,
    moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff_expert=14336),
)
