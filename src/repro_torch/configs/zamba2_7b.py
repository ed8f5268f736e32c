"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
mamba2 ssm_state=64 + shared attention(+MLP) block every 6 layers
[arXiv:2411.15242].  SSM backbone => long_500k runnable (the shared
attention keeps a KV cache; most layers are O(1))."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    head_dim=112, d_ff=14336, vocab_size=32000,
    attn_every=6, shared_attention=True,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk=128),
)
