"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE (sections 16/24/24), dynamic resolution
[arXiv:2409.12191].  Vision frontend = stub: input_specs provides
precomputed patch embeddings + 3D M-RoPE positions."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    head_dim=128, d_ff=18944, vocab_size=152064,
    mrope_sections=(16, 24, 24), frontend="vision_stub",
    vision_tokens=256, rope_theta=1e6,
)
