"""musicgen-large [audio]: 48L d_model=2048 32H d_ff=8192 vocab=2048 —
decoder-only over EnCodec tokens, 4 codebooks (delay pattern)
[arXiv:2306.05284].  Frontend = stub: input_specs provides precomputed
frame embeddings; decode feeds back 4 codebook ids per step."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=8192, vocab_size=2048,
    num_codebooks=4, frontend="audio_stub",
)
