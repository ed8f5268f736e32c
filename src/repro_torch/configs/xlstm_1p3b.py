"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks [arXiv:2405.04517].  Recurrent state => long_500k runnable."""
from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, attn_type="none",
    xlstm=XLSTMConfig(slstm_every=8, chunk=128, proj_factor=2.0),
)
