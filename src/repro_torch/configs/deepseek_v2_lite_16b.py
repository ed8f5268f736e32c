"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408(expert)
vocab=102400, MLA kv_lora=512, 2 shared + 64 routed top-6, first layer
dense (d_ff 10944) [arXiv:2405.04434].

NOTE: the assignment line says both "MoE 64e top-6" and "160 routed";
64 routed matches the published V2-Lite — we use 64 and note the
discrepancy (160 is full V2)."""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400, attn_type="mla",
    mla=MLAConfig(kv_lora_rank=512, qk_rope_head_dim=64,
                  qk_nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=64, experts_per_token=6, shared_experts=2,
                  d_ff_expert=1408, first_dense_layers=1),
)
