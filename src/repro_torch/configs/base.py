"""Model/shape configuration schema for the assigned architectures
(``repro.configs.base``'s twin: pure Python, kept as the port's own copy).

Every architecture is a ``ModelConfig``; every workload shape is a
``ShapeConfig``.  The serving engine runs an arch at its full width on
the card; the tests run the ``reduced()`` variant on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    experts_per_token: int = 0
    shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0   # leading layers with a dense FFN


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = full-rank queries
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    num_heads: int = 0            # mamba2 heads (0 = derive from d_inner/64)
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8          # 1 sLSTM block per `slstm_every` blocks
    chunk: int = 128
    proj_factor: float = 2.0      # mLSTM up-projection
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    attn_type: str = "gqa"        # gqa | mla | none
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    mrope_sections: Optional[tuple[int, ...]] = None   # qwen2-vl M-RoPE
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    attn_every: int = 0           # hybrid: attention layer period (zamba2)
    shared_attention: bool = False  # hybrid: one shared attention block
    num_codebooks: int = 0        # musicgen
    frontend: Optional[str] = None  # audio_stub | vision_stub
    vision_tokens: int = 0        # vlm: patch-embedding lanes in the input
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # memory / distribution knobs (tuned per cell by the launcher)
    remat: bool = True
    scan_layers: bool = True
    attn_chunk_q: int = 512       # chunked-attention block sizes (train)
    attn_chunk_kv: int = 1024

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model FLOPs)."""
        d, l = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.num_codebooks:
            emb = self.num_codebooks * self.vocab_size * d * 2
        per_layer = 0
        # attention
        if self.attn_type == "gqa":
            per_layer += d * self.num_heads * hd          # Wq
            per_layer += 2 * d * self.num_kv_heads * hd   # Wk, Wv
            per_layer += self.num_heads * hd * d          # Wo
        elif self.attn_type == "mla":
            m = self.mla
            qk = m.qk_rope_head_dim + m.qk_nope_head_dim
            per_layer += d * self.num_heads * qk          # Wq (full rank)
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.num_heads * (
                m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.num_heads * m.v_head_dim * d
        # ffn / moe / ssm
        if self.moe:
            e = self.moe
            dense = 3 * d * self.d_ff if self.d_ff else 0
            expert = 3 * d * e.d_ff_expert
            moe_layer = expert * (e.num_experts + e.shared_experts) + d * e.num_experts
            n_moe = l - e.first_dense_layers
            total_ffn = e.first_dense_layers * dense + n_moe * moe_layer
        elif self.d_ff:
            total_ffn = l * 3 * d * self.d_ff
        else:
            total_ffn = 0
        attn_layers = l
        if self.family == "ssm" and self.xlstm:
            attn_layers = 0
            di = int(d * self.xlstm.proj_factor)
            per_block = 2 * d * di + di * d + 4 * di  # up/gate/down + gates
            total_ffn = l * per_block
        if self.family == "hybrid" and self.ssm:
            s = self.ssm
            di = s.expand * d
            mamba = d * 2 * di + di * d + di * (2 * s.state_dim) + 3 * di
            n_attn = (l // max(self.attn_every, 1)) if self.attn_every else 0
            attn_params = per_layer * (1 if self.shared_attention else max(n_attn, 1))
            return emb + l * mamba + attn_params + total_ffn
        return emb + attn_layers * per_layer + total_ffn

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-to experts count)."""
        if not self.moe:
            return self.param_count()
        e = self.moe
        d = self.d_model
        total = self.param_count()
        all_experts = 3 * d * e.d_ff_expert * e.num_experts * (
            self.num_layers - e.first_dense_layers)
        active_experts = 3 * d * e.d_ff_expert * e.experts_per_token * (
            self.num_layers - e.first_dense_layers)
        return total - all_experts + active_experts


@dataclass(frozen=True)
class ShapeConfig:
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatch: Optional[int] = None   # per-step micro batch (train)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    small: dict = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32,
        sliding_window=64 if cfg.sliding_window else None,
        vision_tokens=8 if cfg.vision_tokens else 0,
        attn_chunk_q=64,
        attn_chunk_kv=64,
    )
    if cfg.moe:
        small["moe"] = replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 4),
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            d_ff_expert=128,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
        )
    if cfg.mla:
        small["mla"] = MLAConfig(
            kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=32,
            v_head_dim=32)
    if cfg.ssm:
        small["ssm"] = replace(cfg.ssm, state_dim=16, head_dim=16, chunk=32)
    if cfg.xlstm:
        small["xlstm"] = replace(cfg.xlstm, slstm_every=2, chunk=32)
    if cfg.attn_every:
        small["attn_every"] = 2
    small.update(overrides)
    return replace(cfg, **small)
