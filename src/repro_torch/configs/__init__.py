"""Configurations the port supports: the language-model architecture
registry (``--arch <id>`` resolves here) and the paper's rack
(``orbitcache_paper``)."""
from .base import SHAPES, ModelConfig, ShapeConfig, reduced  # noqa: F401

from .xlstm_1p3b import CONFIG as XLSTM_1P3B
from .mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from .deepseek_v2_lite_16b import CONFIG as DEEPSEEK_V2_LITE_16B
from .llama3_405b import CONFIG as LLAMA3_405B
from .mistral_large_123b import CONFIG as MISTRAL_LARGE_123B
from .qwen2_0p5b import CONFIG as QWEN2_0P5B
from .minitron_4b import CONFIG as MINITRON_4B
from .zamba2_7b import CONFIG as ZAMBA2_7B
from .musicgen_large import CONFIG as MUSICGEN_LARGE
from .qwen2_vl_7b import CONFIG as QWEN2_VL_7B

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        XLSTM_1P3B, MIXTRAL_8X7B, DEEPSEEK_V2_LITE_16B, LLAMA3_405B,
        MISTRAL_LARGE_123B, QWEN2_0P5B, MINITRON_4B, ZAMBA2_7B,
        MUSICGEN_LARGE, QWEN2_VL_7B,
    ]
}

# long_500k needs sub-quadratic attention: recurrent/SSM state or a sliding
# window.  Pure full-attention archs skip it.
LONG_CONTEXT_OK = {"xlstm-1.3b", "zamba2-7b", "mixtral-8x7b"}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
