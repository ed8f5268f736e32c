"""Batched serving engine: prefill + decode with KV caches (port of
``repro.serving.engine``).

``serve_step`` (one token for the whole batch against a KV cache) is the
decode cell.  The engine adds greedy / temperature sampling and
per-sequence stop handling.  It runs on the CUDA card unless it is given
``device="cpu"``; without a card it raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import model as model_mod


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 1024
    temperature: float = 0.0      # 0 = greedy
    eos_token: int = 1
    seed: int = 0                 # seeds the sampling generator


class ServeEngine:
    """Serves ``model`` (a ``models.Model`` of ``cfg``), moved to
    ``device`` (the CUDA card unless ``"cpu"`` is given)."""

    def __init__(self, cfg: ModelConfig, model, scfg: ServeConfig,
                 device=None):
        self.device = resolve_device(device)
        self.cfg, self.scfg = cfg, scfg
        self.model = model.to(self.device)

    # -- prefill: replay the prompt through the decode step ------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor):
        """tokens [B, S] -> (decode_state, last_logits).

        The decode cache is seeded by replaying the prompt through
        ``decode_step``, as the reference does, so the caches are the
        reference's."""
        tokens = tokens.to(self.device)
        b, s = tokens.shape
        state = model_mod.init_decode_state(self.cfg, b, self.scfg.max_seq,
                                            device=self.device)
        logits = None
        for t in range(s):
            logits, state = model_mod.decode_step(
                self.model, state, {"tokens": tokens[:, t: t + 1]}, self.cfg)
        return state, logits

    def _sample(self, logits: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
        """Greedy: the first maximum.  Temperature: Gumbel-max over
        ``logits / temperature``, with exponential draws from ``gen``."""
        lg = logits[:, -1].float()
        if self.scfg.temperature <= 0:
            return torch.argmax(lg, dim=-1).to(torch.int32)
        e = torch.empty_like(lg).exponential_(generator=gen)
        return torch.argmax(lg / self.scfg.temperature - torch.log(e),
                            dim=-1).to(torch.int32)

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, max_new: int) -> torch.Tensor:
        """Greedy/temperature generation.  prompts [B, S] -> int32
        [B, max_new]; after a sequence's ``eos_token`` its lanes hold
        ``eos_token``."""
        state, logits = self.prefill(prompts)
        gen = torch.Generator(device=self.device).manual_seed(self.scfg.seed)
        toks = []
        done = torch.zeros((prompts.shape[0],), dtype=torch.bool,
                           device=self.device)
        nxt = self._sample(logits, gen)
        for _ in range(max_new):
            toks.append(torch.where(done, self.scfg.eos_token, nxt))
            done = done | (nxt == self.scfg.eos_token)
            logits, state = model_mod.decode_step(
                self.model, state, {"tokens": nxt[:, None]}, self.cfg)
            nxt = self._sample(logits, gen)
        return torch.stack(toks, dim=1)


def make_serve_step(cfg: ModelConfig):
    """The decode cell: one token against a deep KV cache."""
    def serve_step(model, state, batch):
        return model_mod.decode_step(model, state, batch, cfg)
    return serve_step
