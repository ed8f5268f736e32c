"""Serving driver: batched generation with the decode engine (port of
``repro.launch.serve``).  On the CUDA card by default:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --batch 4 --prompt-len 16 --max-new 32

``--device cpu --reduced`` runs the reduced config on the CPU.  Weights
are random (a ``torch.Generator`` seeded 0) and so are the prompts
(numpy, seeded 1).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.core.types import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg, device=dev, seed=0)
    eng = ServeEngine(cfg, model, ServeConfig(
        max_batch=args.batch, max_seq=args.prompt_len + args.max_new + 8,
        temperature=args.temperature), device=dev)

    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        2, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)
    t0 = time.perf_counter()
    out = eng.generate(prompts, args.max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total = args.batch * args.max_new
    print(f"arch={cfg.name} device={dev} generated {tuple(out.shape)} in "
          f"{dt:.3f}s ({total / dt:.1f} tok/s)")
    print("sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
