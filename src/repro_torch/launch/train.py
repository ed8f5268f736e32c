"""End-to-end training driver (port of ``repro.launch.train``).  On the
CUDA card by default:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 200 --seq 256 --batch 16 --ckpt <dir>

``--device cpu --reduced`` trains the reduced config on the CPU.  It
exercises deterministic data, the microbatched train step, the AdamW
schedule, atomic checkpoints with resume, and straggler stats.  Weights
are random (a ``torch.Generator`` seeded 0).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.core.types import resolve_device
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, SyntheticStream
from repro_torch.training.fault_tolerance import StragglerStats
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import TrainConfig, make_train_step


def main(argv=None):
    """Train; returns ``dict(start, losses, step_s, model, opt)``: the
    first step run (after a resume), each run step's loss and wall seconds
    (through the loss's read, which waits for the step), the model and the
    AdamW state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-sized smoke config")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg, device=dev, seed=0)
    tc = TrainConfig(
        microbatches=args.microbatches,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps),
    )
    step_fn = make_train_step(cfg, tc)
    ds = SyntheticStream(DataConfig(cfg.vocab_size, args.seq, args.batch),
                         device=dev)

    params = dict(model.named_parameters())
    opt = adamw_init(params, tc.opt)
    start = 0
    if args.ckpt:
        last = ckpt.latest(args.ckpt)
        if last is not None:
            state = ckpt.restore(args.ckpt, last,
                                 {"params": params, "opt": opt})
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(state["params"][k])
            opt = state["opt"]
            start = last + 1
            print(f"resumed from step {last}")

    n_params = sum(p.numel() for p in params.values())
    print(f"arch={cfg.name} device={dev} params={n_params/1e6:.1f}M "
          f"tokens/step={args.batch * args.seq}")
    stragglers = StragglerStats()
    losses, step_s = [], []
    for step in range(start, args.steps):
        t0 = time.time()
        batch = ds.batch(step)
        opt, mt = step_fn(model, opt, batch)
        losses.append(float(mt["loss"]))        # waits for the step
        dt = time.time() - t0
        step_s.append(dt)
        stragglers.update(dt)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(mt['grad_norm']):.3f} "
                  f"lr={float(mt['lr']):.2e} {dt*1e3:.0f}ms")
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt, step, {"params": params, "opt": opt})
    if args.ckpt:
        ckpt.save(args.ckpt, args.steps - 1, {"params": params, "opt": opt})
    print(f"done; stragglers={stragglers.count}")
    return dict(start=start, losses=losses, step_s=step_s, model=model,
                opt=opt)


if __name__ == "__main__":
    main()
