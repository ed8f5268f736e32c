"""End-to-end LM training on the port (twin of ``examples/train_lm.py``):
a ~100M-parameter qwen2-family model for a few hundred steps on synthetic
Zipf-Markov data, on the CUDA card.

    PYTHONPATH=src python examples/train_lm_torch.py          # ~100M params
    PYTHONPATH=src python examples/train_lm_torch.py --tiny --device cpu
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.core.types import resolve_device  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    TrainConfig, make_train_step,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    base = get_arch("qwen2-0.5b")
    if args.tiny:
        cfg = reduced(base)
        seq, batch = 64, 8
    else:
        # ~100M-parameter variant of the qwen2 family
        cfg = dataclasses.replace(
            base, num_layers=8, d_model=512, num_heads=8, num_kv_heads=2,
            head_dim=64, d_ff=1536, vocab_size=32_000, tie_embeddings=True)
        seq, batch = 256, 16

    model = build_model(cfg, device=dev, seed=0)
    params = dict(model.named_parameters())
    n = sum(p.numel() for p in params.values())
    print(f"training {cfg.name}-variant on {dev}: {n/1e6:.1f}M params, "
          f"{batch * seq} tokens/step, {args.steps} steps")

    tc = TrainConfig(microbatches=2, opt=AdamWConfig(
        lr=3e-3, warmup_steps=20, total_steps=args.steps))
    step = make_train_step(cfg, tc)
    opt = adamw_init(params, tc.opt)
    ds = SyntheticStream(DataConfig(cfg.vocab_size, seq, batch), device=dev)

    t0, first = time.time(), None
    for i in range(args.steps):
        opt, mt = step(model, opt, ds.batch(i))
        loss = float(mt["loss"])
        first = first or loss
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={loss:.4f} lr={float(mt['lr']):.2e}")
    print(f"loss {first:.3f} -> {loss:.3f} in {time.time()-t0:.0f}s")
    if not loss < first:
        raise SystemExit("training failed to reduce loss")
    return first, loss


if __name__ == "__main__":
    main()
