"""Training launcher.

Port of the JAX package's ``launch/train.py``: AdamW with WSD (minicpm) or
cosine, gradient-accumulation microbatches, synthetic data, float32
parameters, on the GPU unless ``--device cpu`` is given.  ``--checkpoint``
writes the reference's file: its keys, shapes and values, layers stacked by
group position (``training/checkpoint.py::save_params``).  Attention and its
gradient run through the hand-written ``flash_attention`` kernels on the
card, and rwkv6's time mix and its gradient through the ``wkv6`` kernels.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --reduced --steps 50 --batch 8 --seq 128 --log-every 10
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence

import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import batches_for_arch
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.training.checkpoint import save_params
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.schedule import cosine_schedule, wsd_schedule
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.training.tree import leaves_with_paths


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", choices=["wsd", "cosine"], default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    # MiniCPM trains with WSD (its signature contribution); others cosine.
    sched_name = args.schedule or ("wsd" if "minicpm" in cfg.name else "cosine")
    sched = wsd_schedule if sched_name == "wsd" else cosine_schedule

    tcfg = TrainConfig(optimizer=AdamWConfig(lr=args.lr), n_microbatches=args.microbatches)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev, dtype=torch.float32)
    opt_state = adamw_init(params, tcfg.optimizer)
    step_fn = make_train_step(cfg, tcfg)

    n_params = sum(p.numel() for _, p in leaves_with_paths(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M schedule={sched_name}")

    data = batches_for_arch(cfg, args.batch, args.seq, seed=args.seed, device=dev)
    t0 = time.time()
    first = last = None
    for step, batch in zip(range(args.steps), data):
        lr_scale = sched(step, total_steps=args.steps)
        params, opt_state, metrics = step_fn(params, opt_state, batch, lr_scale)
        loss = float(metrics["loss"])
        if first is None:
            first = loss
        last = loss
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(
                f"step {step:5d} loss {loss:8.4f} gnorm "
                f"{float(metrics['grad_norm']):8.3f} lr x{float(lr_scale):.3f} "
                f"({dt:.1f}s)"
            )
    print(f"loss: {first:.4f} -> {last:.4f}")
    if args.checkpoint:
        save_params(args.checkpoint, cfg, params, {"arch": cfg.name, "steps": args.steps})
        print(f"checkpoint saved to {args.checkpoint}")


if __name__ == "__main__":
    main()
