"""Train a reduced-config model on the PyTorch port with the full training
substrate (AdamW + WSD schedule + microbatching + checkpointing + data
pipeline).

On the GPU, attention and its gradient run through the hand-written
``flash_attention`` forward and backward kernels.  The checkpoint is the
JAX package's file (its keys, shapes and values, layers stacked by group
position), read back and compared leaf by leaf.

    PYTHONPATH=src python examples/torch_train_small.py              # on the GPU
    PYTHONPATH=src python examples/torch_train_small.py --device cpu --steps 20
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import batches_for_arch
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.training.checkpoint import restore_params, save_params
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.schedule import wsd_schedule
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.training.tree import leaves_with_paths


def main(argv=None) -> list[float]:
    """Returns the loss of every step."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint path (default: a temporary directory, removed afterwards)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False      # float32 products in full float32

    cfg = get_arch("minicpm-2b").reduced()   # WSD is MiniCPM's signature
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3), n_microbatches=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.float32)
    opt = adamw_init(params, tcfg.optimizer)
    step_fn = make_train_step(cfg, tcfg)

    losses = []
    for step, batch in zip(range(args.steps), batches_for_arch(cfg, args.batch, args.seq, device=dev)):
        scale = wsd_schedule(step, total_steps=args.steps)
        params, opt, m = step_fn(params, opt, batch, scale)
        losses.append(float(m["loss"]))
        if step % 10 == 0:
            print(f"step {step:3d} loss {losses[-1]:.4f} lr x{float(scale):.3f}")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training must reduce loss"

    with tempfile.TemporaryDirectory() as tmp:
        path = args.checkpoint or os.path.join(tmp, "minicpm")
        save_params(path, cfg, params, {"arch": cfg.name})
        params2 = restore_params(path, cfg, params)
    for (name, a), (_, b) in zip(leaves_with_paths(params), leaves_with_paths(params2), strict=True):
        assert torch.equal(a, b), name
    print("checkpoint round-trip OK")
    return losses


if __name__ == "__main__":
    main()
