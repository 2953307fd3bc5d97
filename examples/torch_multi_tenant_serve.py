"""End-to-end example on the PyTorch port: multi-tenant collaborative
serving with batched requests through the real execution engine.

Three co-located CNNs (combined footprint >> the modeled 8 MB SRAM) are
planned by SwapLess, then real inference requests flow through the global
accelerator worker + per-model CPU pools: each model's prefix runs on
``--device`` (on the GPU its pointwise convolutions go through the
hand-written ``block_matmul`` kernel), its suffix on host thread pools.
The analytic model, the simulator and the real engine all run on the same
plan; the plan and predictions are the host's float64 paths (the JAX
package's example prints the same ones).

    PYTHONPATH=src python examples/torch_multi_tenant_serve.py              # on the GPU
    PYTHONPATH=src python examples/torch_multi_tenant_serve.py --device cpu --requests 2
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.paper_models import paper_profile
from repro_torch.core import latency
from repro_torch.core.allocator import edge_tpu_compiler_plan, swapless_plan
from repro_torch.core.planner import TenantSpec
from repro_torch.device import resolve_device
from repro_torch.hw.specs import EDGE_TPU_PLATFORM
from repro_torch.launch.serve import disable_tf32
from repro_torch.models.cnn import PAPER_CNN_SPECS, build_executable
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.simulator import simulate
from repro_torch.serving.workload import poisson_trace

NAMES = ["densenet201", "resnet50v2", "gpunet"]
RATES = [1.2, 1.2, 2.0]
K_MAX = 4


def main(argv=None):
    """Returns the completed requests of the real engine."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the prefixes run: cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8, help="real requests per model")
    ap.add_argument("--duration", type=float, default=1500.0, help="seconds of simulated traffic")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()

    hw = EDGE_TPU_PLATFORM
    tenants = [TenantSpec(paper_profile(n), r) for n, r in zip(NAMES, RATES)]

    plan = swapless_plan(tenants, hw, K_MAX)
    base = edge_tpu_compiler_plan(tenants)
    pred = latency.predict(tenants, plan, hw)
    print("plan:", dict(zip(NAMES, zip(plan.partition, plan.cores))))
    print("alphas:", [f"{a:.2f}" for a in pred.alphas])

    reqs = poisson_trace(RATES, duration=args.duration, seed=1)
    sim = simulate(tenants, plan, hw, reqs, backend="torch", device=device)
    simb = simulate(tenants, base, hw, reqs, backend="torch", device=device)
    print(
        f"DES mean latency: swapless {sim.overall_mean()*1e3:.1f} ms vs "
        f"compiler {simb.overall_mean()*1e3:.1f} ms "
        f"(-{100*(1 - sim.overall_mean()/simb.overall_mean()):.1f}%)"
    )

    # Batched requests through the real engine.
    models = [build_executable(PAPER_CNN_SPECS[n], seed=i, device=device) for i, n in enumerate(NAMES)]
    eng = ServingEngine(models, plan, k_max=K_MAX, device=device)
    try:
        for i, m in enumerate(models):
            for s in range(args.requests):
                eng.submit(i, m.make_input(s))
        done = eng.drain(timeout=180.0)
        print(f"real engine: {len(done)}/{len(NAMES)*args.requests} requests completed")
        for i, n in enumerate(NAMES):
            outs = [c for c in done if c.model_idx == i]
            ok = all(c.error is None and bool(torch.isfinite(c.output).all()) for c in outs)
            ms = np.array([c.latency for c in outs] or [0.0]) * 1e3
            print(f"  {n:<14} n={len(outs)} outputs_finite={ok} "
                  f"mean={ms.mean():.2f}ms p95={np.percentile(ms, 95):.2f}ms")
    finally:
        eng.shutdown()
    return done


if __name__ == "__main__":
    main()
