"""Multi-tenant serving launcher -- the paper's technique on one GPU.

Port of the JAX package's ``launch/serve.py``.  The SwapLess planner
(analytic queueing model + hill-climbing) picks each model's accelerator
prefix / host suffix split and host core allocation, and the calibrated
model of the paper's Edge TPU testbed predicts and simulates the latency
the plan would see there.  Requests then flow through the real execution
engine: prefixes on the GPU (the pointwise convolutions through the
hand-written ``block_matmul`` kernel), suffixes on host thread pools.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --models inceptionv4,mnasnet --rates 2.0,5.0 --duration 30
"""
from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.paper_models import paper_profile
from repro_torch.core import latency
from repro_torch.core.allocator import (
    edge_tpu_compiler_plan,
    swapless_plan,
)
from repro_torch.core.planner import Plan, TenantSpec
from repro_torch.device import resolve_device
from repro_torch.hw.specs import EDGE_TPU_PLATFORM
from repro_torch.models.cnn import PAPER_CNN_SPECS, build_executable
from repro_torch.serving.engine import (
    CompletedRequest,
    ExecutableModel,
    ServingEngine,
)
from repro_torch.serving.simulator import simulate
from repro_torch.serving.workload import poisson_trace


def disable_tf32() -> None:
    """Full float32 for matrix products and cuDNN convolutions: cuDNN would
    otherwise run float32 convolutions in TF32 (about three digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run_requests(
    models: Sequence[ExecutableModel],
    plan: Plan,
    k_max: int,
    requests: int,
    device: torch.device,
) -> list[CompletedRequest]:
    """Submit ``requests`` inputs (seeds 0..requests-1) per model through a
    ``ServingEngine`` under ``plan`` and return the completed records."""
    eng = ServingEngine(models, plan, k_max=k_max, device=device)
    try:
        for i, m in enumerate(models):
            for s in range(requests):
                eng.submit(i, m.make_input(s))
        return eng.drain(timeout=120.0)
    finally:
        eng.shutdown()


def report_latencies(names: Sequence[str], done: Sequence[CompletedRequest]) -> None:
    by_model: dict[int, list[float]] = {}
    for c in done:
        by_model.setdefault(c.model_idx, []).append(c.latency)
    print(f"real execution: {len(done)} requests completed")
    for i, name in enumerate(names):
        ls = np.array(by_model.get(i, [0.0]))
        print(
            f"  {name:<14} n={len(ls)} mean={ls.mean()*1e3:.2f}ms "
            f"p95={np.percentile(ls, 95)*1e3:.2f}ms"
        )


def main(argv: Sequence[str] | None = None) -> tuple[Plan, list[CompletedRequest]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="inceptionv4,mnasnet")
    ap.add_argument("--rates", default="2.0,5.0")
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--requests", type=int, default=20,
                    help="real-execution requests per model")
    ap.add_argument("--k-max", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="device of the real-execution prefixes (cuda or cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    disable_tf32()
    names = args.models.split(",")
    rates = [float(r) for r in args.rates.split(",")]
    hw = EDGE_TPU_PLATFORM
    tenants = [TenantSpec(paper_profile(n), r) for n, r in zip(names, rates)]

    # --- plan (for the modeled Edge TPU testbed) -----------------------------
    plan = swapless_plan(tenants, hw, args.k_max)
    baseline = edge_tpu_compiler_plan(tenants)
    pred = latency.predict(tenants, plan, hw)
    pred_base = latency.predict(tenants, baseline, hw)
    print("SwapLess plan:")
    for t, p, k, a in zip(tenants, plan.partition, plan.cores, pred.alphas):
        P = t.profile.num_partition_points
        print(
            f"  {t.profile.name:<14} prefix={p}/{P} cores={k} alpha={a:.2f} "
            f"predicted={pred.latencies[names.index(t.profile.name)]*1e3:.1f}ms"
        )
    print(
        f"predicted mean latency: swapless={pred.mean_latency(tenants)*1e3:.1f}ms "
        f"vs compiler={pred_base.mean_latency(tenants)*1e3:.1f}ms"
    )

    # --- stepper simulation over the full duration ---------------------------
    reqs = poisson_trace(rates, args.duration, seed=0)
    sim = simulate(tenants, plan, hw, reqs)
    sim_base = simulate(tenants, baseline, hw, reqs)
    print(
        f"simulated mean latency ({len(reqs)} requests): "
        f"swapless={sim.overall_mean()*1e3:.1f}ms "
        f"compiler={sim_base.overall_mean()*1e3:.1f}ms "
        f"(-{100*(1-sim.overall_mean()/max(sim_base.overall_mean(),1e-12)):.1f}%)"
    )

    # --- real execution: GPU prefixes, host suffixes --------------------------
    models = [
        build_executable(PAPER_CNN_SPECS[n], seed=i, device=device)
        for i, n in enumerate(names)
    ]
    done = run_requests(models, plan, args.k_max, args.requests, device)
    report_latencies(names, done)
    return plan, done


if __name__ == "__main__":
    main()
