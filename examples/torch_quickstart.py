"""Quickstart on the PyTorch port: SwapLess in 60 seconds.

Plans collaborative accelerator-CPU execution for a single memory-oversized
model (InceptionV4, 43.2 MB against the modeled Edge TPU's 8 MB SRAM),
compares it with the default Edge TPU compiler's plan, and checks the
analytic prediction against the simulator.  Planning and prediction are the
host's float64 paths (the JAX package's example prints the same plan and
predictions); the simulator's recurrences run as torch ops on ``--device``.

    PYTHONPATH=src python examples/torch_quickstart.py              # on the GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.paper_models import paper_profile
from repro_torch.core import latency
from repro_torch.core.allocator import edge_tpu_compiler_plan, hill_climb
from repro_torch.core.planner import TenantSpec
from repro_torch.device import resolve_device
from repro_torch.hw.specs import EDGE_TPU_PLATFORM
from repro_torch.serving.simulator import simulate
from repro_torch.serving.workload import poisson_trace


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the simulator runs: cuda (default) or cpu")
    ap.add_argument("--duration", type=float, default=1000.0, help="seconds of simulated traffic")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    hw = EDGE_TPU_PLATFORM
    rate = 4.0  # requests/s
    tenants = [TenantSpec(paper_profile("inceptionv4"), rate)]

    # Default: everything on the accelerator -> intra-model swapping every request.
    base = edge_tpu_compiler_plan(tenants)
    base_pred = latency.predict(tenants, base, hw)
    print(f"[compiler]  full-TPU      predicted {base_pred.latencies[0]*1e3:7.1f} ms")

    # SwapLess: Algorithm 1 picks the partition point + CPU cores.
    plan, _ = hill_climb(tenants, hw, hw.cpu.n_cores)
    pred = latency.predict(tenants, plan, hw)
    p = plan.partition[0]
    print(
        f"[swapless]  prefix={p}/11 cores={plan.cores[0]} "
        f"predicted {pred.latencies[0]*1e3:7.1f} ms "
        f"(-{100*(1-pred.latencies[0]/base_pred.latencies[0]):.1f}%)"
    )

    # Check against the simulator (the paper's testbed's stand-in).
    reqs = poisson_trace([rate], duration=args.duration, seed=0)
    for name, pl in [("compiler", base), ("swapless", plan)]:
        sim = simulate(tenants, pl, hw, reqs, backend="torch", device=device)
        print(f"[{name:>8s}]  simulated     observed {sim.mean_latency(0)*1e3:7.1f} ms")


if __name__ == "__main__":
    main()
