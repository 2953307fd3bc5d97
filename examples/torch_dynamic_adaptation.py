"""Dynamic workload adaptation on the PyTorch port (the paper's Fig. 8
scenario).

MnasNet + InceptionV4 under step-changing request rates; the online
controller re-estimates rates in a sliding window and re-plans every 30 s.
The plans are the host's float64 Algorithm 1 (the JAX package's example
prints the same plans); the simulation runs as torch ops on ``--device``.

    PYTHONPATH=src python examples/torch_dynamic_adaptation.py              # on the GPU
    PYTHONPATH=src python examples/torch_dynamic_adaptation.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.paper_models import paper_profile
from repro_torch.core.allocator import edge_tpu_compiler_plan
from repro_torch.core.planner import TenantSpec
from repro_torch.device import resolve_device
from repro_torch.hw.specs import EDGE_TPU_PLATFORM
from repro_torch.serving.controller import run_adaptive
from repro_torch.serving.simulator import simulate
from repro_torch.serving.workload import RatePhase, dynamic_trace


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the simulator runs: cuda (default) or cpu")
    ap.add_argument("--phase-seconds", type=float, default=300.0, help="length of each of the three rate phases")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    hw = EDGE_TPU_PLATFORM
    profiles = [paper_profile("mnasnet"), paper_profile("inceptionv4")]
    t = args.phase_seconds
    phases = [
        RatePhase(0.0, t, (5.0, 1.0)),
        RatePhase(t, 2 * t, (5.0, 3.0)),
        RatePhase(2 * t, 3 * t, (5.0, 5.0)),
    ]
    trace = dynamic_trace(phases, seed=0)
    res = run_adaptive(
        profiles, trace, hw, hw.cpu.n_cores,
        replan_period=30.0, window=30.0, initial_rates=(5.0, 1.0),
        backend="torch", device=device,
    )
    print(f"adaptive: mean latency {res.sim.overall_mean()*1e3:.1f} ms, "
          f"{len(res.plans)} plans, "
          f"max allocator time {max(res.plan_compute_seconds)*1e3:.2f} ms")
    seen = None
    for when, p in zip(res.replan_times, res.plans):
        if (p.partition, p.cores) != seen:
            print(f"  t={when:6.0f}s plan: partition={list(p.partition)} cores={list(p.cores)}")
            seen = (p.partition, p.cores)

    ts = [TenantSpec(p, 3.0) for p in profiles]
    static = simulate(ts, edge_tpu_compiler_plan(ts), hw, trace, backend="torch", device=device)
    print(f"static compiler baseline: {static.overall_mean()*1e3:.1f} ms "
          f"(adaptive is {100*(1-res.sim.overall_mean()/static.overall_mean()):.1f}% lower)")


if __name__ == "__main__":
    main()
