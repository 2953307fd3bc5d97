"""Fleet serving on the PyTorch port: 8 tenants planned across a 4-device
heterogeneous fleet.

The two-level planner (``fleet_hill_climb``) places each tenant on a
device, hill-climbs every device's local partition/core plan, and the
fleet simulator replays one Poisson trace split across the devices.  The
same mix is also round-robin-placed for contrast, and the adaptive fleet
controller then runs a two-phase dynamic trace where a sustained rate
skew triggers a placement re-plan.  Placement and plans are the host's
float64 paths (the JAX package's example prints the same ones); the
simulators run as torch ops on ``--device``.

    PYTHONPATH=src python examples/torch_fleet_serve.py              # on the GPU
    PYTHONPATH=src python examples/torch_fleet_serve.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.paper_models import paper_profile
from repro_torch.core.fleet import DeviceSpec, fleet_hill_climb, round_robin_fleet_plan
from repro_torch.core.planner import TenantSpec
from repro_torch.device import resolve_device
from repro_torch.serving.fleet import run_adaptive_fleet, simulate_fleet
from repro_torch.serving.workload import RatePhase, dynamic_trace, poisson_trace


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the simulators run: cuda (default) or cpu")
    ap.add_argument("--duration", type=float, default=200.0, help="seconds of the static Poisson trace")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # Four device classes: an overclocked full-spec box, the reference
    # 8 MB Edge TPU, and two cut-down devices (less SRAM, slower swap
    # path, fewer host cores, slower accelerator/CPU).
    fleet = [
        DeviceSpec("fast", 8 << 20, 400e6, 4, tpu_speed=1.2),
        DeviceSpec("ref", 8 << 20, 400e6, 4),
        DeviceSpec("small", 4 << 20, 200e6, 2, tpu_speed=0.6, cpu_speed=0.7),
        DeviceSpec("tiny", 2 << 20, 100e6, 2, tpu_speed=0.4, cpu_speed=0.5),
    ]
    names = [
        "squeezenet", "mobilenetv2", "efficientnet", "mnasnet",
        "gpunet", "densenet201", "resnet50v2", "xception",
    ]
    tenants = [TenantSpec(paper_profile(n), 2.0 + 0.5 * i) for i, n in enumerate(names)]
    rates = [t.rate for t in tenants]

    fleet_plan, _ = fleet_hill_climb(tenants, fleet)
    rr_plan, _ = round_robin_fleet_plan(tenants, fleet)
    print("placement (planned):")
    for i in range(len(tenants)):
        d = fleet_plan.placement[i][0]
        plan = fleet_plan.device_plans[d]
        print(f"  {names[i]:>13} -> {fleet[d].name:<5} "
              f"p={plan.partition[i]} cores={plan.cores[i]}")

    trace = poisson_trace(rates, args.duration, seed=5)
    res = simulate_fleet(tenants, fleet_plan, fleet, trace, backend="torch", device=device)
    res_rr = simulate_fleet(tenants, rr_plan, fleet, trace, backend="torch", device=device)
    mean = res.request_weighted_mean(rates)
    mean_rr = res_rr.request_weighted_mean(rates)
    print(f"planned placement:     mean latency {mean*1e3:7.1f} ms "
          f"(per-TPU util {res.tpu_utilization:.2f})")
    print(f"round-robin placement: mean latency {mean_rr*1e3:7.1f} ms "
          f"(per-TPU util {res_rr.tpu_utilization:.2f})")
    print(f"placement win: {100*(1 - mean/mean_rr):.1f}% lower mean latency")

    # Dynamic phase: traffic migrates onto the two heaviest models; the
    # controller's warm re-plans absorb small drift, and the sustained
    # offered-load skew trips the placement re-plan gate.
    base = tuple(1.0 for _ in tenants)
    skew = tuple(8.0 if i >= 6 else 0.3 for i in range(len(tenants)))
    dyn = dynamic_trace([RatePhase(0.0, 80.0, base), RatePhase(80.0, 240.0, skew)], seed=13)
    ares = run_adaptive_fleet(
        [t.profile for t in tenants], dyn, fleet,
        replan_period=20.0, imbalance_threshold=0.15, imbalance_patience=2,
        backend="torch", device=device,
    )
    print(f"adaptive fleet: {len(ares.replan_times)} re-plan boundaries, "
          f"placement re-planned at t={ares.placement_replan_times}, "
          f"mean latency {ares.sim.overall_mean()*1e3:.1f} ms")


if __name__ == "__main__":
    main()
