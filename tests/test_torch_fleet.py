"""Parity of the port's fleet layers (``core/fleet.py``,
``serving/fleet.py``): the N=1 fleet is the single device bitwise, and a
two-device fleet plans, simulates and adapts exactly as the reference's."""
import dataclasses

import numpy as np
import pytest

from repro.configs.paper_models import paper_profile as ref_paper_profile
from repro.core import fleet as ref_fleet
from repro.core.planner import TenantSpec as RefTenantSpec
from repro.serving import fleet as ref_serving_fleet
from repro.serving import workload as ref_workload
from repro_torch.configs.paper_models import paper_profile
from repro_torch.core import fleet as core_fleet
from repro_torch.core.allocator import hill_climb
from repro_torch.core.fleet import DeviceSpec, FleetTablesCache, fleet_hill_climb, round_robin_fleet_plan
from repro_torch.core.planner import TenantSpec
from repro_torch.hw.specs import EDGE_TPU_PLATFORM as HW
from repro_torch.serving import workload
from repro_torch.serving.controller import run_adaptive
from repro_torch.serving.fleet import offered_device_loads, run_adaptive_fleet, simulate_fleet
from repro_torch.serving.simulator import simulate

# The reference's N=1 pins hold on its three-tenant small mix
# (tests/test_fleet.py::small_mix); the two-device cases add a fourth tenant.
SMALL_MIX = (("squeezenet", 4.0), ("mobilenetv2", 3.0), ("mnasnet", 2.0))
MIX = SMALL_MIX + (("inceptionv4", 1.5),)
PHASES = [(0.0, 60.0, (4.0, 1.0, 1.0, 0.5)), (60.0, 120.0, (1.0, 1.0, 4.0, 2.0))]


def _tenants(mix=MIX):
    return (
        [RefTenantSpec(ref_paper_profile(n), r) for n, r in mix],
        [TenantSpec(paper_profile(n), r) for n, r in mix],
    )


def _two_devices(mod):
    return [
        mod.DeviceSpec("fast", 8 << 20, 400e6, 4, tpu_speed=1.2),
        mod.DeviceSpec("small", 4 << 20, 200e6, 2, tpu_speed=0.6, cpu_speed=0.7),
    ]


def _sim_fields(res):
    out = {}
    for f in ("latencies", "arrivals"):
        out[f] = [np.asarray(x, dtype=np.float64).tolist() for x in getattr(res, f)]
    for f in ("tpu_busy", "duration", "misses", "tpu_requests"):
        out[f] = getattr(res, f)
    return out


def _fleet_plan(fp):
    return dataclasses.asdict(fp)


@pytest.mark.parametrize("backend", ["stepper", "des", "torch"])
def test_single_device_fleet_is_the_single_device(backend):
    _, ts = _tenants(SMALL_MIX)
    dev = DeviceSpec.from_platform(HW, cpu_cores=len(ts))
    fp, fobj = fleet_hill_climb(ts, [dev])
    plan, obj = hill_climb(ts, HW, len(ts))
    assert fp.device_plans[0] == plan and fobj == obj
    trace = workload.poisson_trace([t.rate for t in ts], 60.0, seed=3)
    want = simulate(ts, plan, HW, trace, backend=backend, device="cpu")
    got = simulate_fleet(ts, fp, [dev], trace, backend=backend, device="cpu")
    assert _sim_fields(got) == _sim_fields(want)


def test_single_device_adaptive_fleet_replays_the_controller():
    _, ts = _tenants(SMALL_MIX)
    profiles = [t.profile for t in ts]
    phases = [(0.0, 60.0, (4.0, 1.0, 1.0)), (60.0, 120.0, (1.0, 1.0, 4.0))]
    trace = workload.dynamic_trace([workload.RatePhase(*p) for p in phases], seed=11)
    want = run_adaptive(profiles, trace, HW, len(ts), replan_period=20.0, cold_fallback_margin=None)
    got = run_adaptive_fleet(profiles, trace, [DeviceSpec.from_platform(HW, cpu_cores=len(ts))], replan_period=20.0)
    assert got.replan_times == want.replan_times
    assert [fp.device_plans[0] for fp in got.fleet_plans] == want.plans
    assert _sim_fields(got.sim) == _sim_fields(want.sim)


def test_two_device_planner_equals_the_references():
    ref_ts, ts = _tenants()
    fleet, ref_devs = _two_devices(core_fleet), _two_devices(ref_fleet)
    fp, obj = fleet_hill_climb(ts, fleet, tables=FleetTablesCache())
    ref_fp, ref_obj = ref_fleet.fleet_hill_climb(ref_ts, ref_devs, tables=ref_fleet.FleetTablesCache())
    assert _fleet_plan(fp) == _fleet_plan(ref_fp) and obj == ref_obj
    rr, rr_obj = round_robin_fleet_plan(ts, fleet)
    ref_rr, ref_rr_obj = ref_fleet.round_robin_fleet_plan(ref_ts, ref_devs)
    assert _fleet_plan(rr) == _fleet_plan(ref_rr) and rr_obj == ref_rr_obj
    drifted = [TenantSpec(t.profile, t.rate * 1.3) for t in ts]
    ref_drifted = [RefTenantSpec(t.profile, t.rate * 1.3) for t in ref_ts]
    warm, warm_obj = fleet_hill_climb(drifted, fleet, init=fp)
    ref_warm, ref_warm_obj = ref_fleet.fleet_hill_climb(ref_drifted, ref_devs, init=ref_fp)
    assert _fleet_plan(warm) == _fleet_plan(ref_warm) and warm_obj == ref_warm_obj
    rates = [t.rate for t in drifted]
    assert offered_device_loads(ts, fp, fleet, rates) == ref_serving_fleet.offered_device_loads(
        ref_ts, ref_fp, ref_devs, rates
    )


@pytest.mark.parametrize("backend", ["stepper", "des"])
def test_two_device_simulate_fleet_equals_the_references(backend):
    ref_ts, ts = _tenants()
    fleet, ref_devs = _two_devices(core_fleet), _two_devices(ref_fleet)
    fp, _ = fleet_hill_climb(ts, fleet)
    ref_fp, _ = ref_fleet.fleet_hill_climb(ref_ts, ref_devs)
    rates = [t.rate for t in ts]
    got = simulate_fleet(ts, fp, fleet, workload.poisson_trace(rates, 90.0, seed=4), backend=backend)
    ref = ref_serving_fleet.simulate_fleet(
        ref_ts, ref_fp, ref_devs, ref_workload.poisson_trace(rates, 90.0, seed=4), backend=backend
    )
    assert _sim_fields(got) == _sim_fields(ref)
    assert [_sim_fields(r) for r in got.per_device] == [_sim_fields(r) for r in ref.per_device]


def test_two_device_adaptive_fleet_equals_the_references():
    ref_ts, ts = _tenants()
    fleet, ref_devs = _two_devices(core_fleet), _two_devices(ref_fleet)
    trace = workload.dynamic_trace([workload.RatePhase(*p) for p in PHASES], seed=11)
    ref_trace = ref_workload.dynamic_trace([ref_workload.RatePhase(*p) for p in PHASES], seed=11)
    kw = dict(replan_period=20.0, imbalance_patience=2, cold_fallback_margin=0.05)
    got = run_adaptive_fleet([t.profile for t in ts], trace, fleet, **kw)
    ref = ref_serving_fleet.run_adaptive_fleet([t.profile for t in ref_ts], ref_trace, ref_devs, **kw)
    assert got.replan_times == ref.replan_times
    assert [_fleet_plan(p) for p in got.fleet_plans] == [_fleet_plan(p) for p in ref.fleet_plans]
    assert got.plan_objectives == ref.plan_objectives
    assert got.placement_replan_times == ref.placement_replan_times
    assert got.cold_fallback_times == ref.cold_fallback_times
    assert _sim_fields(got.sim) == _sim_fields(ref.sim)
    # The device stepper under the fleet: same re-plans, latencies in tolerance.
    dev = run_adaptive_fleet([t.profile for t in ts], trace, fleet, backend="torch", device="cpu", **kw)
    assert dev.replan_times == got.replan_times
    assert [_fleet_plan(p) for p in dev.fleet_plans] == [_fleet_plan(p) for p in got.fleet_plans]
    for m in range(len(ts)):
        np.testing.assert_allclose(
            np.sort(np.asarray(dev.sim.latencies[m])), np.sort(np.asarray(got.sim.latencies[m])), atol=2e-6, rtol=1e-5
        )
