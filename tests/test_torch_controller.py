"""Parity of the port's online controller (``serving/controller.py``, with
``serving/forecast.py`` and ``core/plan_cache.py``) with the reference's,
on the Fig. 8 trace (mnasnet + inceptionv4, rates (5,1) -> (5,3) -> (5,5)).

With the host stepper every re-plan, plan, objective and latency equals the
reference's (``==``), under each opt-in extension; with ``backend="torch"``
the re-plans are identical and the latencies agree within 2e-6 s.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.paper_models import paper_profile as ref_paper_profile
from repro.core.objective import p_tail as ref_p_tail
from repro.core.plan_cache import PlanCache as RefPlanCache
from repro.hw.specs import EDGE_TPU_PLATFORM as REF_HW
from repro.serving import controller as ref_controller
from repro.serving import faults as ref_faults
from repro.serving import forecast as ref_forecast
from repro.serving import workload as ref_workload
from repro_torch.configs.paper_models import paper_profile
from repro_torch.core.allocator import hill_climb
from repro_torch.core.objective import p_tail
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.torch_eval import TorchPlanEvaluator
from repro_torch.hw.specs import EDGE_TPU_PLATFORM as HW
from repro_torch.serving import faults, forecast, workload
from repro_torch.serving.controller import run_adaptive

NAMES = ("mnasnet", "inceptionv4")
PHASES = [(0.0, 300.0, (5.0, 1.0)), (300.0, 600.0, (5.0, 3.0)), (600.0, 900.0, (5.0, 5.0))]
KW = dict(replan_period=30.0, window=30.0, initial_rates=(5.0, 1.0))
K_MAX = HW.cpu.n_cores


def _fig8():
    """(reference profiles, reference trace, port profiles, port trace)."""
    ref_trace = ref_workload.dynamic_trace([ref_workload.RatePhase(*p) for p in PHASES], seed=5)
    trace = workload.dynamic_trace([workload.RatePhase(*p) for p in PHASES], seed=5)
    assert workload.trace_to_json(trace) == ref_workload.trace_to_json(ref_trace)
    return [ref_paper_profile(n) for n in NAMES], ref_trace, [paper_profile(n) for n in NAMES], trace


def _fault_schedules():
    def events(mod):
        return mod.FaultSchedule(
            events=(
                mod.FaultEvent(kind="dropout", device=0, start=100.0, end=130.0),
                mod.FaultEvent(kind="throttle", device=0, start=400.0, end=520.0, tpu_factor=0.4, cpu_factor=0.5),
                mod.FaultEvent(kind="swap_degrade", device=0, start=700.0, end=760.0, swap_factor=0.3),
            ),
            dropout_policy="requeue",
        )

    return events(ref_faults), events(faults)


def _plans(res):
    return [dataclasses.asdict(p) for p in res.plans]


def _assert_same_history(got, ref):
    assert got.replan_times == ref.replan_times
    assert _plans(got) == _plans(ref)
    assert got.plan_objectives == ref.plan_objectives
    assert got.cold_fallback_times == ref.cold_fallback_times
    assert got.degraded_replan_times == ref.degraded_replan_times


def _assert_equal_runs(got, ref):
    _assert_same_history(got, ref)
    for m in range(len(NAMES)):
        np.testing.assert_array_equal(np.asarray(got.sim.latencies[m]), np.asarray(ref.sim.latencies[m]))
        np.testing.assert_array_equal(np.asarray(got.sim.arrivals[m]), np.asarray(ref.sim.arrivals[m]))
    assert got.sim.misses == ref.sim.misses
    assert got.sim.tpu_busy == ref.sim.tpu_busy
    assert got.sim.duration == ref.sim.duration


@pytest.mark.parametrize("variant", ["defaults", "forecaster", "objective", "faults"])
def test_run_adaptive_equals_the_references(variant):
    ref_profs, ref_trace, profs, trace = _fig8()
    ref_kw, kw = dict(KW), dict(KW)
    if variant == "forecaster":
        ref_kw["forecaster"] = ref_forecast.EwmaTrendForecaster(len(NAMES))
        kw["forecaster"] = forecast.EwmaTrendForecaster(len(NAMES))
    elif variant == "objective":
        ref_kw["objective"], kw["objective"] = ref_p_tail(0.99), p_tail(0.99)
    elif variant == "faults":
        ref_kw["faults"], kw["faults"] = _fault_schedules()
        ref_kw["fault_aware"] = kw["fault_aware"] = True
    ref = ref_controller.run_adaptive(ref_profs, ref_trace, REF_HW, K_MAX, **ref_kw)
    got = run_adaptive(profs, trace, HW, K_MAX, **kw)
    _assert_equal_runs(got, ref)
    if variant == "faults":
        assert got.degraded_replan_times
        assert dataclasses.asdict(got.sim.fault) == dataclasses.asdict(ref.sim.fault)


def test_plan_cache_and_its_round_trip():
    ref_profs, ref_trace, profs, trace = _fig8()
    ref_cache, cache = RefPlanCache(), PlanCache()
    ref = ref_controller.run_adaptive(ref_profs, ref_trace, REF_HW, K_MAX, plan_cache=ref_cache, **KW)
    got = run_adaptive(profs, trace, HW, K_MAX, plan_cache=cache, **KW)
    _assert_equal_runs(got, ref)
    assert dataclasses.asdict(cache.stats) == dataclasses.asdict(ref_cache.stats)
    assert cache.stats.hits > 0
    payload = cache.persist()
    assert payload == ref_cache.persist()
    # A restored cache serves the same trace as the reference's does.
    restored, ref_restored = PlanCache(), RefPlanCache()
    assert restored.restore(payload) == ref_restored.restore(payload) == len(cache)
    again = run_adaptive(profs, trace, HW, K_MAX, plan_cache=restored, **KW)
    ref_again = ref_controller.run_adaptive(ref_profs, ref_trace, REF_HW, K_MAX, plan_cache=ref_restored, **KW)
    _assert_equal_runs(again, ref_again)
    assert restored.persist() == ref_restored.persist()
    assert restored.stats.hits > cache.stats.hits


def test_torch_backend_replans_identically():
    _, _, profs, trace = _fig8()
    want = run_adaptive(profs, trace, HW, K_MAX, **KW)
    got = run_adaptive(profs, trace, HW, K_MAX, backend="torch", device="cpu", **KW)
    _assert_same_history(got, want)
    for m in range(len(NAMES)):
        a = np.asarray(want.sim.latencies[m])
        b = np.asarray(got.sim.latencies[m])
        np.testing.assert_allclose(b, a, atol=2e-6, rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(got.sim.arrivals[m]), np.asarray(want.sim.arrivals[m]))
    assert got.sim.misses == want.sim.misses


def test_device_evaluator_planner_replans_identically():
    """The planner of the card run in ``chip_smoke.py``: ``hill_climb``
    scoring each frontier on the device evaluator."""
    _, _, profs, trace = _fig8()

    def planner(tenants, platform, k_max, *, tables=None, init_plan=None):
        ev = TorchPlanEvaluator.build(tenants, platform, k_max, tables=tables, device="cpu")
        return hill_climb(tenants, platform, k_max, evaluator=ev, init_plan=init_plan)

    want = run_adaptive(profs, trace, HW, K_MAX, **KW)
    got = run_adaptive(profs, trace, HW, K_MAX, planner=planner, **KW)
    assert got.replan_times == want.replan_times
    assert _plans(got) == _plans(want)
    np.testing.assert_allclose(got.plan_objectives, want.plan_objectives, rtol=1e-4)


def test_torch_backend_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    _, _, profs, trace = _fig8()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_adaptive(profs, trace, HW, K_MAX, backend="torch", **KW)
