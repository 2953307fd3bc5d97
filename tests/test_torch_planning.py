"""Parity of the port's host-side planning and simulation with the JAX
package's: the port copies the float64 NumPy modules verbatim, so profiles,
plans, predictions and stepper means must be *identical*, not close."""
import dataclasses

import pytest

from repro.configs import paper_models as ref_paper_models
from repro.core import allocator as ref_allocator
from repro.core import latency as ref_latency
from repro.core.planner import TenantSpec as RefTenantSpec
from repro.hw import specs as ref_specs
from repro.serving import simulator as ref_simulator
from repro.serving import workload as ref_workload
from repro_torch.configs import paper_models
from repro_torch.core import allocator, latency
from repro_torch.core.planner import TenantSpec
from repro_torch.hw import specs
from repro_torch.serving import simulator, workload

# (names, rates, k_max): the serve default and two other paper mixes.
MIXES = [
    (("inceptionv4", "mnasnet"), (2.0, 5.0), 4),
    (("inceptionv4", "xception", "gpunet", "efficientnet"), (1.0, 0.5, 3.0, 2.0), 8),
    (
        ("inceptionv4", "xception", "densenet201", "mnasnet", "squeezenet"),
        (0.5, 0.5, 1.0, 2.0, 4.0),
        12,
    ),
]
MIX_IDS = ["serve-mix", "four-mix", "five-mix"]


def _tenants(names, rates):
    ref = [RefTenantSpec(ref_paper_models.paper_profile(n), r) for n, r in zip(names, rates)]
    port = [TenantSpec(paper_models.paper_profile(n), r) for n, r in zip(names, rates)]
    return ref, port


def test_platform_is_identical():
    assert dataclasses.asdict(specs.EDGE_TPU_PLATFORM) == dataclasses.asdict(
        ref_specs.EDGE_TPU_PLATFORM
    )


def test_profiles_are_identical():
    ref = ref_paper_models.all_paper_profiles()
    port = paper_models.all_paper_profiles()
    assert list(ref) == list(port)
    for name in ref:
        assert dataclasses.asdict(port[name]) == dataclasses.asdict(ref[name]), name


@pytest.mark.parametrize("names,rates,k_max", MIXES, ids=MIX_IDS)
def test_plans_are_identical(names, rates, k_max):
    ref_t, port_t = _tenants(names, rates)
    hw_ref, hw = ref_specs.EDGE_TPU_PLATFORM, specs.EDGE_TPU_PLATFORM
    assert dataclasses.asdict(allocator.swapless_plan(port_t, hw, k_max)) == (
        dataclasses.asdict(ref_allocator.swapless_plan(ref_t, hw_ref, k_max))
    )
    assert dataclasses.asdict(allocator.edge_tpu_compiler_plan(port_t)) == (
        dataclasses.asdict(ref_allocator.edge_tpu_compiler_plan(ref_t))
    )


@pytest.mark.parametrize("names,rates,k_max", MIXES, ids=MIX_IDS)
def test_predictions_are_identical(names, rates, k_max):
    ref_t, port_t = _tenants(names, rates)
    hw_ref, hw = ref_specs.EDGE_TPU_PLATFORM, specs.EDGE_TPU_PLATFORM
    ref_plans = [
        ref_allocator.swapless_plan(ref_t, hw_ref, k_max),
        ref_allocator.edge_tpu_compiler_plan(ref_t),
    ]
    port_plans = [
        allocator.swapless_plan(port_t, hw, k_max),
        allocator.edge_tpu_compiler_plan(port_t),
    ]
    for ref_plan, port_plan in zip(ref_plans, port_plans):
        want = ref_latency.predict(ref_t, ref_plan, hw_ref)
        got = latency.predict(port_t, port_plan, hw)
        # Every field, and every derived quantity serve.py prints.
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.latencies == want.latencies
        assert got.mean_latency(port_t) == want.mean_latency(ref_t)
        assert got.overload == want.overload


@pytest.mark.parametrize("names,rates,k_max", MIXES, ids=MIX_IDS)
def test_stepper_means_are_identical(names, rates, k_max):
    ref_t, port_t = _tenants(names, rates)
    hw_ref, hw = ref_specs.EDGE_TPU_PLATFORM, specs.EDGE_TPU_PLATFORM
    ref_trace = ref_workload.poisson_trace(list(rates), 30, seed=0)
    trace = workload.poisson_trace(list(rates), 30, seed=0)
    assert (trace.arrival == ref_trace.arrival).all()
    assert (trace.model_idx == ref_trace.model_idx).all()
    for plan_fn in ("swapless_plan", "edge_tpu_compiler_plan"):
        args_ref = (ref_t, hw_ref, k_max) if plan_fn == "swapless_plan" else (ref_t,)
        args = (port_t, hw, k_max) if plan_fn == "swapless_plan" else (port_t,)
        ref_plan = getattr(ref_allocator, plan_fn)(*args_ref)
        plan = getattr(allocator, plan_fn)(*args)
        want = ref_simulator.simulate(ref_t, ref_plan, hw_ref, ref_trace)
        got = simulator.simulate(port_t, plan, hw, trace)
        assert got.overall_mean() == want.overall_mean()
        for i in range(len(names)):
            assert list(got.latencies[i]) == list(want.latencies[i])
        assert got.misses == want.misses


def test_only_the_stepper_backend_is_ported():
    """The port's backends are the stepper, its device twin ``"torch"`` and
    the DES; the reference's ``"jax"`` backend has no counterpart."""
    assert sorted(simulator._BACKENDS) == ["des", "stepper", "torch"]
    with pytest.raises(ValueError, match="'stepper', 'des', 'torch'"):
        simulator.make_backend("jax", [], None, specs.EDGE_TPU_PLATFORM)
