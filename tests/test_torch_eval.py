"""Parity of the port's device plan evaluator (``core/torch_eval.py``) with
the reference's ``JaxPlanEvaluator`` and with the float64 NumPy batch, on
the CPU: objectives within 5e-5 relative, the same infinities and NaN
poison, and identical committed ``hill_climb`` plans."""
import jax
import numpy as np
import pytest
import torch

from benchmarks.sim_throughput import _mixes
from repro.core import jax_eval as ref_jax_eval
from repro.core.allocator import hill_climb as ref_hill_climb
from repro.core.objective import deadline_miss as ref_deadline_miss
from repro.core.objective import p_tail as ref_p_tail
from repro.core.plan_tables import EvalTables as RefEvalTables
from repro.core.planner import FCFS as REF_FCFS
from repro.core.planner import DisciplineSpec as RefDisciplineSpec
from repro.core.planner import TenantSpec as RefTenantSpec
from repro.configs.paper_models import paper_profile as ref_paper_profile
from repro.hw.specs import EDGE_TPU_PLATFORM as REF_HW
from repro_torch.configs.paper_models import paper_profile
from repro_torch.core import latency
from repro_torch.core.allocator import hill_climb, prop_alloc
from repro_torch.core.objective import deadline_miss, p_tail
from repro_torch.core.plan_tables import EvalTables
from repro_torch.core.planner import FCFS, DisciplineSpec, TenantSpec
from repro_torch.core.torch_eval import TorchPlanEvaluator
from repro_torch.hw.specs import EDGE_TPU_PLATFORM as HW

CPU = "cpu"
MIXES = ["collab8", "swap2", "thrash16"]
DISCIPLINES = {
    "fcfs": (FCFS, REF_FCFS),
    "swap_batch": (
        DisciplineSpec(kind="swap_batch", batch_cap=64),
        RefDisciplineSpec(kind="swap_batch", batch_cap=64),
    ),
}


def _tenants(names, rates, deadlines=None):
    deadlines = deadlines or [None] * len(names)
    ref = [RefTenantSpec(ref_paper_profile(n), float(r), deadline=d) for n, r, d in zip(names, rates, deadlines)]
    port = [TenantSpec(paper_profile(n), float(r), deadline=d) for n, r, d in zip(names, rates, deadlines)]
    return ref, port


def _mix_tenants(name, seed=1):
    ts, _, _ = _mixes()[name]
    rates = np.random.default_rng(seed).uniform(0.5, 4.0, len(ts))
    return _tenants([t.profile.name for t in ts], rates)


def _feasible_plans(ts, k_max, n_plans=48, seed=2):
    rng = np.random.default_rng(seed)
    p_max = np.array([t.profile.num_partition_points for t in ts])
    P = rng.integers(0, p_max + 1, size=(n_plans, len(ts)))
    K = np.zeros_like(P)
    keep = np.ones(n_plans, dtype=bool)
    for b in range(n_plans):
        try:
            K[b] = prop_alloc(ts, P[b], k_max)
        except ValueError:
            keep[b] = False
    return P[keep], K[keep]


def _evaluators(ref_ts, ts, k_max):
    et = EvalTables.build(ts, HW, k_max)
    return et, et.to_torch(CPU), RefEvalTables.build(ref_ts, REF_HW, k_max).to_jax()


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("disc", sorted(DISCIPLINES))
def test_objective_matches_reference_and_numpy(mix, disc):
    ref_ts, ts = _mix_tenants(mix)
    spec, ref_spec = DISCIPLINES[disc]
    k_max = max(4, len(ts))
    et, ev, ref_ev = _evaluators(ref_ts, ts, k_max)
    P, K = _feasible_plans(ts, k_max)
    want = latency.objective_batch(ts, P, K, HW, tables=et, discipline=spec)
    got = ev.objective_batch(P, K, discipline=spec)
    ref = ref_ev.objective_batch(P, K, discipline=ref_spec)
    for other in (want, ref):
        assert np.array_equal(np.isinf(other), np.isinf(got))
        finite = np.isfinite(other)
        assert finite.any()
        np.testing.assert_allclose(got[finite], other[finite], rtol=5e-5)


def test_alpha_zero_and_penalized():
    ref_ts, ts = _mix_tenants("collab8")
    k_max = max(4, len(ts))
    et, ev, ref_ev = _evaluators(ref_ts, ts, k_max)
    P, K = _feasible_plans(ts, k_max)
    want = latency.objective_batch(ts, P, K, HW, tables=et, force_alpha_zero=True)
    got = ev.objective_batch(P, K, force_alpha_zero=True)
    ref = ref_ev.objective_batch(P, K, force_alpha_zero=True)
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=5e-5)
    np.testing.assert_allclose(got, ref, rtol=5e-5)
    want_p = latency.penalized_objective_batch(ts, P, K, HW, tables=et)
    got_p = ev.penalized_objective_batch(P, K)
    ref_p = ref_ev.penalized_objective_batch(P, K)
    assert np.array_equal(want_p >= 1e9, got_p >= 1e9)
    ok = want_p < 1e9
    np.testing.assert_allclose(got_p[ok], want_p[ok], rtol=5e-5)
    np.testing.assert_allclose(got_p, ref_p, rtol=5e-5)


@pytest.mark.parametrize("kind", ["p_tail", "deadline_miss"])
@pytest.mark.parametrize("alpha_zero", [False, True])
def test_slo_objectives(kind, alpha_zero):
    names = ["inceptionv4", "mnasnet", "mobilenetv2", "squeezenet"]
    ref_ts, ts = _tenants(names, [2.0, 5.0, 3.0, 4.0], [0.4, 0.05, 0.06, 0.2])
    k_max = 4
    et, ev, ref_ev = _evaluators(ref_ts, ts, k_max)
    P, K = _feasible_plans(ts, k_max, n_plans=64, seed=3)
    obj, ref_obj = (p_tail(0.99), ref_p_tail(0.99)) if kind == "p_tail" else (deadline_miss(), ref_deadline_miss())
    dl = np.array([t.deadline for t in ts])
    want = latency.penalized_objective_batch(
        ts, P, K, HW, tables=et, objective=obj, force_alpha_zero=alpha_zero
    )
    got = ev.penalized_objective_batch(P, K, objective=obj, deadlines=dl, force_alpha_zero=alpha_zero)
    ref = ref_ev.penalized_objective_batch(P, K, objective=ref_obj, deadlines=dl, force_alpha_zero=alpha_zero)
    assert np.array_equal(want >= 1e9, got >= 1e9)
    ok = want < 1e9
    assert ok.any()
    np.testing.assert_allclose(got[ok], want[ok], rtol=5e-5, atol=1e-7)
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=1e-7)
    with pytest.raises(ValueError, match="batching"):
        ev.objective_batch(P, K, objective=obj, discipline=DISCIPLINES["swap_batch"][0])


def test_swap_batch_extension(monkeypatch):
    """A mix whose damped fixed point does not settle in 60 sweeps: the
    masked 540-sweep extension runs, here and in the reference."""
    names = ["mnasnet", "mobilenetv2", "efficientnet"]
    rates = [33.952794612593195, 15.90244329367047, 14.879704988613526]
    ref_ts, ts = _tenants(names, rates)
    et, ev, ref_ev = _evaluators(ref_ts, ts, 4)
    p_max = np.array([t.profile.num_partition_points for t in ts])
    P = np.stack([p_max, p_max - 1, np.maximum(p_max - 2, 0)])
    K = np.stack([prop_alloc(ts, p, 4) for p in P])
    spec, ref_spec = DISCIPLINES["swap_batch"]

    # Record the reference's branch: its lax.cond predicate, read back
    # through a debug callback in a fresh trace.
    seen = []
    cond = jax.lax.cond

    def recording_cond(pred, *args, **kwargs):
        jax.debug.callback(lambda p: seen.append(bool(p)), pred)
        return cond(pred, *args, **kwargs)

    monkeypatch.setattr(jax.lax, "cond", recording_cond)
    ref_jax_eval._objective_kernel.clear_cache()
    try:
        ref = ref_ev.objective_batch(P, K, discipline=ref_spec)
        jax.effects_barrier()
    finally:
        ref_jax_eval._objective_kernel.clear_cache()
    assert seen == [True]

    got = ev.objective_batch(P, K, discipline=spec)
    assert ev.extensions == 1
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    np.testing.assert_allclose(got[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=5e-5)
    # The rows whose fixed point float64 also settles agree with NumPy.
    want = latency.objective_batch(ts, P, K, HW, tables=et, discipline=spec)
    np.testing.assert_allclose(got[1:], want[1:], rtol=5e-5)


def test_nan_poison_of_padded_cells():
    # mnasnet has fewer partition points than inceptionv4: its padded cells
    # (p > P_i) are NaN, and a plan that gathers one scores NaN.
    ref_ts, ts = _tenants(["inceptionv4", "mnasnet"], [2.0, 5.0])
    et, ev, ref_ev = _evaluators(ref_ts, ts, 4)
    width = et.pstack.shape[1]
    p_mn = ts[1].profile.num_partition_points
    assert p_mn < width - 1
    P = np.array([[3, p_mn], [3, p_mn + 1]])
    K = np.array([[2, 0], [2, 0]])
    for disc in sorted(DISCIPLINES):
        spec, ref_spec = DISCIPLINES[disc]
        got = ev.objective_batch(P, K, discipline=spec)
        ref = ref_ev.objective_batch(P, K, discipline=ref_spec)
        assert np.isfinite(got[0]) and np.isnan(got[1])
        assert np.array_equal(np.isnan(got), np.isnan(ref))
    # Past the tables' width torch would raise where JAX clamps: the host
    # check refuses it first.
    with pytest.raises(ValueError, match="partition points"):
        ev.objective_batch(np.array([[3, width]]), np.array([[2, 0]]))


@pytest.mark.parametrize("mix", MIXES)
def test_hill_climb_plans_identical(mix):
    ref_ts, ts = _mix_tenants(mix)
    k_max = max(4, len(ts))
    et, ev, ref_ev = _evaluators(ref_ts, ts, k_max)
    plan, obj = hill_climb(ts, HW, k_max, evaluator=ev)
    want, want_obj = hill_climb(ts, HW, k_max, tables=et, batch=True)
    ref, _ = ref_hill_climb(ref_ts, REF_HW, k_max, evaluator=ref_ev)
    assert plan == want
    assert (plan.partition, plan.cores) == (ref.partition, ref.cores)
    assert obj == pytest.approx(want_obj, rel=1e-4)
    warm, _ = hill_climb(ts, HW, k_max, evaluator=ev, init_plan=want)
    warm_want, _ = hill_climb(ts, HW, k_max, tables=et, batch=True, init_plan=want)
    assert warm == warm_want


def test_hill_climb_discipline_space():
    ref_ts, ts = _mix_tenants("swap2")
    et, ev, ref_ev = _evaluators(ref_ts, ts, 4)
    space = tuple(DISCIPLINES[d][0] for d in ("fcfs", "swap_batch"))
    ref_space = tuple(DISCIPLINES[d][1] for d in ("fcfs", "swap_batch"))
    plan, _ = hill_climb(ts, HW, 4, evaluator=ev, discipline_space=space)
    want, _ = hill_climb(ts, HW, 4, tables=et, batch=True, discipline_space=space)
    ref, _ = ref_hill_climb(ref_ts, REF_HW, 4, evaluator=ref_ev, discipline_space=ref_space)
    assert plan == want
    assert (plan.partition, plan.cores, plan.discipline.kind) == (ref.partition, ref.cores, ref.discipline.kind)


def test_mismatch_and_shape_checks():
    _, ts = _mix_tenants("swap2")
    other = [TenantSpec(t.profile, t.rate * 2.0) for t in ts]
    ev = TorchPlanEvaluator.build(other, HW, 4, device=CPU)
    with pytest.raises(ValueError, match="evaluator"):
        hill_climb(ts, HW, 4, evaluator=ev)
    with pytest.raises(ValueError, match=r"\[B, n\]"):
        ev.objective_batch(np.zeros(2, dtype=np.int64), np.zeros(2, dtype=np.int64))


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    _, ts = _mix_tenants("swap2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchPlanEvaluator.build(ts, HW, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EvalTables.build(ts, HW, 4).to_torch()
