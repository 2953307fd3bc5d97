"""Parity of the port's device stepper (``serving/torch_stepper.py``) with
the reference's JAX stepper and with the float64 NumPy stepper, on the CPU.

The contract is the reference's statistical one: float32 delays within
2e-6 s of the float64 recurrence at every trace length (the long-horizon
case is the one where a prefix sum over the whole trace would cancel),
means and p99 within 1e-4 relative, integer observables exact.
"""
import numpy as np
import pytest
import torch

from benchmarks.sim_throughput import _mixes
from repro.hw.specs import EDGE_TPU_PLATFORM as REF_HW
from repro.serving import jax_stepper as ref_jax_stepper
from repro.serving import simulator as ref_simulator
from repro.serving.workload import Trace as RefTrace
from repro_torch.configs.paper_models import paper_profile
from repro_torch.core.planner import DisciplineSpec, Plan, TenantSpec
from repro_torch.hw.specs import EDGE_TPU_PLATFORM as HW
from repro_torch.serving.simulator import RuntimeSimulator, _server_ends, make_backend, simulate
from repro_torch.serving.torch_stepper import TorchStepper, lindley_ends
from repro_torch.serving.workload import Trace

CPU = "cpu"
MIXES = ["collab8", "swap2", "thrash16"]
SWAP_BATCH = DisciplineSpec(kind="swap_batch", batch_cap=64)


def _mix(name):
    """(reference tenants, reference plan, port tenants, port plan)."""
    ref_ts, ref_plan, _ = _mixes()[name]
    ts = [TenantSpec(paper_profile(t.profile.name), t.rate) for t in ref_ts]
    return ref_ts, ref_plan, ts, Plan(ref_plan.partition, ref_plan.cores)


def _poisson_columns(rates, n_req, seed):
    """Merged-Poisson (model_idx, arrival) columns, sorted."""
    rng = np.random.default_rng(seed)
    lam = float(sum(rates))
    arr = np.cumsum(rng.exponential(1.0 / lam, n_req))
    mi = rng.choice(len(rates), size=n_req, p=np.asarray(rates) / lam).astype(np.int64)
    return mi, arr


def _queue(n, seed, gap=0.01, svc=0.008):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(gap, n)), rng.exponential(svc, n)


class TestLindleyEnds:
    def test_empty(self):
        assert lindley_ends(np.empty(0), np.empty(0), 0.5, device=CPU).shape == (0,)

    @pytest.mark.parametrize("n", [1, 2, 7, 1000, 4097])
    def test_matches_server_ends_and_reference(self, n):
        enq, svc = _queue(n, n)
        got = lindley_ends(enq, svc, 0.005, device=CPU)
        want = _server_ends(enq, svc, 0.005)
        ref = ref_jax_stepper.lindley_ends(enq, svc, 0.005)
        assert got.shape == want.shape
        np.testing.assert_allclose(got - enq, want - enq, atol=2e-6, rtol=0)
        np.testing.assert_allclose(got - enq, ref - enq, atol=2e-6, rtol=0)

    def test_saturated_queue(self):
        enq, svc = _queue(5000, 3, gap=0.005)
        got = lindley_ends(enq, svc, 0.0, device=CPU)
        want = _server_ends(enq, svc, 0.0)
        np.testing.assert_allclose(got - enq, want - enq, rtol=1e-5, atol=2e-6)

    def test_long_horizon(self):
        # 2^18 requests; the clock passes 2,500 s.  Carries combined by a
        # prefix sum over the trace would cancel against that clock.
        enq, svc = _queue(1 << 18, 18)
        assert enq[-1] > 2500.0
        got = lindley_ends(enq, svc, 0.005, device=CPU)
        want = _server_ends(enq, svc, 0.005)
        np.testing.assert_allclose(got - enq, want - enq, atol=2e-6, rtol=0)

    def test_long_span_per_chunk(self):
        # A few hundred requests spread over 30 s (one re-plan span): each
        # chunk covers the whole span, so a within-chunk prefix sum would
        # lose a float32 ulp of 30 s.
        enq, svc = _queue(300, 30, gap=0.1, svc=0.03)
        enq = enq + 500.0
        got = lindley_ends(enq, svc, 0.0, device=CPU)
        want = _server_ends(enq, svc, 0.0)
        np.testing.assert_allclose(got - enq, want - enq, atol=2e-7, rtol=0)

    def test_default_device_is_the_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default resolves")
        enq, svc = _queue(7, 7)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lindley_ends(enq, svc, 0.0)


class TestTorchBackend:
    def test_make_backend_dispatch(self):
        _, _, ts, plan = _mix("collab8")
        profs = [t.profile for t in ts]
        sim = make_backend("torch", profs, plan, HW, device=CPU)
        assert isinstance(sim, TorchStepper) and isinstance(sim, RuntimeSimulator)
        assert sim.device == torch.device("cpu")
        with pytest.raises(ValueError, match="'torch'"):
            make_backend("nope", profs, plan, HW)

    def test_host_backends_need_no_card(self):
        _, _, ts, plan = _mix("swap2")
        profs = [t.profile for t in ts]
        # The default device is the GPU, but only "torch" reads it.
        assert type(make_backend("stepper", profs, plan, HW)) is RuntimeSimulator
        make_backend("des", profs, plan, HW)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_backend("torch", profs, plan, HW)

    @pytest.mark.parametrize("mix", MIXES)
    def test_matches_stepper_and_reference(self, mix):
        ref_ts, ref_plan, ts, plan = _mix(mix)
        mi, arr = _poisson_columns([2.0] * len(ts), 6000, seed=11)
        want = simulate(ts, plan, HW, Trace(mi, arr), warmup_frac=0.0)
        got = simulate(ts, plan, HW, Trace(mi, arr), warmup_frac=0.0, backend="torch", device=CPU)
        ref = ref_simulator.simulate(
            ref_ts, ref_plan, REF_HW, RefTrace(mi, arr), warmup_frac=0.0, backend="jax"
        )
        for other in (want, ref):
            assert got.misses == other.misses
            assert got.tpu_requests == other.tpu_requests
            for m in range(len(ts)):
                assert len(got.latencies[m]) == len(other.latencies[m])
                np.testing.assert_array_equal(got.arrivals[m], other.arrivals[m])
                assert got.mean_latency(m) == pytest.approx(other.mean_latency(m), rel=1e-4, abs=1e-6)
                assert got.p99(m) == pytest.approx(other.p99(m), rel=1e-4, abs=1e-6)


class TestReplicaEngine:
    def _setup(self, n_req=5000, n_rep=3, seed=21):
        ref_ts, ref_plan, ts, plan = _mix("collab8")
        mi, arr = _poisson_columns([2.4] * 4 + [15.0] * 4, n_req, seed)
        scales = np.random.default_rng(seed + 1).uniform(0.8, 1.25, size=(n_rep, len(ts)))
        return ref_ts, ref_plan, ts, plan, mi, arr, scales

    def test_matches_reference_and_per_replica_simulate(self):
        ref_ts, ref_plan, ts, plan, mi, arr, scales = self._setup()
        profs = [t.profile for t in ts]
        stats = make_backend("torch", profs, plan, HW, device=CPU).run_trace_replicas(Trace(mi, arr), scales)
        ref = ref_simulator.make_backend(
            "jax", [t.profile for t in ref_ts], ref_plan, REF_HW
        ).run_trace_replicas(RefTrace(mi, arr), scales)
        np.testing.assert_allclose(stats.mean_latency, ref.mean_latency, rtol=2e-4)
        np.testing.assert_allclose(stats.tpu_busy, ref.tpu_busy, rtol=1e-4)
        np.testing.assert_array_equal(stats.counts, ref.counts)
        np.testing.assert_array_equal(stats.misses, ref.misses)
        for r in range(scales.shape[0]):
            want = simulate(ts, plan, HW, Trace(mi, arr, scales[r][mi]), warmup_frac=0.0)
            for m in range(len(profs)):
                assert stats.mean_latency[r, m] == pytest.approx(want.mean_latency(m), rel=2e-4)
                assert stats.counts[m] == len(want.latencies[m])
            assert list(stats.misses) == want.misses
            assert stats.tpu_busy[r] == pytest.approx(want.tpu_busy, rel=1e-4)

    def test_full_cpu_route(self):
        # One model entirely on its single-core CPU pool: the route whose
        # operands are built on the host.
        _, _, ts, plan, mi, arr, scales = self._setup(n_req=2000)
        part = list(plan.partition)
        part[-1] = 0
        plan = Plan(tuple(part), plan.cores)
        profs = [t.profile for t in ts]
        stats = make_backend("torch", profs, plan, HW, device=CPU).run_trace_replicas(Trace(mi, arr), scales)
        for r in range(scales.shape[0]):
            want = simulate(ts, plan, HW, Trace(mi, arr, scales[r][mi]), warmup_frac=0.0)
            for m in range(len(profs)):
                assert stats.mean_latency[r, m] == pytest.approx(want.mean_latency(m), rel=2e-4)

    def test_replica_engine_is_read_only(self):
        _, _, ts, plan, mi, arr, scales = self._setup(n_req=1000)
        sim = make_backend("torch", [t.profile for t in ts], plan, HW, device=CPU)
        a = sim.run_trace_replicas(Trace(mi, arr), scales)
        assert sim.tpu_free == 0.0 and sim.tpu_busy == 0.0
        assert all(len(ls) == 0 for ls in sim.latencies)
        b = sim.run_trace_replicas(Trace(mi, arr), scales)
        np.testing.assert_array_equal(a.mean_latency, b.mean_latency)

    def test_guards(self):
        _, _, ts, plan, mi, arr, scales = self._setup(n_req=200)
        profs = [t.profile for t in ts]
        trace = Trace(mi, arr)
        sim = make_backend("torch", profs, plan, HW, device=CPU)
        with pytest.raises(ValueError, match="n_replicas"):
            sim.run_trace_replicas(trace, scales[0])
        with pytest.raises(ValueError, match="unit-scale"):
            sim.run_trace_replicas(Trace(mi, arr, np.full(len(mi), 1.0 + 1e-9)), scales)
        with pytest.raises(ValueError, match="sorted"):
            sim.run_trace_replicas(Trace(mi[::-1].copy(), arr[::-1].copy()), scales)
        dirty = make_backend("torch", profs, plan, HW, device=CPU)
        dirty.run_trace(trace)
        with pytest.raises(ValueError, match="fresh"):
            dirty.run_trace_replicas(trace, scales)
        sb = make_backend("torch", profs, Plan(plan.partition, plan.cores, SWAP_BATCH), HW, device=CPU)
        with pytest.raises(ValueError, match="FCFS"):
            sb.run_trace_replicas(trace, scales)
        cores = list(plan.cores)
        cores[-1] = 2
        multi = make_backend("torch", profs, Plan(plan.partition, tuple(cores)), HW, device=CPU)
        with pytest.raises(ValueError, match="k<=1"):
            multi.run_trace_replicas(trace, scales)

    def test_empty_trace(self):
        _, _, ts, plan, _, _, scales = self._setup(n_req=200)
        sim = make_backend("torch", [t.profile for t in ts], plan, HW, device=CPU)
        stats = sim.run_trace_replicas(Trace(np.empty(0, np.int64), np.empty(0)), scales)
        assert stats.mean_latency.shape == (3, len(ts))
        assert stats.counts.sum() == 0 and stats.misses.sum() == 0
