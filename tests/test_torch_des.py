"""Parity of the port's discrete-event simulator (``serving/des.py``): the
host NumPy module is a verbatim copy, so on one ``trace_to_json`` trace it
must equal the reference's DES exactly, equal the port's stepper
elementwise under FCFS, and reproduce the closed form of a deterministic
single tenant."""
import dataclasses

import numpy as np
import pytest

from repro.configs.paper_models import paper_profile as ref_paper_profile
from repro.core.planner import DisciplineSpec as RefDisciplineSpec
from repro.core.planner import Plan as RefPlan
from repro.core.planner import TenantSpec as RefTenantSpec
from repro.hw.specs import EDGE_TPU_PLATFORM as REF_HW
from repro.serving import simulator as ref_simulator
from repro.serving import workload as ref_workload
from repro_torch.configs.paper_models import paper_profile
from repro_torch.core import latency
from repro_torch.core.planner import DisciplineSpec, Plan, TenantSpec
from repro_torch.hw.specs import EDGE_TPU_PLATFORM as HW
from repro_torch.serving.des import DiscreteEventSimulator
from repro_torch.serving.simulator import make_backend, simulate
from repro_torch.serving.workload import (
    deterministic_trace,
    poisson_trace,
    trace_from_json,
    trace_to_json,
    with_service_jitter,
)

MIX = (("squeezenet", 4.0), ("mobilenetv2", 3.0), ("mnasnet", 2.0), ("inceptionv4", 1.0))
MIX_PLAN = ((2, 3, 5, 9), (0, 1, 1, 2))


def _fields(res):
    """Every field of a ``SimResult`` as plain Python values."""
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if f.name in ("latencies", "arrivals"):
            v = [np.asarray(x, dtype=np.float64).tolist() for x in v]
        elif dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        out[f.name] = v
    return out


@pytest.mark.parametrize("disc", ["fcfs", "swap_batch"])
def test_des_equals_the_references_on_a_json_trace(disc):
    rates = [r for _, r in MIX]
    payload = trace_to_json(with_service_jitter(poisson_trace(rates, 120.0, seed=7), sigma=0.3, seed=8))
    assert payload == ref_workload.trace_to_json(
        ref_workload.with_service_jitter(ref_workload.poisson_trace(rates, 120.0, seed=7), sigma=0.3, seed=8)
    )
    part, cores = MIX_PLAN
    spec = {} if disc == "fcfs" else {"discipline": DisciplineSpec(kind="swap_batch", batch_cap=8)}
    ref_spec = {} if disc == "fcfs" else {"discipline": RefDisciplineSpec(kind="swap_batch", batch_cap=8)}
    ts = [TenantSpec(paper_profile(n), r) for n, r in MIX]
    ref_ts = [RefTenantSpec(ref_paper_profile(n), r) for n, r in MIX]
    got = simulate(ts, Plan(part, cores, **spec), HW, trace_from_json(payload), backend="des")
    ref = ref_simulator.simulate(
        ref_ts, RefPlan(part, cores, **ref_spec), REF_HW, ref_workload.trace_from_json(payload), backend="des"
    )
    assert _fields(got) == _fields(ref)
    # The scalar per-request path too.
    got_s = simulate(ts, Plan(part, cores, **spec), HW, trace_from_json(payload), backend="des", vectorize=False)
    assert _fields(got_s) == _fields(got)
    assert all(len(ls) for ls in got.latencies)


@pytest.mark.parametrize(
    "name,rate,plan",
    [("inceptionv4", 3.0, Plan((11,), (0,))), ("inceptionv4", 2.0, Plan((9,), (4,)))],
    ids=["full-tpu", "partitioned"],
)
def test_des_equals_stepper_elementwise(name, rate, plan):
    ts = [TenantSpec(paper_profile(name), rate)]
    reqs = poisson_trace([rate], 500.0, seed=1)
    des = simulate(ts, plan, HW, reqs, backend="des")
    step = simulate(ts, plan, HW, reqs, backend="stepper")
    d = sorted(zip(des.arrivals[0], des.latencies[0]))
    s = sorted(zip(step.arrivals[0], step.latencies[0]))
    assert len(d) == len(s) > 0
    for (at_d, a), (at_s, b) in zip(d, s):
        assert at_d == at_s
        assert a == pytest.approx(b, rel=1e-12, abs=1e-15)
    assert des.tpu_busy == pytest.approx(step.tpu_busy, rel=1e-12)


@pytest.mark.parametrize(
    "name,plan",
    [("inceptionv4", Plan((11,), (0,))), ("inceptionv4", Plan((9,), (4,))), ("mnasnet", Plan((0,), (4,)))],
    ids=["full-tpu", "partitioned", "full-cpu"],
)
def test_deterministic_single_tenant_closed_form(name, plan):
    ts = [TenantSpec(paper_profile(name), 0.05)]
    res = simulate(ts, plan, HW, deterministic_trace([0.05], 2000.0), backend="des")
    static = latency.predict(ts, plan, HW).static_latencies[0]
    assert res.latencies[0]
    for lat in res.latencies[0]:
        assert lat == pytest.approx(static, rel=1e-9)


def test_make_backend_des():
    profs = [paper_profile("mnasnet")]
    assert isinstance(make_backend("des", profs, Plan((7,), (0,)), HW), DiscreteEventSimulator)
