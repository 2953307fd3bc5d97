"""Traces, the stepper simulator and the real-execution engine.

Re-exports the reference's public names that the port holds; the
discrete-event simulator (``des``), the adaptive controller
(``controller``), the rate forecasters (``forecast``) and the fleet
simulator (``fleet``) are not ported yet.
"""
from repro_torch.serving.cache import SramCache
from repro_torch.serving.engine import CompletedRequest, ExecutableModel, ServingEngine
from repro_torch.serving.result import FleetSimResult, SimResult, merge_fleet_results
from repro_torch.serving.scheduling import (
    FCFS,
    Discipline,
    DisciplineSpec,
    FcfsDiscipline,
    PriorityDiscipline,
    SwapBatchDiscipline,
    WeightedFairDiscipline,
    make_discipline,
)
from repro_torch.serving.simulator import RuntimeSimulator, make_backend, simulate
from repro_torch.serving.workload import (
    ChurnTrace,
    RatePhase,
    Request,
    Trace,
    as_trace,
    route_trace,
    deterministic_trace,
    diurnal_trace,
    dynamic_trace,
    mmpp_trace,
    poisson_trace,
    tenant_churn_trace,
    trace_from_json,
    trace_to_json,
    with_service_jitter,
)

__all__ = [
    "ChurnTrace",
    "CompletedRequest",
    "Discipline",
    "DisciplineSpec",
    "FCFS",
    "FcfsDiscipline",
    "FleetSimResult",
    "PriorityDiscipline",
    "SwapBatchDiscipline",
    "WeightedFairDiscipline",
    "ExecutableModel",
    "RatePhase",
    "Request",
    "RuntimeSimulator",
    "ServingEngine",
    "SimResult",
    "SramCache",
    "Trace",
    "as_trace",
    "deterministic_trace",
    "diurnal_trace",
    "dynamic_trace",
    "make_backend",
    "make_discipline",
    "merge_fleet_results",
    "mmpp_trace",
    "poisson_trace",
    "route_trace",
    "simulate",
    "tenant_churn_trace",
    "trace_from_json",
    "trace_to_json",
    "with_service_jitter",
]
