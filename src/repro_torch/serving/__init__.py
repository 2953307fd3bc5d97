"""Traces, the serving simulators (stepper, discrete-event, device stepper),
the adaptive controller, the rate forecasters, the fleet simulator and the
real-execution engine.

Re-exports the reference's public names, with the reference's import lines.
"""
from repro_torch.serving.cache import SramCache
from repro_torch.serving.controller import (
    AdaptiveRunResult,
    SlidingRateEstimator,
    run_adaptive,
)
from repro_torch.serving.des import DiscreteEventSimulator
from repro_torch.serving.engine import CompletedRequest, ExecutableModel, ServingEngine
from repro_torch.serving.fleet import (
    FleetAdaptiveResult,
    offered_device_loads,
    run_adaptive_fleet,
    simulate_fleet,
)
from repro_torch.serving.forecast import (
    EwmaTrendForecaster,
    NeverForecaster,
    OracleForecaster,
    PeriodicForecaster,
    RateForecaster,
    piecewise_rate_fn,
)
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
    "AdaptiveRunResult",
    "ChurnTrace",
    "CompletedRequest",
    "Discipline",
    "DisciplineSpec",
    "DiscreteEventSimulator",
    "EwmaTrendForecaster",
    "FCFS",
    "FcfsDiscipline",
    "FleetAdaptiveResult",
    "FleetSimResult",
    "NeverForecaster",
    "OracleForecaster",
    "PeriodicForecaster",
    "PriorityDiscipline",
    "RateForecaster",
    "SwapBatchDiscipline",
    "WeightedFairDiscipline",
    "ExecutableModel",
    "RatePhase",
    "Request",
    "RuntimeSimulator",
    "ServingEngine",
    "SimResult",
    "SlidingRateEstimator",
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
    "offered_device_loads",
    "piecewise_rate_fn",
    "poisson_trace",
    "route_trace",
    "run_adaptive",
    "run_adaptive_fleet",
    "simulate",
    "simulate_fleet",
    "tenant_churn_trace",
    "trace_from_json",
    "trace_to_json",
    "with_service_jitter",
]
