"""Analytic queueing model, the Algorithm 1 planner, the plan cache and the
fleet planner (host NumPy); the device plan evaluator is
``repro_torch.core.torch_eval``.

Re-exports the reference's public names, with the reference's import lines.
"""
from repro_torch.core.planner import (
    ModelProfile,
    Plan,
    Segment,
    TenantSpec,
    intra_swap_bytes,
    load_time,
    prefix_service_time,
    validate_plan,
)
from repro_torch.core.plan_tables import EvalTables, PlanTables
from repro_torch.core.fleet import (
    DeviceSpec,
    FleetPlan,
    FleetTablesCache,
    fleet_hill_climb,
    fleet_plan_objective,
    round_robin_fleet_plan,
    validate_fleet_plan,
)
from repro_torch.core.plan_cache import (
    CacheStats,
    FleetPlanCache,
    PlanCache,
    mix_fingerprint,
    quantize_rates,
)
from repro_torch.core.queueing import (
    mdk_wait,
    mdk_wait_batch,
    mg1_wait,
    mg1_wait_batch,
    mixture_moments,
    mixture_moments_batch,
)
from repro_torch.core.swap import aggregate_footprint, tpu_arrival_rate, weight_miss_probs
from repro_torch.core.latency import (
    LatencyBreakdown,
    SystemPrediction,
    objective,
    objective_batch,
    penalized_objective,
    penalized_objective_batch,
    predict,
)
from repro_torch.core.allocator import (
    brute_force_oracle,
    edge_tpu_compiler_plan,
    hill_climb,
    prop_alloc,
    prop_alloc_batch,
    swapless_alpha0_plan,
    swapless_plan,
    threshold_plan,
)

__all__ = [
    "CacheStats",
    "DeviceSpec",
    "EvalTables",
    "FleetPlan",
    "FleetPlanCache",
    "FleetTablesCache",
    "LatencyBreakdown",
    "ModelProfile",
    "Plan",
    "PlanCache",
    "PlanTables",
    "Segment",
    "SystemPrediction",
    "TenantSpec",
    "aggregate_footprint",
    "brute_force_oracle",
    "edge_tpu_compiler_plan",
    "fleet_hill_climb",
    "fleet_plan_objective",
    "hill_climb",
    "intra_swap_bytes",
    "load_time",
    "mdk_wait",
    "mix_fingerprint",
    "mdk_wait_batch",
    "mg1_wait",
    "mg1_wait_batch",
    "mixture_moments",
    "mixture_moments_batch",
    "objective",
    "objective_batch",
    "penalized_objective",
    "penalized_objective_batch",
    "predict",
    "prefix_service_time",
    "prop_alloc",
    "prop_alloc_batch",
    "quantize_rates",
    "round_robin_fleet_plan",
    "swapless_alpha0_plan",
    "swapless_plan",
    "threshold_plan",
    "tpu_arrival_rate",
    "validate_fleet_plan",
    "validate_plan",
    "weight_miss_probs",
]
