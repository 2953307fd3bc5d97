"""Weight-miss probability and aggregate-footprint modeling (Eq. 10)."""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.planner import ModelProfile, Plan, TenantSpec
from repro_torch.hw.specs import Platform


def aggregate_footprint(tenants: Sequence[TenantSpec], partition: Sequence[int]) -> int:
    """W(P): total TPU-resident weight bytes under partitioning P."""
    return sum(
        t.profile.prefix_weight_bytes(p) for t, p in zip(tenants, partition)
    )


def tpu_arrival_rate(tenants: Sequence[TenantSpec], partition: Sequence[int]) -> float:
    """lambda_TPU = sum over models with a non-empty TPU prefix."""
    return sum(t.rate for t, p in zip(tenants, partition) if p > 0)


def weight_miss_probs(
    tenants: Sequence[TenantSpec],
    partition: Sequence[int],
    platform: Platform,
) -> list[float]:
    """alpha_Mi(P) per Eq. 10.

    Regime 1 (alpha = 0): the aggregate footprint fits in SRAM, or only a
    single tenant uses the TPU (driver keeps weights persistent).
    Regime 2: shared-occupancy cache; conservative upper bound
    ``1 - lambda_i / lambda_TPU`` -- any intervening request of a different
    model is assumed to evict M_i.
    """
    lam_tpu = tpu_arrival_rate(tenants, partition)
    active = [p > 0 for p in partition]
    n_active = sum(active)
    fits = aggregate_footprint(tenants, partition) <= platform.sram_bytes

    alphas: list[float] = []
    for t, p in zip(tenants, partition):
        if p <= 0:
            alphas.append(0.0)
        elif fits or n_active <= 1 or lam_tpu <= 0.0:
            alphas.append(0.0)
        else:
            alphas.append(max(0.0, 1.0 - t.rate / lam_tpu))
    return alphas
