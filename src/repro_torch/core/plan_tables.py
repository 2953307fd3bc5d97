"""Precomputed per-tenant cost tables for the vectorized plan evaluator.

The online allocator (Algorithm 1) evaluates hundreds of candidate plans per
re-planning step.  Each evaluation of the scalar objective walks Python-level
per-tenant loops; its cost grows with tenants x partition points and caps the
mixes the <2 ms re-plan budget can handle.

Two cache levels feed the batch evaluator (``latency.*_batch``):

* ``PlanTables`` -- rate-independent per-``(tenant, p[, k])`` quantities
  (prefix service, T_load, boundary transfer, suffix CPU times, prefix
  weights).  Depends only on (profiles, platform), so a serving controller
  builds it once and reuses it across every re-plan as rates drift.

* ``EvalTables`` -- rate-aware contribution tables derived from a
  ``PlanTables``.  The Eq. 1-5 objective decomposes into per-tenant sums
  plus row-global coupling through ``lam_TPU`` and the shared-cache regime
  of Eq. 10:

      total = sum_i phi(i, p_i, k_i)                 [static per-tenant]
            + lam_TPU * W_TPU                        [M/G/1 wait, Eq. 1]
            + shared * (SL - Q / lam_TPU)            [swap term, Eq. 10]

  with the M/G/1 moment numerators themselves per-tenant sums
  (S1 + shared*(SL - Q/lam), S2 + shared*(U - V/lam)).  ``EvalTables``
  stores every per-tenant summand as a dense array, so evaluating B
  candidate plans costs two gathers + two row-sums + O(1) vector ops on
  [B]-shaped arrays -- independent of the per-plan Python work the scalar
  path pays.

Padded (p > P_i) cells are poisoned with NaN: any accidental gather of an
out-of-range partition point surfaces as NaN instead of silently pricing an
impossible plan.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

import numpy as np

from repro_torch.core import queueing
from repro_torch.core.planner import ModelProfile, TenantSpec
from repro_torch.hw.specs import Platform

if TYPE_CHECKING:
    import torch

_PAD = np.nan

# Column layout of EvalTables.pstack ([n, P_max+1, 9]).
(
    PCOL_LAM,      # rate * 1{p > 0}              -> lam_TPU
    PCOL_ACTIVE,   # 1{p > 0}                     -> n_active (Eq. 10 regime)
    PCOL_WEIGHT,   # prefix weight bytes          -> aggregate footprint W(P)
    PCOL_S1,       # rate * s_tpu                 -> E[S] numerator
    PCOL_S2,       # rate * s_tpu^2               -> E[S^2] numerator
    PCOL_SL,       # rate * T_load                -> swap-term sum
    PCOL_Q,        # rate^2 * T_load              -> swap-term / lam part
    PCOL_U,        # rate * T_load * (2 s + T_load)   -> E[S^2] swap part
    PCOL_V,        # rate^2 * T_load * (2 s + T_load) -> E[S^2] / lam part
) = range(9)

# Column layout of EvalTables.pkstack ([n, P_max+1, k_max+1, 2]).
PKCOL_STATIC, PKCOL_OVERLOAD = range(2)


def _padded(rows: Sequence[np.ndarray], width: int) -> np.ndarray:
    out = np.full((len(rows), width), _PAD, dtype=np.float64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


@dataclasses.dataclass(frozen=True)
class PlanTables:
    """Rate-free per-(tenant, p[, k]) cost tables on one platform."""

    profiles: tuple[ModelProfile, ...]
    platform: Platform
    num_points: np.ndarray      # [n] int, P_i per tenant
    input_xfer: np.ndarray      # [n] input transfer time (s)
    prefix_service: np.ndarray  # [n, P_max+1] s_TPU: compute + intra-swap
    load: np.ndarray            # [n, P_max+1] T_load
    boundary: np.ndarray        # [n, P_max+1] boundary transfer at cut p
    suffix1: np.ndarray         # [n, P_max+1] 1-core CPU suffix time
    prefix_weight: np.ndarray   # [n, P_max+1] TPU-resident bytes
    k_max: int
    tenant_idx: np.ndarray = dataclasses.field(repr=False, default=None)  # [n]
    # Per-tenant sorted non-dominated partition points (see
    # ``ModelProfile.pareto_points`` for the dominance relation and proof).
    # Always contains 0 and P_i; the searchers' ``prune`` flag opts out.
    frontiers: tuple[np.ndarray, ...] = dataclasses.field(
        repr=False, default=None
    )

    def __post_init__(self) -> None:
        if self.tenant_idx is None:
            object.__setattr__(self, "tenant_idx", np.arange(len(self.profiles)))
        if self.frontiers is None:
            object.__setattr__(
                self, "frontiers", tuple(p.pareto_points for p in self.profiles)
            )

    @property
    def frontier_sizes(self) -> np.ndarray:
        return np.array([len(f) for f in self.frontiers])

    @property
    def n_tenants(self) -> int:
        return len(self.profiles)

    @classmethod
    def build(
        cls,
        profiles: Sequence[ModelProfile],
        platform: Platform,
        k_max: int,
    ) -> "PlanTables":
        bw = platform.swap_bw
        sram = platform.sram_bytes
        n_points = np.array([p.num_partition_points for p in profiles])
        width = int(n_points.max()) + 1 if len(profiles) else 1

        svc_rows, load_rows, bnd_rows, w_rows, sfx_rows = [], [], [], [], []
        for prof in profiles:
            P = prof.num_partition_points
            cum_w = prof._cum_weight.astype(np.float64)  # [P+1]
            cum_tpu = prof._cum_tpu                      # [P+1]
            # s_TPU(p) = prefix compute + overflow streamed per request.
            overflow = np.maximum(0.0, cum_w - sram)
            svc = cum_tpu + overflow / bw
            svc[0] = 0.0  # prefix_service_time short-circuits p <= 0
            svc_rows.append(svc)
            # T_load(p): only the normally-resident part reloads on a miss.
            load_rows.append(np.minimum(cum_w, sram) / bw)
            # Boundary tensor transfer at cut p: d_out(p)/B (p=0 entry is the
            # input tensor, matching boundary_bytes; the evaluator charges it
            # only on genuinely split plans).
            bnd = np.empty(P + 1)
            bnd[0] = prof.input_bytes / bw
            if P:
                bnd[1:] = np.array([s.out_bytes for s in prof.segments]) / bw
            bnd_rows.append(bnd)
            w_rows.append(cum_w)
            sfx_rows.append(prof._suffix_cpu1)

        return cls(
            profiles=tuple(profiles),
            platform=platform,
            num_points=n_points,
            input_xfer=np.array([p.input_bytes for p in profiles]) / bw,
            prefix_service=_padded(svc_rows, width),
            load=_padded(load_rows, width),
            boundary=_padded(bnd_rows, width),
            suffix1=_padded(sfx_rows, width),
            prefix_weight=_padded(w_rows, width),
            k_max=k_max,
        )

    @classmethod
    def for_tenants(
        cls,
        tenants: Sequence[TenantSpec],
        platform: Platform,
        k_max: int,
    ) -> "PlanTables":
        return cls.build([t.profile for t in tenants], platform, k_max)

    def matches(
        self, tenants: Sequence[TenantSpec], platform: Platform | None = None
    ) -> bool:
        """True when built for exactly these profiles (and, when given, for
        this platform -- the hardware constants are baked into the tables)."""
        if platform is not None and platform != self.platform:
            return False
        return len(tenants) == len(self.profiles) and all(
            t.profile is p for t, p in zip(tenants, self.profiles)
        )

    def matches_profiles(
        self, profiles: Sequence[ModelProfile], platform: Platform | None = None
    ) -> bool:
        """`matches` on raw profiles (no rates attached) -- the fleet cache
        keys tables on (device class, hosted profiles) where tenant specs
        don't exist yet.  Same `is` identity contract as `matches`."""
        if platform is not None and platform != self.platform:
            return False
        return len(profiles) == len(self.profiles) and all(
            q is p for q, p in zip(profiles, self.profiles)
        )


@dataclasses.dataclass(frozen=True)
class EvalTables:
    """Rate-aware per-tenant contribution tables for one tenant mix.

    ``pstack[i, p, c]`` holds the nine per-(tenant, p) summands (PCOL_*) of
    the row-global objective decomposition; ``pkstack[i, p, k, c]`` holds the
    static latency contribution phi and the CPU-overload term (PKCOL_*).
    Rebuild whenever rates change (~100 us); reuse the ``base`` PlanTables
    across rebuilds.
    """

    base: PlanTables
    rates: np.ndarray           # [n]
    sram_bytes: int
    k_max: int
    pstack: np.ndarray          # [n, P_max+1, 9]
    pkstack: np.ndarray         # [n, P_max+1, k_max+1, 2]

    @property
    def tenant_idx(self) -> np.ndarray:
        return self.base.tenant_idx

    @property
    def num_points(self) -> np.ndarray:
        return self.base.num_points

    @classmethod
    def build(
        cls,
        tenants: Sequence[TenantSpec],
        platform: Platform,
        k_max: int,
        *,
        base: PlanTables | None = None,
    ) -> "EvalTables":
        if base is None or not base.matches(tenants, platform):
            base = PlanTables.for_tenants(tenants, platform, k_max)
        n = len(tenants)
        rates = np.array([t.rate for t in tenants], dtype=np.float64)
        r = rates[:, None]                                  # [n, 1]
        svc, tl, s1 = base.prefix_service, base.load, base.suffix1
        width = svc.shape[1]
        col = np.arange(width)[None, :]                     # [1, W]
        on_tpu = col > 0
        on_cpu = col < base.num_points[:, None]

        # --- per-(tenant, p) summands -------------------------------------
        # s_tpu and T_load are 0 at p=0, so only lam/active need the mask.
        t2 = tl * (2.0 * svc + tl)
        pstack = np.stack(
            [
                r * on_tpu,             # PCOL_LAM (finite in pad cells; the
                on_tpu + 0.0 * svc,     # PCOL_ACTIVE   svc NaN poisons S1)
                base.prefix_weight,     # PCOL_WEIGHT
                r * svc,                # PCOL_S1
                r * svc * svc,          # PCOL_S2
                r * tl,                 # PCOL_SL
                r * r * tl,             # PCOL_Q
                r * t2,                 # PCOL_U
                r * r * t2,             # PCOL_V
            ],
            axis=-1,
        )

        # --- per-(tenant, p, k) summands ----------------------------------
        # phi(i, p, k) = r_i * [ 1{p>0}(input_xfer + s_tpu)
        #                        + 1{0<p<P} boundary_xfer
        #                        + 1{p<P}(mdk_wait + s_cpu_1core) ]
        with np.errstate(divide="ignore", invalid="ignore"):
            mu_one = 1.0 / s1                               # inf on empty suffix
        k = np.arange(k_max + 1, dtype=np.float64)[None, None, :]
        mdk = queueing.mdk_wait_batch(r[:, :, None], mu_one[:, :, None], k)
        cpu_term = np.where(
            on_cpu[:, :, None], s1[:, :, None] + mdk, 0.0
        )                                                   # [n, W, K+1]
        tpu_term = np.where(on_tpu, base.input_xfer[:, None] + svc, 0.0)
        bnd_term = np.where(on_tpu & on_cpu, base.boundary, 0.0)
        phi = r[:, :, None] * ((tpu_term + bnd_term)[:, :, None] + cpu_term)
        # CPU overload: max(0, r * s1 / max(k, 1) - 1); 0 on full-TPU rows
        # (s1 == 0) without an explicit 1{p<P} mask, as in the scalar path.
        over = np.maximum(0.0, (r * s1)[:, :, None] / np.maximum(k, 1.0) - 1.0)
        pkstack = np.stack([phi, over], axis=-1)

        return cls(
            base=base,
            rates=rates,
            sram_bytes=platform.sram_bytes,
            k_max=k_max,
            pstack=pstack,
            pkstack=pkstack,
        )

    def matches(
        self, tenants: Sequence[TenantSpec], platform: Platform | None = None
    ) -> bool:
        """True when built for exactly these profiles at exactly these rates
        (and, when given, for this platform)."""
        return self.base.matches(tenants, platform) and all(
            t.rate == r for t, r in zip(tenants, self.rates)
        )

    def to_torch(self, device: "str | torch.device" = "cuda"):
        """Device-resident ``repro_torch.core.torch_eval.TorchPlanEvaluator``
        over these tables (float32, statistical-equivalence contract; the
        NumPy evaluator over ``self`` stays the bitwise reference).
        Imported lazily so this module keeps zero accelerator dependencies."""
        from repro_torch.core.torch_eval import TorchPlanEvaluator

        return TorchPlanEvaluator.from_tables(self, device=device)
