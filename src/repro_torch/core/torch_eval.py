"""Batched plan evaluator on a torch device: Eq. 1-5 / Eq. 10 in torch ops.

``TorchPlanEvaluator`` ports the ``EvalTables`` decomposition of the Eq. 5
objective (see ``plan_tables.py``) to torch: scoring B candidate plans is
two device gathers, two row-sums, and O(1) vector math per candidate -- one
pass for a whole hill-climb neighbor frontier, or for a Monte-Carlo batch
of rate draws.  ``hill_climb(evaluator=...)`` plugs it into Algorithm 1's
batched walk.

Contract (the reference's standing invariant): the NumPy evaluator
(``latency.objective_batch`` et al.) is the bitwise-pinned reference; this
one runs in float32 and is *statistically equivalent*: objectives agree to
~1e-5 relative, and committed hill-climb plans are identical except where
two candidates tie within float32 round-off (~1e-7 relative -- orders of
magnitude below any latency difference the paper's mixes produce).

Both aggregation tails are ported exactly:

* the FCFS tail with the Eq. 10 shared-occupancy collapse
  ``(SL - Q/lam)`` / ``(U - V/lam)`` and the Pollaczek-Khinchine wait;
* the ``swap_batch`` tail with the damped amortization fixed point --
  same formulas, same 60-sweep damped loop, same masked 540-sweep
  extension and unamortized-FCFS fallback as
  ``queueing.swap_batch_amortization``, so the two implementations agree
  wherever the fixed point converges (the extension runs only when a lane
  diverged, which costs one host sync per call).

The padded (p > P_i) table cells keep their NaN poison: a candidate row
gathering an out-of-range partition point scores NaN, never a silently
finite price.  Indices past the tables' width raise on the host before any
gather (torch raises where JAX would clamp).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.objective import Objective, is_default
from repro_torch.core.plan_tables import (
    EvalTables,
    PCOL_ACTIVE,
    PCOL_LAM,
    PCOL_Q,
    PCOL_S1,
    PCOL_S2,
    PCOL_SL,
    PCOL_U,
    PCOL_V,
    PCOL_WEIGHT,
    PKCOL_OVERLOAD,
    PKCOL_STATIC,
)
from repro_torch.core.planner import FCFS, DisciplineSpec, TenantSpec
from repro_torch.device import resolve_device
from repro_torch.hw.specs import Platform

__all__ = ["TorchPlanEvaluator"]

_WAIT_CAP = 1e12
_PENALTY_BASE = 1e9  # mirrors latency._PENALTY_BASE
_INF = float("inf")


def _tail_quantile(wq, rho, q):
    """torch port of ``queueing.wait_tail_quantile`` (same conventions)."""
    tail = (wq / rho) * torch.log(rho / (1.0 - q))
    tail = torch.where((1.0 - q) >= rho, 0.0, tail)
    tail = torch.where((rho >= 1.0) | torch.isinf(wq), _INF, tail)
    return torch.where((rho <= 0.0) | (wq <= 0.0), 0.0, tail)


def _exceed_prob(wq, rho, t):
    """torch port of ``queueing.wait_exceed_prob`` (same conventions)."""
    t = torch.clamp_min(t, 0.0)
    p = rho * torch.exp(-rho * t / wq)
    p = torch.where((wq <= 0.0) | ~torch.isfinite(wq), 0.0, p)
    p = torch.where((rho >= 1.0) | torch.isinf(wq), 1.0, p)
    return torch.where(rho <= 0.0, 0.0, p)


def _miss_prob(wt, rho_t, wc, rho_c, slack):
    """torch port of ``latency._miss_prob``: slack split across the TPU and
    CPU waits proportionally to their means, independence combine."""
    wsum = wt + wc
    ft = torch.where(wsum > 0.0, wt / wsum, 0.0)
    fc = torch.where(wsum > 0.0, wc / wsum, 0.0)
    sa = torch.where(ft > 0.0, slack * ft, 0.0)
    sb = torch.where(fc > 0.0, slack * fc, 0.0)
    pt = _exceed_prob(wt, rho_t, sa)
    pc = _exceed_prob(wc, rho_c, sb)
    miss = 1.0 - (1.0 - pt) * (1.0 - pc)
    return torch.where(slack < 0.0, 1.0, miss)


def _shared_alphas(A, lam, r, on, sram_bytes):
    """Eq. 10 per-tenant alphas ``[B, n]`` of the shared-cache regime."""
    shared = (
        (A[:, PCOL_WEIGHT] > sram_bytes)
        & (A[:, PCOL_ACTIVE] > 1.0)
        & (lam > 0.0)
    )
    safe_lam = torch.where(lam > 0.0, lam, 1.0)
    return torch.where(
        shared[:, None] & on,
        torch.clamp_min(1.0 - r / safe_lam[:, None], 0.0),
        0.0,
    )


def _slo(
    pstack, pkstack, rates, svc_tab, tl_tab, ix_tab, bnd_tab, s1c_tab,
    npoints, sram_bytes, deadlines,
    P, K,
    force_alpha_zero: bool, kind: str, q: float,
):
    """(value, overload) for B plans under a non-mean objective.

    The torch port of ``latency._batch_eval_slo``'s FCFS tail: per-tenant
    [B, n] gathers of the static pieces, the Eq. 10 per-tenant alphas, the
    Pollaczek-Khinchine wait, the M/D/k pool wait, then either the quantile
    latencies (``p_tail``) or the slack-split miss probabilities
    (``deadline_miss``).  Same float32 statistical-equivalence contract as
    the mean path.
    """
    n = P.shape[1]
    ti = torch.arange(n, device=P.device)
    A = pstack[ti, P].sum(dim=1)        # [B, 9]
    F = pkstack[ti, P, K].sum(dim=1)    # [B, 2]
    lam = A[:, PCOL_LAM]
    on = P > 0
    on_cpu = P < npoints[None, :]
    r_full = rates[None, :].expand(P.shape)
    r = torch.where(on, r_full, 0.0)
    svc = torch.where(on, svc_tab[ti, P], 0.0)
    tl = torch.where(on, tl_tab[ti, P], 0.0)

    if force_alpha_zero:
        alphas = torch.zeros_like(r)
    else:
        alphas = _shared_alphas(A, lam, r, on, sram_bytes)
    sl = (r * alphas * tl).sum(dim=-1)
    u = (r * alphas * tl * (2.0 * svc + tl)).sum(dim=-1)
    rho_tpu = A[:, PCOL_S1] + sl
    es2_num = A[:, PCOL_S2] + u
    tpu_wait = torch.where(
        rho_tpu >= 1.0, _INF, es2_num / (2.0 * (1.0 - rho_tpu))
    )
    swap_i = alphas * tl

    s1c = torch.where(on_cpu, s1c_tab[ti, P], 0.0)
    kf = K.to(svc.dtype)
    mu_one = torch.where(s1c > 0.0, 1.0 / torch.where(s1c > 0.0, s1c, 1.0), _INF)
    cap = kf * mu_one
    cpu_wait = 0.5 * (1.0 / (cap - r_full) - 1.0 / cap)
    cpu_wait = torch.where(r_full >= cap, _INF, cpu_wait)
    cpu_wait = torch.where((kf <= 0.0) | (mu_one <= 0.0), _INF, cpu_wait)
    cpu_wait = torch.where(r_full <= 0.0, 0.0, cpu_wait)
    cpu_wait = torch.where(on_cpu, cpu_wait, 0.0)
    rho_cpu = r_full * s1c / torch.clamp_min(kf, 1.0)

    static = (
        torch.where(on, ix_tab[None, :], 0.0)
        + svc
        + torch.where(on & on_cpu, bnd_tab[ti, P], 0.0)
        + s1c
    )
    wt = torch.where(on, tpu_wait[:, None], 0.0)
    if kind == "p_tail":
        tail_t = _tail_quantile(wt, rho_tpu[:, None], q)
        tail_c = _tail_quantile(cpu_wait, rho_cpu, q)
        vals = static + swap_i + tail_t + tail_c
    else:
        slack = deadlines[None, :] - static - swap_i
        vals = _miss_prob(wt, rho_tpu[:, None], cpu_wait, rho_cpu, slack)
    value = (r_full * vals).sum(dim=1)
    overload = torch.clamp_min(rho_tpu - 1.0, 0.0) + F[:, PKCOL_OVERLOAD]
    return value, overload


def _objective(
    pstack, pkstack, rates, svc_tab, tl_tab, sram_bytes,
    P, K,
    force_alpha_zero: bool, batches: bool, batch_cap: int, staleness: float,
):
    """(total, overload, extended) for B candidate plans; [B, n] int64 P/K.

    Gathers, per-tenant sums, and whichever aggregation tail the
    discipline flags select; ``extended`` tells whether the swap_batch
    tail ran its 540-sweep extension.
    """
    n = P.shape[1]
    ti = torch.arange(n, device=P.device)
    A = pstack[ti, P].sum(dim=1)        # [B, 9]
    F = pkstack[ti, P, K].sum(dim=1)    # [B, 2]
    lam = A[:, PCOL_LAM]
    S1 = A[:, PCOL_S1]
    S2 = A[:, PCOL_S2]
    zero_rate = (rates <= 0.0).any()
    zr_on_tpu = ((rates <= 0.0)[None, :] & (P > 0)).any(dim=1)

    if batches and not force_alpha_zero:
        # ---- swap_batch amortized tail --------------------------------
        on = P > 0
        r = torch.where(on, rates[None, :], 0.0)
        svc = torch.where(on, svc_tab[ti, P], 0.0)
        tl = torch.where(on, tl_tab[ti, P], 0.0)
        alphas = _shared_alphas(A, lam, r, on, sram_bytes)
        safe_lam = torch.where(lam > 0.0, lam, 1.0)
        p = torch.where(lam[:, None] > 0.0, r / safe_lam[:, None], 0.0)
        live = (alphas > 0.0) & (p < 1.0)
        p = torch.where(live, p, 0.0)
        aT = r * alphas * tl
        aU = aT * (2.0 * svc + tl)
        Bc = int(batch_cap)

        def sweep(wq):
            wq_e = wq[..., None]
            rw = r * wq_e
            ratio = torch.where(wq_e > 0.0, staleness / wq_e, _INF)
            fresh = 1.0 - torch.exp(-ratio)
            q = torch.where(live, fresh * rw / (1.0 + rw), 0.0)
            c = q + (1.0 - q) * p
            run = torch.where(
                c < 1.0,
                (1.0 - c**Bc) / (1.0 - c) + c ** (Bc - 1) * p / (1.0 - p),
                float(Bc) + p / (1.0 - p),
            )
            g = torch.where(live, 1.0 / ((1.0 - p) * run), 1.0)
            sl = (g * aT).sum(dim=-1)
            u = (g * aU).sum(dim=-1)
            rho = S1 + sl
            wq_next = torch.where(
                rho < 1.0, (S2 + u) / (2.0 * (1.0 - rho)), _WAIT_CAP
            )
            return wq_next, rho, g

        wq0, rho_opt, _ = sweep(torch.full_like(lam, _WAIT_CAP))
        wq = wq0
        for _ in range(60):
            wq = 0.5 * (wq + sweep(wq)[0])
        wait, rho, g = sweep(wq)

        # Relative residual: float32 never resolves the 1e-12 absolute
        # floor, so the effective tolerance is the 1e-6 relative part --
        # converged lanes sit at ~1e-7 relative after the damped loop.
        def resid_bad(f_wq, w):
            return torch.abs(f_wq - w) > (1e-12 + 1e-6 * torch.abs(w))

        diverged = resid_bad(wait, wq)
        extended = bool(diverged.any())
        if extended:
            for _ in range(9 * 60):
                wq = torch.where(diverged, 0.5 * (wq + sweep(wq)[0]), wq)
            wait_x, rho_x, g_x = sweep(wq)
            wait = torch.where(diverged, wait_x, wait)
            rho = torch.where(diverged, rho_x, rho)
            g = torch.where(diverged[..., None], g_x, g)
            still = resid_bad(wait, wq)
            # Period-2 orbits: unamortized FCFS fallback (g = 1).
            sl_f = aT.sum(dim=-1)
            u_f = aU.sum(dim=-1)
            rho_f = S1 + sl_f
            wait_f = torch.where(
                rho_f < 1.0, (S2 + u_f) / (2.0 * (1.0 - rho_f)), _INF
            )
            wait = torch.where(still, wait_f, wait)
            rho = torch.where(still, rho_f, rho)
            g = torch.where(still[..., None], 1.0, g)

        unstable = rho_opt >= 1.0
        wait = torch.where(
            unstable, _INF, torch.where(lam > 0.0, wait, 0.0)
        )
        alpha_eff = torch.where(live, g * alphas, alphas)
        swap_latency = (r * alpha_eff * tl).sum(dim=-1)
        total = F[:, PKCOL_STATIC] + lam * wait + swap_latency
        # Zero-rate NaN convention: a zero-rate tenant on an unstable TPU
        # queue contributes 0 * inf = NaN in the scalar per-tenant sum.
        total = torch.where(
            zero_rate & zr_on_tpu & torch.isinf(wait), torch.nan, total
        )
        overload = torch.clamp_min(rho - 1.0, 0.0) + F[:, PKCOL_OVERLOAD]
        return total, overload, extended

    # ---- FCFS tail ----------------------------------------------------
    if force_alpha_zero:
        swap_term = torch.zeros_like(lam)
        rho_tpu = S1
        es2_num = S2
    else:
        shared = (
            (A[:, PCOL_WEIGHT] > sram_bytes)
            & (A[:, PCOL_ACTIVE] > 1.0)
            & (lam > 0.0)
        )
        inv_lam = torch.where(shared, 1.0 / torch.where(lam > 0.0, lam, 1.0), 0.0)
        swap_term = (A[:, PCOL_SL] - A[:, PCOL_Q] * inv_lam) * shared
        rho_tpu = S1 + swap_term
        es2_num = S2 + (A[:, PCOL_U] - A[:, PCOL_V] * inv_lam) * shared

    tpu_wait = torch.where(
        rho_tpu >= 1.0, _INF, es2_num / (2.0 * (1.0 - rho_tpu))
    )
    total = F[:, PKCOL_STATIC] + lam * tpu_wait + swap_term
    total = torch.where(
        zero_rate & zr_on_tpu & torch.isinf(tpu_wait), torch.nan, total
    )
    overload = torch.clamp_min(rho_tpu - 1.0, 0.0) + F[:, PKCOL_OVERLOAD]
    return total, overload, False


@dataclasses.dataclass
class TorchPlanEvaluator:
    """Device-resident batched Eq. 5 evaluator for one (mix, rates) pair.

    Build once per re-plan (``EvalTables.to_torch()`` or
    ``TorchPlanEvaluator.build``); every ``*_batch`` call is then one
    gather/sum/aggregate pass on ``device``.  Rebuild when rates change,
    exactly like ``EvalTables`` itself (the transfer is a few kilobytes).
    ``extensions`` counts the calls whose swap_batch tail ran the 540-sweep
    extension.
    """

    et: EvalTables
    device: torch.device
    pstack: torch.Tensor     # [n, W, 9] float32
    pkstack: torch.Tensor    # [n, W, K+1, 2] float32
    rates: torch.Tensor      # [n] float32
    svc_tab: torch.Tensor    # [n, W] float32
    tl_tab: torch.Tensor     # [n, W] float32
    ix_tab: torch.Tensor     # [n] float32 input transfer (SLO objectives)
    bnd_tab: torch.Tensor    # [n, W] float32 boundary transfer
    s1c_tab: torch.Tensor    # [n, W] float32 one-core CPU suffix time
    npoints: torch.Tensor    # [n] int64 partition points per tenant
    extensions: int = 0

    @classmethod
    def from_tables(
        cls, et: EvalTables, device: "str | torch.device" = "cuda"
    ) -> "TorchPlanEvaluator":
        dev = resolve_device(device)

        def put(arr, dtype=torch.float32):
            return torch.as_tensor(np.asarray(arr), dtype=dtype, device=dev)

        return cls(
            et=et,
            device=dev,
            pstack=put(et.pstack),
            pkstack=put(et.pkstack),
            rates=put(et.rates),
            svc_tab=put(et.base.prefix_service),
            tl_tab=put(et.base.load),
            ix_tab=put(et.base.input_xfer),
            bnd_tab=put(et.base.boundary),
            s1c_tab=put(et.base.suffix1),
            npoints=put(et.base.num_points, torch.int64),
        )

    @classmethod
    def build(
        cls,
        tenants: Sequence[TenantSpec],
        platform: Platform,
        k_max: int,
        *,
        tables=None,
        device: "str | torch.device" = "cuda",
    ) -> "TorchPlanEvaluator":
        base = getattr(tables, "base", tables)
        et = (
            tables
            if isinstance(tables, EvalTables)
            and tables.matches(tenants, platform)
            else EvalTables.build(tenants, platform, k_max, base=base)
        )
        return cls.from_tables(et, device=device)

    def matches(
        self, tenants: Sequence[TenantSpec], platform: Platform | None = None
    ) -> bool:
        return self.et.matches(tenants, platform)

    def _indices(self, partitions, cores):
        """``[B, n]`` int64 P/K on the device, range-checked on the host."""
        P = np.asarray(partitions, dtype=np.int64)
        K = np.asarray(cores, dtype=np.int64)
        if P.ndim != 2 or P.shape != K.shape:
            raise ValueError(
                f"expected [B, n] partitions/cores, got {P.shape}/{K.shape}"
            )
        n, width, k_width = self.pkstack.shape[:3]
        if P.shape[1] != n:
            raise ValueError(f"expected {n} tenants per plan, got {P.shape[1]}")
        if P.size and (P.min() < 0 or P.max() >= width or K.min() < 0 or K.max() >= k_width):
            raise ValueError(
                f"partition points must lie in [0, {width - 1}] and cores "
                f"in [0, {k_width - 1}]"
            )
        return (
            torch.from_numpy(P).to(self.device),
            torch.from_numpy(K).to(self.device),
        )

    def _eval(
        self,
        partitions,
        cores,
        force_alpha_zero,
        discipline,
        objective=None,
        deadlines=None,
    ):
        P, K = self._indices(partitions, cores)
        if not is_default(objective):
            if discipline.batches:
                raise ValueError(
                    "TorchPlanEvaluator does not support SLO objectives under "
                    "batching disciplines; use the NumPy evaluator "
                    "(hill_climb without evaluator=)"
                )
            if deadlines is None:
                deadlines = np.full(self.rates.shape[0], np.inf)
            value, overload = _slo(
                self.pstack, self.pkstack, self.rates,
                self.svc_tab, self.tl_tab, self.ix_tab, self.bnd_tab,
                self.s1c_tab, self.npoints,
                float(self.et.sram_bytes),
                torch.as_tensor(np.asarray(deadlines, dtype=np.float32), device=self.device),
                P, K,
                force_alpha_zero=bool(force_alpha_zero),
                kind=objective.kind,
                q=float(objective.q),
            )
            return value, overload
        total, overload, extended = _objective(
            self.pstack, self.pkstack, self.rates, self.svc_tab, self.tl_tab,
            float(self.et.sram_bytes), P, K,
            force_alpha_zero=bool(force_alpha_zero),
            batches=bool(discipline.batches),
            batch_cap=int(discipline.batch_cap),
            staleness=float(discipline.staleness),
        )
        self.extensions += extended
        return total, overload

    def objective_batch(
        self,
        partitions,
        cores,
        *,
        force_alpha_zero: bool = False,
        discipline: DisciplineSpec = FCFS,
        objective: Objective | None = None,
        deadlines=None,
    ) -> np.ndarray:
        """Eq. 5 objective for B plans; float32 on the device, float64 out."""
        total, _ = self._eval(
            partitions, cores, force_alpha_zero, discipline, objective,
            deadlines,
        )
        return total.cpu().numpy().astype(np.float64)

    def penalized_objective_batch(
        self,
        partitions,
        cores,
        *,
        force_alpha_zero: bool = False,
        discipline: DisciplineSpec = FCFS,
        objective: Objective | None = None,
        deadlines=None,
    ) -> np.ndarray:
        """Batched ``latency.penalized_objective`` under the statistical
        contract: infeasible plans priced at ``_PENALTY_BASE * (1 +
        overload)``, exactly the NumPy convention.

        ``objective=`` selects the opt-in SLO objectives (``deadlines``
        carries the per-tenant budget vector for ``deadline_miss`` -- the
        evaluator holds tables, not tenant specs); the ``None`` default is
        the pinned mean path.
        """
        total, overload = self._eval(
            partitions, cores, force_alpha_zero, discipline, objective,
            deadlines,
        )
        total = total.cpu().numpy().astype(np.float64)
        overload = overload.cpu().numpy().astype(np.float64)
        feasible = (overload == 0.0) & np.isfinite(total)
        return np.where(feasible, total, _PENALTY_BASE * (1.0 + overload))
