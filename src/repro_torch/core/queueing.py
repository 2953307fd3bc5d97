"""Queueing primitives from the paper's analytic model (Section III-B).

* TPU: single unified M/G/1/FCFS queue; expected wait via Pollaczek-Khinchine
  (Eq. 1) with the effective service time the lambda-weighted mixture over
  model prefixes including inter-model swap latency (Eq. 2).
* CPU: per-model M/D/k queues with dedicated cores (Eq. 3).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Mg1Metrics:
    """Per-term M/G/1 predictions (Eq. 1 decomposed for validation).

    ``benchmarks/model_vs_sim.py`` and the differential DES tests compare
    each term against its simulated observable: ``rho`` against busy-time /
    duration, ``wait`` against mean time-in-queue, ``sojourn`` against mean
    wait + service, ``queue_len`` (Little's law, ``lam * sojourn``) against
    the time-averaged number in system.
    """

    rho: float
    wait: float
    sojourn: float
    queue_len: float


def mg1_metrics(lam: float, es: float, es2: float) -> Mg1Metrics:
    """All M/G/1 steady-state predictions the simulators can observe.

    Same inputs and stability semantics as ``mg1_wait`` (unstable queues
    report ``inf`` waits); ``rho`` is reported even when >= 1.
    """
    wait = mg1_wait(lam, es, es2)
    sojourn = wait + es if lam > 0.0 else es
    return Mg1Metrics(
        rho=lam * es,
        wait=wait,
        sojourn=sojourn,
        queue_len=lam * sojourn,
    )


def mg1_wait(lam: float, es: float, es2: float) -> float:
    """Pollaczek-Khinchine expected queueing delay for an M/G/1/FCFS queue.

    Args:
      lam: aggregate Poisson arrival rate (1/s).
      es: E[S], mean service time (s).
      es2: E[S^2], second moment of service time (s^2).

    Returns:
      E[W] in seconds; ``inf`` if the queue is unstable (rho >= 1).
    """
    if lam <= 0.0:
        return 0.0
    rho = lam * es
    if rho >= 1.0:
        return math.inf
    return lam * es2 / (2.0 * (1.0 - rho))


def mdk_wait(lam: float, mu: float, k: int) -> float:
    """Approximate expected queueing delay for an M/D/k queue (Eq. 3).

    E[W] ~= 1/2 * (1/(k*mu - lam) - 1/(k*mu))  -- i.e. half the M/M/1-style
    wait of a pooled server, halved for deterministic service.
    """
    if lam <= 0.0:
        return 0.0
    if k <= 0 or mu <= 0:
        return math.inf
    cap = k * mu
    if lam >= cap:
        return math.inf
    return 0.5 * (1.0 / (cap - lam) - 1.0 / cap)


def mg1_wait_batch(lam: np.ndarray, es: np.ndarray, es2: np.ndarray) -> np.ndarray:
    """Broadcasting Pollaczek-Khinchine wait; element-wise ``mg1_wait``.

    Any shape; unstable entries (rho >= 1) come back ``inf``, empty queues
    (lam <= 0) come back 0, mirroring the scalar branch structure exactly.
    """
    lam = np.asarray(lam, dtype=np.float64)
    rho = lam * es
    with np.errstate(divide="ignore", invalid="ignore"):
        wait = lam * es2 / (2.0 * (1.0 - rho))
    wait = np.where(rho >= 1.0, np.inf, wait)
    return np.where(lam <= 0.0, 0.0, wait)


def mdk_wait_batch(lam: np.ndarray, mu: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Broadcasting M/D/k wait approximation; element-wise ``mdk_wait``.

    ``mu`` may be ``inf`` (zero service time): the pooled capacity is then
    infinite and the wait collapses to 0, as in the scalar version.
    """
    lam = np.asarray(lam, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        cap = k * mu  # k=0 with mu=inf -> nan; masked by the k<=0 branch below
        wait = 0.5 * (1.0 / (cap - lam) - 1.0 / cap)
    wait = np.where(lam >= cap, np.inf, wait)
    wait = np.where((k <= 0) | (mu <= 0), np.inf, wait)
    return np.where(lam <= 0.0, 0.0, wait)


def wait_exceed_prob(wq, rho, t):
    """P(W > t) for an M/G/1-style queueing delay, exponential-tail model.

    The waiting time has an atom at zero of mass ``1 - rho``; the
    conditional wait is approximated as exponential with mean ``wq / rho``
    (the exact conditional mean), so

        P(W > t) ~= rho * exp(-rho * t / wq)          for t >= 0.

    This is exact for M/M/1 and a standard light-tail approximation for
    M/G/1 (the same model the ``swap_batch_amortization`` staleness bracket
    uses).  ``benchmarks/model_vs_sim.py`` maps where it breaks against the
    DES ground truth.

    Broadcasting element-wise over any shapes.  Conventions:

    * ``rho <= 0`` (idle queue) -> 0.
    * ``rho >= 1`` or ``wq`` infinite (unstable) -> 1.
    * ``wq <= 0`` with ``0 < rho < 1`` (degenerate zero wait) -> 0.
    * ``t < 0`` is clamped to 0, so the result at ``t <= 0`` is ``rho``
      (the probability of waiting at all).
    """
    wq = np.asarray(wq, dtype=np.float64)
    rho = np.asarray(rho, dtype=np.float64)
    t = np.maximum(np.asarray(t, dtype=np.float64), 0.0)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        p = rho * np.exp(-rho * t / wq)
    p = np.where((wq <= 0.0) | ~np.isfinite(wq), 0.0, p)
    p = np.where((rho >= 1.0) | np.isinf(wq), 1.0, p)
    return np.where(rho <= 0.0, 0.0, p)


def wait_tail_quantile(wq, rho, q):
    """q-th quantile of the queueing delay under the same tail model.

    Inverting ``wait_exceed_prob``: the quantile is 0 while the zero atom
    covers it (``1 - q >= rho``), else

        W(q) = (wq / rho) * ln(rho / (1 - q)).

    Broadcasting element-wise.  Unstable entries (``rho >= 1`` or infinite
    ``wq``) return ``inf``; idle or degenerate queues (``rho <= 0`` or
    ``wq <= 0``) return 0, mirroring ``wait_exceed_prob``'s conventions.
    """
    wq = np.asarray(wq, dtype=np.float64)
    rho = np.asarray(rho, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        tail = (wq / rho) * np.log(rho / (1.0 - q))
    tail = np.where((1.0 - q) >= rho, 0.0, tail)
    tail = np.where((rho >= 1.0) | np.isinf(wq), np.inf, tail)
    return np.where((rho <= 0.0) | (wq <= 0.0), 0.0, tail)


# Finite stand-in for an infinite queueing delay inside the swap-batch
# fixed-point iteration (damping with a literal inf would poison the
# average); any real wait is astronomically below this.
_WAIT_CAP = 1e12


def swap_batch_amortization(
    lam,
    s1,
    s2,
    rates,
    alphas,
    t_load,
    service,
    batch_cap: int,
    *,
    staleness: float = math.inf,
    iters: int = 60,
):
    """Batch-amortized M/G/1 swap model: the Eq. 1/Eq. 2 generalization for
    the ``swap_batch`` TPU discipline (``repro_torch.serving.scheduling``).

    Under FCFS every inter-model switch pays ``T_load`` and tenant i's
    switch-in probability is the Eq. 10 ``alpha_i``.  ``swap_batch`` keeps
    serving the resident tenant while (a) the same-tenant run is shorter
    than ``batch_cap`` and (b) a same-tenant request is queued, so the
    probability that a service *continues* tenant i's run is

        c_i = q_i + (1 - q_i) * p_i

    where ``p_i = r_i / lam`` is the FCFS natural continuation (the next
    head happens to be the same tenant -- all a cap-1 scheduler gets) and
    ``q_i`` is the probability a same-tenant request is queued at the
    completion *and* the staleness bound still allows an extension.
    Availability comes from Little's law on the queue: with ``N_i^q``
    approximately geometric with mean ``r_i * W_q``,

        q_i = [1 - exp(-staleness / W_q)] * r_i W_q / (1 + r_i W_q)

    -- the bracket is the probability the global head has waited less than
    ``staleness`` under the M/G/1 wait's exponential tail approximation
    (exactly 1 at the default ``staleness = inf``, so the unthrottled model
    is untouched; a staleness far below ``W_q`` collapses the model to
    FCFS, matching the discipline whose runs the bound keeps breaking).

    Mean run length (extensions capped at ``batch_cap``, natural FCFS
    continuation beyond it uncapped, exactly as the discipline behaves):

        E[L_i] = (1 - c_i^B) / (1 - c_i)  +  c_i^(B-1) p_i / (1 - p_i)

    and the amortized switch-in probability is ``alpha_i^B = alpha_i *
    g_i`` with ``g_i = 1 / ((1 - p_i) E[L_i])`` -- ``g_i = 1`` exactly at
    ``B = 1`` or an empty queue (checks: both limits collapse ``E[L_i]`` to
    the FCFS run length ``1/(1 - p_i)``), decaying toward ``1 / (B (1 -
    p_i) + p_i)`` under backlog.  The amortized swap sums feed back into
    Pollaczek-Khinchine, and ``W_q`` is the fixed point of that loop
    (amortization lengthens with queueing, queueing shrinks with
    amortization): a damped iteration from the optimistic end, which both
    the scalar and the batched evaluator run with identical formulas and
    iteration count so the two stay within round-off of each other.  At the
    ``iters`` cap the residual is checked explicitly; elements where the
    damped sweep failed to close (a period-2 orbit appears near saturation,
    where the decreasing map's slope passes -3) fall back to the
    unamortized FCFS swap term -- see the inline note at the check.

    Array contract: per-tenant inputs (``rates``/``alphas``/``t_load``/
    ``service``) reduce along their last axis; ``lam``/``s1``/``s2`` are
    the matching leading shape (scalars for one plan, ``[B]`` against
    ``[B, n]`` for a batch of plans).  ``s1``/``s2`` are the *swap-free*
    aggregate moments ``sum r_i s_i`` and ``sum r_i s_i^2``.

    Returns ``(wait, rho, alpha_eff)``: the amortized queueing delay (inf
    when unstable even at full amortization), the amortized utilization,
    and the per-tenant effective switch-in probabilities.
    """
    lam = np.asarray(lam, dtype=np.float64)
    s1 = np.asarray(s1, dtype=np.float64)
    s2 = np.asarray(s2, dtype=np.float64)
    rates = np.asarray(rates, dtype=np.float64)
    alphas = np.asarray(alphas, dtype=np.float64)
    t_load = np.asarray(t_load, dtype=np.float64)
    service = np.asarray(service, dtype=np.float64)
    B = int(batch_cap)

    lam_e = lam[..., None]
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(lam_e > 0.0, rates / lam_e, 0.0)
    # A tenant with alpha = 0 never pays a switch-in; its g is irrelevant
    # and p -> 1 (single active tenant) would otherwise produce 0 * inf.
    live = (alphas > 0.0) & (p < 1.0)
    p = np.where(live, p, 0.0)
    aT = rates * alphas * t_load                 # switch-rate summand
    aU = aT * (2.0 * service + t_load)           # E[S^2] swap summand

    def sweep(wq):
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            wq_e = wq[..., None]
            rw = rates * wq_e
            # P(head fresh enough to let the run extend): exactly 1.0 at
            # staleness=inf (exp(-inf) == 0, and 1.0 * q == q bitwise), and
            # exp(-inf) == 0 again at wq == 0 (idle queue, nothing queued).
            fresh = 1.0 - np.exp(
                -np.divide(staleness, wq_e, where=wq_e > 0.0,
                           out=np.full_like(wq_e, np.inf))
            )
            q = np.where(live, fresh * rw / (1.0 + rw), 0.0)
            c = q + (1.0 - q) * p
            run = np.where(
                c < 1.0,
                (1.0 - c**B) / (1.0 - c) + c ** (B - 1) * p / (1.0 - p),
                # c -> 1 limit: the geometric sum tends to B and the
                # natural-continuation tail to p/(1-p) (p < 1 for live
                # tenants) -- dropping the tail would overstate the
                # amortized swap term by up to (1-p)B : (1-p)B + p.
                float(B) + p / (1.0 - p),
            )
            g = np.where(live, 1.0 / ((1.0 - p) * run), 1.0)
            sl = (g * aT).sum(axis=-1)
            u = (g * aU).sum(axis=-1)
            rho = s1 + sl
            wq_next = np.where(
                rho < 1.0, (s2 + u) / (2.0 * (1.0 - rho)), _WAIT_CAP
            )
        return wq_next, rho, g

    # Start from the large-backlog limit.  With staleness = inf that is the
    # point of maximal amortization, so "unstable even there" means
    # unstable, full stop; with finite staleness a huge backlog instead
    # collapses amortization toward FCFS (the head is always stale), which
    # is again exactly the regime whose rho decides stability.
    wq, rho_opt, _ = sweep(np.broadcast_to(_WAIT_CAP, lam.shape).astype(float))
    for _ in range(iters):
        wq_next, _, _ = sweep(wq)
        wq = 0.5 * (wq + wq_next)
    wait, rho, g = sweep(wq)
    # Explicit convergence check at the iteration cap.  The sweep map is
    # *decreasing* in wq (a longer backlog amortizes more, which shortens
    # the wait), so the damped iterate h(w) = (w + f(w)) / 2 is contractive
    # only while f' > -3; near saturation f' can approach and pass that and
    # the orbit either converges too slowly for the cap or settles into a
    # genuine period-2 cycle, where every reported value is an artifact of
    # the iteration count.  Converged elements (every input outside a thin
    # near-saturation shell) sit at float-epsilon residual after the damped
    # loop, far inside the tolerance, and stay bitwise untouched by all of
    # the handling below (updates are masked ``np.where`` writes and each
    # element's iteration count depends only on its own values, so the
    # batch == scalar invariant survives every branch).
    resid_bad = lambda f_wq, w: np.abs(f_wq - w) > (1e-12 + 1e-6 * np.abs(w))
    diverged = resid_bad(wait, wq)
    if np.any(diverged):
        # Slow-but-contractive elements (|h'| just under 1) close with a
        # deterministic extension budget; lanes already converged are frozen
        # by the mask, so their values never move.
        for _ in range(9 * iters):
            wq_next, _, _ = sweep(wq)
            wq = np.where(diverged, 0.5 * (wq + wq_next), wq)
        wait_x, rho_x, g_x = sweep(wq)
        wait = np.where(diverged, wait_x, wait)
        rho = np.where(diverged, rho_x, rho)
        g = np.where(diverged[..., None], g_x, g)
        diverged = resid_bad(wait, wq)
    if np.any(diverged):
        # Genuine non-convergence (a period-2 orbit): fall back to the
        # *unamortized* swap term (g = 1, the plain FCFS Eq. 1/Eq. 10
        # moments).  Amortization can only shorten the wait, so this is a
        # safe conservative price -- it may report inf for a queue that
        # batching would just barely stabilize, which is preferable to an
        # oscillation artifact that depends on the iteration cap.
        sl_f = aT.sum(axis=-1)
        u_f = aU.sum(axis=-1)
        rho_f = s1 + sl_f
        with np.errstate(divide="ignore", invalid="ignore"):
            wait_f = np.where(
                rho_f < 1.0, (s2 + u_f) / (2.0 * (1.0 - rho_f)), np.inf
            )
        wait = np.where(diverged, wait_f, wait)
        rho = np.where(diverged, rho_f, rho)
        g = np.where(diverged[..., None], 1.0, g)
    unstable = rho_opt >= 1.0
    wait = np.where(unstable, np.inf, np.where(lam > 0.0, wait, 0.0))
    return wait, rho, np.where(live, g * alphas, alphas)


def mixture_moments(weights: list[float], values: list[float]) -> tuple[float, float]:
    """First and second moments of a discrete mixture distribution.

    ``weights`` need not be normalized; each request class i has a
    *deterministic* service time ``values[i]`` and probability proportional
    to ``weights[i]`` -- the TPU service distribution of Eq. 2.
    """
    tot = sum(weights)
    if tot <= 0.0:
        return 0.0, 0.0
    m1 = sum(w * v for w, v in zip(weights, values)) / tot
    m2 = sum(w * v * v for w, v in zip(weights, values)) / tot
    return m1, m2


def mixture_moments_batch(
    weights: np.ndarray, values: np.ndarray, axis: int = -1
) -> tuple[np.ndarray, np.ndarray]:
    """Batched ``mixture_moments``: reduce the atom axis of stacked mixtures.

    ``weights`` and ``values`` broadcast against each other; mixtures whose
    total weight is <= 0 get (0, 0), matching the scalar guard.
    """
    weights = np.asarray(weights, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    tot = weights.sum(axis=axis)
    with np.errstate(divide="ignore", invalid="ignore"):
        m1 = (weights * values).sum(axis=axis) / tot
        m2 = (weights * values * values).sum(axis=axis) / tot
    ok = tot > 0.0
    return np.where(ok, m1, 0.0), np.where(ok, m2, 0.0)
