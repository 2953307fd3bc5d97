"""Rate forecasting for predictive re-planning.

The adaptive controller (``run_adaptive`` / ``run_adaptive_fleet``) is
reactive by default: every re-plan scores the plan space against the
sliding-window rate estimate, so a plan switch lands one window *after*
the traffic that needed it.  The MMPP and diurnal scenarios in
``workload.py`` are forecastable, and the forecasters here close that gap:
at each re-plan boundary the controller feeds the forecaster the fresh
rate estimate and, when the forecaster is warmed up, plans against the
*predicted* rate vector one re-plan horizon ahead instead of the trailing
estimate -- the plan switch lands before the burst, not after (the
model-driven resource-management discipline of Liang et al. 2201.07312).

Contract (``RateForecaster``): ``observe(now, rates)`` ingests one rate
sample per re-plan boundary; ``forecast(now, horizon)`` returns the
predicted per-model rate vector at ``now + horizon``, or ``None`` while
the forecaster cannot commit to a prediction yet -- the controller falls
back to the reactive estimate for exactly that boundary, so a forecaster
that always returns ``None`` replays the reactive controller bitwise
(``benchmarks/predictive.py`` self-checks this before timing anything).

Everything here is opt-in: ``run_adaptive(forecaster=None)`` (the
default) never imports or touches this module's state.
"""
from __future__ import annotations

import math
from typing import Callable, Protocol, Sequence, runtime_checkable


@runtime_checkable
class RateForecaster(Protocol):
    """Duck-typed forecaster surface the adaptive controllers consume."""

    def observe(self, now: float, rates: Sequence[float]) -> None:
        """Ingest the rate estimate evaluated at time ``now``."""

    def forecast(self, now: float, horizon: float) -> list[float] | None:
        """Predicted rates at ``now + horizon``; ``None`` = not warmed up."""


def _clamped(rates: Sequence[float]) -> list[float]:
    """Forecasts are rate vectors: negative extrapolations clamp to idle."""
    return [max(0.0, float(r)) for r in rates]


class EwmaTrendForecaster:
    """Per-model EWMA level + trend (Holt's linear method, time-aware).

    Each observation ``(t, x_i)`` updates model i's level ``l_i`` and
    per-second trend ``b_i``::

        pred  = l_i + b_i * dt
        l_i'  = alpha * x_i + (1 - alpha) * pred
        b_i'  = beta * (l_i' - l_i) / dt + (1 - beta) * b_i

    with ``dt`` the elapsed time since the previous sample (the controller
    samples at re-plan boundaries, so ``dt`` is usually the re-plan
    period, but irregular boundaries are handled).  The forecast at
    ``now + horizon`` extrapolates ``l_i + b_i * (now + horizon - t_last)``
    and clamps at zero.  On a noiseless linear ramp the trend converges to
    the true slope (pinned by ``tests/test_predictive.py``); on an MMPP
    step the trailing-window estimate starts rising as soon as the burst
    enters the window and the trend term extrapolates the rise, landing
    the plan switch roughly one re-plan period before the reactive
    controller's.

    ``forecast`` returns ``None`` until two samples have been observed
    (no trend exists yet), so the leading boundaries replay the reactive
    controller exactly.
    """

    def __init__(
        self, n_models: int, *, alpha: float = 0.5, beta: float = 0.3
    ):
        if not 0.0 < alpha <= 1.0 or not 0.0 < beta <= 1.0:
            raise ValueError("alpha and beta must lie in (0, 1]")
        self.alpha = alpha
        self.beta = beta
        self.level = [0.0] * n_models
        self.trend = [0.0] * n_models
        self._t_last = 0.0
        self._n_obs = 0

    def observe(self, now: float, rates: Sequence[float]) -> None:
        if len(rates) != len(self.level):
            raise ValueError(
                f"rate vector has {len(rates)} models, forecaster "
                f"{len(self.level)}"
            )
        if self._n_obs == 0:
            self.level = [float(r) for r in rates]
            self._t_last = now
            self._n_obs = 1
            return
        dt = now - self._t_last
        if dt <= 0.0:
            # Re-observation at the same instant: refresh the level only
            # (no time elapsed to attribute a trend to).
            a = self.alpha
            self.level = [
                a * float(x) + (1.0 - a) * l
                for x, l in zip(rates, self.level)
            ]
            return
        a, b = self.alpha, self.beta
        for i, x in enumerate(rates):
            pred = self.level[i] + self.trend[i] * dt
            new_level = a * float(x) + (1.0 - a) * pred
            self.trend[i] = (
                b * (new_level - self.level[i]) / dt
                + (1.0 - b) * self.trend[i]
            )
            self.level[i] = new_level
        self._t_last = now
        self._n_obs += 1

    def forecast(self, now: float, horizon: float) -> list[float] | None:
        if self._n_obs < 2:
            return None
        ahead = (now - self._t_last) + horizon
        return _clamped(
            l + b * ahead for l, b in zip(self.level, self.trend)
        )


class PeriodicForecaster:
    """Binned periodic rate profile for diurnal (cyclical) traffic.

    The period is divided into ``n_bins`` equal bins; each observation is
    accumulated into the bin of ``now mod period`` and the forecast at
    ``now + horizon`` answers with the running mean of the target time's
    bin.  A target bin with no samples yet returns ``None`` (reactive
    fallback), so the first cycle of a diurnal trace runs reactively and
    every later cycle re-plans against the profile learned from the
    earlier ones -- recurring daily states are anticipated, not chased.

    On a noiseless periodic rate signal sampled at a fixed cadence the
    recovered profile equals the per-bin mean of the signal exactly
    (pinned by ``tests/test_predictive.py``).
    """

    def __init__(self, n_models: int, period: float, *, n_bins: int = 48):
        if period <= 0:
            raise ValueError("period must be positive")
        if n_bins < 1:
            raise ValueError("n_bins must be >= 1")
        self.period = float(period)
        self.n_bins = int(n_bins)
        self._sum = [[0.0] * n_models for _ in range(self.n_bins)]
        self._count = [0] * self.n_bins

    def _bin(self, t: float) -> int:
        frac = (t % self.period) / self.period
        return min(int(frac * self.n_bins), self.n_bins - 1)

    def observe(self, now: float, rates: Sequence[float]) -> None:
        b = self._bin(now)
        acc = self._sum[b]
        if len(rates) != len(acc):
            raise ValueError(
                f"rate vector has {len(rates)} models, forecaster "
                f"{len(acc)}"
            )
        for i, r in enumerate(rates):
            acc[i] += float(r)
        self._count[b] += 1

    def profile(self, bin_idx: int) -> list[float] | None:
        """Learned mean rate vector of one bin (``None`` if unseen)."""
        c = self._count[bin_idx]
        if c == 0:
            return None
        return [s / c for s in self._sum[bin_idx]]

    def forecast(self, now: float, horizon: float) -> list[float] | None:
        prof = self.profile(self._bin(now + horizon))
        return None if prof is None else _clamped(prof)


class OracleForecaster:
    """Perfect-knowledge forecaster: wraps the true rate function.

    ``fn(t)`` must return the per-model rate vector at absolute time
    ``t``.  Used by tests and benchmarks to bound what forecasting can
    buy -- predictive re-planning with an oracle is the headroom any
    learned forecaster is chasing.
    """

    def __init__(self, fn: Callable[[float], Sequence[float]]):
        self._fn = fn

    def observe(self, now: float, rates: Sequence[float]) -> None:
        pass

    def forecast(self, now: float, horizon: float) -> list[float] | None:
        return _clamped(self._fn(now + horizon))


class NeverForecaster:
    """Forecaster that never commits: every boundary falls back reactive.

    Exists to pin the fallback contract -- ``run_adaptive(forecaster=
    NeverForecaster())`` must replay ``run_adaptive()`` bitwise (the
    benchmark self-check and ``tests/test_predictive.py`` both use it).
    """

    def observe(self, now: float, rates: Sequence[float]) -> None:
        pass

    def forecast(self, now: float, horizon: float) -> None:
        return None


def piecewise_rate_fn(
    phases: Sequence,  # Sequence[workload.RatePhase]
) -> Callable[[float], tuple[float, ...]]:
    """True rate function of a ``dynamic_trace`` phase list, for oracles.

    Times before the first phase answer with the first phase's rates,
    past the last with the last's (the controller may probe one horizon
    beyond the trace end).
    """
    if not phases:
        raise ValueError("phases must not be empty")

    def fn(t: float) -> tuple[float, ...]:
        for ph in phases:
            if t < ph.end:
                return tuple(ph.rates)
        return tuple(phases[-1].rates)

    return fn


__all__ = [
    "EwmaTrendForecaster",
    "NeverForecaster",
    "OracleForecaster",
    "PeriodicForecaster",
    "RateForecaster",
    "piecewise_rate_fn",
]
