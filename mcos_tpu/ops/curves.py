"""Deterministic interest-rate term structures (piecewise-flat forward
curves).

The reference prices everything at one flat rate (engine/config.py:15,
r=6.5%); a desk discounts off a curve (for NIFTY: the NSE MIBOR/OIS strip).
Because the model's short rate is deterministic, curve support is *exact*
without touching the simulation kernels:

- **European / terminal payoffs**: only ∫₀ᵀ r dt enters (drift and
  discount), so pricing at the flat equivalent rate r_eff(T) = R(T)/T is
  exact — the engines substitute params.r per maturity.
- **Path-dependent / American**: the deterministic drift commutes with the
  multiplicative dynamics. Simulate at flat r̄, then shift the recorded
  log-spot sheet by the cumulative drift correction
      off(t_k) = R(t_k) − r̄·t_k       (S_curve = S_flat · e^{off}),
  and discount the backward induction with per-step factors
  exp(−∫_{t_k}^{t_{k+1}} r dt) instead of a constant. Both are (steps,)
  host-precomputed vectors; the scan kernels are unchanged
  (engine/american.py consumes them like the dividend grids).

All arithmetic is host f64 (tiny, precision-critical work).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["RateCurve"]


class RateCurve:
    """Piecewise-flat instantaneous forward curve r(t).

    Args:
        times: knot ends (year fractions), strictly increasing, > 0.
        rates: forward rate on [t_{i−1}, t_i) (t₋₁ = 0); the last rate
            extends flat beyond the final knot.

    Static configuration (hashable), like strikes or dividend schedules.
    """

    __slots__ = ("times", "rates")

    def __init__(self, times: Sequence[float], rates: Sequence[float]):
        t = tuple(float(x) for x in times)
        r = tuple(float(x) for x in rates)
        if not t or len(t) != len(r):
            raise ValueError(
                f"need equal, nonzero knot counts (got {len(t)} times, "
                f"{len(r)} rates)")
        if any(x <= 0.0 for x in t):
            raise ValueError("curve times must be > 0")
        if any(t[i] >= t[i + 1] for i in range(len(t) - 1)):
            raise ValueError("curve times must be strictly increasing")
        self.times = t
        self.rates = r

    @classmethod
    def flat(cls, r: float) -> "RateCurve":
        return cls([1.0], [r])

    def __eq__(self, other) -> bool:
        return (isinstance(other, RateCurve) and self.times == other.times
                and self.rates == other.rates)

    def __hash__(self) -> int:
        return hash((self.times, self.rates))

    def __repr__(self) -> str:
        knots = ", ".join(f"{t:.4g}:{r:.4%}"
                          for t, r in zip(self.times, self.rates))
        return f"RateCurve({knots})"

    # -- curve calculus ---------------------------------------------------------
    def rate(self, t: float) -> float:
        """Instantaneous forward rate at time t."""
        for knot, r in zip(self.times, self.rates):
            if t < knot:
                return r
        return self.rates[-1]

    def integral(self, T: float) -> float:
        """R(T) = ∫₀ᵀ r(t) dt."""
        if T <= 0.0:
            return 0.0
        total, prev = 0.0, 0.0
        for knot, r in zip(self.times, self.rates):
            if T <= knot:
                return total + r * (T - prev)
            total += r * (knot - prev)
            prev = knot
        return total + self.rates[-1] * (T - prev)

    def r_eff(self, T: float) -> float:
        """Flat-equivalent zero rate R(T)/T — exact for terminal payoffs."""
        if T <= 0.0:
            return self.rates[0]
        return self.integral(T) / T

    def discount(self, T: float) -> float:
        return float(np.exp(-self.integral(T)))

    # -- simulation-grid vectors (host-precomputed, kernels unchanged) ----------
    def grid_integrals(self, T: float, num_steps: int) -> np.ndarray:
        """(num_steps,) cumulative R(t_k) at t_k = k·T/n, k = 1..n."""
        dt = float(T) / num_steps
        return np.array([self.integral(dt * (k + 1))
                         for k in range(num_steps)], np.float64)

    def grid_log_offsets(self, T: float, num_steps: int,
                         r_flat: float) -> np.ndarray:
        """(num_steps,) log-spot corrections R(t_k) − r_flat·t_k for a path
        sheet simulated at the flat rate r_flat."""
        dt = float(T) / num_steps
        cum = self.grid_integrals(T, num_steps)
        flat = r_flat * dt * np.arange(1, num_steps + 1, dtype=np.float64)
        return (cum - flat).astype(np.float32)

    def grid_step_dfs(self, T: float, num_steps: int) -> np.ndarray:
        """(num_steps,) per-step discount factors
        exp(−∫_{t_{k−1}}^{t_k} r dt), k = 1..n (t₀ = 0)."""
        cum = np.concatenate([[0.0], self.grid_integrals(T, num_steps)])
        return np.exp(-np.diff(cum)).astype(np.float32)
