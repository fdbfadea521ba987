"""Discrete dividend support: schedules, escrowed/proportional adjustments,
and the exact compounded-cash path model.

The reference carries only a continuous dividend *yield* `q`
(reference: engine/config.py:16, engine/models.py:25-28) — fine for index
options, wrong for single-stock options around ex-dates (NSE stock options
are a large share of the reference's 50-symbol universe, js/stocks.js:2-53).
This module adds discrete dividends as a *payoff/measure-layer* transform so
the simulation kernels (ops/simulate.py, ops/draws_kernel.py) stay
untouched — no dynamics change, no scan/Pallas twin obligation.

Three models, each exact in its own terms:

1. **Proportional dividends** (`kind="proportional"`): at ex-date t_i the
   spot drops by a fraction d_i. Under any multiplicative dynamics
   (GBM/SVJ/QE — the spot enters only via log-increments) this commutes with
   the path:   S_div(t) = S_model(t) · Π_{t_i ≤ t} (1 − d_i).
   European pricing with spot S₀·Π(1−d_i) is therefore *exact*; path sheets
   are adjusted by a deterministic per-date factor.

2. **Escrowed cash** (`dividend_model="escrowed"`): the classic desk model —
   run the dynamics on X₀ = S₀ − PV_r(dividends) and treat X as the risky
   part. European pricing = price(X₀) with the unchanged engine. An
   approximation (the vol applies to X, not S), universally used and clearly
   labelled in responses.

3. **Compounded cash** (`dividend_model="path"`): the exact discrete-cash
   model for path-dependent/American pricing. With M(t) the multiplicative
   model path (M(0)=1),

       S_div(t) = M(t) · (S₀ − Σ_{t_i ≤ t} D_i / M(t_i))
                = S_model(t) · (1 − Σ_{t_i ≤ t} D_i / S_model(t_i)),

   which drops by *exactly* D_i at each ex-date (the Σ term picks up
   D_i/M(t_i), scaled back by M(t_i)) and grows multiplicatively between.
   Its forward is closed-form,

       F_div(T) = S₀ e^{(r−q)T} − Σ_{t_i ≤ T} D_i e^{(r−q)(T−t_i)},

   an exact martingale oracle the tests pin MC against. The adjustment needs
   only the *recorded* path values at ex-dates — a cumulative sum over the
   date axis of an existing (dates, paths) sheet (engine/american.py).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "DividendSchedule",
    "pv_cash",
    "proportional_factor",
    "effective_spot",
    "forward_with_dividends",
    "cash_to_proportional",
]


class DividendSchedule:
    """An immutable, host-side discrete dividend schedule.

    Args:
        times: ex-dividend dates in year fractions, strictly positive and
            strictly increasing.
        amounts: cash amounts (same currency as spot) for ``kind="cash"``,
            or fractional drops in (0, 1) for ``kind="proportional"``.
        kind: "cash" | "proportional".

    The schedule is static configuration (like strikes/steps), not a traced
    value: engines hash it into jit static state and memo keys.
    """

    __slots__ = ("times", "amounts", "kind")

    def __init__(self, times: Sequence[float], amounts: Sequence[float],
                 kind: str = "cash"):
        t = tuple(float(x) for x in times)
        a = tuple(float(x) for x in amounts)
        if len(t) != len(a):
            raise ValueError(
                f"dividend times ({len(t)}) and amounts ({len(a)}) differ")
        if any(x <= 0.0 for x in t):
            raise ValueError("dividend times must be > 0 (year fractions)")
        if any(t[i] >= t[i + 1] for i in range(len(t) - 1)):
            raise ValueError("dividend times must be strictly increasing")
        if kind not in ("cash", "proportional"):
            raise ValueError(f"unknown dividend kind: {kind!r}")
        if kind == "proportional" and any(not 0.0 < x < 1.0 for x in a):
            raise ValueError("proportional dividends must lie in (0, 1)")
        if kind == "cash" and any(x < 0.0 for x in a):
            raise ValueError("cash dividends must be >= 0")
        self.times = t
        self.amounts = a
        self.kind = kind

    def __len__(self) -> int:
        return len(self.times)

    def __bool__(self) -> bool:
        return len(self.times) > 0

    def __eq__(self, other) -> bool:
        return (isinstance(other, DividendSchedule)
                and self.times == other.times
                and self.amounts == other.amounts
                and self.kind == other.kind)

    def __hash__(self) -> int:
        return hash((self.times, self.amounts, self.kind))

    def __repr__(self) -> str:
        pairs = ", ".join(f"{t:.4g}:{a:.4g}"
                          for t, a in zip(self.times, self.amounts))
        return f"DividendSchedule({self.kind}; {pairs})"

    def before(self, T: float) -> "DividendSchedule":
        """The sub-schedule with ex-dates t_i <= T (ex-date on expiry day
        still drops the spot before settlement)."""
        keep = [(t, a) for t, a in zip(self.times, self.amounts) if t <= T]
        return DividendSchedule([t for t, _ in keep], [a for _, a in keep],
                                self.kind)

    def grid_amounts(self, T: float, num_steps: int) -> Optional[np.ndarray]:
        """Snap the schedule onto the simulation grid t_1..t_n, t_k = k·T/n.

        Returns a (num_steps,) float32 array whose slot k−1 holds the total
        amount with ex-date nearest t_k (clamped to interior dates
        k ∈ [1, n−1], so "exercise just before the drop" always has a grid
        date and the terminal date stays unambiguous), or None when no
        dividend falls in (0, T].

        Proportional amounts on one date compose multiplicatively:
        1−d = Π(1−d_i).
        """
        sub = self.before(T)
        if not sub:
            return None
        dt = float(T) / num_steps
        out = np.zeros((num_steps,), np.float32)
        for t, a in zip(sub.times, sub.amounts):
            k = int(round(t / dt))
            k = min(max(k, 1), max(num_steps - 1, 1))
            if self.kind == "proportional":
                out[k - 1] = 1.0 - (1.0 - out[k - 1]) * (1.0 - a)
            else:
                out[k - 1] += a
        return out


def pv_cash(schedule: DividendSchedule, r: float, T: float,
            discount=None) -> float:
    """Σ_{t_i <= T} D_i e^{−r t_i} — the escrow account backing the spot.

    `discount`: optional t → DF(t) callable (e.g. ops/curves.RateCurve
    .discount) replacing the flat e^{−r t}; `r` is ignored when given.
    """
    if schedule.kind != "cash":
        raise ValueError("pv_cash needs a cash schedule")
    sub = schedule.before(T)
    if discount is None:
        discount = lambda t: math.exp(-r * t)  # noqa: E731
    return sum(a * discount(t) for t, a in zip(sub.times, sub.amounts))


def proportional_factor(schedule: DividendSchedule, T: float) -> float:
    """Π_{t_i <= T} (1 − d_i) — the exact terminal spot multiplier."""
    if schedule.kind != "proportional":
        raise ValueError("proportional_factor needs a proportional schedule")
    sub = schedule.before(T)
    f = 1.0
    for a in sub.amounts:
        f *= 1.0 - a
    return f


def effective_spot(spot: float, schedule: Optional[DividendSchedule],
                   r: float, T: float,
                   discount=None) -> Tuple[float, float]:
    """(adjusted spot, ∂S_eff/∂S) for European pricing through the unchanged
    engines.

    - proportional: S·Π(1−d_i) — exact; chain factor Π(1−d_i).
    - cash: S − PV_r(divs) — the escrowed model; chain factor 1.

    The chain factor converts Greeks taken w.r.t. S_eff back to raw-spot
    Greeks: Δ = factor·Δ_eff, Γ = factor²·Γ_eff.

    `discount`: optional t → DF(t) callable (a rate curve) for the escrow
    PV; flat e^{−r t} otherwise.
    """
    if schedule is None or not schedule.before(T):
        return float(spot), 1.0
    if schedule.kind == "proportional":
        f = proportional_factor(schedule, T)
        return float(spot) * f, f
    pv = pv_cash(schedule, r, T, discount=discount)
    eff = float(spot) - pv
    if eff <= 0.0:
        raise ValueError(
            f"escrowed spot {eff:.4f} <= 0: dividend PV {pv:.4f} exceeds "
            f"spot {spot:.4f}")
    return eff, 1.0


def forward_with_dividends(spot: float, schedule: Optional[DividendSchedule],
                           r: float, q: float, T: float) -> float:
    """Exact T-forward under each dividend model.

    cash (compounded model): F = S₀e^{(r−q)T} − Σ D_i e^{(r−q)(T−t_i)}
    proportional:            F = S₀e^{(r−q)T} · Π(1−d_i)

    The cash formula is the martingale identity of the compounded-cash path
    model — the MC oracle test (tests/test_dividends.py) pins the simulated
    terminal mean to it.
    """
    growth = math.exp((r - q) * T)
    if schedule is None or not schedule.before(T):
        return float(spot) * growth
    sub = schedule.before(T)
    if schedule.kind == "proportional":
        return float(spot) * growth * proportional_factor(schedule, T)
    carried = sum(a * math.exp((r - q) * (T - t))
                  for t, a in zip(sub.times, sub.amounts))
    return float(spot) * growth - carried


def cash_to_proportional(schedule: DividendSchedule, spot: float,
                         r: float, q: float) -> DividendSchedule:
    """Convert cash dividends to forward-equivalent proportional drops.

    d_i = D_i / F(t_i⁻) where F(t_i⁻) is the compounded-model forward just
    before the i-th ex-date (already net of earlier dividends). Useful when a
    path-dependent engine supports only deterministic per-date factors: the
    converted schedule reproduces the cash schedule's forward curve exactly
    at every ex-date (the remaining difference is the drop's stochasticity —
    proportional drops scale with the path, cash drops don't).
    """
    if schedule.kind != "cash":
        raise ValueError("cash_to_proportional needs a cash schedule")
    props = []
    for i, (t, a) in enumerate(zip(schedule.times, schedule.amounts)):
        fwd = spot * math.exp((r - q) * t) - sum(
            schedule.amounts[j] * math.exp((r - q) * (t - schedule.times[j]))
            for j in range(i))
        if fwd <= a:
            raise ValueError(
                f"dividend {a} at t={t} exceeds the available forward {fwd}")
        props.append(a / fwd)
    return DividendSchedule(schedule.times, props, "proportional")
