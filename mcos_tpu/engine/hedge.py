"""Static replication: project a target payoff onto a vanilla hedge chain.

Carr–Madan (1998) says any European payoff f(S_T) decomposes exactly into a
bond + forward + a strip of calls; with a finite strike grid the best static
hedge is the L²(paths) projection of the payoff onto
    X = [1, S_T, (S_T − K₁)₊, …, (S_T − K_m)₊],
and for *path-dependent* targets (Asian, barrier, lookback) the projection
residual is precisely the statically-unhedgeable path risk — the number a
desk needs before it agrees to warehouse the exotic.

Execution: the target payoff and the terminal spots come off ONE CRN
device pass (the same stat scan the exotics engine prices with,
ops/exotics.py:simulate_path_stats); the tiny (N × m) projection itself
runs on the host in f64 — a dense call strip's Gram is near-collinear and
f32 normal equations lose the weights. The hedge is then *valued* off the
exact COS/Bates oracle per strike (ops/cos_pricer.py) — model prices, not
MC noise, in the reported hedge cost.

Capability absent from the reference (its only hedging tool is the dynamic
delta backtest, reference engine/risk.py:227-337).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import DEFAULT_NUM_PATHS, scaled_steps
from mcos_tpu.engine.exotics import exotic_payoff_and_control
from mcos_tpu.models.params import SVJParams
from mcos_tpu.ops import exotics as ops_exotics

Array = jax.Array


@partial(jax.jit, static_argnames=(
    "kind", "num_paths", "num_steps", "is_call", "averaging", "knock",
    "direction", "floating"))
def _target_and_terminals(
    params: SVJParams, spot, strike, T, key, barrier,
    *, kind: str, num_paths: int, num_steps: int, is_call: bool,
    averaging: str, knock: str, direction: str, floating: bool,
) -> Dict[str, Array]:
    """ONE CRN device pass: target payoff samples + terminal spots.

    The simulation is the expensive part and stays on device (the same stat
    scan the exotics engine prices with); the tiny (N × m) projection runs
    on the host in f64 — the call-strip Gram is near-collinear for dense
    strike grids and f32 normal equations lose the weights there.
    """
    stats = ops_exotics.simulate_path_stats(
        params, spot, T, key, num_paths=num_paths, num_steps=num_steps,
        antithetic=True, companion=False)

    if kind == "digital":
        s_t = stats["s_final"]
        pay_b = ((s_t >= strike) if is_call else (s_t <= strike)
                 ).astype(jnp.float32)
    elif kind == "vanilla":
        s_t = stats["s_final"]
        pay_b = jnp.maximum(s_t - strike, 0.0) if is_call \
            else jnp.maximum(strike - s_t, 0.0)
    else:
        pay_b, _, _ = exotic_payoff_and_control(
            stats, params, spot, strike, T, barrier, kind=kind,
            num_steps=num_steps, is_call=is_call, averaging=averaging,
            knock=knock, direction=direction, floating=floating,
            one_touch=False, control_variate=False)

    return {"y": pay_b.reshape(-1), "s_t": stats["s_final"].reshape(-1)}


def _project(y: np.ndarray, s_t: np.ndarray, spot: float,
             hedge_strikes: np.ndarray) -> Dict:
    """Host-f64 L² projection of y onto [1, S_T, (S_T − Kᵢ)₊]."""
    basis = np.concatenate([
        np.ones((s_t.size, 1)),
        s_t[:, None],
        np.maximum(s_t[:, None] - hedge_strikes[None, :], 0.0),
    ], axis=1)
    w, *_ = np.linalg.lstsq(basis, y, rcond=None)
    resid = y - basis @ w
    var_y = float(np.var(y))
    r2 = 1.0 - float(np.var(resid)) / var_y if var_y > 1e-12 else 1.0
    return {
        "weights": w,
        "r2": r2,
        "resid_std": float(np.std(resid)),
        "resid_quantiles": np.quantile(resid, [0.01, 0.05, 0.5, 0.95,
                                               0.99]),
        "target_mean": float(np.mean(y)),
        "target_se": float(np.std(y) / np.sqrt(y.size)),
    }


class StaticHedgeEngine:
    """Replicating-portfolio construction for a target (possibly
    path-dependent) payoff against a vanilla call chain."""

    def __init__(self, params: SVJParams, num_paths: int = DEFAULT_NUM_PATHS,
                 num_steps: int = 252, seed: int = 42):
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)

    def replicate(
        self,
        spot: float,
        T: float,
        kind: str = "digital",
        strike: float = 0.0,
        is_call: bool = True,
        barrier: float = 0.0,
        averaging: str = "arithmetic",
        knock: str = "out",
        direction: str = "up",
        floating: bool = False,
        hedge_strikes: Optional[Sequence[float]] = None,
        n_hedge: int = 13,
    ) -> Dict:
        """Build the static hedge and value it with the exact COS oracle.

        Returns the hedge weights (bond / forward / per-strike calls), the
        model value of the hedge portfolio, the target's MC price off the
        same paths, R², and the residual (unhedged P&L) distribution in
        discounted currency units.
        """
        if kind not in ("digital", "vanilla", "asian", "barrier", "lookback"):
            raise ValueError(f"unknown replication target: {kind!r}")
        if hedge_strikes is None:
            hedge_strikes = np.linspace(0.80, 1.20, int(n_hedge)) * spot
        hedge_strikes = np.asarray(hedge_strikes, np.float64)
        if hedge_strikes.size < 1:
            raise ValueError("need at least one hedge strike")

        steps = scaled_steps(self.num_steps, T)
        dev = jax.device_get(_target_and_terminals(
            self.params, spot, strike, T, jax.random.key(self.seed),
            barrier, kind=kind, num_paths=self.num_paths, num_steps=steps,
            is_call=is_call, averaging=averaging, knock=knock,
            direction=direction, floating=floating))
        out = _project(np.asarray(dev["y"], np.float64),
                       np.asarray(dev["s_t"], np.float64), spot,
                       hedge_strikes)

        from mcos_tpu.ops.cos_pricer import cos_price

        r, q = float(self.params.r), float(self.params.q)
        discount = float(np.exp(-r * T))
        w = np.asarray(out["weights"], np.float64)
        # The Heston CF divides by ξ² and by β±d (β = κ − ρξiu, which is 0
        # at u=0 when κ=ρ=0); the exact-GBM degenerate point (gbm_params:
        # κ=ξ=0) needs floors for the valuation leg only — the price impact
        # is O(ξ²T) and O(κ·0) respectively, far below f64 COS truncation.
        p_val = self.params
        if float(p_val.xi) < 1e-4:
            p_val = p_val.replace(xi=1e-4)
        if float(p_val.kappa) < 1e-6:
            p_val = p_val.replace(kappa=1e-6)
        call_values = np.asarray(
            cos_price(p_val, spot, hedge_strikes, T, True), np.float64)
        forward_value = spot * float(np.exp(-q * T))
        hedge_value = (w[0] * discount + w[1] * forward_value
                       + float(w[2:] @ call_values))
        resid_q = np.asarray(out["resid_quantiles"], np.float64) * discount
        return {
            "kind": kind,
            "hedge_strikes": hedge_strikes.tolist(),
            "weights": {
                "bond": float(w[0]),
                "forward": float(w[1]),
                "calls": w[2:].tolist(),
            },
            "hedge_value": float(hedge_value),
            "target_price_mc": float(out["target_mean"]) * discount,
            "target_se": float(out["target_se"]) * discount,
            "r2": float(out["r2"]),
            "resid_std": float(out["resid_std"]) * discount,
            "resid_quantiles": {
                "p01": resid_q[0], "p05": resid_q[1], "p50": resid_q[2],
                "p95": resid_q[3], "p99": resid_q[4],
            },
            "unhedgeable_fraction": float(
                np.sqrt(max(1.0 - out["r2"], 0.0))),
        }
