"""Counterparty exposure profiles and CVA/DVA — XVA layer.

Capability beyond the reference (whose risk layer stops at same-day
stress/VaR, /root/reference/engine/risk.py): simulate the market to a grid
of future exposure dates, revalue the netting set at each date, and reduce
to the XVA quantities a desk actually carries:

    EE(t)  = E[V_t^+]           expected exposure
    ENE(t) = E[(-V_t)^+]        expected negative exposure (DVA side)
    EPE    = avg_t e^{-rt} EE(t)   (discounted running average)
    PFE_q(t) = quantile_q(V_t^+)   potential future exposure
    CVA = LGD * sum_i  e^{-r t_i} EE(t_i) * [PD(t_{i-1}, t_i)]

Design: market states at the exposure dates are sampled *exactly* —
correlated lognormal increments date-to-date (no Euler error, dates are
the only grid) in one `lax.scan` over dates carrying (paths, assets) log
prices. Revaluation at each date is the closed-form jax Black-Scholes on
the whole (paths, positions) sheet at once (`ops/bs.py` is differentiable
device code, not host scipy — the same module the pricers use). The scan
emits only the netted/gross book values per date: (dates, paths) — no
(dates, paths, positions) sheet ever lives in HBM.

Because everything is jax, `cva_delta` is ONE `jax.grad` through the whole
exposure simulation — the hedge the desk wants and a quantity the
bump-and-revalue generation can't produce cheaply.

Exact oracles used by the tests:
  * a single long call position has V_t >= 0 and discounted-martingale
    value, so e^{-rt} EE(t) = C_0 for every t, and CVA = LGD * C_0 * PD(T);
  * a forward contract's EE(t) is the Black formula on its t-forward value;
  * netted exposure <= gross exposure pathwise.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import DIVIDEND_YIELD, RISK_FREE_RATE
from mcos_tpu.ops.bs import bs_price

Array = jax.Array


def _positions_arrays(positions: Sequence[dict], n_assets: int):
    """Columnize a position list into f32 arrays (host, once per book).

    Each position: {"kind": "call"|"put"|"forward", "strike": K,
    "T": maturity_years, "qty": signed_quantity, "asset": index}.
    """
    kinds = {"call": 0, "put": 1, "forward": 2}
    kind = np.array([kinds[p.get("kind", "call")] for p in positions],
                    np.int32)
    strike = np.array([p["strike"] for p in positions], np.float32)
    mat = np.array([p["T"] for p in positions], np.float32)
    qty = np.array([p.get("qty", 1.0) for p in positions], np.float32)
    asset = np.array([int(p.get("asset", 0)) for p in positions], np.int32)
    if (asset < 0).any() or (asset >= n_assets).any():
        raise ValueError("position asset index out of range")
    return kind, strike, mat, qty, asset


def _book_value(s_row, t, kind, strike, mat, qty, asset, r, q_by_asset,
                sigma_by_asset):
    """(paths,) netted book value at date t from (paths, assets) spots.

    Positions past maturity contribute zero (settled). Forwards value
    linearly; calls/puts by closed-form BS with the remaining life.
    """
    tau = jnp.maximum(mat - t, 1e-8)[None, :]             # (1, P)
    s = s_row[:, asset]                                   # (paths, P)
    sig = sigma_by_asset[asset][None, :]
    qq = q_by_asset[asset][None, :]
    k = strike[None, :]
    call = bs_price(s, k, tau, r, qq, sig, True)
    put = bs_price(s, k, tau, r, qq, sig, False)
    fwd = s * jnp.exp(-qq * tau) - k * jnp.exp(-r * tau)
    v = jnp.where(kind[None, :] == 0, call,
                  jnp.where(kind[None, :] == 1, put, fwd))
    # Alive through expiry itself: at t = T the floored tau collapses the
    # BS value to intrinsic — the unsettled payoff is still exposure, so a
    # date grid ending exactly at the book horizon keeps its last bucket
    # (dropping it biased CVA low by one PD increment).
    alive = (mat[None, :] - t >= -1e-7).astype(s.dtype)
    per_pos = qty[None, :] * v * alive
    return jnp.sum(per_pos, axis=1), jnp.sum(jnp.maximum(per_pos, 0.0),
                                             axis=1)


@partial(jax.jit, static_argnames=("num_paths",))
def _exposure_values(spots, sigmas, chol, r, q_by_asset, dates, key,
                     kind, strike, mat, qty, asset, *, num_paths: int):
    """(dates, paths) netted and gross book values.

    Exact date-to-date lognormal stepping: the scan carry is the
    (paths, assets) log-spot sheet; each emit is two (paths,) rows.
    """
    n_assets = spots.shape[0]
    log_s0 = jnp.log(spots)[None, :].repeat(num_paths, axis=0)
    deltas = jnp.diff(jnp.concatenate([jnp.zeros(1, jnp.float32), dates]))

    def step(carry, inp):
        log_s, i = carry
        t, d = inp
        z = jax.random.normal(jax.random.fold_in(key, i),
                              (num_paths, n_assets), jnp.float32)
        z = z @ chol.T
        log_s = log_s + ((r - q_by_asset - 0.5 * sigmas**2) * d
                         + sigmas * jnp.sqrt(d) * z)
        net, gross = _book_value(jnp.exp(log_s), t, kind, strike, mat, qty,
                                 asset, r, q_by_asset, sigmas)
        # Asset 0's level ratio rides along as the wrong-way-risk driver.
        return (log_s, i + 1), (net, gross, jnp.exp(log_s[:, 0]) / spots[0])

    (_, _), (net, gross, s_ratio) = jax.lax.scan(
        step, (log_s0, jnp.int32(0)), (dates, deltas))
    return net, gross, s_ratio


class ExposureEngine:
    """EE/ENE/PFE profiles, CVA/DVA, and CVA delta for a vanilla book.

    Market model: correlated GBM per asset (flat vols — the model under
    which the closed-form revaluation is self-consistent). `positions` is
    a list of dicts (see `_positions_arrays`).
    """

    def __init__(self, spots, sigmas, corr, positions: List[dict],
                 r: float = RISK_FREE_RATE,
                 q: Optional[Sequence[float]] = None,
                 num_paths: int = 65_536, seed: int = 42):
        self.spots = np.atleast_1d(np.asarray(spots, np.float32))
        self.sigmas = np.atleast_1d(np.asarray(sigmas, np.float32))
        n = self.spots.shape[0]
        corr = np.atleast_2d(np.asarray(corr, np.float64))
        self.chol = np.linalg.cholesky(corr).astype(np.float32)
        self.q = (np.full(n, DIVIDEND_YIELD, np.float32) if q is None
                  else np.asarray(q, np.float32))
        self.r = float(r)
        self.positions = list(positions)
        self.pos_arrays = _positions_arrays(self.positions, n)
        self.num_paths = int(num_paths)
        self.seed = int(seed)

    def _values(self, dates: np.ndarray):
        kind, strike, mat, qty, asset = self.pos_arrays
        return _exposure_values(
            jnp.asarray(self.spots), jnp.asarray(self.sigmas),
            jnp.asarray(self.chol), jnp.float32(self.r),
            jnp.asarray(self.q), jnp.asarray(dates, jnp.float32),
            jax.random.key(self.seed), jnp.asarray(kind),
            jnp.asarray(strike), jnp.asarray(mat), jnp.asarray(qty),
            jnp.asarray(asset), num_paths=self.num_paths)

    def profile(self, num_dates: int = 32,
                horizon: Optional[float] = None,
                quantile: float = 0.975,
                collateral_threshold: Optional[float] = None,
                margin_period: float = 10.0 / 252.0) -> Dict[str, object]:
        """Exposure profile on a uniform date grid up to the book horizon.

        `collateral_threshold` models a CSA: the counterparty posts
        variation margin above the threshold, but collateral lags by the
        margin period of risk — the held amount at t is what the call at
        t - MPR produced, C_t = max(V_{t-MPR} - threshold, 0), so the
        residual exposure max(V_t - C_t, 0)⁺ keeps the gap risk a real
        CSA leaves (jump over the margin period + the threshold itself).
        Lag handling uses the nearest earlier grid date (C=0 before the
        first); threshold=0 leaves pure gap risk, threshold→∞ recovers
        the uncollateralized profile.
        """
        mat = self.pos_arrays[2]
        horizon = float(horizon or mat.max())
        dates = np.linspace(horizon / num_dates, horizon,
                            num_dates).astype(np.float32)
        net, gross, _ = self._values(dates)
        if collateral_threshold is not None:
            thr = jnp.float32(collateral_threshold)
            # index of the newest grid date <= t - MPR (or -1 ⇒ no call yet)
            lag_idx = np.searchsorted(
                dates, dates - np.float32(margin_period), side="right") - 1
            lagged = jnp.where(
                jnp.asarray(lag_idx >= 0)[:, None],
                net[jnp.maximum(jnp.asarray(lag_idx), 0)], 0.0)
            collateral = jnp.maximum(lagged - thr, 0.0)
            net = net - collateral
        pos = jnp.maximum(net, 0.0)
        neg = jnp.maximum(-net, 0.0)
        disc = np.exp(-self.r * dates)
        ee = np.asarray(jnp.mean(pos, axis=1))
        ene = np.asarray(jnp.mean(neg, axis=1))
        pfe = np.asarray(jnp.quantile(pos, quantile, axis=1))
        gross_ee = np.asarray(jnp.mean(jnp.maximum(gross, 0.0), axis=1))
        return {
            "dates": dates.tolist(),
            "ee": ee.tolist(),
            "ene": ene.tolist(),
            "pfe": pfe.tolist(),
            "pfe_quantile": quantile,
            "gross_ee": gross_ee.tolist(),
            "epe": float(np.mean(disc * ee)),
            "ene_avg": float(np.mean(disc * ene)),
            "netting_benefit": float(np.mean(disc * (gross_ee - ee))),
            "num_paths_used": self.num_paths,
        }

    def cva(self, hazard_rate: float = 0.02, lgd: float = 0.6,
            num_dates: int = 32, own_hazard: float = 0.0,
            horizon: Optional[float] = None) -> Dict[str, float]:
        """Unilateral CVA (and DVA when `own_hazard` > 0) with a flat
        hazard curve: PD(t_{i-1}, t_i) = e^{-h t_{i-1}} - e^{-h t_i}."""
        prof = self.profile(num_dates=num_dates, horizon=horizon)
        t = np.asarray(prof["dates"])
        disc = np.exp(-self.r * t)
        dpd = lambda h: (np.exp(-h * np.concatenate([[0.0], t[:-1]]))
                         - np.exp(-h * t))
        cva = lgd * float(np.sum(disc * np.asarray(prof["ee"])
                                 * dpd(hazard_rate)))
        out = {"cva": cva, "hazard_rate": hazard_rate, "lgd": lgd,
               "epe": prof["epe"], "pd_horizon":
               float(1.0 - np.exp(-hazard_rate * t[-1]))}
        if own_hazard > 0.0:
            out["dva"] = lgd * float(np.sum(
                disc * np.asarray(prof["ene"]) * dpd(own_hazard)))
            out["bcva"] = cva - out["dva"]
        return out

    def cva_wwr(self, hazard_rate: float = 0.02, lgd: float = 0.6,
                gamma: float = 1.0, num_dates: int = 32,
                horizon: Optional[float] = None) -> Dict[str, float]:
        """CVA with wrong-way risk: a spot-linked stochastic intensity

            lambda_t = h0 * (S_0 / S_t)^gamma        (asset 0's level),

        so default clusters when the market sells off. Pathwise Cox
        accounting: conditional on the path, the default probability in
        bucket i is exp(-Lambda_{i-1}) - exp(-Lambda_i) with Lambda the
        left-point intensity integral, and

            CVA = LGD * E[ sum_i disc_i * V_i^+ * dPD_i(path) ].

        gamma = 0 reduces EXACTLY to the independent-hazard `cva()`
        formula (test-pinned); gamma > 0 raises the CVA of books whose
        exposure grows as the market falls (short puts — wrong way) and
        lowers it for books long the market (right way).
        """
        mat = self.pos_arrays[2]
        horizon = float(horizon or mat.max())
        dates = np.linspace(horizon / num_dates, horizon,
                            num_dates).astype(np.float32)
        net, _, s_ratio = self._values(dates)
        pos = jnp.maximum(net, 0.0)                     # (dates, paths)
        lam = hazard_rate * s_ratio ** (-gamma)         # intensity per date
        deltas = jnp.asarray(
            np.diff(np.concatenate([[0.0], dates])), jnp.float32)
        # Left-point integral: Lambda_i = sum_{j<i} lam_j * dt_j + h0*dt_1
        # for the first bucket (intensity from t=0 uses h0 — S ratio is 1).
        lam_left = jnp.concatenate(
            [jnp.full((1, lam.shape[1]), hazard_rate, jnp.float32),
             lam[:-1]], axis=0)
        big_lambda = jnp.cumsum(lam_left * deltas[:, None], axis=0)
        surv = jnp.exp(-big_lambda)                     # S(t_i) per path
        surv_prev = jnp.concatenate(
            [jnp.ones((1, lam.shape[1]), jnp.float32), surv[:-1]], axis=0)
        dpd = surv_prev - surv
        disc = jnp.asarray(np.exp(-self.r * dates), jnp.float32)[:, None]
        cva = lgd * float(jnp.mean(jnp.sum(disc * pos * dpd, axis=0)))
        return {
            "cva": cva,
            "gamma": float(gamma),
            "hazard_rate": hazard_rate,
            "lgd": lgd,
            "mean_pd_horizon": float(jnp.mean(1.0 - surv[-1])),
        }

    def cva_delta(self, hazard_rate: float = 0.02, lgd: float = 0.6,
                  num_dates: int = 32) -> Dict[str, object]:
        """dCVA/dS0 per asset — ONE jax.grad pass through the exposure
        simulation (smooth a.e.; the hedge ratio for the CVA desk)."""
        kind, strike, mat, qty, asset = (jnp.asarray(a)
                                         for a in self.pos_arrays)
        horizon = float(self.pos_arrays[2].max())
        dates = jnp.asarray(np.linspace(horizon / num_dates, horizon,
                                        num_dates), jnp.float32)
        disc = jnp.exp(-self.r * dates)
        t_prev = jnp.concatenate([jnp.zeros(1), dates[:-1]])
        dpd = jnp.exp(-hazard_rate * t_prev) - jnp.exp(-hazard_rate * dates)

        def cva_of(spots):
            net, _, _ = _exposure_values(
                spots, jnp.asarray(self.sigmas), jnp.asarray(self.chol),
                jnp.float32(self.r), jnp.asarray(self.q), dates,
                jax.random.key(self.seed), kind, strike, mat, qty, asset,
                num_paths=self.num_paths)
            ee = jnp.mean(jnp.maximum(net, 0.0), axis=1)
            return lgd * jnp.sum(disc * ee * dpd)

        val, grad = jax.value_and_grad(cva_of)(jnp.asarray(self.spots))
        return {"cva": float(val), "cva_delta": np.asarray(grad).tolist()}
