"""SSVI (surface SVI) volatility surface — fit, evaluation, no-arb report.

Capability beyond the reference's surface stack (Hagan SABR slices +
cubic splines, /root/reference/engine/surface.py): the Gatheral-Jacquier
(2014) *surface* parameterization that desks use as the arbitrage-aware
master surface. Total implied variance at log-moneyness k:

    w(k, theta_t) = theta_t/2 * [ 1 + rho*phi(theta_t)*k
                                  + sqrt((phi(theta_t)*k + rho)^2
                                         + 1 - rho^2) ],
    phi(theta) = eta * theta^(-gamma)          (power-law),

with one ATM total-variance node theta_t per maturity and three global
shape parameters (rho, eta, gamma). ATM consistency w(0, t) = theta_t
holds by construction; the ATM skew is d_k w(0) = rho*theta*phi.

Design: the fit reuses the repo's vmapped differential-evolution +
Adam-polish stack (utils/optim.py) with a module-level objective and a
traced data pytree, so repeated fits share one compiled program; the
whole (maturities x strikes) residual grid evaluates as one broadcast
expression per DE candidate. The no-arbitrage report gets Gatheral's
butterfly density factor

    g(k) = (1 - k*w'/(2w))^2 - (w'^2/4)*(1/w + 1/4) + w''/2

with w' and w'' by jax AD of the SSVI formula itself — no finite
differences — and the calendar check verifies dw/dt >= 0 on the grid.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.utils.optim import adam_polish, differential_evolution

Array = jax.Array

SSVI_BOUNDS = {
    "rho": (-0.999, 0.999),
    "eta": (0.01, 5.0),
    "gamma": (0.01, 0.99),
}


def ssvi_total_variance(k, theta, rho, eta, gamma):
    """w(k, theta) — broadcasts over any k/theta shapes."""
    theta = jnp.maximum(theta, 1e-10)
    phi = eta * theta ** (-gamma)
    pk = phi * k
    return 0.5 * theta * (1.0 + rho * pk
                          + jnp.sqrt((pk + rho) ** 2 + 1.0 - rho ** 2))


def _ssvi_objective(x, data):
    """Weighted SSE in total variance over the (T, K) grid; rows are
    maturities with their own theta node."""
    rho, eta, gamma = x[0], x[1], x[2]
    w_model = ssvi_total_variance(data["k"], data["theta"][:, None],
                                  rho, eta, gamma)
    return jnp.sum(data["weights"] * (w_model - data["w_mkt"]) ** 2)


def butterfly_g(k, theta, rho, eta, gamma):
    """Gatheral's g(k): the smile is butterfly-arbitrage-free iff
    g(k) >= 0 (risk-neutral density is proportional to a positive factor
    times g). w' and w'' via jax AD, vectorized over the k grid."""
    def w_of(kk):
        return ssvi_total_variance(kk, theta, rho, eta, gamma)

    w = w_of(k)
    wp = jax.vmap(jax.grad(w_of))(k)
    wpp = jax.vmap(jax.grad(jax.grad(w_of)))(k)
    return ((1.0 - k * wp / (2.0 * w)) ** 2
            - 0.25 * wp ** 2 * (1.0 / w + 0.25) + 0.5 * wpp)


class SSVISurface:
    """Fitted SSVI surface: evaluate, interrogate, and export.

    `maturities` (m,) ascending; `theta` (m,) ATM total-variance nodes;
    global (rho, eta, gamma). Between maturities, theta interpolates
    linearly in t (total-variance interpolation; flat extrapolation of
    the ATM *variance rate* theta/t beyond the ends).
    """

    def __init__(self, maturities, theta, rho: float, eta: float,
                 gamma: float):
        self.maturities = np.asarray(maturities, np.float64)
        self.theta = np.asarray(theta, np.float64)
        self.rho = float(rho)
        self.eta = float(eta)
        self.gamma = float(gamma)

    # ── evaluation ───────────────────────────────────────────────────────
    def theta_at(self, T):
        T = np.asarray(T, np.float64)
        t, th = self.maturities, self.theta
        rate_lo = th[0] / t[0]
        rate_hi = th[-1] / t[-1]
        inner = np.interp(T, t, th)
        return np.where(T <= t[0], rate_lo * T,
                        np.where(T >= t[-1], rate_hi * T, inner))

    def total_variance(self, k, T):
        return np.asarray(ssvi_total_variance(
            jnp.asarray(k, jnp.float32), jnp.asarray(self.theta_at(T),
                                                     jnp.float32),
            self.rho, self.eta, self.gamma), np.float64)

    def vol(self, k, T):
        """Black-Scholes implied vol at log-moneyness k = ln(K/F)."""
        T = np.asarray(T, np.float64)
        return np.sqrt(self.total_variance(k, T) / np.maximum(T, 1e-12))

    def atm_skew(self, T) -> float:
        """d(sigma_imp)/dk at ATM, from the closed form
        d_k w(0) = rho*theta*phi (chain rule through sigma = sqrt(w/T))."""
        th = float(self.theta_at(T))
        phi = self.eta * th ** (-self.gamma)
        dw = self.rho * th * phi
        return dw / (2.0 * np.sqrt(th * float(T)))

    # ── no-arbitrage report ──────────────────────────────────────────────
    def arbitrage_report(self, k_grid: Optional[Sequence[float]] = None
                         ) -> Dict[str, object]:
        if k_grid is None:
            k_grid = np.linspace(-1.0, 1.0, 101)
        k = jnp.asarray(np.asarray(k_grid), jnp.float32)
        butterfly = []
        for th in self.theta:
            g = np.asarray(butterfly_g(k, float(th), self.rho, self.eta,
                                       self.gamma))
            butterfly.append(float(g.min()))
        # Gatheral-Jacquier Thm 4.2 sufficient conditions per slice.
        phi = self.eta * self.theta ** (-self.gamma)
        cond1 = self.theta * phi * (1.0 + abs(self.rho))
        cond2 = self.theta * phi ** 2 * (1.0 + abs(self.rho))
        # Calendar: w(k, t) non-decreasing in t on the grid.
        w = np.stack([self.total_variance(np.asarray(k_grid), t)
                      for t in self.maturities])
        cal_min = float(np.diff(w, axis=0).min()) if len(
            self.maturities) > 1 else 0.0
        return {
            "butterfly_g_min": butterfly,
            "butterfly_free": bool(min(butterfly) >= -1e-10),
            "thm42_cond1_max": float(cond1.max()),   # sufficient if <= 4
            "thm42_cond2_max": float(cond2.max()),   # sufficient if <= 4
            "calendar_min_dw": cal_min,
            "calendar_free": bool(cal_min >= -1e-10),
        }

    # ── export ───────────────────────────────────────────────────────────
    def iv_grid(self, spot: float, strikes, maturities, r: float,
                q: float) -> np.ndarray:
        """(len(maturities), len(strikes)) IV grid, e.g. for the Dupire
        local-vol builder (engine/localvol.py)."""
        strikes = np.asarray(strikes, np.float64)
        out = np.empty((len(maturities), len(strikes)))
        for i, t in enumerate(maturities):
            f = spot * np.exp((r - q) * t)
            out[i] = self.vol(np.log(strikes / f), t)
        return out


def calibrate_ssvi(maturities, forwards, strikes, market_ivs,
                   weights=None, seed: int = 0, pop_size: int = 48,
                   iters: int = 150, polish_steps: int = 200
                   ) -> Dict[str, object]:
    """Fit SSVI to an IV grid.

    Args:
        maturities: (m,) ascending year fractions.
        forwards: (m,) forward prices per maturity.
        strikes: (m, n) strike grid (row per maturity).
        market_ivs: (m, n) Black implied vols; NaN entries are skipped.
        weights: optional (m, n) quote weights (vega/spread weights).

    theta nodes are pinned to the market ATM total variance per maturity
    (interpolated in k from each row); DE + Adam fit the three globals.
    """
    mats = np.asarray(maturities, np.float64)
    fwds = np.asarray(forwards, np.float64)
    strikes = np.asarray(strikes, np.float64)
    ivs = np.asarray(market_ivs, np.float64)
    k = np.log(strikes / fwds[:, None])
    w_mkt = ivs ** 2 * mats[:, None]
    mask = np.isfinite(w_mkt)
    if weights is None:
        weights = mask.astype(np.float64)
    else:
        weights = np.asarray(weights, np.float64) * mask
    weights = weights / weights.sum()

    # ATM theta per row: interpolate market total variance to k = 0.
    theta = np.empty(len(mats))
    for i in range(len(mats)):
        ki, wi = k[i][mask[i]], w_mkt[i][mask[i]]
        order = np.argsort(ki)
        theta[i] = np.interp(0.0, ki[order], wi[order])

    data = {"k": jnp.asarray(k, jnp.float32),
            "w_mkt": jnp.asarray(np.nan_to_num(w_mkt), jnp.float32),
            "weights": jnp.asarray(weights, jnp.float32),
            "theta": jnp.asarray(theta, jnp.float32)}
    bounds = np.array([SSVI_BOUNDS["rho"], SSVI_BOUNDS["eta"],
                       SSVI_BOUNDS["gamma"]], np.float32)
    res = differential_evolution(_ssvi_objective, bounds,
                                 jax.random.key(seed), pop_size=pop_size,
                                 iters=iters, args=data)
    x, fun = adam_polish(_ssvi_objective, res.x, bounds,
                         steps=polish_steps, lr=0.02, args=data)
    fun = float(fun)
    surf = SSVISurface(mats, theta, float(x[0]), float(x[1]), float(x[2]))
    return {
        "surface": surf,
        "rho": surf.rho, "eta": surf.eta, "gamma": surf.gamma,
        "theta": theta.tolist(),
        "objective": fun,
        # weights are normalized to sum 1, so the objective IS the
        # weighted mean-square total-variance error.
        "rmse_total_variance": float(np.sqrt(max(fun, 0.0))),
        "n_quotes": int(mask.sum()),
        "arbitrage": surf.arbitrage_report(),
    }
