r"""Heston-Hull-White hybrid: stochastic volatility AND stochastic rates.

Capability beyond the reference (fixed flat r, engine/config.py:15): the
3-factor hybrid a desk needs for long-dated options, where rate volatility
contributes materially to the terminal spot variance:

    dS/S = (r_t - q) dt + sqrt(v_t) dW1
    dv   = kappa (theta - v) dt + xi sqrt(v) dW2      (Heston, full trunc.)
    dr   = a (b - r) dt + sigma_r dW3                 (Vasicek/Hull-White)

with a full 3x3 correlation (rho_sv, rho_sr, rho_vr; Cholesky-mixed).

Design: one `lax.scan` over steps carrying (log S, v, r, \int r dt).
The rate factor steps with the EXACT Ornstein-Uhlenbeck transition (its
conditional law is Gaussian in closed form — no Euler bias in r), the
money-market integral accumulates trapezoidally, and pricing discounts
along the path: price = E[exp(-\int r dt) payoff]. Antithetic branches
negate all three normals and ride the same scan.

Closed-form oracles (host f64, used as test pins and control refs):
  * vasicek_bond:     P(0,T) = A(T) e^{-B(T) r0}
  * bsm_hullwhite:    European option under GBM + Vasicek rates via the
    T-forward measure — Black on F = S0 e^{-qT} / P(0,T) with total
    variance  V = sig_s^2 T + 2 rho_sr sig_s sig_r (T - B)/a
               + sig_r^2 (T - 2B + B2)/a^2,
    B = (1-e^{-aT})/a, B2 = (1-e^{-2aT})/(2a).   (exact)
The sigma_r -> 0 limit reduces the hybrid to Heston, pinned against the
COS oracle (ops/cos_pricer.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy.stats import norm

from mcos_tpu.config import DIVIDEND_YIELD
from mcos_tpu.ops.simulate import _safe_sqrt

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HHWParams:
    """Heston-Hull-White parameters (no jumps: the hybrid targets the
    long-dated regime where rate vol, not jump risk, drives the smile)."""

    # Heston block
    kappa: float = 3.0
    theta: float = 0.04
    xi: float = 0.5
    v0: float = 0.04
    # Hull-White block
    a: float = 0.1          # rate mean-reversion speed
    b: float = 0.05         # long-run short rate
    sigma_r: float = 0.01   # absolute rate vol
    r0: float = 0.05        # initial short rate
    # correlations
    rho_sv: float = -0.7
    rho_sr: float = 0.3
    rho_vr: float = 0.0
    q: float = DIVIDEND_YIELD


# ─────────────────────────────────────────────────────────────────────────────
# Closed forms (host f64)
# ─────────────────────────────────────────────────────────────────────────────
def vasicek_bond(p: HHWParams, T: float) -> float:
    """Zero-coupon bond P(0, T) under the Vasicek short rate."""
    a, b, s = float(p.a), float(p.b), float(p.sigma_r)
    B = (1.0 - np.exp(-a * T)) / a
    A = np.exp((b - s**2 / (2 * a**2)) * (B - T) - s**2 * B**2 / (4 * a))
    return float(A * np.exp(-B * float(p.r0)))


def bsm_hullwhite(p: HHWParams, spot: float, strike: float, T: float,
                  sigma_s: float, is_call: bool = True) -> float:
    """European option under GBM(sigma_s) + Vasicek rates — exact.

    T-forward-measure Black formula; the derivation in the module header.
    The spot/rate correlation `p.rho_sr` enters the total variance.
    """
    a, s_r = float(p.a), float(p.sigma_r)
    P = vasicek_bond(p, T)
    B = (1.0 - np.exp(-a * T)) / a
    B2 = (1.0 - np.exp(-2.0 * a * T)) / (2.0 * a)
    V = (sigma_s**2 * T
         + 2.0 * float(p.rho_sr) * sigma_s * s_r * (T - B) / a
         + s_r**2 * (T - 2.0 * B + B2) / a**2)
    F = spot * np.exp(-float(p.q) * T) / P
    sv = np.sqrt(max(V, 1e-16))
    d1 = (np.log(F / strike) + 0.5 * V) / sv
    d2 = d1 - sv
    call = P * (F * norm.cdf(d1) - strike * norm.cdf(d2))
    if is_call:
        return float(call)
    return float(call - P * (F - strike))   # forward-measure parity


# ─────────────────────────────────────────────────────────────────────────────
# Simulation — one scan, exact OU rate stepping
# ─────────────────────────────────────────────────────────────────────────────
@partial(jax.jit, static_argnames=("num_paths", "num_steps", "antithetic"))
def hhw_terminal(p: HHWParams, spot, T, key, *, num_paths: int,
                 num_steps: int,
                 antithetic: bool = True) -> Tuple[Array, Array]:
    """(branches, paths) terminal spots and pathwise discount factors
    exp(-\\int r dt).

    The money-market integral uses the LEFT-POINT rule, matching the
    left-point r in the log-spot drift: the r terms then cancel pathwise
    in D*S_T, making the discounted spot an EXACT discrete martingale
    (E[D S_T] = S0 e^{-qT} to f32 noise at any step count — the property
    pricing actually depends on). The bond E[D] carries the O(dt)
    left-point bias instead; tests budget for it.
    """
    dtype = jnp.float32
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    n_branch = 2 if antithetic else 1
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None]

    # 3x3 correlation Cholesky (traced; jnp handles the 3x3 inline).
    corr = jnp.array([[1.0, p.rho_sv, p.rho_sr],
                      [p.rho_sv, 1.0, p.rho_vr],
                      [p.rho_sr, p.rho_vr, 1.0]], dtype)
    chol = jnp.linalg.cholesky(corr)

    # Exact OU transition: r' = b + (r-b) e^{-a dt} + s_ou z,
    # s_ou^2 = sigma_r^2 (1 - e^{-2 a dt}) / (2a).
    e_adt = jnp.exp(-p.a * dt)
    s_ou = p.sigma_r * jnp.sqrt((1.0 - e_adt**2)
                                / jnp.maximum(2.0 * p.a, 1e-12))

    shape = (n_branch, num_paths)
    init = (jnp.zeros(shape, dtype),                        # log(S/S0)
            jnp.full(shape, jnp.asarray(p.v0, dtype)),      # v
            jnp.full(shape, jnp.asarray(p.r0, dtype)),      # r
            jnp.zeros(shape, dtype))                        # int r dt

    def step(carry, step_idx):
        log_s, v, r, int_r = carry
        z = jax.random.normal(jax.random.fold_in(key, step_idx),
                              (3, num_paths), dtype)
        zc = chol @ z                                       # correlate
        z1, z2, z3 = (zc[0][None] * sign, zc[1][None] * sign,
                      zc[2][None] * sign)
        v_pos = jnp.maximum(v, 0.0)
        sqrt_v = _safe_sqrt(v_pos)  # zero (not inf) derivative at v = 0
        log_s = log_s + ((r - p.q - 0.5 * v_pos) * dt + sqrt_v * z1 * sqrt_dt)
        v = jnp.maximum(v_pos + p.kappa * (p.theta - v_pos) * dt
                        + p.xi * sqrt_v * z2 * sqrt_dt, 0.0)
        r_new = p.b + (r - p.b) * e_adt + s_ou * z3
        int_r = int_r + r * dt                              # left-point
        return (log_s, v, r_new, int_r), None

    (log_s, _, _, int_r), _ = jax.lax.scan(step, init,
                                           jnp.arange(num_steps))
    return spot * jnp.exp(log_s), jnp.exp(-int_r)
