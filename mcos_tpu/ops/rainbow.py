"""Closed-form two-asset rainbow prices (host f64): Stulz and Margrabe.

These are the exact-GBM oracles for the rainbow Monte Carlo in
`engine/basket.py` and double as *control-variate references*: the basket
simulator's companion legs are correlated GBMs with per-asset sigma_i = sqrt(v0_i),
so the same payoff evaluated on the companions has these closed forms
exactly — the control's expectation is known, the estimator stays unbiased.

Precision note: small host-side bivariate-normal CDF evaluations; keeping
this off-device f64 follows the repo's rule for precision-critical small
work.

Capability beyond the reference (single-asset only, SURVEY.md §2 C1-C15).

Formulas: Stulz (1982) "Options on the minimum or maximum of two risky
assets", in cost-of-carry form; Margrabe (1978) exchange option.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import multivariate_normal, norm


def _bvn_cdf(a: float, b: float, rho: float) -> float:
    """P(X ≤ a, Y ≤ b) for standard bivariate normal with correlation rho."""
    rho = float(np.clip(rho, -1 + 1e-12, 1 - 1e-12))
    return float(multivariate_normal(
        mean=[0.0, 0.0], cov=[[1.0, rho], [rho, 1.0]]).cdf([a, b]))


def margrabe_exchange(S1: float, S2: float, T: float, q1: float, q2: float,
                      sigma1: float, sigma2: float, rho: float) -> float:
    """Exchange option E[e^{-rT} max(S1_T − S2_T, 0)] — rate-free.

    The option to exchange asset 2 for asset 1; Margrabe (1978): Black-
    Scholes with S2 as numéraire, volatility of the ratio
    σ² = σ1² + σ2² − 2ρσ1σ2.
    """
    sig = np.sqrt(max(sigma1**2 + sigma2**2 - 2 * rho * sigma1 * sigma2,
                      1e-16))
    st = sig * np.sqrt(T)
    d1 = (np.log(S1 / S2) + (q2 - q1 + 0.5 * sig**2) * T) / st
    d2 = d1 - st
    return float(S1 * np.exp(-q1 * T) * norm.cdf(d1)
                 - S2 * np.exp(-q2 * T) * norm.cdf(d2))


def min_asset_value(S1: float, S2: float, T: float, q1: float, q2: float,
                    sigma1: float, sigma2: float, rho: float) -> float:
    """e^{-rT} E[min(S1_T, S2_T)] = PV(S1) − Margrabe(S1→S2)."""
    return float(S1 * np.exp(-q1 * T)
                 - margrabe_exchange(S1, S2, T, q1, q2, sigma1, sigma2, rho))


def stulz_min_call(S1: float, S2: float, K: float, T: float, r: float,
                   q1: float, q2: float, sigma1: float, sigma2: float,
                   rho: float) -> float:
    """European call on min(S1, S2): E[e^{-rT} max(min(S1_T,S2_T) − K, 0)].

    Stulz (1982) in carry form b_i = r − q_i. K=0 degenerates to
    `min_asset_value` (handled explicitly — the d-terms blow up).
    """
    if K <= 0.0:
        return min_asset_value(S1, S2, T, q1, q2, sigma1, sigma2, rho)
    b1, b2 = r - q1, r - q2
    s1t, s2t = sigma1 * np.sqrt(T), sigma2 * np.sqrt(T)
    sig = np.sqrt(max(sigma1**2 + sigma2**2 - 2 * rho * sigma1 * sigma2,
                      1e-16))
    st = sig * np.sqrt(T)
    g1 = (np.log(S1 / K) + (b1 + 0.5 * sigma1**2) * T) / s1t
    g2 = (np.log(S2 / K) + (b2 + 0.5 * sigma2**2) * T) / s2t
    d12 = (np.log(S2 / S1) + (b2 - b1 - 0.5 * sig**2) * T) / st
    d21 = (np.log(S1 / S2) + (b1 - b2 - 0.5 * sig**2) * T) / st
    r1 = (rho * sigma2 - sigma1) / sig
    r2 = (rho * sigma1 - sigma2) / sig
    return float(
        S1 * np.exp((b1 - r) * T) * _bvn_cdf(g1, d12, r1)
        + S2 * np.exp((b2 - r) * T) * _bvn_cdf(g2, d21, r2)
        - K * np.exp(-r * T) * _bvn_cdf(g1 - s1t, g2 - s2t, rho))


def rainbow_price(S1: float, S2: float, K: float, T: float, r: float,
                  q1: float, q2: float, sigma1: float, sigma2: float,
                  rho: float, kind: str = "worst_of",
                  is_call: bool = True) -> float:
    """Any of the four two-asset rainbow vanillas from Stulz + parities.

    - call on max:  max(a,b) = a + b − min(a,b)  ⇒  c_max = c1 + c2 − c_min
    - puts:         p = K·e^{-rT} − PV(min/max) + c  (min/max put-call parity)
    """
    if kind not in ("worst_of", "best_of"):
        raise ValueError(f"kind must be worst_of|best_of, got {kind!r}")
    from mcos_tpu.ops.bs import bs_price

    cmin = stulz_min_call(S1, S2, K, T, r, q1, q2, sigma1, sigma2, rho)
    if kind == "worst_of":
        c = cmin
        pv_under = min_asset_value(S1, S2, T, q1, q2, sigma1, sigma2, rho)
    else:
        c1 = float(bs_price(S1, K, T, r, q1, sigma1, True))
        c2 = float(bs_price(S2, K, T, r, q2, sigma2, True))
        c = c1 + c2 - cmin
        pv_under = (S1 * np.exp(-q1 * T) + S2 * np.exp(-q2 * T)
                    - min_asset_value(S1, S2, T, q1, q2, sigma1, sigma2,
                                      rho))
    if is_call:
        return float(c)
    return float(K * np.exp(-r * T) - pv_under + c)
