"""Black-Scholes closed-form analytics in JAX.

Re-design of the reference's scalar BS helpers
(reference: engine/monte_carlo.py:28-55 and engine/surface.py:22-45).
Differences from the reference:

- Fully vectorized: every function broadcasts over arrays of spots / strikes /
  maturities / vols (the reference loops per strike in Python).
- Fully differentiable: Greeks can be obtained either from the closed forms
  below or via `jax.grad(bs_price)` — both are exercised by the test suite.
- Numerically safe under AD: T→0 and σ→0 limits are handled with the
  "double-where" pattern so gradients contain no NaNs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import ndtr

Array = jax.Array

_EPS = 1e-12


def norm_pdf(x):
    return jnp.exp(-0.5 * x * x) / jnp.sqrt(2.0 * jnp.pi)


def _d1_d2(S, K, T, r, q, sigma):
    """d₁, d₂ with safe denominators (σ√T floored away from 0 for AD safety)."""
    sqrtT = jnp.sqrt(jnp.maximum(T, _EPS))
    denom = jnp.maximum(sigma * sqrtT, _EPS)
    d1 = (jnp.log(S / K) + (r - q + 0.5 * sigma * sigma) * T) / denom
    d2 = d1 - sigma * sqrtT
    return d1, d2


def bs_price(S, K, T, r, q, sigma, is_call: bool = True):
    """European option price (engine/monte_carlo.py:28-42 semantics).

    At T<=0 or σ<=0 returns the (discounted-forward) intrinsic value, matching
    the reference's degenerate branches (monte_carlo.py:32-34, surface.py:24-25).
    """
    S, K, T, r, q, sigma = map(jnp.asarray, (S, K, T, r, q, sigma))
    degenerate = (T <= _EPS) | (sigma <= _EPS)

    # Safe inputs for the live branch so the dead branch can't poison grads.
    T_s = jnp.where(degenerate, 1.0, T)
    sig_s = jnp.where(degenerate, 1.0, sigma)
    d1, d2 = _d1_d2(S, K, T_s, r, q, sig_s)

    df_r = jnp.exp(-r * T)
    df_q = jnp.exp(-q * T)
    if is_call:
        live = S * df_q * ndtr(d1) - K * df_r * ndtr(d2)
        intrinsic = jnp.maximum(S * df_q - K * df_r, 0.0)
    else:
        live = K * df_r * ndtr(-d2) - S * df_q * ndtr(-d1)
        intrinsic = jnp.maximum(K * df_r - S * df_q, 0.0)
    return jnp.where(degenerate, intrinsic, live)


def bs_delta(S, K, T, r, q, sigma, is_call: bool = True):
    """∂P/∂S (engine/monte_carlo.py:45-55 semantics).

    Degenerate limits are consistent with `bs_price`'s: at expiry (T→0) the
    delta is the spot-moneyness indicator; at σ→0 with time remaining it is
    e^{-qT}·1{forward ITM} — the true N(d₁) limit (d₁ → ±∞ by the sign of
    ln(S/K) + (r−q)T), not the spot comparison.
    """
    S, K, T, r, q, sigma = map(jnp.asarray, (S, K, T, r, q, sigma))
    expired = T <= _EPS
    zero_vol = (sigma <= _EPS) & ~expired
    degenerate = expired | zero_vol
    T_s = jnp.where(degenerate, 1.0, T)
    sig_s = jnp.where(degenerate, 1.0, sigma)
    d1, _ = _d1_d2(S, K, T_s, r, q, sig_s)
    df_q = jnp.exp(-q * T)
    fwd_itm_call = S * jnp.exp((r - q) * T) > K
    if is_call:
        live = df_q * ndtr(d1)
        edge = jnp.where(expired, jnp.where(S > K, 1.0, 0.0),
                         jnp.where(fwd_itm_call, df_q, 0.0))
    else:
        live = df_q * (ndtr(d1) - 1.0)
        edge = jnp.where(expired, jnp.where(S < K, -1.0, 0.0),
                         jnp.where(fwd_itm_call, 0.0, -df_q))
    return jnp.where(degenerate, edge, live)


def bs_gamma(S, K, T, r, q, sigma):
    """∂²P/∂S² (same for call and put)."""
    S, K, T, r, q, sigma = map(jnp.asarray, (S, K, T, r, q, sigma))
    degenerate = (T <= _EPS) | (sigma <= _EPS)
    T_s = jnp.where(degenerate, 1.0, T)
    sig_s = jnp.where(degenerate, 1.0, sigma)
    d1, _ = _d1_d2(S, K, T_s, r, q, sig_s)
    live = jnp.exp(-q * T_s) * norm_pdf(d1) / (S * sig_s * jnp.sqrt(T_s))
    return jnp.where(degenerate, 0.0, live)


def bs_vega(S, K, T, r, q, sigma):
    """∂P/∂σ (engine/surface.py:40-45 semantics; same for call/put)."""
    S, K, T, r, q, sigma = map(jnp.asarray, (S, K, T, r, q, sigma))
    degenerate = (T <= _EPS) | (sigma <= _EPS)
    T_s = jnp.where(degenerate, 1.0, T)
    sig_s = jnp.where(degenerate, 1.0, sigma)
    d1, _ = _d1_d2(S, K, T_s, r, q, sig_s)
    live = S * jnp.exp(-q * T_s) * jnp.sqrt(T_s) * norm_pdf(d1)
    return jnp.where(degenerate, 0.0, live)


def bs_theta(S, K, T, r, q, sigma, is_call: bool = True):
    """∂P/∂t = −∂P/∂T (annualized; calendar decay is positive for long options)."""
    S, K, T, r, q, sigma = map(jnp.asarray, (S, K, T, r, q, sigma))
    degenerate = (T <= _EPS) | (sigma <= _EPS)
    T_s = jnp.where(degenerate, 1.0, T)
    sig_s = jnp.where(degenerate, 1.0, sigma)
    d1, d2 = _d1_d2(S, K, T_s, r, q, sig_s)
    df_r = jnp.exp(-r * T_s)
    df_q = jnp.exp(-q * T_s)
    common = -S * df_q * norm_pdf(d1) * sig_s / (2.0 * jnp.sqrt(T_s))
    if is_call:
        live = common - r * K * df_r * ndtr(d2) + q * S * df_q * ndtr(d1)
    else:
        live = common + r * K * df_r * ndtr(-d2) - q * S * df_q * ndtr(-d1)
    return jnp.where(degenerate, 0.0, live)


def bs_rho(S, K, T, r, q, sigma, is_call: bool = True):
    """∂P/∂r."""
    S, K, T, r, q, sigma = map(jnp.asarray, (S, K, T, r, q, sigma))
    degenerate = (T <= _EPS) | (sigma <= _EPS)
    T_s = jnp.where(degenerate, 1.0, T)
    sig_s = jnp.where(degenerate, 1.0, sigma)
    _, d2 = _d1_d2(S, K, T_s, r, q, sig_s)
    df_r = jnp.exp(-r * T_s)
    if is_call:
        live = K * T_s * df_r * ndtr(d2)
    else:
        live = -K * T_s * df_r * ndtr(-d2)
    return jnp.where(degenerate, 0.0, live)


def bs_all_greeks(S, K, T, r, q, sigma, is_call: bool = True):
    """All five closed-form Greeks in one dict (vectorized)."""
    return {
        "price": bs_price(S, K, T, r, q, sigma, is_call),
        "delta": bs_delta(S, K, T, r, q, sigma, is_call),
        "gamma": bs_gamma(S, K, T, r, q, sigma),
        "vega": bs_vega(S, K, T, r, q, sigma),
        "theta": bs_theta(S, K, T, r, q, sigma, is_call),
        "rho": bs_rho(S, K, T, r, q, sigma, is_call),
    }
