"""Time-dependent SVJ (Bates) dynamics: piecewise-constant θ(t), ξ(t), λ(t).

The reference's term-structure support (`engine/models.py:88-144`) swaps in a
*different constant-parameter* SVJParams per maturity — each expiry is priced
under its own homogeneous model, so the implied dynamics are mutually
inconsistent (the 6M surface and the 1Y surface disagree about what happens
in the first 6 months). This module upgrades that to ONE consistent process:

    dS/S = (r − q − λ(t)·k̄) dt + √v dW₁ + (e^J − 1) dN(λ(t))
    dv   = κ(θ(t) − v) dt + ξ(t) √v dW₂,   d⟨W₁,W₂⟩ = ρ dt

with θ, ξ, λ piecewise-constant on a calendar-time segment grid (κ, ρ, μ_J,
σ_J stay global — the reference's own curve parameterization, models.py:88).

Two consistent implementations, cross-pinned in tests/test_tdsvj.py:

1. **Exact oracle** (`cos_price_td`): the Bates CF chained across segments by
   the Mikhailov-Nögel (2003) time-dependent Heston recursion — each segment's
   Riccati solution takes the next-later segment's (C, D) as its terminal
   condition; jump exponents are additive per segment since λ is constant
   within one. With a single segment this reduces exactly to `bates_cf`
   (pinned). Host numpy complex128 like the rest of ops/cos_pricer.py.
2. **MC simulator** (`simulate_terminal_td`): the same full-truncation
   log-Euler scan as `ops/simulate.py`, with per-step (θ, ξ, λ) entering as
   `lax.scan` xs through `SVJParams.replace` — the step math is byte-for-byte
   `_svj_step_core`, so every dynamics invariant pinned on the constant-param
   simulator carries over.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.models.params import SVJParams, TermStructureSVJ
from mcos_tpu.ops.cos_pricer import cos_expansion_from_phi
from mcos_tpu.ops.simulate import _svj_step_core

Array = jax.Array


# ─────────────────────────────────────────────────────────────────────────────
# Segment grid
# ─────────────────────────────────────────────────────────────────────────────
def normalize_segments(
    seg_ends: Sequence[float],
    thetas: Sequence[float],
    xis: Sequence[float],
    lams: Sequence[float],
    T: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Clip/extend a piecewise-constant segment spec to exactly cover [0, T].

    `seg_ends` are ascending right edges in calendar years. Segments past T
    are dropped; if the last edge falls short of T the final segment is
    extended (flat extrapolation — models.py:134-137 convention).
    """
    ends = np.asarray(seg_ends, np.float64)
    th = np.asarray(thetas, np.float64)
    xi = np.asarray(xis, np.float64)
    lam = np.asarray(lams, np.float64)
    if not (ends.shape == th.shape == xi.shape == lam.shape):
        raise ValueError("segment arrays must share one length")
    if ends.size == 0:
        raise ValueError("need at least one segment")
    if np.any(np.diff(ends) <= 0) or ends[0] <= 0:
        raise ValueError("segment ends must be positive and ascending")
    keep = int(np.searchsorted(ends, T - 1e-12) + 1)
    keep = min(keep, ends.size)
    ends, th, xi, lam = ends[:keep].copy(), th[:keep], xi[:keep], lam[:keep]
    ends[-1] = T
    return ends, th, xi, lam


def segments_from_term_structure(
    ts: TermStructureSVJ, T: float, n_segments: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Discretize a `TermStructureSVJ`'s piecewise-linear *maturity* curves
    into piecewise-constant *calendar-time* segments via forward stripping.

    The TS curves give per-maturity aggregate levels; a consistent process
    needs instantaneous levels. θ(T) and λ(T) enter aggregate quantities
    ~linearly in time (∫θ, ∫λ), so strip forwards: inst_s = (c(t_s)·t_s −
    c(t_{s-1})·t_{s-1}) / τ_s. ξ(T) enters variance-of-variance ~as ∫ξ², so
    strip in ξ² space. Floors keep stripped values admissible when the input
    curve is steeply inverted (θ, λ ≥ 0; ξ ≥ 1e-4).
    """
    edges = np.linspace(0.0, T, n_segments + 1)
    mids_end = edges[1:]

    def curve(vals: dict, t: np.ndarray, default: float) -> np.ndarray:
        return np.array(
            [ts._interp(vals, float(x), default) for x in t], np.float64)

    th_agg = curve(ts.theta_curve, mids_end, 0.04)
    xi_agg = curve(ts.xi_curve, mids_end, 0.5)
    lam_agg = curve(ts.lambda_curve, mids_end, 1.0)

    tau = np.diff(edges)

    def strip_linear(agg: np.ndarray, floor: float) -> np.ndarray:
        cum = agg * mids_end
        inst = np.diff(np.concatenate([[0.0], cum])) / tau
        return np.maximum(inst, floor)

    th = strip_linear(th_agg, 1e-6)
    lam = strip_linear(lam_agg, 0.0)
    xi = np.sqrt(strip_linear(xi_agg**2, 1e-8))
    return mids_end, th, xi, lam


def step_param_arrays(
    seg_ends: np.ndarray,
    thetas: np.ndarray,
    xis: np.ndarray,
    lams: np.ndarray,
    T: float,
    num_steps: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-step (θ, ξ, λ) arrays for an Euler grid of `num_steps` on [0, T].

    Step i covers [i·dt, (i+1)·dt] and takes the segment containing its
    midpoint — the piecewise-constant analogue of the left-point rule used
    everywhere else in the engine.
    """
    dt = T / num_steps
    mids = (np.arange(num_steps) + 0.5) * dt
    idx = np.minimum(np.searchsorted(seg_ends, mids), seg_ends.size - 1)
    return thetas[idx], xis[idx], lams[idx]


def _expected_integrals(kappa: float, v0: float, taus: np.ndarray,
                        thetas: np.ndarray, lams: np.ndarray):
    """(∫₀ᵀ E[v_t] dt, ∫₀ᵀ λ(t) dt) under piecewise-constant (θ, λ).

    E[v_t] solves a linear ODE per segment (dE[v]/dt = κ(θ_s − E[v])), so
    both the integral and the segment-end value are exact:
        ∫ = θ_s τ + (v_start − θ_s)(1 − e^{−κτ})/κ,
        v_end = θ_s + (v_start − θ_s) e^{−κτ}.
    """
    v = float(v0)
    int_v = 0.0
    int_lam = 0.0
    for s in range(len(taus)):
        tau, th, lam = float(taus[s]), float(thetas[s]), float(lams[s])
        if kappa > 1e-8:
            e_kt = np.exp(-kappa * tau)
            int_v += th * tau + (v - th) * (1.0 - e_kt) / kappa
            v = th + (v - th) * e_kt
        else:
            int_v += v * tau
        int_lam += lam * tau
    return int_v, int_lam


def td_variance_swap_fair_strike(
    params: SVJParams,
    seg_ends,
    thetas,
    xis,
    lams,
    T: float,
) -> dict:
    """Fair variance-swap strike under td dynamics — exact closed form.

    The td analogue of exotics.variance_swap_fair_strike (whose CIR mean
    integral it reproduces exactly in the constant-segment limit):
        QV/T = (1/T) ∫₀ᵀ E[v_t] dt            (piecewise-exact recursion)
             + (1/T) Σ_s λ_s τ_s (μ_J² + σ_J²)  (jump second moment)
    ξ(t) does not enter (E[v] is ξ-free); it only moves higher moments.
    Returns both legs and the total in variance units.
    """
    seg_ends, thetas, xis, lams = normalize_segments(
        seg_ends, thetas, xis, lams, T)
    taus = np.diff(np.concatenate([[0.0], seg_ends]))
    int_v, int_lam = _expected_integrals(
        float(params.kappa), float(params.v0), taus, thetas, lams)
    diffusion = int_v / T
    jumps = (int_lam / T) * (float(params.mu_j) ** 2
                             + float(params.sigma_j) ** 2)
    total = diffusion + jumps
    return {
        "fair_variance": total,
        "fair_vol_strike": float(np.sqrt(max(total, 0.0))),
        "diffusion_leg": diffusion,
        "jump_leg": jumps,
    }


# ─────────────────────────────────────────────────────────────────────────────
# Exact oracle: chained-Riccati Bates CF (Mikhailov-Nögel 2003)
# ─────────────────────────────────────────────────────────────────────────────
def td_bates_cf(
    u: np.ndarray,
    params: SVJParams,
    seg_ends: np.ndarray,
    thetas: np.ndarray,
    xis: np.ndarray,
    lams: np.ndarray,
    T: float,
    spot: float,
) -> np.ndarray:
    """CF E[e^{iu ln S_T}] under piecewise-constant (θ, ξ, λ) Bates dynamics.

    `params` supplies the global (κ, ρ, v0, μ_J, σ_J, r, q). Segments are
    processed in reverse calendar order; each Heston Riccati solve takes the
    accumulated D as its terminal condition:

        r± = (β ± d)/ξ²,  β = κ − ρξiu,  d = √(β² + ξ²(u² + iu))
        g  = (D₀ − r₋)/(D₀ − r₊)
        D(τ) = (r₋ − r₊ g e^{−dτ}) / (1 − g e^{−dτ})
        C(τ) = C₀ + κθ[r₋τ − (2/ξ²) ln((1 − g e^{−dτ})/(1 − g))]

    With D₀ = 0 this is exactly the little-trap form in `bates_cf`
    (cos_pricer.py:50-58), so a single segment reproduces it to rounding.
    The principal branch of √· keeps Re(d) ≥ 0, hence |e^{−dτ}| ≤ 1 — the
    same continuity argument as the little trap, segment by segment.

    Jumps: λ constant within a segment ⇒ the jump exponent is additive,
    Σ_s λ_s τ_s [(e^{iuμ_J − u²σ_J²/2} − 1) − iu k̄].
    """
    p = params
    kappa, rho = float(p.kappa), float(p.rho)
    v0, r, q = float(p.v0), float(p.r), float(p.q)
    mu_j, sig_j = float(p.mu_j), float(p.sigma_j)

    u = np.asarray(u, np.complex128)
    iu = 1j * u

    starts = np.concatenate([[0.0], seg_ends[:-1]])
    taus = seg_ends - starts

    C = np.zeros_like(u)
    D = np.zeros_like(u)
    jump_exp = np.zeros_like(u)
    k_bar = np.exp(mu_j + 0.5 * sig_j**2) - 1.0
    jump_factor = np.exp(iu * mu_j - 0.5 * u**2 * sig_j**2) - 1.0

    for s in range(len(taus) - 1, -1, -1):
        tau = float(taus[s])
        if tau <= 0.0:
            continue
        theta, xi, lam = float(thetas[s]), float(xis[s]), float(lams[s])
        xi2 = xi * xi
        beta = kappa - rho * xi * iu
        d = np.sqrt(beta**2 + xi2 * (u**2 + iu))
        r_minus = (beta - d) / xi2
        r_plus = (beta + d) / xi2
        g = (D - r_minus) / (D - r_plus)
        e_dt = np.exp(-d * tau)
        denom = 1.0 - g * e_dt
        D = (r_minus - r_plus * g * e_dt) / denom
        C = C + kappa * theta * (
            r_minus * tau - (2.0 / xi2) * np.log(denom / (1.0 - g)))
        jump_exp = jump_exp + lam * tau * (jump_factor - iu * k_bar)

    drift = iu * (np.log(spot) + (r - q) * T)
    return np.exp(drift + C + D * v0 + jump_exp)


def _cumulant_range_td(
    params: SVJParams,
    seg_ends: np.ndarray,
    thetas: np.ndarray,
    xis: np.ndarray,
    lams: np.ndarray,
    T: float,
    spot: float,
    L: float = 12.0,
) -> Tuple[float, float]:
    """Truncation interval for ln S_T: exact c1 via the segment recursion for
    E[∫v dt]; c2/c4 from the constant-param formulas at time-averaged levels
    (truncation only needs the right scale — L=12 is generous)."""
    p = params
    kappa = float(p.kappa)
    mu_j, sig_j = float(p.mu_j), float(p.sigma_j)
    r, q = float(p.r), float(p.q)
    k_bar = np.exp(mu_j + 0.5 * sig_j**2) - 1.0

    starts = np.concatenate([[0.0], seg_ends[:-1]])
    taus = seg_ends - starts

    int_v, int_lam = _expected_integrals(kappa, float(p.v0), taus, thetas,
                                         lams)

    c1 = (np.log(spot) + (r - q) * T - int_lam * k_bar - 0.5 * int_v
          + int_lam * mu_j)

    theta_bar = float(np.sum(thetas * taus) / T)
    xi_bar = float(np.sqrt(np.sum(xis**2 * taus) / T))
    lam_bar = float(int_lam / T)
    rho = float(p.rho)
    v0 = float(p.v0)
    if kappa * T > 0.01:
        # Same κT guard as ops/cos_pricer.py:_cumulant_range — the closed
        # form cancels catastrophically in f64 below it.
        ekt = np.exp(-kappa * T)
        xi_ = xi_bar
        c2_h = (xi_ * T * kappa * ekt * (v0 - theta_bar)
                * (8 * kappa * rho - 4 * xi_)
                + kappa * rho * xi_ * (1 - ekt) * (16 * theta_bar - 8 * v0)
                + 2 * theta_bar * kappa * T * (-4 * kappa * rho * xi_
                                               + xi_**2 + 4 * kappa**2)
                + xi_**2 * ((theta_bar - 2 * v0) * np.exp(-2 * kappa * T)
                            + theta_bar * (6 * ekt - 7) + 2 * v0)
                + 8 * kappa**2 * (v0 - theta_bar) * (1 - ekt)) / (8 * kappa**3)
    else:
        c2_h = (v0 * T + xi_bar**2 * v0 * T**3 / 12.0
                - rho * xi_bar * v0 * T**2 / 2.0)
    c2 = abs(c2_h) + lam_bar * T * (mu_j**2 + sig_j**2)
    c4 = lam_bar * T * (mu_j**4 + 6 * mu_j**2 * sig_j**2 + 3 * sig_j**4)
    half = L * np.sqrt(c2 + np.sqrt(max(c4, 0.0)))
    return c1 - half, c1 + half


def cos_price_td(
    params: SVJParams,
    spot: float,
    strikes,
    T: float,
    seg_ends,
    thetas,
    xis,
    lams,
    is_call: bool = True,
    n_terms: int = 512,
    L: float = 12.0,
) -> np.ndarray:
    """European prices under piecewise-constant (θ, ξ, λ) Bates dynamics —
    the exact oracle the td MC simulator is pinned against."""
    seg_ends, thetas, xis, lams = normalize_segments(
        seg_ends, thetas, xis, lams, T)
    a, b = _cumulant_range_td(params, seg_ends, thetas, xis, lams, T, spot,
                              L=L)
    u = np.arange(n_terms) * np.pi / (b - a)
    phi = td_bates_cf(u, params, seg_ends, thetas, xis, lams, T, spot)
    return cos_expansion_from_phi(phi, a, b, spot, strikes, T,
                                  float(params.r), float(params.q), is_call)


# ─────────────────────────────────────────────────────────────────────────────
# MC simulator: the constant-param scan with per-step (θ, ξ, λ) as xs
# ─────────────────────────────────────────────────────────────────────────────
@partial(jax.jit, static_argnames=(
    "num_paths", "num_steps", "antithetic", "companion", "dtype"))
def simulate_terminal_td(
    params: SVJParams,
    theta_t: Array,
    xi_t: Array,
    lam_t: Array,
    spot,
    T,
    key: Array,
    num_paths: int,
    num_steps: int,
    antithetic: bool = True,
    companion: bool = False,
    dtype=jnp.float32,
) -> Tuple[Array, Array, Optional[Array]]:
    """Time-dependent twin of `simulate.simulate_terminal`.

    `theta_t/xi_t/lam_t` are (num_steps,) per-step levels (from
    `step_param_arrays`). Each step runs the SAME `_svj_step_core` with
    `params.replace(theta=θᵢ, xi=ξᵢ, lambda_j=λᵢ)` — constant arrays
    reproduce the constant-param simulator exactly (pinned in tests).

    The companion CV leg keeps σ = √v0 (a GBM on the same dW₁ with known
    BS expectation — still a valid control under td dynamics).
    """
    n_branch = 2 if antithetic else 1
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None]

    log_s0 = jnp.zeros((n_branch, num_paths), dtype)
    v0 = jnp.broadcast_to(jnp.asarray(params.v0, dtype),
                          (n_branch, num_paths))

    sigma_cv = jnp.sqrt(jnp.asarray(params.v0, dtype))
    g_drift = (params.r - params.q - 0.5 * sigma_cv**2) * dt

    xs = (jnp.arange(num_steps),
          jnp.asarray(theta_t, dtype),
          jnp.asarray(xi_t, dtype),
          jnp.asarray(lam_t, dtype))

    def step(carry, x):
        log_s, v, log_g = carry
        step_idx, theta_i, xi_i, lam_i = x
        p_i = params.replace(theta=theta_i, xi=xi_i, lambda_j=lam_i)
        k_step = jax.random.fold_in(key, step_idx)
        k_norm, k_unif = jax.random.split(k_step)
        z = jax.random.normal(k_norm, (3, num_paths), dtype)
        u_jump = jax.random.uniform(k_unif, (num_paths,), dtype)
        z1 = z[0] * sign
        z2 = z[1] * sign
        z_js = z[2] * sign
        log_s, v = _svj_step_core(p_i, dt, sqrt_dt, log_s, v,
                                  z1, z2, u_jump[None, :], z_js)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
        return (log_s, v, log_g), None

    (log_s, v, log_g), _ = jax.lax.scan(step, (log_s0, v0, log_s0), xs)
    return (spot * jnp.exp(log_s), v,
            (spot * jnp.exp(log_g) if companion else None))


@partial(jax.jit, static_argnames=(
    "num_paths", "num_steps", "companion", "dtype"))
def simulate_reset_td(
    params: SVJParams,
    theta_t: Array,
    xi_t: Array,
    lam_t: Array,
    spot,
    T,
    reset_step,
    key: Array,
    num_paths: int,
    num_steps: int,
    companion: bool = True,
    dtype=jnp.float32,
):
    """`simulate_terminal_td` that also captures log S at a reset date.

    `reset_step` ∈ [1, num_steps−1]: the reset falls after that many Euler
    steps (t₁ = reset_step·dt). Returns (s_reset, s_T, g_reset, g_T), each
    (2, num_paths) antithetic — the inputs to forward-start / cliquet-leg
    payoffs, whose value depends on the *path across expiries* and is
    therefore only well-defined under ONE consistent process (the whole
    point of the td model; a per-maturity parameter swap gives no answer).
    """
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[:, None]

    log_s0 = jnp.zeros((2, num_paths), dtype)
    v0 = jnp.broadcast_to(jnp.asarray(params.v0, dtype), (2, num_paths))
    sigma_cv = jnp.sqrt(jnp.asarray(params.v0, dtype))
    g_drift = (params.r - params.q - 0.5 * sigma_cv**2) * dt

    xs = (jnp.arange(num_steps),
          jnp.asarray(theta_t, dtype),
          jnp.asarray(xi_t, dtype),
          jnp.asarray(lam_t, dtype))
    reset_idx = jnp.asarray(reset_step, jnp.int32) - 1

    def step(carry, x):
        log_s, v, log_g, log_s_r, log_g_r = carry
        step_idx, theta_i, xi_i, lam_i = x
        p_i = params.replace(theta=theta_i, xi=xi_i, lambda_j=lam_i)
        k_step = jax.random.fold_in(key, step_idx)
        k_norm, k_unif = jax.random.split(k_step)
        z = jax.random.normal(k_norm, (3, num_paths), dtype)
        u_jump = jax.random.uniform(k_unif, (num_paths,), dtype)
        log_s, v = _svj_step_core(p_i, dt, sqrt_dt, log_s, v,
                                  z[0] * sign, z[1] * sign,
                                  u_jump[None, :], z[2] * sign)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z[0] * sign * sqrt_dt
        hit = step_idx == reset_idx
        log_s_r = jnp.where(hit, log_s, log_s_r)
        log_g_r = jnp.where(hit, log_g, log_g_r)
        return (log_s, v, log_g, log_s_r, log_g_r), None

    (log_s, _, log_g, log_s_r, log_g_r), _ = jax.lax.scan(
        step, (log_s0, v0, log_s0, log_s0, log_s0), xs)
    return (spot * jnp.exp(log_s_r), spot * jnp.exp(log_s),
            (spot * jnp.exp(log_g_r) if companion else None),
            (spot * jnp.exp(log_g) if companion else None))
