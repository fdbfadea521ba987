"""SVCJ dynamics: correlated jumps in price and variance.

Two halves, same philosophy as the SVJ stack (ops/simulate.py +
ops/cos_pricer.py — capability the reference does not have; its engine
stops at SVJ, reference engine/models.py:25-28):

1. `svcj_terminal` — differentiable scan simulator with in-scan threefry
   draws, antithetic pairing, and the GBM companion control-variate leg.
   The step recursion extends `_svj_step_core`'s full-truncation log-Euler
   scheme with the exponential variance jump Z_v = μ_v·E and the
   correlated price-jump mean μ_j + ρ_J·Z_v.

2. `svcj_cf` / `svcj_cos_price` — the semi-analytic oracle. The SVCJ
   characteristic function is the Heston "little trap" CF times a jump
   transform whose time integral ∫₀ᵀ(𝔐(u, B(u,s)) − 1)ds we evaluate by
   Gauss-Legendre quadrature in host complex128 (the integrand is smooth;
   128 nodes put the quadrature error far below the COS truncation error).
   𝔐 is the joint jump MGF: E[e^{iu Z_s + B Z_v}] =
   e^{iuμ_j − u²σ_j²/2} / (1 − μ_v B − iu ρ_J μ_v).

Pricing convention notes: one Poisson clock drives both jumps; the jump is
applied at the END of each Euler step (same O(dt) timing convention as
`_svj_step_core`, so the MC-vs-COS test bands include the same
discretization allowance the SVJ oracle test uses).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.models.params import SVCJParams
from mcos_tpu.ops.cos_pricer import (
    _cumulant_range,
    cos_expansion_from_phi,
)
from mcos_tpu.ops.simulate import _safe_sqrt

Array = jax.Array


def _svcj_step_core(params: SVCJParams, dt, sqrt_dt, log_s, v,
                    z1, z2, u_jump, z_js, e_v):
    """One full-truncation log-Euler SVCJ step.

    `e_v` is a standard Exp(1) draw; the variance jump is Z_v = μ_v·e_v.
    Antithetic convention: normals (z1, z2, z_js) negate across branches,
    jump-occurrence uniforms AND exponential magnitudes are shared — the
    same pairing `_svj_step_core` callers use, extended to Z_v (an
    exponential has no antithetic reflection).
    """
    p = params
    v_pos = jnp.maximum(v, 0.0)
    sqrt_v = _safe_sqrt(v_pos)

    k_bar = (jnp.exp(p.mu_j + 0.5 * p.sigma_j**2)
             / (1.0 - p.rho_j * p.mu_v) - 1.0)
    drift_comp = p.r - p.q - p.lambda_j * k_bar

    dw1 = z1 * sqrt_dt
    dw2 = p.rho * dw1 + jnp.sqrt(1.0 - p.rho * p.rho) * z2 * sqrt_dt

    jump_ind = u_jump < p.lambda_j * dt
    z_v = p.mu_v * e_v
    jump_s = jnp.where(jump_ind, p.mu_j + p.rho_j * z_v + p.sigma_j * z_js,
                       0.0)

    log_s = log_s + (drift_comp - 0.5 * v_pos) * dt + sqrt_v * dw1 + jump_s
    v = v_pos + p.kappa * (p.theta - v_pos) * dt + p.xi * sqrt_v * dw2 \
        + jnp.where(jump_ind, z_v, 0.0)
    v = jnp.maximum(v, 0.0)
    return log_s, v


@partial(jax.jit, static_argnames=(
    "num_paths", "num_steps", "antithetic", "companion", "dtype"))
def svcj_terminal(
    params: SVCJParams,
    spot,
    T,
    key: Array,
    num_paths: int,
    num_steps: int,
    antithetic: bool = True,
    companion: bool = False,
    dtype=jnp.float32,
) -> Tuple[Array, Array, Optional[Array]]:
    """Terminal (S, v, G) under SVCJ; mirrors simulate.simulate_terminal.

    The companion G is the same constant-vol GBM leg riding dW₁ (its
    expectation is the BS(√v0) price — variance jumps never touch it, so
    it stays a valid control variate).
    """
    n_branch = 2 if antithetic else 1
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None]

    # Relative-log carry: see simulate.simulate_terminal's f32 note.
    log_s0 = jnp.zeros((n_branch, num_paths), dtype)
    v0 = jnp.broadcast_to(jnp.asarray(params.v0, dtype),
                          (n_branch, num_paths))
    sigma_cv = jnp.sqrt(jnp.asarray(params.v0, dtype))
    g_drift = (params.r - params.q - 0.5 * sigma_cv**2) * dt

    def step(carry, step_idx):
        log_s, v, log_g = carry
        k_step = jax.random.fold_in(key, step_idx)
        k_norm, k_unif = jax.random.split(k_step)
        z = jax.random.normal(k_norm, (3, num_paths), dtype)
        u = jax.random.uniform(k_unif, (2, num_paths), dtype)
        z1 = z[0] * sign
        z2 = z[1] * sign
        z_js = z[2] * sign
        u_jump = u[0][None, :]
        e_v = -jnp.log1p(-u[1])[None, :]      # Exp(1), shared across pair
        log_s, v = _svcj_step_core(params, dt, sqrt_dt, log_s, v,
                                   z1, z2, u_jump, z_js, e_v)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
        return (log_s, v, log_g), None

    (log_s, v, log_g), _ = jax.lax.scan(
        step, (log_s0, v0, log_s0), jnp.arange(num_steps))
    return (spot * jnp.exp(log_s), v,
            (spot * jnp.exp(log_g) if companion else None))


# ─────────────────────────────────────────────────────────────────────────────
# Semi-analytic oracle (host complex128, same design as ops/cos_pricer.py)
# ─────────────────────────────────────────────────────────────────────────────
def svcj_cf(u: np.ndarray, params: SVCJParams, T: float, spot: float,
            n_quad: int = 128) -> np.ndarray:
    """Characteristic function E[e^{iu ln S_T}] of the SVCJ model.

    Heston part: Albrecher "little trap" (identical to cos_pricer.bates_cf).
    Jump part: λ∫₀ᵀ(𝔐(u,B(u,s)) − 1)ds − iuλk̄T with the integral by
    Gauss-Legendre. As μ_v → 0 the transform collapses to the Merton term
    and the CF reduces exactly to bates_cf (pinned in tests).
    """
    p = params
    kappa, theta, xi = float(p.kappa), float(p.theta), float(p.xi)
    rho, v0 = float(p.rho), float(p.v0)
    lam, mu_j, sig_j = float(p.lambda_j), float(p.mu_j), float(p.sigma_j)
    mu_v, rho_j = float(p.mu_v), float(p.rho_j)
    r, q = float(p.r), float(p.q)
    if rho_j * mu_v >= 1.0:
        raise ValueError(f"rho_j*mu_v={rho_j * mu_v:.3f} >= 1: "
                         "jump compensator diverges")

    u = np.asarray(u, np.complex128)
    iu = 1j * u

    beta = kappa - rho * xi * iu
    d = np.sqrt(beta**2 + xi**2 * (iu + u**2))
    g2 = (beta - d) / (beta + d)
    exp_dt = np.exp(-d * T)
    log_term = np.log((1.0 - g2 * exp_dt) / (1.0 - g2))
    C = (kappa * theta / xi**2) * ((beta - d) * T - 2.0 * log_term)
    D = ((beta - d) / xi**2) * (1.0 - exp_dt) / (1.0 - g2 * exp_dt)

    k_bar = np.exp(mu_j + 0.5 * sig_j**2) / (1.0 - rho_j * mu_v) - 1.0

    # ∫₀ᵀ (𝔐(u, B(u,s)) − 1) ds on Gauss-Legendre nodes; B(u,s) is the
    # Heston D-function at horizon s (the variance jump decays through the
    # same CIR ODE the diffusion does).
    nodes, weights = np.polynomial.legendre.leggauss(n_quad)
    s = 0.5 * T * (nodes + 1.0)                      # (n_quad,)
    w = 0.5 * T * weights
    exp_ds = np.exp(-d[None, :] * s[:, None])        # (n_quad, n_u)
    B = ((beta - d) / xi**2)[None, :] * (1.0 - exp_ds) \
        / (1.0 - g2[None, :] * exp_ds)
    mgf = np.exp(iu * mu_j - 0.5 * u**2 * sig_j**2)[None, :] \
        / (1.0 - mu_v * B - (iu * rho_j * mu_v)[None, :])
    integral = np.sum(w[:, None] * (mgf - 1.0), axis=0)
    jump = lam * integral - iu * lam * k_bar * T

    drift = iu * (np.log(spot) + (r - q) * T)
    return np.exp(drift + C + D * v0 + jump)


def svcj_cos_price(params: SVCJParams, spot: float, strikes, T: float,
                   is_call: bool = True, n_terms: int = 1024,
                   L: float = 14.0) -> np.ndarray:
    """European SVCJ prices via the COS expansion of `svcj_cf`.

    Truncation range: the SVJ cumulant formulas on an effective parameter
    set — θ_eff = θ + λμ_v/κ absorbs the variance-jump lift of E[v] and
    σ_j,eff² = σ_j² + ρ_J²μ_v² the price-jump variance of the ρ_J·Z_v
    term — with a wider safety factor (L=14) and more terms than the pure
    Bates default to cover the fatter tails.
    """
    p = params
    svj_eff = p.svj_part().replace(
        theta=float(p.theta) + float(p.lambda_j) * float(p.mu_v)
        / max(float(p.kappa), 1e-8),
        sigma_j=float(np.sqrt(float(p.sigma_j)**2
                              + (float(p.rho_j) * float(p.mu_v))**2)),
    )
    a, b = _cumulant_range(svj_eff, T, spot, L=L)
    u = np.arange(n_terms) * np.pi / (b - a)
    phi = svcj_cf(u, params, T, spot)
    return cos_expansion_from_phi(phi, a, b, spot, strikes, T,
                                  float(p.r), float(p.q), is_call)
