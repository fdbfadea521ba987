r"""Rough Heston: fractional-Riccati COS oracle + multi-factor lifted MC.

Model family beyond the reference (its engine stops at classical SVJ,
reference engine/models.py:25-28) and the natural companion to the
repo's rough Bergomi stack (ops/rough.py): where rBergomi has a
log-normal, non-mean-reverting variance, rough Heston keeps the CIR
mean-reversion of Heston but drives it through the fractional kernel

    v_t = v0 + (1/Gamma(alpha)) * int_0^t (t-s)^(alpha-1)
              [ lam*(theta - v_s) ds + nu*sqrt(v_s) dB_s ],
    dS/S = (r - q) dt + sqrt(v_t) dW1,   d<W1, B> = rho dt,

with alpha = H + 1/2 in (1/2, 1). At H = 1/2 the kernel is constant and
the model IS classical Heston (test-pinned both in the CF and the MC).

Two independent routes to the same law, per the repo's oracle doctrine:

1. **Exact CF (host complex128)** — El Euch-Rosenbaum: the CF of
   x = ln S_T solves through the fractional Riccati equation

       D^alpha h(u, t) = F(u, h),
       F(u, h) = -(u^2 + i*u)/2 + (i*u*rho*nu - lam) h + nu^2 h^2 / 2,
       log phi(u) = i*u*(ln S0 + (r-q)T)
                    + theta*lam * I^1 h(u, T) + v0 * I^(1-alpha) h(u, T),

   solved by the fractional Adams predictor-corrector scheme (Diethelm-
   Ford-Freed), vectorized over the COS u-grid. At alpha = 1 this is the
   classical Heston Riccati ODE and phi reduces to the little-trap CF in
   ops/cos_pricer.py (pinned to rtol ~ 1e-4 by the Adams error O(dt^2)).
   The COS truncation interval is self-calibrating: c2/c4 cumulants read
   off the CF itself by small-u finite differences (no closed-form
   cumulants exist for the rough model).

2. **Lifted (multi-factor Markovian) MC on device** — Abi Jaber's lifted
   Heston: approximate the power kernel by a sum of exponentials,
   K(t) ~= sum_i c_i exp(-x_i t), with (c_i, x_i) moment-matched against
   the inverse-Laplace measure mu(dx) = x^(-alpha)/(Gamma(alpha)
   Gamma(1-alpha)) dx on a geometric grid. The variance becomes an
   n-factor affine state

       v = max(v0 + sum_i c_i V_i, 0),
       V_i <- (V_i + dt*lam*(theta - v) + nu*sqrt(v)*dB)/(1 + x_i dt),

   one explicit-semi-implicit Euler step (the 1/(1+x dt) damping keeps
   the stiff high-frequency factors stable at x_max*dt >> 1). On device the
   whole factor block is a (n_factors, branch, paths) elementwise update
   inside ONE `lax.scan` — no per-factor loop, no materialized history —
   and the scan is differentiable, so delta / dP/dv0 / vega come out of
   the same `jax.grad` machinery every other engine uses. Antithetic
   pairing and the GBM companion control variate follow the repo-wide
   conventions of ops/simulate.py (companion rides the SAME dW1).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache, partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import DIVIDEND_YIELD, RISK_FREE_RATE
from mcos_tpu.ops.cos_pricer import cos_expansion_from_phi
from mcos_tpu.ops.simulate import _safe_sqrt

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RoughHestonParams:
    """Rough Heston parameters. `hurst` is static (it shapes the host-side
    Adams weights and the lifted-kernel fit); the rest are traced leaves,
    so (lam, theta, nu, rho, v0) sensitivities compose with `jax.grad`."""

    lam: float = 1.5        # mean-reversion speed (kappa of the rough CIR)
    theta: float = 0.04     # long-run variance
    nu: float = 0.35        # vol-of-vol on the fractional kernel
    rho: float = -0.7       # spot/vol correlation
    v0: float = 0.04        # initial variance
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD
    hurst: float = dataclasses.field(default=0.1,
                                     metadata={"static": True})

    def replace(self, **updates) -> "RoughHestonParams":
        return dataclasses.replace(self, **updates)


# ─────────────────────────────────────────────────────────────────────────────
# Fractional Riccati CF (host complex128) — the exact oracle
# ─────────────────────────────────────────────────────────────────────────────
def _riccati_rhs(u: np.ndarray, h: np.ndarray, lam: float, nu: float,
                 rho: float) -> np.ndarray:
    """F(u, h) of the rough-Heston Riccati (classical Heston RHS)."""
    iu = 1j * u
    return -0.5 * (u * u + iu) + (iu * rho * nu - lam) * h \
        + 0.5 * nu * nu * h * h


def rough_heston_h(u: np.ndarray, params: RoughHestonParams, T: float,
                   n_steps: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """Solve D^alpha h = F(u, h), h(0) = 0 on [0, T] for a vector of u.

    Fractional Adams predictor-corrector (Diethelm-Ford-Freed), error
    O(dt^(1+alpha)). Both weight families depend only on the lag k - j, so
    each step is one complex dot over the stored F-history, vectorized
    across the whole u grid. Returns (h, Fh), each (n_steps+1, n_u).
    """
    alpha = float(params.hurst) + 0.5
    lam, nu, rho = float(params.lam), float(params.nu), float(params.rho)
    u = np.asarray(u, np.complex128)
    n_u = u.shape[0]
    N = int(n_steps)
    dt = T / N

    m = np.arange(N + 1, dtype=np.float64)
    # Predictor (rectangle) weights b_m and corrector (trapezoid) lag
    # weights a_m, both indexed by lag m = k - j.
    b = (dt ** alpha / alpha) * ((m + 1.0) ** alpha - m ** alpha)
    a = (dt ** alpha / (alpha * (alpha + 1.0))) * (
        (m + 2.0) ** (alpha + 1.0) + m ** (alpha + 1.0)
        - 2.0 * (m + 1.0) ** (alpha + 1.0))
    a_new = dt ** alpha / (alpha * (alpha + 1.0))   # weight of F(h_pred)
    inv_gamma = 1.0 / math.gamma(alpha)

    h = np.zeros((N + 1, n_u), np.complex128)
    Fh = np.zeros((N + 1, n_u), np.complex128)
    Fh[0] = _riccati_rhs(u, h[0], lam, nu, rho)

    ks = np.arange(N, dtype=np.float64)
    # j = 0 corrector weight is the one lag-dependent exception.
    a0 = (dt ** alpha / (alpha * (alpha + 1.0))) * (
        ks ** (alpha + 1.0) - (ks - alpha) * (ks + 1.0) ** alpha)

    # Overflow at coarse N is handled by the caller's step-doubling guard
    # (rough_heston_cos_price) — silence the warning, propagate the nan.
    with np.errstate(over="ignore", invalid="ignore"):
        for k in range(N):
            hist = Fh[:k + 1]                        # (k+1, n_u)
            pred = inv_gamma * (b[k::-1][:, None] * hist).sum(axis=0)
            f_pred = _riccati_rhs(u, pred, lam, nu, rho)
            if k == 0:
                lag_sum = np.zeros(n_u, np.complex128)
            else:
                lag_sum = (a[k - 1::-1][:, None] * Fh[1:k + 1]).sum(axis=0)
            h[k + 1] = inv_gamma * (a0[k] * Fh[0] + lag_sum + a_new * f_pred)
            Fh[k + 1] = _riccati_rhs(u, h[k + 1], lam, nu, rho)
    return h, Fh


def rough_heston_cf(u: np.ndarray, params: RoughHestonParams, T: float,
                    spot: float, n_steps: int = 256) -> np.ndarray:
    """Characteristic function E[e^{iu ln S_T}] of the rough Heston model.

    log phi = iu(ln S0 + (r-q)T) + theta*lam*I^1 h(T) + v0*I^(1-alpha)h(T).
    I^1 by trapezoid; I^(1-alpha) (the Riemann-Liouville integral with the
    (T-s)^(-alpha) endpoint singularity) by the product-trapezoid rule —
    piecewise-linear h integrated EXACTLY against the kernel, the same
    weight family as the Adams corrector at the final node.
    """
    alpha = float(params.hurst) + 0.5
    r, q, v0 = float(params.r), float(params.q), float(params.v0)
    theta, lam = float(params.theta), float(params.lam)
    u = np.asarray(u, np.complex128)
    N = int(n_steps)
    dt = T / N

    h, _ = rough_heston_h(u, params, T, n_steps=N)

    # I^1 h(T): trapezoid (h is smooth away from 0; h(0)=0).
    i1 = dt * (h.sum(axis=0) - 0.5 * (h[0] + h[-1]))

    # I^(1-alpha) h(T) with gam = 1 - alpha: product-trapezoid weights
    # w_j over the full grid (w_0 multiplies h_0 = 0, dropped).
    gam = 1.0 - alpha
    j = np.arange(1, N, dtype=np.float64)
    w_mid = ((N - j + 1.0) ** (gam + 1.0) - 2.0 * (N - j) ** (gam + 1.0)
             + (N - j - 1.0) ** (gam + 1.0))
    i_frac = (dt ** gam / math.gamma(gam + 2.0)) * (
        (w_mid[:, None] * h[1:N]).sum(axis=0) + h[N])

    log_phi = 1j * u * (np.log(spot) + (r - q) * T) \
        + theta * lam * i1 + v0 * i_frac
    return np.exp(log_phi)


def _cf_cumulant_range(params: RoughHestonParams, T: float, spot: float,
                       L: float = 13.0, n_steps: int = 160):
    """Self-calibrating COS truncation interval [a, b] for ln S_T.

    No closed-form cumulants exist for rough Heston, so read them off the
    CF itself: Re log phi(u) = -u^2 c2/2 + u^4 c4/24 + O(u^6) — two small
    real nodes (eps, 2 eps) give (c2, c4) by solving the 2x2 system, and
    c1 = Im log phi(eps)/eps to O(eps^2). Overshoot is harmless (it only
    costs COS terms), undershoot is not, so the scale of eps targets
    c2 * eps^2 ~ 1e-2.
    """
    var_guess = max(float(params.v0), float(params.theta), 1e-4) * T
    eps = 0.1 / math.sqrt(var_guess)
    # Centered CF (spot=1) so log's principal branch is safe: the centered
    # c1 is O((r-q)T - var/2), far inside (-pi/eps, pi/eps).
    phi = rough_heston_cf(np.array([eps, 2.0 * eps]), params, T, 1.0,
                          n_steps=n_steps)
    lp = np.log(phi)
    r1, r2 = float(lp[0].real), float(lp[1].real)
    # r1 = -e^2 c2/2 + e^4 c4/24 ; r2 = -4 e^2 c2/2 + 16 e^4 c4/24.
    c2 = (16.0 * r1 - r2) / (-6.0 * eps ** 2)
    c4 = (r2 - 4.0 * r1) * (2.0 / eps ** 4)
    c1 = float(lp[0].imag) / eps + math.log(spot)
    c2 = max(c2, 1e-8)
    half = L * math.sqrt(c2 + math.sqrt(max(c4, 0.0)))
    return c1 - half, c1 + half


def rough_heston_cos_price(params: RoughHestonParams, spot: float, strikes,
                           T: float, is_call: bool = True,
                           n_terms: int = 384, L: float = 13.0,
                           n_steps: int = 256) -> np.ndarray:
    """European rough-Heston prices via the COS expansion of the CF.

    Adams-step guard: at coarse n_steps the predictor's h^2 term can
    overflow at the largest u nodes (measured at n_steps = 128 with the
    default grid) — on any non-finite phi the solve retries with doubled
    steps (the N=256 default is converged to ~1e-5 relative on the
    benchmark smile; N=512/1024 move the ATM price by < 2e-5 relative).
    """
    a, b = _cf_cumulant_range(params, T, spot, L=L,
                              n_steps=max(n_steps // 2, 96))
    u = np.arange(n_terms) * np.pi / (b - a)
    N = int(n_steps)
    for _ in range(3):
        phi = rough_heston_cf(u, params, T, spot, n_steps=N)
        if np.all(np.isfinite(phi)):
            break
        N *= 2
    else:
        raise FloatingPointError(
            "rough_heston_cf did not stabilize; raise n_steps")
    return cos_expansion_from_phi(phi, a, b, spot, strikes, T,
                                  float(params.r), float(params.q), is_call)


# ─────────────────────────────────────────────────────────────────────────────
# Lifted (multi-factor) kernel fit — host, cached
# ─────────────────────────────────────────────────────────────────────────────
@lru_cache(maxsize=64)
def lifted_kernel_nodes(hurst: float, T: float, resolution: float,
                        n_factors: int = 24) -> Tuple[Tuple[float, ...],
                                                      Tuple[float, ...]]:
    """Moment-matched (c_i, x_i) with K(t) ~= sum_i c_i e^{-x_i t}.

    The power kernel is a Laplace mixture, K(t) = int e^{-xt} mu(dx) with
    mu(dx) = x^(-alpha) dx / (Gamma(alpha) Gamma(1-alpha)); partition the
    x-axis into a ZEROTH cell [0, eta_0] (the quasi-constant slow mass —
    without it the kernel is under-estimated at the t = T end, measured
    44% sup error; with it < 1%) plus a geometric grid spanning
    [0.02/T, 20/resolution], and match the 0th and 1st moments of mu per
    cell:

        c_i = int_cell mu(dx),   x_i = (1/c_i) int_cell x mu(dx).

    Sup relative error on [resolution, T]: < 0.8% for H in [0.05, 0.4] at
    the default n_factors = 24 (`lifted_kernel_error`, test-pinned).

    `resolution` is the finest time scale the LIFTED MODEL resolves and is
    deliberately a model constant, NOT the simulation dt: fixing the node
    set defines one concrete Markovian model whose Euler error then decays
    cleanly as steps refine (measured ATM bias with the T/256 kernel:
    +1.0% at dt = T/256, +0.5% at T/1024, +0.08% at T/4096 — whereas
    re-stiffening x_max with every dt kept the bias ~flat). Engines
    oversample steps 4-16x above the kernel resolution.

    H = 1/2 degenerates to the constant kernel: exactly one factor
    (c, x) = (1, 0) and the scheme IS classical full-truncation Euler.
    """
    h = float(hurst)
    if abs(h - 0.5) < 1e-12:
        return (1.0,), (0.0,)
    alpha = h + 0.5
    n = int(n_factors)
    eta = np.concatenate([[0.0],
                          np.geomspace(0.02 / T, 20.0 / resolution, n)])
    norm = math.gamma(alpha) * math.gamma(1.0 - alpha)
    p0 = 1.0 - alpha                       # int x^-alpha = x^p0 / p0
    p1 = 2.0 - alpha
    c = (eta[1:] ** p0 - eta[:-1] ** p0) / (p0 * norm)
    x = (p0 / p1) * (eta[1:] ** p1 - eta[:-1] ** p1) \
        / (eta[1:] ** p0 - eta[:-1] ** p0)
    return tuple(float(v) for v in c), tuple(float(v) for v in x)


def lifted_kernel_error(hurst: float, T: float, resolution: float,
                        n_factors: int = 24) -> float:
    """Sup relative error of the exponential-sum kernel on [resolution, T]."""
    c, x = lifted_kernel_nodes(hurst, T, resolution, n_factors)
    t = np.geomspace(resolution, T, 400)
    k_exact = t ** (hurst - 0.5) / math.gamma(hurst + 0.5)
    k_hat = (np.asarray(c)[:, None]
             * np.exp(-np.asarray(x)[:, None] * t[None, :])).sum(axis=0)
    return float(np.max(np.abs(k_hat - k_exact) / k_exact))


# ─────────────────────────────────────────────────────────────────────────────
# Lifted MC — differentiable scan over the factor state
# ─────────────────────────────────────────────────────────────────────────────
@partial(jax.jit, static_argnames=("num_paths", "num_steps", "antithetic",
                                   "companion", "remat_chunk", "dtype"))
def lifted_terminal(
    params: RoughHestonParams,
    spot,
    T,
    key: Array,
    c_weights: Array,
    x_nodes: Array,
    num_paths: int,
    num_steps: int,
    antithetic: bool = True,
    companion: bool = False,
    remat_chunk: int = 0,
    dtype=jnp.float32,
) -> Tuple[Array, Array, Optional[Array]]:
    """Terminal (S, v, G) under lifted rough Heston.

    State per path: log-spot + the n-factor variance block V; one
    semi-implicit Euler step per scan iteration (module docstring). The
    companion G is the constant-vol GBM leg on the same dW1 — E[G-payoff]
    is the BS(sqrt(v0)) price, the repo-standard beta=1 control variate.

    `remat_chunk` (callers that differentiate MUST set it): plain scan
    backward stores the (n_factors, branch, paths) carry per step —
    2048 steps x 200k paths x 24 factors = 78 GB of residuals, more than
    one device holds. With remat_chunk = m the scan
    nests into (num_steps/m) checkpointed chunks of m steps: backward
    keeps only the chunk-boundary carries and recomputes inside each
    chunk, so peak residual memory drops to (num_steps/m + m) carries
    (~5 GB at m = 64) for one extra forward pass of compute. Forward-only
    callers leave it 0 (scan forward carries O(1) state either way).
    """
    n_branch = 2 if antithetic else 1
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None]

    c = jnp.asarray(c_weights, dtype)[:, None, None]     # (nf, 1, 1)
    damp = 1.0 / (1.0 + jnp.asarray(x_nodes, dtype)[:, None, None] * dt)

    v0 = jnp.asarray(params.v0, dtype)
    lam = jnp.asarray(params.lam, dtype)
    theta = jnp.asarray(params.theta, dtype)
    nu = jnp.asarray(params.nu, dtype)
    rho = jnp.asarray(params.rho, dtype)
    rho_perp = jnp.sqrt(1.0 - rho * rho)

    log_s0 = jnp.zeros((n_branch, num_paths), dtype)
    v_fac0 = jnp.zeros((c.shape[0], n_branch, num_paths), dtype)
    sigma_cv = jnp.sqrt(v0)
    g_drift = (params.r - params.q - 0.5 * v0) * dt

    def step(carry, step_idx):
        log_s, v_fac, log_g = carry
        z = jax.random.normal(jax.random.fold_in(key, step_idx),
                              (2, num_paths), dtype)
        z1 = z[0] * sign                       # spot driver
        zv = rho * z1 + rho_perp * z[1] * sign  # variance driver dB
        v_pos = jnp.maximum(v0 + jnp.sum(c * v_fac, axis=0), 0.0)
        sqrt_v = _safe_sqrt(v_pos)
        shock = lam * (theta - v_pos) * dt + nu * sqrt_v * zv * sqrt_dt
        v_fac = (v_fac + shock[None]) * damp
        log_s = log_s + (params.r - params.q - 0.5 * v_pos) * dt \
            + sqrt_v * z1 * sqrt_dt
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
        return (log_s, v_fac, log_g), None

    init = (log_s0, v_fac0, log_s0)
    if remat_chunk:
        if num_steps % remat_chunk:
            raise ValueError(f"num_steps={num_steps} not a multiple of "
                             f"remat_chunk={remat_chunk}")

        @partial(jax.checkpoint, prevent_cse=False)
        def chunk(carry, chunk_idx):
            inner, _ = jax.lax.scan(
                step, carry,
                chunk_idx * remat_chunk + jnp.arange(remat_chunk))
            return inner, None

        (log_s, v_fac, log_g), _ = jax.lax.scan(
            chunk, init, jnp.arange(num_steps // remat_chunk))
    else:
        (log_s, v_fac, log_g), _ = jax.lax.scan(
            step, init, jnp.arange(num_steps))
    v_final = jnp.maximum(v0 + jnp.sum(c * v_fac, axis=0), 0.0)
    return (spot * jnp.exp(log_s), v_final,
            (spot * jnp.exp(log_g) if companion else None))
