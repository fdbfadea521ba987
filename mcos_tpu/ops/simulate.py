"""SVJ / GBM path simulation as differentiable `lax.scan` programs.

Re-design of the reference's Numba kernel
(reference: engine/monte_carlo.py:189-243, `_simulate_svj_paths_numba`).

Design decisions (vs the reference):

- **Streaming carry, log-space spot.** The scan carry holds (log S, v) only —
  the reference's own "streaming memory" idea (monte_carlo.py:12) — and the
  spot update accumulates in log space, so there is no per-step `exp`: one
  `exp` at the end materializes S_T. The reference exponentiates every step
  (monte_carlo.py:236).
- **Counter-based RNG inside the scan.** Normals/uniforms are drawn per step
  from threefry keys (`jax.random.fold_in(key, step)`), replacing the
  reference's pre-drawn (paths × steps) Z tensors (monte_carlo.py:290-308) —
  no HBM traffic for randoms, and CRN across parameter bumps is "use the same
  key".
- **Antithetic in the same pass.** Both branches ride one scan with a sign
  vector on the normals (shared jump-occurrence uniforms, negated jump sizes —
  exactly the reference's convention at monte_carlo.py:318-324), instead of a
  second full kernel call.
- **Full truncation** variance scheme: v⁺ = max(v, 0) in both drift and
  diffusion, then clip after the update (monte_carlo.py:223-239 semantics).

Everything is differentiable wrt (spot, T, r, q, κ, θ, ξ, ρ, v0, μ_J, σ_J);
the jump *indicator* 1{U < λ·dt} has zero derivative wrt λ (see
engine/greeks.py for score-function treatment of λ sensitivities).

The GPU kernel in `mcos_tpu.ops.draws_kernel` implements the from-draws
recursion for the non-differentiated hot path; tests pin the two to each other
and `mcos_tpu.ops.backend.simulator_for` chooses between them.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.models.params import SVJParams

Array = jax.Array


def _safe_sqrt(x):
    """√x with a zero (not ∞) derivative at x ≤ 0.

    Full truncation clips v to exactly 0, where d√v/dv = ∞ would poison every
    pathwise gradient (NaN via 0·∞). The double-where keeps both the value
    and the cotangent finite.
    """
    safe = jnp.maximum(x, 1e-20)
    return jnp.where(x > 0, jnp.sqrt(safe), 0.0)


def _svj_step_core(params: SVJParams, dt, sqrt_dt, log_s, v, z1, z2, u_jump, z_js):
    """One full-truncation log-Euler SVJ step shared by all simulators.

    Mirrors monte_carlo.py:221-239: v⁺ = max(v,0); dW₂ = ρ·dW₁ + √(1−ρ²)·Z₂√dt;
    compensated drift (r − q − λk − v⁺/2)dt; Bernoulli jump 1{U < λ·dt} with
    lognormal size μ_J + σ_J·Z.
    """
    p = params
    v_pos = jnp.maximum(v, 0.0)
    sqrt_v = _safe_sqrt(v_pos)

    k = jnp.exp(p.mu_j + 0.5 * p.sigma_j**2) - 1.0
    drift_comp = p.r - p.q - p.lambda_j * k

    dw1 = z1 * sqrt_dt
    dw2 = p.rho * dw1 + jnp.sqrt(1.0 - p.rho * p.rho) * z2 * sqrt_dt

    jump = jnp.where(u_jump < p.lambda_j * dt, p.mu_j + p.sigma_j * z_js, 0.0)

    log_s = log_s + (drift_comp - 0.5 * v_pos) * dt + sqrt_v * dw1 + jump
    v = v_pos + p.kappa * (p.theta - v_pos) * dt + p.xi * sqrt_v * dw2
    v = jnp.maximum(v, 0.0)
    return log_s, v


@partial(jax.jit, static_argnames=(
    "num_paths", "num_steps", "antithetic", "companion", "dtype"))
def simulate_terminal(
    params: SVJParams,
    spot,
    T,
    key: Array,
    num_paths: int,
    num_steps: int,
    antithetic: bool = True,
    companion: bool = False,
    dtype=jnp.float32,
) -> Tuple[Array, Array, Optional[Array]]:
    """Simulate SVJ paths with in-scan threefry draws; return terminal (S, v, G).

    When `companion=True`, a GBM *companion leg* with constant volatility
    σ = √v0 rides the same dW₁ increments:
        d log G = (r − q − σ²/2) dt + σ dW₁
    Its terminal payoff has a *known* expectation (the Black-Scholes price), so
    it is a correct control variate for the SVJ payoff. Note: the reference's
    "BS control variate" (monte_carlo.py:358-362) reuses the SVJ terminal spot
    itself as the control leg, which makes its CV-adjusted price an estimator
    of the σ=√v0 Black-Scholes price rather than the SVJ price — that bias is
    NOT reproduced here (a compat mode in the pricer reproduces the arithmetic
    for parity testing). Cost of the companion: one extra FMA per path-step.

    Returns:
        S_final: shape (n_branch, num_paths); row 0 base, row 1 antithetic.
        v_final: same shape (terminal variance, for guards/validation).
        G_final: same shape if companion else None.
    """
    n_branch = 2 if antithetic else 1
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)

    # sign[0] = +1 (base), sign[1] = -1 (antithetic); broadcast over paths.
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None]

    # The carry holds log(S/S0), not log S: per-step drift increments are
    # O(1e-5) while log S ≈ 10 has an f32 ulp of ~1e-6, so an absolute-log
    # carry quantizes the (path-identical) drift the same way every step —
    # a bias that grows linearly in steps (measured ~6e-4 on the forward at
    # 4000 steps). Relative to S0 the accumulator stays O(0.1) and the same
    # increments resolve ~150x finer. S0 multiplies back at the end.
    log_s0 = jnp.zeros((n_branch, num_paths), dtype)
    v0 = jnp.broadcast_to(jnp.asarray(params.v0, dtype), (n_branch, num_paths))

    sigma_cv = jnp.sqrt(jnp.asarray(params.v0, dtype))
    g_drift = (params.r - params.q - 0.5 * sigma_cv**2) * dt

    def step(carry, step_idx):
        log_s, v, log_g = carry
        k_step = jax.random.fold_in(key, step_idx)
        k_norm, k_unif = jax.random.split(k_step)
        z = jax.random.normal(k_norm, (3, num_paths), dtype)
        u_jump = jax.random.uniform(k_unif, (num_paths,), dtype)
        # Antithetic: negate normals, share jump-occurrence uniforms
        # (monte_carlo.py:318-324 convention).
        z1 = z[0] * sign
        z2 = z[1] * sign
        z_js = z[2] * sign
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v,
                                  z1, z2, u_jump[None, :], z_js)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
        return (log_s, v, log_g), None

    (log_s, v, log_g), _ = jax.lax.scan(
        step, (log_s0, v0, log_s0), jnp.arange(num_steps))
    return (spot * jnp.exp(log_s), v,
            (spot * jnp.exp(log_g) if companion else None))


@partial(jax.jit, static_argnames=(
    "num_paths", "num_steps", "antithetic", "companion", "dtype"))
def simulate_terminal_with_score(
    params: SVJParams,
    spot,
    T,
    key: Array,
    num_paths: int,
    num_steps: int,
    antithetic: bool = True,
    companion: bool = True,
    dtype=jnp.float32,
) -> Tuple[Array, Array, Optional[Array], Array]:
    """`simulate_terminal` + the jump-count likelihood-ratio score.

    Identical dynamics AND identical per-step key folding to
    `simulate_terminal` (fold_in(key, step) → split → z(3,·), u) so CRN
    holds between the two — the fused all-Greeks program
    (engine/greeks.py:_all_greeks_device) relies on it. Extra output:
        score = Σ_t (1{U_t < λdt} − λdt) / (λdt·(1−λdt)) · dt
    shape (num_paths,) — the ∂/∂λ score of the per-step Bernoulli jump
    indicators (engine/greeks.py:lambda_lr_estimate identity). Both
    antithetic branches share the jump uniforms, hence ONE score row.
    Emitted through stop_gradient: it is an estimator ingredient, not part
    of any differentiated price.
    """
    n_branch = 2 if antithetic else 1
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None]
    prob = jnp.clip(params.lambda_j * dt, 1e-7, 1.0 - 1e-7)

    log_s0 = jnp.zeros((n_branch, num_paths), dtype)
    v0 = jnp.broadcast_to(jnp.asarray(params.v0, dtype), (n_branch, num_paths))
    score0 = jnp.zeros((num_paths,), dtype)

    sigma_cv = jnp.sqrt(jnp.asarray(params.v0, dtype))
    g_drift = (params.r - params.q - 0.5 * sigma_cv**2) * dt

    def step(carry, step_idx):
        log_s, v, log_g, score = carry
        k_step = jax.random.fold_in(key, step_idx)
        k_norm, k_unif = jax.random.split(k_step)
        z = jax.random.normal(k_norm, (3, num_paths), dtype)
        u_jump = jax.random.uniform(k_unif, (num_paths,), dtype)
        z1 = z[0] * sign
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v,
                                  z1, z[1] * sign, u_jump[None, :],
                                  z[2] * sign)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
        jumped = (u_jump < prob).astype(dtype)
        score = score + jax.lax.stop_gradient(
            (jumped - prob) / (prob * (1.0 - prob)) * dt)
        return (log_s, v, log_g, score), None

    (log_s, v, log_g, score), _ = jax.lax.scan(
        step, (log_s0, v0, log_s0, score0), jnp.arange(num_steps))
    return (spot * jnp.exp(log_s), v,
            (spot * jnp.exp(log_g) if companion else None), score)


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "dtype"))
def simulate_terminal_members(
    params_batch: SVJParams,
    spot,
    T,
    key: Array,
    num_paths: int,
    num_steps: int,
    dtype=jnp.float32,
) -> Tuple[Array, Array, Array]:
    """CRN member batch in ONE scan: params leaves carry a leading (M,)
    axis; every member rides the SAME per-step draws (the common-random-
    numbers contract the FD Greeks need), antithetic pairs included.

    This deliberately avoids `vmap(scan-with-in-kernel-RNG))`, whose
    batched threefry inside the loop body is costly to compile; a single
    scan whose carries are (M, 2, paths) arrays with params broadcast as
    (M, 1, 1) is the same math. Key folding is
    identical to `simulate_terminal` (fold_in(key, step) → split →
    z(3,·), u), so member results are CRN-consistent with the single-run
    simulators.

    Returns (s_final, g_final, score): (M, 2, paths), (M, 2, paths),
    (M, paths) — the companion leg always on (its cost is one FMA), the
    λ-score per member (prob = λ_m·dt differs; the uniforms are shared).
    """
    m = jax.tree.leaves(params_batch)[0].shape[0]
    p = jax.tree.map(lambda x: jnp.asarray(x, dtype)[:, None, None],
                     params_batch)
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[None, :, None]   # (1, 2, 1)
    prob = jnp.clip(p.lambda_j * dt, 1e-7, 1.0 - 1e-7)    # (M, 1, 1)

    log_s0 = jnp.zeros((m, 2, num_paths), dtype)
    v0 = jnp.broadcast_to(jnp.asarray(p.v0, dtype), (m, 2, num_paths))
    score0 = jnp.zeros((m, num_paths), dtype)

    sigma_cv = jnp.sqrt(p.v0)                             # (M, 1, 1)
    g_drift = (p.r - p.q - 0.5 * sigma_cv**2) * dt

    def step(carry, step_idx):
        log_s, v, log_g, score = carry
        k_step = jax.random.fold_in(key, step_idx)
        k_norm, k_unif = jax.random.split(k_step)
        z = jax.random.normal(k_norm, (3, num_paths), dtype)
        u_jump = jax.random.uniform(k_unif, (num_paths,), dtype)
        z1 = z[0][None, None, :] * sign                   # (1→M, 2, paths)
        log_s, v = _svj_step_core(p, dt, sqrt_dt, log_s, v,
                                  z1, z[1][None, None, :] * sign,
                                  u_jump[None, None, :],
                                  z[2][None, None, :] * sign)
        log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
        jumped = (u_jump[None, None, :] < prob).astype(dtype)[:, 0, :]
        score = score + jax.lax.stop_gradient(
            (jumped - prob[:, 0, :]) / (prob[:, 0, :]
                                        * (1.0 - prob[:, 0, :])) * dt)
        return (log_s, v, log_g, score), None

    (log_s, _, log_g, score), _ = jax.lax.scan(
        step, (log_s0, v0, log_s0, score0), jnp.arange(num_steps))
    return spot * jnp.exp(log_s), spot * jnp.exp(log_g), score


@partial(jax.jit, static_argnames=("companion", "steps_major"))
def simulate_terminal_from_draws(
    params: SVJParams,
    spot,
    T,
    z1: Array,
    z2: Array,
    u_jump: Array,
    z_js: Array,
    companion: bool = False,
    steps_major: bool = False,
) -> Tuple[Array, Array, Optional[Array]]:
    """Simulate with externally supplied randoms (QMC driver / CRN oracles).

    Args:
        z1, z2, z_js: standard normals, shape (num_paths, num_steps) —
            the reference kernel's exact input layout (monte_carlo.py:190-198)
            — or (num_steps, num_paths) when `steps_major=True` (the Sobol
            driver's zero-transpose layout; the scan walks the step axis, so
            steps-major is its native orientation).
        u_jump: U(0,1) jump-occurrence uniforms, same shape.
        companion: also evolve the σ=√v0 GBM control-variate leg on dW₁
            (see `simulate_terminal`).

    Returns:
        (S_final, v_final, G_final or None), each shape (num_paths,).
    """
    if not steps_major:
        z1, z2, u_jump, z_js = z1.T, z2.T, u_jump.T, z_js.T
    num_steps, num_paths = z1.shape
    dtype = z1.dtype
    spot = jnp.asarray(spot, dtype)
    dt = jnp.asarray(T, dtype) / num_steps
    sqrt_dt = jnp.sqrt(dt)

    log_s0 = jnp.zeros((num_paths,), dtype)  # log(S/S0) carry, see above
    v0 = jnp.broadcast_to(jnp.asarray(params.v0, dtype), (num_paths,))
    sigma_cv = jnp.sqrt(jnp.asarray(params.v0, dtype))
    g_drift = (params.r - params.q - 0.5 * sigma_cv**2) * dt

    def step(carry, draws):
        log_s, v, log_g = carry
        z1_t, z2_t, u_t, zj_t = draws
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v,
                                  z1_t, z2_t, u_t, zj_t)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1_t * sqrt_dt
        return (log_s, v, log_g), None

    (log_s, v, log_g), _ = jax.lax.scan(
        step, (log_s0, v0, log_s0), (z1, z2, u_jump, z_js))
    return (spot * jnp.exp(log_s), v,
            (spot * jnp.exp(log_g) if companion else None))


@partial(jax.jit, static_argnames=("antithetic", "companion"))
def simulate_terminal_from_draws_pair(
    params: SVJParams,
    spot,
    T,
    z1: Array,
    z2: Array,
    u_jump: Array,
    z_js: Array,
    *,
    antithetic: bool = True,
    companion: bool = False,
) -> Tuple[Array, Array, Optional[Array]]:
    """Both antithetic branches of `simulate_terminal_from_draws`.

    Draws are steps-major (num_steps, num_paths). The antithetic branch
    negates (z1, z2, z_js) and shares u_jump (monte_carlo.py:318-324).
    Returns (S, v, G or None), each (n_branch, num_paths) — the signature
    of the kernel twin in `ops/draws_kernel.py`.
    """
    branches = [(z1, z2, z_js)]
    if antithetic:
        branches.append((-z1, -z2, -z_js))
    outs = [simulate_terminal_from_draws(params, spot, T, a, b, u_jump, c,
                                         companion=companion, steps_major=True)
            for a, b, c in branches]
    s, v, g = (jnp.stack(x) if x[0] is not None else None
               for x in zip(*outs))
    return s, v, g


@partial(jax.jit, static_argnames=("num_paths", "num_steps"))
def simulate_paths_recorded(
    params: SVJParams,
    spot,
    T,
    key: Array,
    num_paths: int,
    num_steps: int,
) -> Array:
    """Record full paths for visualization (≤ O(100) paths).

    Equivalent of the reference's record_paths=True mode
    (monte_carlo.py:215-219, 240-241; used by get_sample_paths at :452-471).

    Returns:
        paths: shape (num_paths, num_steps + 1), paths[:, 0] = spot.
    """
    dtype = jnp.float32
    spot = jnp.asarray(spot, dtype)
    dt = jnp.asarray(T, dtype) / num_steps
    sqrt_dt = jnp.sqrt(dt)

    log_s0 = jnp.zeros((num_paths,), dtype)  # log(S/S0) carry, see above
    v0 = jnp.broadcast_to(jnp.asarray(params.v0, dtype), (num_paths,))

    def step(carry, step_idx):
        log_s, v = carry
        k_step = jax.random.fold_in(key, step_idx)
        k_norm, k_unif = jax.random.split(k_step)
        z = jax.random.normal(k_norm, (3, num_paths), dtype)
        u = jax.random.uniform(k_unif, (num_paths,), dtype)
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v,
                                  z[0], z[1], u, z[2])
        return (log_s, v), log_s

    (_, _), log_path = jax.lax.scan(step, (log_s0, v0), jnp.arange(num_steps))
    paths = spot * jnp.exp(log_path).T  # (num_paths, num_steps)
    return jnp.concatenate(
        [jnp.broadcast_to(spot, (num_paths, 1)), paths], axis=1
    )


@partial(jax.jit, static_argnames=(
    "num_paths", "num_steps", "antithetic", "companion", "dtype"))
def simulate_terminal_qe(
    params: SVJParams,
    spot,
    T,
    key: Array,
    num_paths: int,
    num_steps: int,
    antithetic: bool = True,
    companion: bool = False,
    dtype=jnp.float32,
) -> Tuple[Array, Array, Optional[Array]]:
    """Andersen (2008) Quadratic-Exponential Heston scheme + Merton jumps.

    Near-exact variance transitions: v' is sampled by moment-matching the
    exact noncentral-χ² law (quadratic branch for ψ ≤ 1.5, exponential tail
    branch otherwise, selected branchlessly), and log-spot uses the
    K0..K4 central discretization with the Broadie-Kaya integrated-variance
    proxy. Euler full truncation (monte_carlo.py:221-239 semantics,
    `simulate_terminal`) needs ~60× more time steps for the same bias —
    measured: QE at 16 steps matches the semi-analytic COS price where Euler
    at 16 steps misses by ~10σ (see tests/test_qe_scheme.py) — so at fixed
    accuracy QE is an order-of-magnitude throughput multiplier.

    Same antithetic convention (negated normals, shared jump uniforms) and
    GBM companion CV leg as the Euler path. Not used for AD Greeks (the
    branch selection makes gradients noisier than Euler's smooth updates).
    """
    p = params
    n_branch = 2 if antithetic else 1
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None]

    kappa = jnp.asarray(p.kappa, dtype)
    theta = jnp.asarray(p.theta, dtype)
    xi = jnp.asarray(p.xi, dtype)
    rho = jnp.asarray(p.rho, dtype)

    # Variance-transition constants (exact conditional mean/variance).
    e_kdt = jnp.exp(-kappa * dt)
    c_mean = 1.0 - e_kdt
    var1 = xi**2 * e_kdt * c_mean / jnp.maximum(kappa, 1e-12)
    var2 = theta * xi**2 * c_mean**2 / jnp.maximum(2.0 * kappa, 1e-12)

    # Log-spot constants (Andersen eqs. 33-35, γ₁=γ₂=½ central scheme).
    gamma = 0.5
    k_over = kappa * rho / jnp.maximum(xi, 1e-12) - 0.5
    k0 = -rho * kappa * theta * dt / jnp.maximum(xi, 1e-12)
    k1 = gamma * dt * k_over - rho / jnp.maximum(xi, 1e-12)
    k2 = gamma * dt * k_over + rho / jnp.maximum(xi, 1e-12)
    k3 = gamma * dt * (1.0 - rho**2)
    k4 = gamma * dt * (1.0 - rho**2)

    k_comp = jnp.exp(p.mu_j + 0.5 * p.sigma_j**2) - 1.0
    drift_dt = (p.r - p.q - p.lambda_j * k_comp) * dt

    sigma_cv = jnp.sqrt(jnp.asarray(p.v0, dtype))
    g_drift = (p.r - p.q - 0.5 * sigma_cv**2) * dt
    sqrt_dt = jnp.sqrt(dt)

    log_s0 = jnp.zeros((n_branch, num_paths), dtype)  # log(S/S0), see above
    v0 = jnp.broadcast_to(jnp.asarray(p.v0, dtype), (n_branch, num_paths))

    psi_c = 1.5

    def step(carry, step_idx):
        log_s, v, log_g = carry
        k_step = jax.random.fold_in(key, step_idx)
        k_norm, k_unif = jax.random.split(k_step)
        z = jax.random.normal(k_norm, (2, num_paths), dtype)
        u = jax.random.uniform(k_unif, (2, num_paths), dtype)
        z_x = z[0] * sign          # spot-driving normal (antithetic)
        z_js = z[1] * sign         # jump size normal (antithetic)
        u_v = u[0][None, :]        # variance uniform (shared across pair)
        u_jump = u[1][None, :]     # jump-occurrence uniform (shared)

        # ── variance transition (QE) ────────────────────────────────────────
        m = theta + (v - theta) * e_kdt
        s2 = v * var1 + var2
        psi = s2 / jnp.maximum(m * m, 1e-20)

        # Quadratic branch (ψ ≤ ψ_c): v' = a (b + Z_v)².
        two_over_psi = 2.0 / jnp.maximum(psi, 1e-12)
        b2 = jnp.maximum(
            two_over_psi - 1.0
            + jnp.sqrt(jnp.maximum(two_over_psi, 1e-12))
            * jnp.sqrt(jnp.maximum(two_over_psi - 1.0, 0.0)), 0.0)
        a = m / (1.0 + b2)
        z_v = ndtri_safe(u_v)
        v_quad = a * (jnp.sqrt(b2) + z_v) ** 2

        # Exponential branch (ψ > ψ_c): mass p at 0, exponential tail.
        p_mass = jnp.clip((psi - 1.0) / (psi + 1.0), 0.0, 0.999)
        beta = (1.0 - p_mass) / jnp.maximum(m, 1e-20)
        u_clip = jnp.clip(u_v, 1e-7, 1.0 - 1e-7)
        v_exp = jnp.where(
            u_v <= p_mass, 0.0,
            jnp.log((1.0 - p_mass) / jnp.maximum(1.0 - u_clip, 1e-12))
            / jnp.maximum(beta, 1e-20))

        v_next = jnp.where(psi <= psi_c, v_quad, v_exp)

        # ── log-spot update (central K-scheme + jumps) ──────────────────────
        jump = jnp.where(u_jump < p.lambda_j * dt,
                         p.mu_j + p.sigma_j * z_js, 0.0)
        diff_var = jnp.maximum(k3 * v + k4 * v_next, 0.0)
        log_s = (log_s + drift_dt + k0 + k1 * v + k2 * v_next
                 + jnp.sqrt(diff_var) * z_x + jump)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z_x * sqrt_dt
        return (log_s, v_next, log_g), None

    (log_s, v, log_g), _ = jax.lax.scan(
        step, (log_s0, v0, log_s0), jnp.arange(num_steps))
    return (spot * jnp.exp(log_s), v,
            (spot * jnp.exp(log_g) if companion else None))


@partial(jax.jit, static_argnames=("antithetic", "companion", "steps_major"))
def simulate_terminal_qe_from_draws(
    params: SVJParams,
    spot,
    T,
    z_x: Array,
    u_v: Array,
    u_jump: Array,
    z_js: Array,
    antithetic: bool = True,
    companion: bool = False,
    steps_major: bool = False,
) -> Tuple[Array, Array, Optional[Array]]:
    """Andersen QE scheme driven by externally supplied randoms (QMC driver).

    Args:
        z_x: standard normals driving the log-spot diffusion (the Brownian-
            bridge-reordered Sobol block, exactly like Euler's z1).
        u_v: U(0,1) variance-transition uniforms — QE consumes *uniforms*
            here (quadratic branch inverts them, exponential branch uses
            them directly), so the Sobol dims map through unchanged.
        u_jump: U(0,1) jump-occurrence uniforms (PRNG stream, shared across
            the antithetic pair).
        z_js: jump-size normals.
        antithetic: add the branch with negated (z_x, z_js); u_v and u_jump
            are shared, so the variance path is identical across the pair —
            the same convention as `simulate_terminal_qe`.

    Returns (S, v, G or None), each (n_branch, num_paths).
    """
    if not steps_major:
        z_x, u_v, u_jump, z_js = z_x.T, u_v.T, u_jump.T, z_js.T
    num_steps, num_paths = z_x.shape
    dtype = z_x.dtype
    p = params
    n_branch = 2 if antithetic else 1
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None]

    kappa = jnp.asarray(p.kappa, dtype)
    theta = jnp.asarray(p.theta, dtype)
    xi = jnp.asarray(p.xi, dtype)
    rho = jnp.asarray(p.rho, dtype)

    e_kdt = jnp.exp(-kappa * dt)
    c_mean = 1.0 - e_kdt
    var1 = xi**2 * e_kdt * c_mean / jnp.maximum(kappa, 1e-12)
    var2 = theta * xi**2 * c_mean**2 / jnp.maximum(2.0 * kappa, 1e-12)

    gamma = 0.5
    k_over = kappa * rho / jnp.maximum(xi, 1e-12) - 0.5
    k0 = -rho * kappa * theta * dt / jnp.maximum(xi, 1e-12)
    k1 = gamma * dt * k_over - rho / jnp.maximum(xi, 1e-12)
    k2 = gamma * dt * k_over + rho / jnp.maximum(xi, 1e-12)
    k3 = gamma * dt * (1.0 - rho**2)
    k4 = gamma * dt * (1.0 - rho**2)

    k_comp = jnp.exp(p.mu_j + 0.5 * p.sigma_j**2) - 1.0
    drift_dt = (p.r - p.q - p.lambda_j * k_comp) * dt
    sigma_cv = jnp.sqrt(jnp.asarray(p.v0, dtype))
    g_drift = (p.r - p.q - 0.5 * sigma_cv**2) * dt
    sqrt_dt = jnp.sqrt(dt)

    log_s0 = jnp.zeros((n_branch, num_paths), dtype)  # log(S/S0)
    v0 = jnp.broadcast_to(jnp.asarray(p.v0, dtype), (n_branch, num_paths))
    psi_c = 1.5

    def step(carry, draws):
        log_s, v, log_g = carry
        zx_t, uv_t, uj_t, zjs_t = draws
        z_x_b = zx_t[None, :] * sign
        z_js_b = zjs_t[None, :] * sign
        u_v_b = uv_t[None, :]
        u_jump_b = uj_t[None, :]

        m = theta + (v - theta) * e_kdt
        s2 = v * var1 + var2
        psi = s2 / jnp.maximum(m * m, 1e-20)

        two_over_psi = 2.0 / jnp.maximum(psi, 1e-12)
        b2 = jnp.maximum(
            two_over_psi - 1.0
            + jnp.sqrt(jnp.maximum(two_over_psi, 1e-12))
            * jnp.sqrt(jnp.maximum(two_over_psi - 1.0, 0.0)), 0.0)
        a = m / (1.0 + b2)
        z_v = ndtri_safe(u_v_b)
        v_quad = a * (jnp.sqrt(b2) + z_v) ** 2

        p_mass = jnp.clip((psi - 1.0) / (psi + 1.0), 0.0, 0.999)
        beta = (1.0 - p_mass) / jnp.maximum(m, 1e-20)
        u_clip = jnp.clip(u_v_b, 1e-7, 1.0 - 1e-7)
        v_exp = jnp.where(
            u_v_b <= p_mass, 0.0,
            jnp.log((1.0 - p_mass) / jnp.maximum(1.0 - u_clip, 1e-12))
            / jnp.maximum(beta, 1e-20))

        v_next = jnp.where(psi <= psi_c, v_quad, v_exp)

        jump = jnp.where(u_jump_b < p.lambda_j * dt,
                         p.mu_j + p.sigma_j * z_js_b, 0.0)
        diff_var = jnp.maximum(k3 * v + k4 * v_next, 0.0)
        log_s = (log_s + drift_dt + k0 + k1 * v + k2 * v_next
                 + jnp.sqrt(diff_var) * z_x_b + jump)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z_x_b * sqrt_dt
        return (log_s, v_next, log_g), None

    (log_s, v, log_g), _ = jax.lax.scan(
        step, (log_s0, v0, log_s0), (z_x, u_v, u_jump, z_js))
    return (spot * jnp.exp(log_s), v,
            (spot * jnp.exp(log_g) if companion else None))


@partial(jax.jit, static_argnames=(
    "num_paths", "num_steps", "antithetic", "companion", "dtype"))
def simulate_terminal_tilted(
    params: SVJParams,
    spot,
    T,
    key: Array,
    shift,
    num_paths: int,
    num_steps: int,
    antithetic: bool = True,
    companion: bool = False,
    dtype=jnp.float32,
) -> Tuple[Array, Array, Optional[Array], Array]:
    """`simulate_terminal` under an exponentially tilted spot-Brownian measure.

    Importance sampling for far-from-the-money payoffs: each spot-driving
    normal is drawn as z + `shift` (a per-step constant drift on dW₁ only —
    the variance Brownian, jump occurrences, and jump sizes keep their
    nominal law), and every path carries the exact Radon-Nikodym weight

        L = exp(−shift·Σᵢ zᵢ − num_steps·shift²/2)

    so that E[L·f(path)] equals the untilted expectation for any payoff f.
    A positive shift pushes paths upward (deep OTM calls); negative pushes
    down (deep OTM puts). The GBM companion leg rides the same tilted dW₁,
    so E[L·payoff(G_T)] is still the Black-Scholes price and the companion
    control variate remains valid under the weighted estimator.

    Antithetic branches negate the *standard* normal before tilting
    (z̃ = ±z, dynamics use z̃ + shift) and carry their own weight
    L(z̃) — each branch is an unbiased tilted estimator on its own.

    Capability absent from the reference (plain MC only,
    monte_carlo.py:290-324). Returns (S_final, v_final, G_final or None,
    log_weight), the first three shaped (n_branch, num_paths) and
    log_weight likewise.
    """
    n_branch = 2 if antithetic else 1
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    shift = jnp.asarray(shift, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None]

    log_s0 = jnp.zeros((n_branch, num_paths), dtype)  # log(S/S0) carry
    v0 = jnp.broadcast_to(jnp.asarray(params.v0, dtype), (n_branch, num_paths))
    lw0 = jnp.zeros((n_branch, num_paths), dtype)

    sigma_cv = jnp.sqrt(jnp.asarray(params.v0, dtype))
    g_drift = (params.r - params.q - 0.5 * sigma_cv**2) * dt

    def step(carry, step_idx):
        log_s, v, log_g, log_w = carry
        k_step = jax.random.fold_in(key, step_idx)
        k_norm, k_unif = jax.random.split(k_step)
        z = jax.random.normal(k_norm, (3, num_paths), dtype)
        u_jump = jax.random.uniform(k_unif, (num_paths,), dtype)
        z1_std = z[0] * sign               # the branch's standard normal z̃
        z1 = z1_std + shift                # tilted draw used by the dynamics
        z2 = z[1] * sign
        z_js = z[2] * sign
        log_w = log_w - shift * z1_std - 0.5 * shift * shift
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v,
                                  z1, z2, u_jump[None, :], z_js)
        if companion:
            log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
        return (log_s, v, log_g, log_w), None

    (log_s, v, log_g, log_w), _ = jax.lax.scan(
        step, (log_s0, v0, log_s0, lw0), jnp.arange(num_steps))
    return (spot * jnp.exp(log_s), v,
            (spot * jnp.exp(log_g) if companion else None), log_w)


def optimal_tilt(params: SVJParams, spot, strike, T, num_steps: int) -> float:
    """Per-step drift shift that aims the GBM proxy's terminal mean at K.

    Under σ = √v0 GBM, log(S_T/S0) gains σ·shift·√(n·T) of extra drift from a
    per-step shift on z₁, so targeting E[log S_T] = log K gives

        shift = (log(K/S0) − (r − q − σ²/2)·T) / (σ·√(n·T)).

    Positive for OTM calls (K > forward-ish), negative for OTM puts — the
    standard "tilt to the money" heuristic; any fixed shift keeps the
    estimator unbiased, this one just minimizes variance approximately.
    """
    sigma = float(np.sqrt(float(params.v0)))
    d = float(np.log(float(strike) / float(spot))
              - (float(params.r) - float(params.q) - 0.5 * sigma * sigma)
              * float(T))
    return d / max(sigma * float(np.sqrt(num_steps * float(T))), 1e-12)


def ndtri_safe(u):
    """Inverse normal CDF with clipped tails (f32-safe)."""
    from jax.scipy.special import ndtri

    return ndtri(jnp.clip(u, 1e-7, 1.0 - 1e-7))


def vanilla_payoff(s_final: Array, strike, is_call: bool) -> Array:
    """European payoff max(±(S−K), 0) (monte_carlo.py:327-335)."""
    if is_call:
        return jnp.maximum(s_final - strike, 0.0)
    return jnp.maximum(strike - s_final, 0.0)


def combine_antithetic(payoffs: Array) -> Array:
    """Average payoff branches pairwise: (n_branch, n_paths) → (n_paths,).

    With antithetic branches this is the reference's pairwise combination
    0.5·(payoff + payoff_anti) (monte_carlo.py:338-339); with a single branch
    it is the identity.
    """
    return jnp.mean(payoffs, axis=0)


def mc_mean_stderr(values: Array) -> Tuple[Array, Array]:
    """Monte Carlo mean and standard error over the path axis.

    Matches the reference's estimator (monte_carlo.py:342-343): stderr uses the
    *population* std of the (antithetic-combined) per-path values / √n.
    """
    n = values.shape[-1]
    mean = jnp.mean(values, axis=-1)
    std = jnp.std(values, axis=-1)
    return mean, std / jnp.sqrt(jnp.asarray(n, values.dtype))
