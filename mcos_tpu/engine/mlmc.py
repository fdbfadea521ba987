"""Multilevel Monte Carlo pricing (Giles 2008) for the SVJ model.

Capability beyond the reference (its only accuracy knob is a flat path-count
increase; see also Giles & Burgos, "Computation of Greeks with multilevel
Monte Carlo", arXiv:1102.1348 for the framework). MLMC prices to a target
RMS accuracy ε at O(ε⁻²) cost instead of single-level Euler's O(ε⁻³):

    E[P_L] = E[P_0] + Σ_{l=1..L} E[P_l − P_{l−1}]

with each correction estimated from *coupled* path pairs — the fine level
uses 2× the steps of the coarse level and the coarse level consumes the
pairwise-summed Brownian increments of the fine level, so corrections
shrink like the strong error (V_l ≈ 2^{−l} for Euler + Lipschitz payoff)
and need exponentially fewer paths per level.

Device shape: each level is one fused `lax.scan` over coarse steps (two fine
sub-steps inside), jit-cached per (level, paths) shape; the level loop runs
on the host with geometric path-count growth so recompiles stay bounded.

Coupling details:
- Brownian increments: z_coarse = (z_a + z_b)/√2 — exact in law.
- Jumps use exact Poisson counts (NOT the engine's per-step Bernoulli
  approximation): per fine step the compound jump is μ·N + σ√N·Z with
  N ~ Poisson(λ·dt_f) — exact for lognormal sizes — and the coarse step
  applies the SUM of its two fine jumps. Poisson additivity makes the
  coarse marginal exactly Poisson(λ·dt_c), so the telescoping identity
  holds AND jumps never mismatch between levels (a naive Bernoulli
  coupling mismatches with probability ≈ λT at EVERY level, which keeps
  V_l flat — measured before this fix). MLMC therefore estimates the true
  Bates jump law, same as the COS oracle.
- Antithetic pairing rides inside each level as usual.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.models.params import SVJParams
from mcos_tpu.ops.simulate import _safe_sqrt

Array = jax.Array


def _diffusion_step(p: SVJParams, dt, sqrt_dt, log_s, v, z1, z2):
    """Full-truncation Heston Euler step + compensated drift (no jumps —
    MLMC applies exact compound-Poisson jumps separately)."""
    v_pos = jnp.maximum(v, 0.0)
    sqrt_v = _safe_sqrt(v_pos)
    k = jnp.exp(p.mu_j + 0.5 * p.sigma_j**2) - 1.0
    drift = p.r - p.q - p.lambda_j * k
    dw1 = z1 * sqrt_dt
    dw2 = p.rho * dw1 + jnp.sqrt(1.0 - p.rho * p.rho) * z2 * sqrt_dt
    log_s = log_s + (drift - 0.5 * v_pos) * dt + sqrt_v * dw1
    v = jnp.maximum(v_pos + p.kappa * (p.theta - v_pos) * dt
                    + p.xi * sqrt_v * dw2, 0.0)
    return log_s, v


def _compound_jump(p: SVJParams, key, lam_dt, num_paths, sign):
    """Exact compound-Poisson jump for one step: μ·N + σ√N·Z, N~Poisson.

    Exact for lognormal jump sizes (a sum of n iid N(μ,σ²) is N(nμ, nσ²)).
    Antithetic branches share the count and negate Z.
    """
    kc, kz = jax.random.split(key)
    n = jax.random.poisson(kc, lam_dt, (num_paths,)).astype(jnp.float32)
    z = jax.random.normal(kz, (num_paths,), jnp.float32)
    return (p.mu_j * n)[None, :] + p.sigma_j * jnp.sqrt(n)[None, :] \
        * (z[None, :] * sign)


@partial(jax.jit, static_argnames=("num_paths", "num_coarse_steps",
                                   "is_call"))
def _coupled_level(params: SVJParams, spot, strike, T, key, *,
                   num_paths: int, num_coarse_steps: int, is_call: bool):
    """One MLMC correction level: (mean, E[x²]) of P_fine − P_coarse.

    Fine = 2·num_coarse_steps Euler steps; coarse = num_coarse_steps steps
    on the summed increments. Returns per-path stats of the antithetic-
    combined payoff difference (discounted).
    """
    dtype = jnp.float32
    p = params
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt_f = T / (2 * num_coarse_steps)
    dt_c = T / num_coarse_steps
    sqrt_dt_f = jnp.sqrt(dt_f)
    sqrt_dt_c = jnp.sqrt(dt_c)
    inv_sqrt2 = jnp.float32(1.0 / np.sqrt(2.0))

    n_branch = 2
    sign = jnp.array([1.0, -1.0], dtype)[:, None]
    zeros = jnp.zeros((n_branch, num_paths), dtype)
    v0 = jnp.broadcast_to(jnp.asarray(p.v0, dtype), (n_branch, num_paths))

    lam_dt_f = jnp.asarray(p.lambda_j, dtype) * dt_f

    def step(carry, step_idx):
        ls_f, v_f, ls_c, v_c = carry
        k_step = jax.random.fold_in(key, step_idx)
        ka, kb, kja, kjb = jax.random.split(k_step, 4)
        za = jax.random.normal(ka, (2, num_paths), dtype)
        zb = jax.random.normal(kb, (2, num_paths), dtype)
        jump_a = _compound_jump(p, kja, lam_dt_f, num_paths, sign)
        jump_b = _compound_jump(p, kjb, lam_dt_f, num_paths, sign)

        # Fine: two diffusion sub-steps, each with its exact jump.
        ls_f, v_f = _diffusion_step(p, dt_f, sqrt_dt_f, ls_f, v_f,
                                    za[0] * sign, za[1] * sign)
        ls_f = ls_f + jump_a
        ls_f, v_f = _diffusion_step(p, dt_f, sqrt_dt_f, ls_f, v_f,
                                    zb[0] * sign, zb[1] * sign)
        ls_f = ls_f + jump_b
        # Coarse: one step on the summed increments + the SAME total jump
        # (Poisson additivity ⇒ the coarse marginal is exactly the coarse
        # scheme's law; jumps never mismatch between levels).
        z1_c = (za[0] + zb[0]) * inv_sqrt2 * sign
        z2_c = (za[1] + zb[1]) * inv_sqrt2 * sign
        ls_c, v_c = _diffusion_step(p, dt_c, sqrt_dt_c, ls_c, v_c,
                                    z1_c, z2_c)
        ls_c = ls_c + jump_a + jump_b
        return (ls_f, v_f, ls_c, v_c), None

    (ls_f, _, ls_c, _), _ = jax.lax.scan(
        step, (zeros, v0, zeros, v0), jnp.arange(num_coarse_steps))

    s_f = spot * jnp.exp(ls_f)
    s_c = spot * jnp.exp(ls_c)
    phi = 1.0 if is_call else -1.0
    pay_f = jnp.mean(jnp.maximum(phi * (s_f - strike), 0.0), axis=0)
    pay_c = jnp.mean(jnp.maximum(phi * (s_c - strike), 0.0), axis=0)
    discount = jnp.exp(-p.r * T)
    diff = discount * (pay_f - pay_c)
    return jnp.mean(diff), jnp.mean(diff * diff)


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "is_call"))
def _level_zero(params: SVJParams, spot, strike, T, key, *,
                num_paths: int, num_steps: int, is_call: bool):
    """Base level: Euler diffusion + exact Poisson jumps at the coarse grid
    (the same scheme family the corrections couple, so telescoping holds)."""
    dtype = jnp.float32
    p = params
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[:, None]
    lam_dt = jnp.asarray(p.lambda_j, dtype) * dt
    zeros = jnp.zeros((2, num_paths), dtype)
    v0 = jnp.broadcast_to(jnp.asarray(p.v0, dtype), (2, num_paths))

    def step(carry, step_idx):
        log_s, v = carry
        k_step = jax.random.fold_in(key, step_idx)
        kn, kj = jax.random.split(k_step)
        z = jax.random.normal(kn, (2, num_paths), dtype)
        log_s, v = _diffusion_step(p, dt, sqrt_dt, log_s, v,
                                   z[0] * sign, z[1] * sign)
        log_s = log_s + _compound_jump(p, kj, lam_dt, num_paths, sign)
        return (log_s, v), None

    (log_s, _), _ = jax.lax.scan(step, (zeros, v0), jnp.arange(num_steps))
    s_final = spot * jnp.exp(log_s)
    phi = 1.0 if is_call else -1.0
    pay = jnp.mean(jnp.maximum(phi * (s_final - strike), 0.0), axis=0)
    x = jnp.exp(-p.r * T) * pay
    return jnp.mean(x), jnp.mean(x * x)


def mlmc_price(
    params: SVJParams,
    spot: float,
    strike: float,
    T: float,
    is_call: bool = True,
    eps: float = 0.05,
    base_steps: int = 4,
    max_levels: int = 8,
    pilot_paths: int = 8_192,
    max_paths_per_level: int = 4_000_000,
    seed: int = 0,
) -> Dict:
    """Price a European option to RMS accuracy ≈ eps via MLMC.

    Standard Giles driver: pilot runs estimate the per-level variances V_l
    and costs C_l ∝ 2^l, optimal allocations N_l ∝ √(V_l/C_l) target a
    sampling variance of eps²/2, and levels are appended until the
    bias estimate |Y_L|/(2^α − 1) (α = 1, Euler weak order) is below
    eps/√2. Path counts are clamped to power-of-two-friendly sizes so jit
    shapes stay bounded (≤ 1 compile per level per growth step).
    """
    rng_root = jax.random.key(seed)

    def run_level(level: int, n: int):
        n = int(min(max(n, 256), max_paths_per_level))
        # Round to the next power of two: bounded compile-shape universe.
        n = 1 << int(np.ceil(np.log2(n)))
        key = jax.random.fold_in(rng_root, level * 1000 + n % 997)
        if level == 0:
            m, m2 = _level_zero(params, spot, strike, T, key,
                                num_paths=n, num_steps=base_steps,
                                is_call=is_call)
        else:
            m, m2 = _coupled_level(params, spot, strike, T, key,
                                   num_paths=n,
                                   num_coarse_steps=base_steps * 2**(level - 1),
                                   is_call=is_call)
        return n, float(m), float(m2)

    return giles_driver(run_level, eps=eps, base_steps=base_steps,
                        max_levels=max_levels, pilot_paths=pilot_paths)


def giles_driver(run_level, *, eps: float, base_steps: int,
                 max_levels: int, pilot_paths: int) -> Dict:
    """The Giles allocation/extension loop, shared VERBATIM by the
    single-device `mlmc_price` and the mesh driver
    (`parallel/mesh.py:sharded_mlmc_price`) — only `run_level(level, n)
    -> (n_used, mean, mean_sq)` differs (device-local vs psum-pooled).
    """
    levels = []  # per level: dict(n, mean, var, cost)
    for level in (0, 1, 2):
        n, m, m2 = run_level(level, pilot_paths)
        levels.append({"level": level, "n": n, "mean": m,
                       "var": max(m2 - m * m, 1e-12),
                       "cost": base_steps * 2**level})

    target_var = 0.5 * eps * eps
    for _ in range(24):  # refinement rounds
        # Optimal allocation (Giles eq. 12): N_l ∝ √(V_l / C_l).
        lam = sum(np.sqrt(lv["var"] * lv["cost"]) for lv in levels)
        needs_more = False
        for lv in levels:
            n_opt = int(np.ceil(
                np.sqrt(lv["var"] / lv["cost"]) * lam / target_var))
            if n_opt > 2 * lv["n"]:
                n_new = max(n_opt, 2 * lv["n"])
                n, m, m2 = run_level(lv["level"], n_new)
                if n > lv["n"]:
                    lv.update(n=n, mean=m, var=max(m2 - m * m, 1e-12))
                    needs_more = True
        # Bias check on the finest correction (weak order α = 1 ⇒ the
        # remaining bias ≈ |Y_L|).
        y_last = abs(levels[-1]["mean"]) if len(levels) > 1 else np.inf
        if y_last > eps / np.sqrt(2.0) and len(levels) < max_levels:
            lvl = len(levels)
            n, m, m2 = run_level(lvl, pilot_paths)
            levels.append({"level": lvl, "n": n, "mean": m,
                           "var": max(m2 - m * m, 1e-12),
                           "cost": base_steps * 2**lvl})
            needs_more = True
        if not needs_more:
            break

    price = sum(lv["mean"] for lv in levels)
    stat_var = sum(lv["var"] / lv["n"] for lv in levels)
    bias = abs(levels[-1]["mean"]) if len(levels) > 1 else float("nan")
    return {
        "price": float(price),
        "std_error": float(np.sqrt(stat_var)),
        "bias_estimate": float(bias),
        "eps": eps,
        "num_levels": len(levels),
        "fine_steps": base_steps * 2 ** (len(levels) - 1),
        "total_path_steps": int(sum(2 * lv["n"] * lv["cost"]
                                    for lv in levels)),
        "levels": [{k: lv[k] for k in ("level", "n", "mean", "var")}
                   for lv in levels],
    }
