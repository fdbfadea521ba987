"""Fused SVJ-Euler simulator over pre-drawn randoms, as a Pallas kernel for
NVIDIA GPUs (Triton route).

This is the kernel twin of `simulate.simulate_terminal_from_draws`, the
execution engine of the Sobol + Brownian-bridge driver behind `/api/price`.
The scan twin runs once per antithetic branch, and each of its steps reads
the step's draw rows and reads and writes the (log S, v, log G) carries in
device memory. Here one program owns a tile of paths and walks every step in
a loop, so the carries of both antithetic branches and the companion leg
stay in registers, and each draw word is read once for both branches.

Semantics are those of `simulate._svj_step_core`, written in the same
operation order: full-truncation log-Euler, compensated drift, Bernoulli
jumps 1{U < λ·dt} with lognormal sizes. The antithetic branch negates the
normals and shares the jump uniforms (reference monte_carlo.py:318-324).
Jump uniforms are an input: the caller draws them exactly as the scan path
does, so both routes see identical inputs and agree to f32 rounding.

Layout: draws are steps-major (num_steps, num_paths), the layout the Sobol
driver produces. A 1-D grid runs over path tiles (a power of two); the last
tile's loads and stores are masked, so no draw array is padded or copied.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from mcos_tpu.models.params import SVJParams

Array = jax.Array

# Packed scalar layout: the kernel reads its constants from one small f32
# array, padded to a power of two for the Triton block model.
(_SPOT, _V0, _DT, _SQRT_DT, _KAPPA, _THETA, _XI, _RHO, _RHO_PERP, _LAM_DT,
 _MU_J, _SIG_J, _DRIFT, _G_DRIFT, _SIG_CV, _NPARAMS) = range(16)
_PACKED_LEN = 16

# Paths per program and Triton launch settings. At 500k paths a 1024-path
# tile gives ~490 programs over the H100's 132 SMs; a sweep of tile 256-2048
# x warps 2-8 x stages 1-3 on the card showed no setting clearly better.
TILE = 1024
NUM_WARPS = 4
NUM_STAGES = 3


def _pack_params(params: SVJParams, spot, T, num_steps: int) -> Array:
    """Per-call scalar constants, computed as the scan twin computes them."""
    f = lambda x: jnp.asarray(x, jnp.float32)
    dt = f(T) / num_steps
    k = jnp.exp(f(params.mu_j) + 0.5 * f(params.sigma_j) ** 2) - 1.0
    sigma_cv = jnp.sqrt(f(params.v0))
    vals = {
        _SPOT: f(spot),
        _V0: f(params.v0),
        _DT: dt,
        _SQRT_DT: jnp.sqrt(dt),
        _KAPPA: f(params.kappa),
        _THETA: f(params.theta),
        _XI: f(params.xi),
        _RHO: f(params.rho),
        _RHO_PERP: jnp.sqrt(1.0 - f(params.rho) * f(params.rho)),
        _LAM_DT: f(params.lambda_j) * dt,
        _MU_J: f(params.mu_j),
        _SIG_J: f(params.sigma_j),
        _DRIFT: f(params.r) - f(params.q) - f(params.lambda_j) * k,
        _G_DRIFT: (f(params.r) - f(params.q) - 0.5 * sigma_cv**2) * dt,
        _SIG_CV: sigma_cv,
    }
    pad = [jnp.float32(0.0)] * (_PACKED_LEN - _NPARAMS)
    return jnp.stack([vals[i] for i in range(_NPARAMS)] + pad)


def _kernel(p_ref, z1_ref, z2_ref, uj_ref, zj_ref, *out_refs,
            tile: int, n_branch: int, companion: bool):
    num_steps, num_paths = z1_ref.shape
    start = pl.program_id(0) * tile
    cols = pl.ds(start, tile)
    mask = (start + jnp.arange(tile)) < num_paths

    dt, sqrt_dt = p_ref[_DT], p_ref[_SQRT_DT]
    kappa, theta, xi = p_ref[_KAPPA], p_ref[_THETA], p_ref[_XI]
    rho, rho_perp = p_ref[_RHO], p_ref[_RHO_PERP]
    lam_dt, mu_j, sig_j = p_ref[_LAM_DT], p_ref[_MU_J], p_ref[_SIG_J]
    drift, g_drift, sig_cv = p_ref[_DRIFT], p_ref[_G_DRIFT], p_ref[_SIG_CV]
    signs = (1, -1)[:n_branch]

    def load(ref, t):
        return plt.load(ref.at[t, cols], mask=mask, other=0.0)

    def body(t, carry):
        log_s, v, log_g = carry
        z1, z2 = load(z1_ref, t), load(z2_ref, t)
        u, zj = load(uj_ref, t), load(zj_ref, t)
        jumped = u < lam_dt
        new_s, new_v, new_g = [], [], []
        for b, sign in enumerate(signs):
            # The antithetic branch negates the normals (exact in f32).
            z1_b, z2_b, zj_b = (z1, z2, zj) if sign > 0 else (-z1, -z2, -zj)
            v_pos = jnp.maximum(v[b], 0.0)
            sqrt_v = jnp.sqrt(v_pos)
            dw1 = z1_b * sqrt_dt
            dw2 = rho * dw1 + rho_perp * z2_b * sqrt_dt
            jump = jnp.where(jumped, mu_j + sig_j * zj_b, 0.0)
            new_s.append(log_s[b] + (drift - 0.5 * v_pos) * dt
                         + sqrt_v * dw1 + jump)
            new_v.append(jnp.maximum(
                v_pos + kappa * (theta - v_pos) * dt + xi * sqrt_v * dw2,
                0.0))
            if companion:
                new_g.append(log_g[b] + g_drift + sig_cv * z1_b * sqrt_dt)
        return tuple(new_s), tuple(new_v), tuple(new_g)

    zeros = (jnp.zeros((tile,), jnp.float32),) * n_branch
    v0 = (jnp.full((tile,), p_ref[_V0], jnp.float32),) * n_branch
    log_s, v, log_g = jax.lax.fori_loop(
        0, num_steps, body, (zeros, v0, zeros if companion else ()))

    spot = p_ref[_SPOT]
    for b in range(n_branch):
        plt.store(out_refs[0].at[b, cols], spot * jnp.exp(log_s[b]),
                  mask=mask)
        plt.store(out_refs[1].at[b, cols], v[b], mask=mask)
        if companion:
            plt.store(out_refs[2].at[b, cols], spot * jnp.exp(log_g[b]),
                      mask=mask)


@functools.partial(
    jax.jit, static_argnames=("antithetic", "companion", "tile", "interpret"))
def svj_terminal_from_draws_kernel(
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
    tile: int = TILE,
    interpret: bool = False,
) -> Tuple[Array, Array, Optional[Array]]:
    """Terminal (S, v, G or None), each (n_branch, num_paths).

    Args:
        z1, z2, u_jump, z_js: steps-major (num_steps, num_paths) draws.
        tile: paths per program, a power of two.
        interpret: run in the Pallas interpreter. Required on any platform
            other than a GPU; only tests pass it.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "svj_terminal_from_draws_kernel compiles only for a GPU "
            f"(default backend is {jax.default_backend()!r}); pass "
            "interpret=True to run it in the Pallas interpreter")
    if tile <= 0 or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    num_steps, num_paths = z1.shape
    n_branch = 2 if antithetic else 1
    out = jax.ShapeDtypeStruct((n_branch, num_paths), jnp.float32)
    n_out = 3 if companion else 2
    draws = [jnp.asarray(x, jnp.float32) for x in (z1, z2, u_jump, z_js)]
    outs = pl.pallas_call(
        functools.partial(_kernel, tile=tile, n_branch=n_branch,
                          companion=companion),
        grid=(pl.cdiv(num_paths, tile),),
        out_shape=(out,) * n_out,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="svj_euler_draws",
    )(_pack_params(params, spot, T, num_steps), *draws)
    return outs[0], outs[1], (outs[2] if companion else None)
