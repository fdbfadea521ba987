"""Quanto options: foreign-asset payoffs paid in domestic currency.

Capability beyond the reference (single-currency only): a quanto call
pays max(S_T - K, 0) * FX_fixed where S is a foreign-currency asset. The
measure change to the domestic risk-neutral measure tilts the asset
drift by the quanto adjustment -rho_fx * sigma_fx * sigma_S; under
stochastic volatility that correction is *path-dependent*:

    d log S = (r_f - q - rho_fx sigma_fx sqrt(v_t) - v_t/2) dt
              + sqrt(v_t) dW1 + jumps,

discounted at the DOMESTIC rate r_d. The reference generation of desks
prices quantos with a constant-vol adjustment; under SVJ the sqrt(v_t)
inside the drift correlates with the payoff region (high-vol paths are
the ITM put paths), which shifts quanto skew — exactly what the MC here
captures and the BS closed form cannot.

Device shape: the same streaming scan as the core simulator
(`_svj_step_core`) with the quanto tilt applied from the pre-step
variance (left-point, matching the Euler drift), plus a GBM companion
leg on the same dW1 with the *constant*-vol tilt — whose expectation is
the exact quanto-BS closed form (`quanto_bs`), giving the usual exact
companion control variate.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import DEFAULT_NUM_PATHS
from mcos_tpu.models.params import SVJParams
from mcos_tpu.ops.bs import bs_price
from mcos_tpu.ops.simulate import (_safe_sqrt, _svj_step_core,
                                   combine_antithetic, mc_mean_stderr)

Array = jax.Array


def quanto_bs(S: float, K: float, T: float, r_d: float, r_f: float,
              q: float, sigma: float, sigma_fx: float, rho_fx: float,
              is_call: bool = True) -> float:
    """Closed-form quanto Black-Scholes (constant vol).

    The domestic-measure drift of S is r_f - q - rho_fx sigma_fx sigma;
    discounting at r_d. Expressed through the vanilla pricer as
    BS(S, K, T, r = r_d, q_eff = r_d - (r_f - q - rho sigma_fx sigma)).
    """
    drift = r_f - q - rho_fx * sigma_fx * sigma
    q_eff = r_d - drift
    return float(bs_price(S, K, T, r_d, q_eff, sigma, is_call))


@partial(jax.jit, static_argnames=("num_paths", "num_steps"))
def _quanto_terminal(params: SVJParams, spot, T, r_d, sigma_fx, rho_fx,
                     key, *, num_paths: int, num_steps: int):
    """(2, paths) quanto-measure terminal spots for SVJ and the
    constant-vol GBM companion (same dW1)."""
    dtype = jnp.float32
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[:, None]
    spot = jnp.asarray(spot, dtype)

    sigma_cv = jnp.sqrt(jnp.asarray(params.v0, dtype))
    # Companion: constant-vol quanto drift (exact closed form exists).
    g_drift = (params.r - params.q
               - rho_fx * sigma_fx * sigma_cv - 0.5 * sigma_cv**2) * dt

    zeros = jnp.zeros((2, num_paths), dtype)
    v0 = jnp.broadcast_to(jnp.asarray(params.v0, dtype), (2, num_paths))

    def step(carry, step_idx):
        log_s, v, log_g = carry
        k_step = jax.random.fold_in(key, step_idx)
        k_n, k_u = jax.random.split(k_step)
        z = jax.random.normal(k_n, (3, num_paths), dtype)
        u = jax.random.uniform(k_u, (num_paths,), dtype)
        z1 = z[0][None] * sign
        # Quanto tilt from the PRE-step variance (left-point rule, the
        # same convention as the Euler drift inside the core step).
        tilt = rho_fx * sigma_fx * _safe_sqrt(jnp.maximum(v, 0.0)) * dt
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v,
                                  z1, z[1][None] * sign, u[None, :],
                                  z[2][None] * sign)
        log_s = log_s - tilt
        log_g = log_g + g_drift + sigma_cv * z1 * sqrt_dt
        return (log_s, v, log_g), None

    (log_s, _, log_g), _ = jax.lax.scan(step, (zeros, v0, zeros),
                                        jnp.arange(num_steps))
    return spot * jnp.exp(log_s), spot * jnp.exp(log_g)


class QuantoEngine:
    """Quanto vanilla pricing under SVJ with an exact companion control.

    `params.r` plays the FOREIGN rate r_f (the asset's own carry);
    `r_domestic` prices and discounts the payoff currency.
    """

    def __init__(self, params: SVJParams, r_domestic: float,
                 sigma_fx: float, rho_fx: float,
                 num_paths: int = DEFAULT_NUM_PATHS,
                 num_steps: int = 64, seed: int = 42,
                 use_control_variate: bool = True, mesh=None):
        self.params = params
        self.r_d = float(r_domestic)
        self.sigma_fx = float(sigma_fx)
        self.rho_fx = float(rho_fx)
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.use_cv = bool(use_control_variate)
        # None honors MCOS_AUTO_MESH=1; "auto"/Mesh routes price() through
        # parallel/families.py:sharded_quanto_price.
        self.mesh = mesh

    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True,
              fx_fixed: float = 1.0) -> Dict[str, float]:
        from mcos_tpu.engine.pricer import resolve_mesh

        p = self.params
        mesh = resolve_mesh(self.mesh)
        if mesh is not None:
            from mcos_tpu.parallel.families import sharded_quanto_price

            res = jax.device_get(sharded_quanto_price(
                p, self.r_d, self.sigma_fx, self.rho_fx, spot, strike, T,
                jax.random.key(self.seed), mesh=mesh,
                num_paths=self.num_paths, num_steps=self.num_steps,
                is_call=is_call, control_variate=self.use_cv,
                fx_fixed=fx_fixed))
            out = {"num_paths_used": int(np.asarray(res["num_paths_used"])),
                   "num_steps": self.num_steps,
                   "quanto_adjustment_bs": quanto_bs(
                       spot, strike, T, self.r_d, float(p.r), float(p.q),
                       float(np.sqrt(float(p.v0))), self.sigma_fx,
                       self.rho_fx, is_call)
                   - float(bs_price(spot, strike, T, self.r_d,
                                    self.r_d - float(p.r) + float(p.q),
                                    np.sqrt(float(p.v0)), is_call)),
                   "price": float(res["price"]),
                   "std_error": float(res["std_error"])}
            if self.use_cv:
                out["cv_beta"] = float(res["cv_beta"])
            return out
        s, g = _quanto_terminal(
            p, spot, T, jnp.float32(self.r_d),
            jnp.float32(self.sigma_fx), jnp.float32(self.rho_fx),
            jax.random.key(self.seed), num_paths=self.num_paths,
            num_steps=self.num_steps)
        phi = 1.0 if is_call else -1.0
        pay = combine_antithetic(jnp.maximum(phi * (s - strike), 0.0))
        disc = float(np.exp(-self.r_d * T))
        out = {"num_paths_used": self.num_paths,
               "num_steps": self.num_steps,
               "quanto_adjustment_bs": quanto_bs(
                   spot, strike, T, self.r_d, float(p.r), float(p.q),
                   float(np.sqrt(float(p.v0))), self.sigma_fx,
                   self.rho_fx, is_call)
               - float(bs_price(spot, strike, T, self.r_d,
                                self.r_d - float(p.r) + float(p.q),
                                np.sqrt(float(p.v0)), is_call))}
        if self.use_cv:
            ctrl = combine_antithetic(jnp.maximum(phi * (g - strike), 0.0))
            ctrl_exact = quanto_bs(
                spot, strike, T, self.r_d, float(p.r), float(p.q),
                float(np.sqrt(float(p.v0))), self.sigma_fx, self.rho_fx,
                is_call)
            ctrl_c = ctrl - jnp.mean(ctrl)
            var_c = float(jnp.mean(ctrl_c**2))
            beta = (float(jnp.mean((pay - jnp.mean(pay)) * ctrl_c))
                    / max(var_c, 1e-12)) if var_c > 1e-12 else 0.0
            adj = pay - beta * (ctrl - ctrl_exact / disc)
            mean, se = mc_mean_stderr(adj)
            out["cv_beta"] = beta
        else:
            mean, se = mc_mean_stderr(pay)
        out["price"] = fx_fixed * disc * float(mean)
        out["std_error"] = fx_fixed * disc * float(se)
        return out
