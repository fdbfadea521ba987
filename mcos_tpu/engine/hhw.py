"""Heston-Hull-White engine: long-dated pricing under stochastic rates.

Engine layer over `ops/hhw.py` (model, scheme, and closed-form oracles in
its header). Greeks ride the differentiable scan: delta, v0-vega, and the
rate-vol sensitivity dP/d sigma_r ("rate vega" — the quantity that says
whether stochastic rates matter for this contract) come from ONE
`jax.grad` pass through the simulation, CRN by construction.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.ops.hhw import HHWParams, hhw_terminal, vasicek_bond

Array = jax.Array


@partial(jax.jit, static_argnames=("is_call",))
def _reduce_disc_payoff(s, d, strikes, *, is_call: bool):
    """((strikes,) mean, (strikes,) stderr, scalar E[D]) in one program."""
    phi = 1.0 if is_call else -1.0
    pay = jnp.maximum(phi * (s[..., None] - strikes[None, None, :]),
                      0.0) * d[..., None]
    comb = jnp.mean(pay, axis=0)
    mean = jnp.mean(comb, axis=0)
    se = jnp.std(comb, axis=0) / jnp.sqrt(jnp.float32(comb.shape[0]))
    return mean, se, jnp.mean(d)


def _disc_payoff_mean(p: HHWParams, spot, strikes, T, key, *,
                      num_paths: int, num_steps: int, is_call) -> Array:
    s, d = hhw_terminal(p, spot, T, key, num_paths=num_paths,
                        num_steps=num_steps)
    phi = 1.0 if is_call else -1.0
    pay = jnp.maximum(phi * (s[..., None] - strikes[None, None, :]), 0.0)
    return jnp.mean(pay * d[..., None], axis=(0, 1))


class HHWEngine:
    """Monte Carlo pricer for the Heston-Hull-White hybrid (scan
    simulator; Greeks ride the same differentiable scan)."""

    def __init__(self, params: HHWParams, num_paths: int = 200_000,
                 num_steps: int = 128, seed: int = 42):
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)

    def _terminal(self, spot: float, T: float):
        return hhw_terminal(self.params, spot, T,
                            jax.random.key(self.seed),
                            num_paths=self.num_paths,
                            num_steps=self.num_steps)

    def price(self, spot: float, strikes, T: float,
              is_call: bool = True) -> Dict[str, object]:
        strikes_arr = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))
        s, d = self._terminal(spot, T)
        # One fused reduction program + ONE host transfer (eager jnp ops
        # here would each be a dispatch and a host sync).
        mean, se, zc = jax.device_get(_reduce_disc_payoff(
            s, d, strikes_arr, is_call=is_call))
        mean, se = np.asarray(mean), np.asarray(se)
        scalar = np.ndim(strikes) == 0
        return {
            "price": float(mean[0]) if scalar else mean.tolist(),
            "std_error": float(se[0]) if scalar else se.tolist(),
            "zero_coupon_mc": float(zc),
            "zero_coupon_exact": vasicek_bond(self.params, T),
            "num_paths_used": self.num_paths,
            "num_steps": self.num_steps,
        }

    def greeks(self, spot: float, strike: float, T: float,
               is_call: bool = True) -> Dict[str, float]:
        """delta / v0-vega / rate-vega (dP/d sigma_r) / rho-rate (dP/dr0),
        one value_and_grad pass through the discounted-payoff scan."""
        key = jax.random.key(self.seed)
        k_arr = jnp.asarray([strike], jnp.float32)

        def f(s0, v0, sigma_r, r0):
            p = dataclasses.replace(self.params, v0=v0, sigma_r=sigma_r,
                                    r0=r0)
            return _disc_payoff_mean(p, s0, k_arr, T, key,
                                     num_paths=self.num_paths,
                                     num_steps=self.num_steps,
                                     is_call=is_call)[0]

        args = (jnp.float32(spot), jnp.asarray(self.params.v0, jnp.float32),
                jnp.asarray(self.params.sigma_r, jnp.float32),
                jnp.asarray(self.params.r0, jnp.float32))
        price, grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3))(*args)
        sigma0 = float(np.sqrt(float(self.params.v0)))
        return {
            "price": float(price),
            "delta": float(grads[0]),
            # per-vol-point convention of engine/greeks.py:400 and
            # engine/american.py:537: 2*sigma*dP/dv0, NO extra /100 —
            # the same JSON key must mean the same thing on every endpoint.
            "vega_per_vol_point": float(2.0 * sigma0 * grads[1]),
            "rate_vega": float(grads[2]),     # dP / d sigma_r (absolute)
            "rho_rate": float(grads[3]),      # dP / d r0
        }

    def rate_vol_impact(self, spot: float, strike: float, T: float,
                        is_call: bool = True) -> Dict[str, float]:
        """How much of the price is stochastic-rates? Reprice with
        sigma_r = 0 on the same paths (CRN) and report the spread."""
        base = self.price(spot, strike, T, is_call)
        frozen = HHWEngine(dataclasses.replace(self.params, sigma_r=1e-8),
                           num_paths=self.num_paths,
                           num_steps=self.num_steps, seed=self.seed)
        det = frozen.price(spot, strike, T, is_call)
        return {
            "price": base["price"],
            "price_deterministic_rates": det["price"],
            "stochastic_rates_premium": base["price"] - det["price"],
            "std_error": float(np.hypot(base["std_error"],
                                        det["std_error"])),
        }
