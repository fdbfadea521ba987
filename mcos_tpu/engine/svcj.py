"""SVCJ pricing engine: MC with companion CV + the semi-analytic oracle.

Capability beyond the reference (its engine stops at SVJ,
engine/models.py:25-28): correlated price/variance jumps let one crash
clock gap the spot down while kicking variance up — the spot-vol
co-movement a pure-SVJ fit has to fake by inflating ξ. The engine
follows the repo's standard shape: a jitted functional core
(module-level, value-stable static args — no per-call retraces), a thin
stateful wrapper with reference-style result keys, and the COS oracle
(`ops/svcj.py:svcj_cos_price`) as the exactness anchor for smiles and
calibration-grade IVs.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import scaled_steps
from mcos_tpu.models.params import SVCJParams
from mcos_tpu.ops.bs import bs_price
from mcos_tpu.ops.svcj import svcj_cos_price, svcj_terminal

Array = jax.Array


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "is_call"))
def _svcj_price_core(params: SVCJParams, spot, strikes, T, seed, *,
                     num_paths: int, num_steps: int,
                     is_call: bool) -> Dict[str, Array]:
    """Antithetic + companion-CV SVCJ pricing over a strike vector.

    Same estimator discipline as engine/pricer.py:mc_price_core: the
    companion GBM leg rides the SAME dW₁ (β=1 CV; its expectation is the
    BS(√v0) price — variance jumps never touch it), payoffs pool over both
    antithetic branches, moments stay f32 on device.
    """
    strikes = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))
    s_final, v_final, g_final = svcj_terminal(
        params, spot, T, jax.random.key(seed), num_paths=num_paths,
        num_steps=num_steps, antithetic=True, companion=True)
    discount = jnp.exp(-params.r * jnp.asarray(T, jnp.float32))
    sign = 1.0 if is_call else -1.0
    pay = jnp.maximum(sign * (s_final[..., None] - strikes), 0.0)
    g_pay = jnp.maximum(sign * (g_final[..., None] - strikes), 0.0)
    bs_ref = bs_price(spot, strikes, T, params.r, params.q,
                      jnp.sqrt(params.v0), is_call)
    # Collapse antithetic PAIRS before the moments (mc_mean_stderr
    # convention, ops/simulate.py): branch members share jump draws and z²
    # magnitudes, so treating the 2n branch values as iid would mis-scale
    # the stderr.
    eff = jnp.mean(pay - g_pay, axis=0) + bs_ref / discount
    n = jnp.float32(eff.shape[0])
    mean = jnp.mean(eff, axis=0)
    var = jnp.maximum(jnp.mean(eff * eff, axis=0) - mean * mean, 0.0)
    return {
        "price": discount * mean,
        "std_error": discount * jnp.sqrt(var / n),
        "bs_ref": bs_ref,
        "v_max": jnp.max(v_final),
        "frac_nonfinite": jnp.mean(~jnp.isfinite(s_final)),
    }


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "is_call"))
def _svcj_delta_vega(params: SVCJParams, spot, strike, T, key, *,
                     num_paths: int, num_steps: int, is_call: bool):
    """Pathwise AD (∂P/∂S₀, ∂P/∂v₀) through the scan in ONE backward pass.

    Jump indicators don't depend on (S₀, v₀), so the pathwise derivative
    of the vanilla payoff is unbiased — the same argument engine/greeks.py
    makes for SVJ.
    """
    def price_fn(s0, v0):
        p = params.replace(v0=v0)
        s_final, _, g_final = svcj_terminal(
            p, s0, T, key, num_paths=num_paths, num_steps=num_steps,
            antithetic=True, companion=True)
        discount = jnp.exp(-params.r * jnp.asarray(T, jnp.float32))
        sign = 1.0 if is_call else -1.0
        pay = jnp.maximum(sign * (s_final - strike), 0.0)
        g_pay = jnp.maximum(sign * (g_final - strike), 0.0)
        bs_ref = bs_price(s0, strike, T, params.r, params.q,
                          jnp.sqrt(v0), is_call)
        return discount * jnp.mean(pay - g_pay) + bs_ref

    price, grads = jax.value_and_grad(price_fn, argnums=(0, 1))(
        jnp.asarray(spot, jnp.float32), jnp.asarray(params.v0, jnp.float32))
    return price, grads[0], grads[1]


class SVCJEngine:
    """Stateful wrapper over the jitted SVCJ cores (one per API request)."""

    def __init__(self, params: SVCJParams, num_paths: int = 200_000,
                 num_steps: int = 252, seed: int = 42, mesh=None):
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        # None honors MCOS_AUTO_MESH=1 (the serving toggle); "auto" or an
        # explicit Mesh routes price() through the psum-pooled driver
        # (parallel/families.py:sharded_svcj_price).
        self.mesh = mesh

    def _steps(self, T: float) -> int:
        return scaled_steps(self.num_steps, T)

    def price(self, spot: float, strike, T: float,
              is_call: bool = True) -> Dict:
        from mcos_tpu.engine.pricer import resolve_mesh

        strikes = np.atleast_1d(np.asarray(strike, np.float32))
        mesh = resolve_mesh(self.mesh)
        if mesh is not None:
            from mcos_tpu.parallel.families import sharded_svcj_price

            res = jax.device_get(sharded_svcj_price(
                self.params, spot, strikes, T, jax.random.key(self.seed),
                mesh=mesh, num_paths=self.num_paths,
                num_steps=self._steps(T), is_call=is_call))
            res["bs_ref"] = np.asarray(bs_price(
                spot, strikes, T, self.params.r, self.params.q,
                jnp.sqrt(self.params.v0), is_call))
        else:
            res = jax.device_get(_svcj_price_core(
                self.params, spot, strikes, T, self.seed,
                num_paths=self.num_paths, num_steps=self._steps(T),
                is_call=is_call))
        out = {
            "price": float(res["price"][0]),
            "std_error": float(res["std_error"][0]),
            "bs_ref": float(res["bs_ref"][0]),
            "num_paths_used": int(np.asarray(res.get(
                "num_paths_used", self.num_paths))),
            "num_steps": self._steps(T),
            "v_max": float(res["v_max"]),
            "frac_nonfinite": float(res["frac_nonfinite"]),
        }
        if strikes.shape[0] > 1:
            out["chain"] = [
                {"strike": float(k), "price": float(res["price"][i]),
                 "std_error": float(res["std_error"][i])}
                for i, k in enumerate(strikes)]
        return out

    def cos_price(self, spot: float, strikes, T: float,
                  is_call: bool = True) -> np.ndarray:
        """Semi-analytic oracle (exact up to COS truncation)."""
        return svcj_cos_price(self.params, spot, strikes, T, is_call)

    def greeks(self, spot: float, strike: float, T: float,
               is_call: bool = True) -> Dict:
        price, dS, dv0 = jax.device_get(_svcj_delta_vega(
            self.params, spot, strike, T, jax.random.key(self.seed),
            num_paths=self.num_paths, num_steps=self._steps(T),
            is_call=is_call))
        sigma0 = float(np.sqrt(float(self.params.v0)))
        return {
            "price": float(price),
            "delta": float(dS),
            # Repo-wide convention (engine/greeks.py): vega per unit vol
            # = ∂P/∂σ₀ = 2σ₀·∂P/∂v₀.
            "vega": 2.0 * sigma0 * float(dv0),
            "dP_dv0": float(dv0),
        }

    def smile(self, spot: float, T: float,
              strikes: Sequence[float]) -> Dict:
        """Exact COS-implied vols across strikes (no MC noise)."""
        from mcos_tpu.engine.surface import implied_vol

        strikes = np.asarray(strikes, np.float64)
        prices = self.cos_price(spot, strikes, T, True)
        ivs = [implied_vol(float(c), spot, float(k), T,
                           float(self.params.r), float(self.params.q), True)
               for c, k in zip(prices, strikes)]
        return {
            "strikes": strikes.tolist(),
            "prices": [float(c) for c in prices],
            "iv": [None if v is None else float(v) for v in ivs],
        }

    def mc_vs_cos(self, spot: float, strikes, T: float,
                  is_call: bool = True) -> Dict:
        """MC-vs-oracle diagnostic rows (the /api/svcj compare mode)."""
        strikes = np.atleast_1d(np.asarray(strikes, np.float64))
        exact = self.cos_price(spot, strikes, T, is_call)
        res = jax.device_get(_svcj_price_core(
            self.params, spot, strikes.astype(np.float32), T,
            self.seed, num_paths=self.num_paths,
            num_steps=self._steps(T), is_call=is_call))
        rows = []
        for i, k in enumerate(strikes):
            se = float(res["std_error"][i])
            rows.append({
                "strike": float(k),
                "mc_price": float(res["price"][i]),
                "cos_price": float(exact[i]),
                "std_error": se,
                "err_sigmas": float(abs(res["price"][i] - exact[i])
                                    / max(se, 1e-12)),
            })
        return {"rows": rows}
