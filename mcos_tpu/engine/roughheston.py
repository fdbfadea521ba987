"""Rough Heston engine: lifted-MC pricing + the fractional-Riccati oracle.

Model family beyond the reference (its engine stops at classical SVJ,
reference engine/models.py:25-28). Same engine shape as the rest of the
repo (engine/svcj.py is the closest sibling): a module-level jitted core
(value-stable statics, no per-call retraces), a thin stateful wrapper
with reference-style result keys, and the COS oracle as the exactness
anchor for smiles, calibration, and the MC cross-check.

Two deliberate design points, both measured (ops/roughheston.py):

- The lifted kernel's node set is keyed to a RESOLUTION time scale
  (default T/256), not to the simulation dt — so refining steps converges
  to a fixed Markovian model (Euler bias at the T/256 kernel: +1.0% of
  ATM at 256 steps, +0.5% at 1024, +0.08% at 4096) instead of chasing a
  model that stiffens with every dt.
- Steps OVERSAMPLE the kernel resolution (default 8x per year-fraction
  via `scaled_steps`), because the scheme's weak error, not the kernel
  fit (< 1 ATM rupee), dominates the bias budget.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import scaled_steps
from mcos_tpu.ops.bs import bs_price
from mcos_tpu.ops.roughheston import (
    RoughHestonParams,
    lifted_kernel_error,
    lifted_kernel_nodes,
    lifted_terminal,
    rough_heston_cos_price,
)

Array = jax.Array

KERNEL_RES_STEPS = 256          # lifted-kernel resolution: T / 256


def _nodes(params: RoughHestonParams, T: float, n_factors: int):
    c, x = lifted_kernel_nodes(float(params.hurst), float(T),
                               float(T) / KERNEL_RES_STEPS, n_factors)
    return jnp.asarray(c, jnp.float32), jnp.asarray(x, jnp.float32)


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "is_call"))
def _rh_price_core(params: RoughHestonParams, spot, strikes, T, seed,
                   c_weights, x_nodes, *, num_paths: int, num_steps: int,
                   is_call: bool) -> Dict[str, Array]:
    """Antithetic + companion-CV lifted rough-Heston pricing over strikes.

    Estimator discipline identical to engine/svcj.py:_svcj_price_core:
    companion GBM leg on the same dW1 (beta=1 CV, expectation =
    BS(sqrt(v0))), antithetic PAIRS collapsed before the moments, f32
    moments on device.
    """
    strikes = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))
    s_final, v_final, g_final = lifted_terminal(
        params, spot, T, jax.random.key(seed), c_weights, x_nodes,
        num_paths=num_paths, num_steps=num_steps, antithetic=True,
        companion=True)
    discount = jnp.exp(-params.r * jnp.asarray(T, jnp.float32))
    sign = 1.0 if is_call else -1.0
    pay = jnp.maximum(sign * (s_final[..., None] - strikes), 0.0)
    g_pay = jnp.maximum(sign * (g_final[..., None] - strikes), 0.0)
    bs_ref = bs_price(spot, strikes, T, params.r, params.q,
                      jnp.sqrt(params.v0), is_call)
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


def _rh_mc_price(params: RoughHestonParams, s0, strike, T, key,
                 c_weights, x_nodes, *, num_paths: int, num_steps: int,
                 is_call: bool, remat_chunk: int = 0):
    """Scalar CV-adjusted price (shared by the AD-delta and FD cores)."""
    s_final, _, g_final = lifted_terminal(
        params, s0, T, key, c_weights, x_nodes, num_paths=num_paths,
        num_steps=num_steps, antithetic=True, companion=True,
        remat_chunk=remat_chunk)
    discount = jnp.exp(-params.r * jnp.asarray(T, jnp.float32))
    sign = 1.0 if is_call else -1.0
    pay = jnp.maximum(sign * (s_final - strike), 0.0)
    g_pay = jnp.maximum(sign * (g_final - strike), 0.0)
    bs_ref = bs_price(s0, strike, T, params.r, params.q,
                      jnp.sqrt(params.v0), is_call)
    return discount * jnp.mean(pay - g_pay) + bs_ref


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "is_call"))
def _rh_delta_core(params: RoughHestonParams, spot, strike, T, key,
                   c_weights, x_nodes, *, num_paths: int, num_steps: int,
                   is_call: bool):
    """Pathwise AD delta through the factor scan (one backward pass).

    Delta is the STABLE pathwise derivative here: the S0-chain
    (dS_T/dS0 = S_T/S0) never touches the variance recursion. The
    variance-parameter chains are NOT taken by AD — the per-step factor
    d(sqrt v)/dv = 1/(2 sqrt v) makes them exponentially heavy-tailed
    when rough paths pin v near 0 (f32 overflow at thousands of steps)
    — those go through `_rh_fd_sens` CRN-FD instead,
    mirroring the repo's gamma-by-CRN-FD-of-AD-delta convention
    (engine/greeks.py).

    remat_chunk=64: without it the backward pass materializes the factor
    carry for every step (78 GB at the default workload, computed from
    the shapes); the checkpointed chunks cap residuals at ~5 GB for one extra
    forward pass (ops/roughheston.py:lifted_terminal docstring).
    """
    def price_fn(s0):
        return _rh_mc_price(params, s0, strike, T, key, c_weights,
                            x_nodes, num_paths=num_paths,
                            num_steps=num_steps, is_call=is_call,
                            remat_chunk=64)

    return jax.value_and_grad(price_fn)(jnp.asarray(spot, jnp.float32))


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "is_call"))
def _rh_fd_sens(params: RoughHestonParams, spot, strike, T, key,
                c_weights, x_nodes, *, num_paths: int, num_steps: int,
                is_call: bool):
    """(dP/dv0, dP/dnu, dP/drho) by CRN central differences — SIX bumped
    members vmapped into ONE forward device program, every member on the
    same threefry key (CRN: the bump difference cancels the path noise).
    Forward-only, so no remat is needed."""
    v0 = jnp.asarray(params.v0, jnp.float32)
    nu = jnp.asarray(params.nu, jnp.float32)
    rho = jnp.asarray(params.rho, jnp.float32)
    h_v0 = 0.05 * v0
    h_nu = jnp.float32(0.02)
    h_rho = jnp.float32(0.02)
    v0s = jnp.stack([v0 + h_v0, v0 - h_v0, v0, v0, v0, v0])
    nus = jnp.stack([nu, nu, nu + h_nu, nu - h_nu, nu, nu])
    rhos = jnp.stack([rho, rho, rho, rho,
                      jnp.minimum(rho + h_rho, 0.999),
                      jnp.maximum(rho - h_rho, -0.999)])

    def member(v0_, nu_, rho_):
        p = params.replace(v0=v0_, nu=nu_, rho=rho_)
        return _rh_mc_price(p, spot, strike, T, key, c_weights, x_nodes,
                            num_paths=num_paths, num_steps=num_steps,
                            is_call=is_call)

    prices = jax.vmap(member)(v0s, nus, rhos)
    d_v0 = (prices[0] - prices[1]) / (2.0 * h_v0)
    d_nu = (prices[2] - prices[3]) / (2.0 * h_nu)
    d_rho = (prices[4] - prices[5]) / (rhos[4] - rhos[5])
    return d_v0, d_nu, d_rho


class RoughHestonEngine:
    """Stateful wrapper over the jitted lifted-MC cores + the COS oracle.

    `num_steps` is per-year (scaled by maturity like every other engine);
    the default 8192/yr oversamples the T/256 kernel resolution 8x — the
    measured weak-error sweet spot (class docstring).
    """

    def __init__(self, params: RoughHestonParams,
                 num_paths: int = 200_000, num_steps: int = 8192,
                 n_factors: int = 24, seed: int = 42, mesh=None):
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.n_factors = int(n_factors)
        self.seed = int(seed)
        # None honors MCOS_AUTO_MESH=1; "auto"/Mesh routes price() through
        # parallel/families.py:sharded_roughheston_price (factor scan per
        # device, psum'd CV-effective moments).
        self.mesh = mesh

    def _steps(self, T: float) -> int:
        n = max(scaled_steps(self.num_steps, T), 2 * KERNEL_RES_STEPS)
        return ((n + 63) // 64) * 64     # remat-chunk aligned (greeks)

    def kernel_fit_error(self, T: float) -> float:
        return lifted_kernel_error(float(self.params.hurst), float(T),
                                   float(T) / KERNEL_RES_STEPS,
                                   self.n_factors)

    def price(self, spot: float, strike, T: float,
              is_call: bool = True) -> Dict:
        from mcos_tpu.engine.pricer import resolve_mesh

        strikes = np.atleast_1d(np.asarray(strike, np.float32))
        c, x = _nodes(self.params, T, self.n_factors)
        mesh = resolve_mesh(self.mesh)
        if mesh is not None:
            from mcos_tpu.ops.bs import bs_price
            from mcos_tpu.parallel.families import sharded_roughheston_price

            res = jax.device_get(sharded_roughheston_price(
                self.params, spot, strikes, T, jax.random.key(self.seed),
                mesh=mesh, num_paths=self.num_paths,
                num_steps=self._steps(T), n_factors=self.n_factors,
                is_call=is_call))
            res["bs_ref"] = np.asarray(bs_price(
                spot, strikes, T, self.params.r, self.params.q,
                np.sqrt(float(self.params.v0)), is_call))
        else:
            res = jax.device_get(_rh_price_core(
                self.params, spot, strikes, T, self.seed, c, x,
                num_paths=self.num_paths, num_steps=self._steps(T),
                is_call=is_call))
        out = {
            "price": float(res["price"][0]),
            "std_error": float(res["std_error"][0]),
            "bs_ref": float(res["bs_ref"][0]),
            "num_paths_used": self.num_paths,
            "num_steps": self._steps(T),
            "n_factors": len(c),
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
        """Semi-analytic oracle (exact up to COS + Adams truncation)."""
        return rough_heston_cos_price(self.params, spot, strikes, T,
                                      is_call)

    def greeks(self, spot: float, strike: float, T: float,
               is_call: bool = True) -> Dict:
        """AD delta (stable pathwise chain) + CRN-FD variance-parameter
        sensitivities — see _rh_delta_core for why the split."""
        c, x = _nodes(self.params, T, self.n_factors)
        key = jax.random.key(self.seed)
        steps = self._steps(T)
        price, d_s = jax.device_get(_rh_delta_core(
            self.params, spot, strike, T, key, c, x,
            num_paths=self.num_paths, num_steps=steps, is_call=is_call))
        d_v0, d_nu, d_rho = jax.device_get(_rh_fd_sens(
            self.params, spot, strike, T, key, c, x,
            num_paths=self.num_paths, num_steps=steps, is_call=is_call))
        sigma0 = float(np.sqrt(float(self.params.v0)))
        return {
            "price": float(price),
            "delta": float(d_s),
            # Repo-wide convention (engine/greeks.py): vega per unit vol
            # = dP/dsigma0 = 2 sigma0 dP/dv0.
            "vega": 2.0 * sigma0 * float(d_v0),
            "dP_dv0": float(d_v0),
            "dP_dnu": float(d_nu),
            "dP_drho": float(d_rho),
        }

    def smile(self, spot: float, T: float,
              strikes: Sequence[float]) -> Dict:
        """Exact COS-implied vols across strikes (no MC noise)."""
        from mcos_tpu.engine.surface import implied_vol

        strikes = np.asarray(strikes, np.float64)
        prices = self.cos_price(spot, strikes, T, True)
        ivs = [implied_vol(float(cv), spot, float(k), T,
                           float(self.params.r), float(self.params.q),
                           True)
               for cv, k in zip(prices, strikes)]
        return {
            "strikes": strikes.tolist(),
            "prices": [float(cv) for cv in prices],
            "iv": [None if v is None else float(v) for v in ivs],
        }

    def atm_skew_term_structure(self, spot: float,
                                maturities: Sequence[float]) -> Dict:
        """d(IV)/d(ln K) at the money per maturity — the rough signature.

        Rough Heston shares rBergomi's power law: |skew| ~ T^(H - 1/2)
        as T -> 0 (the engine/rough.py test pins the rBergomi analogue).
        Computed from exact COS prices, central difference in ln K.
        """
        from mcos_tpu.engine.surface import implied_vol

        rows = []
        for T in maturities:
            bump = 0.02
            ks = spot * np.exp(np.array([-bump, bump]))
            prices = self.cos_price(spot, ks, float(T), True)
            ivs = [implied_vol(float(cv), spot, float(k), float(T),
                               float(self.params.r), float(self.params.q),
                               True)
                   for cv, k in zip(prices, ks)]
            if None in ivs:
                continue
            rows.append({"T": float(T),
                         "atm_skew": (ivs[1] - ivs[0]) / (2.0 * bump)})
        return {"rows": rows, "hurst": float(self.params.hurst)}

    def mc_vs_cos(self, spot: float, strikes, T: float,
                  is_call: bool = True) -> Dict:
        """MC-vs-oracle diagnostic rows (the /api/roughheston compare
        mode). `err_sigmas` bands exclude the documented O(dt) scheme
        bias — the compare payload reports it honestly instead."""
        strikes = np.atleast_1d(np.asarray(strikes, np.float64))
        exact = self.cos_price(spot, strikes, T, is_call)
        c, x = _nodes(self.params, T, self.n_factors)
        res = jax.device_get(_rh_price_core(
            self.params, spot, strikes.astype(np.float32), T, self.seed,
            c, x, num_paths=self.num_paths, num_steps=self._steps(T),
            is_call=is_call))
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
        return {"rows": rows, "kernel_fit_error": self.kernel_fit_error(T),
                "num_steps": self._steps(T)}


def calibrate_rough_heston(spot: float, strikes, T: float, market_prices,
                           r: Optional[float] = None,
                           q: Optional[float] = None,
                           is_call: bool = True,
                           hurst: Optional[float] = None,
                           hurst_grid: Sequence[float] = (0.05, 0.1, 0.2,
                                                          0.35),
                           fit_lam_theta: bool = False,
                           n_starts: int = 2, seed: int = 0,
                           n_terms: int = 192,
                           n_adams: int = 128) -> Dict:
    """Fit rough-Heston to a single-maturity smile on the COS objective.

    Same architecture as the rBergomi fit (engine/rough.py): the
    non-smooth-in-H kernel machinery makes H a GRID axis (or a fixed
    input), and the smooth parameters (nu, rho, v0[, lam, theta]) go to a
    multi-start trust-region least squares per H — the oracle is exact,
    so there is no MC noise in the objective. Reduced COS settings
    (n_terms/n_adams) keep one objective eval at ~10 ms host-side.
    """
    from mcos_tpu.config import DIVIDEND_YIELD, RISK_FREE_RATE
    from scipy.optimize import least_squares

    r = RISK_FREE_RATE if r is None else float(r)
    q = DIVIDEND_YIELD if q is None else float(q)
    strikes = np.asarray(strikes, np.float64)
    market = np.asarray(market_prices, np.float64)
    h_values = [float(hurst)] if hurst is not None else list(hurst_grid)

    if fit_lam_theta:
        lo = np.array([0.05, -0.99, 1e-4, 0.1, 1e-3])
        hi = np.array([2.50, 0.50, 1.00, 8.0, 1.00])
        base = np.array([0.35, -0.6, 0.04, 1.5, 0.04])
    else:
        lo = np.array([0.05, -0.99, 1e-4])
        hi = np.array([2.50, 0.50, 1.00])
        base = np.array([0.35, -0.6, 0.04])

    def make_params(x, h):
        if fit_lam_theta:
            nu, rho, v0, lam, theta = x
        else:
            nu, rho, v0 = x
            lam, theta = 1.5, float(v0)
        return RoughHestonParams(lam=float(lam), theta=float(theta),
                                 nu=float(nu), rho=float(rho),
                                 v0=float(v0), r=r, q=q, hurst=h)

    rng = np.random.default_rng(seed)
    best, best_h = None, None
    for h in h_values:
        def resid(x, _h=h):
            p = make_params(x, _h)
            try:
                model = rough_heston_cos_price(
                    p, spot, strikes, T, is_call,
                    n_terms=n_terms, n_steps=n_adams)
            except FloatingPointError:
                return np.full(market.shape, 1e3)
            return model - market

        starts = [base] + [lo + rng.random(lo.shape) * (hi - lo)
                           for _ in range(n_starts - 1)]
        for x0 in starts:
            try:
                res = least_squares(resid, x0, bounds=(lo, hi), xtol=1e-10)
            except Exception:  # noqa: BLE001 — a bad start must not kill it
                continue
            if best is None or res.cost < best.cost:
                best, best_h = res, h

    if best is None:
        raise RuntimeError("rough-Heston calibration failed on every start")
    params = make_params(best.x, best_h)
    rmse = float(np.sqrt(2.0 * best.cost / max(market.size, 1)))
    return {
        "params": params,
        "hurst": float(best_h),
        "nu": float(params.nu), "rho": float(params.rho),
        "v0": float(params.v0), "lam": float(params.lam),
        "theta": float(params.theta),
        "rmse_price": rmse, "n_quotes": int(market.size),
    }
