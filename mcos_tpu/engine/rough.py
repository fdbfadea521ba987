"""Rough Bergomi pricing engine: smiles, Greeks-by-AD, term skew.

Engine layer over `ops/rough.py` (see its header for the model and the
matmul-only design). Capability beyond the reference, whose model
menu stops at Markovian SVJ (reference engine/monte_carlo.py:1-14).

Because the conditional (Romano-Touzi) estimator prices every path with a
smooth Black formula, this engine gets delta AND gamma from nested
`jax.grad` — no CRN finite differences needed anywhere (contrast
engine/greeks.py, where the kinked MC payoff forces gamma = CRN-FD of the
AD delta). eta/rho/xi sensitivities ride the same backward pass.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.engine.surface import implied_vol
from mcos_tpu.ops.rough import (RoughBergomiParams, rbergomi_chol,
                                rbergomi_conditional_payoffs,
                                rbergomi_lift, rbergomi_lifted_payoffs,
                                rbergomi_path_stats, rbergomi_terminal,
                                sample_xi_curve,
                                xi_curve_from_variance_swaps)
from mcos_tpu.utils.optim import adam_polish, differential_evolution

Array = jax.Array

RBERGOMI_CAL_BOUNDS = {
    "eta": (0.3, 4.0),
    "rho": (-0.99, -0.05),
    "xi": (0.002, 0.40),
}


@jax.jit
def _combine_mean_se(pay):
    """(branches, paths, strikes) payoffs → ((strikes,) mean, stderr) in
    ONE device program (eager reductions would each sync with the host)."""
    comb = jnp.mean(pay, axis=0)
    mean = jnp.mean(comb, axis=0)
    se = jnp.std(comb, axis=0) / jnp.sqrt(jnp.float32(comb.shape[0]))
    return mean, se


class RoughBergomiEngine:
    """Monte Carlo pricer for the rough Bergomi model.

    The Cholesky factor of the exact (W~, dW) covariance is prepared on
    host per (hurst, T, num_steps) and cached; all device work is one
    matmul plus elementwise math (no scan), so warm repricing across
    strikes/params at a fixed maturity reuses one compiled program.
    """

    def __init__(self, params: RoughBergomiParams,
                 num_paths: int = 131_072, num_steps: int = 128,
                 seed: int = 42, use_sobol: bool = False,
                 rqmc_randomizations: int = 8, xi_curve=None,
                 sampler: str = "auto", lift_factors: int = 24):
        if sampler not in ("auto", "exact", "lift"):
            raise ValueError("sampler must be 'auto', 'exact' or 'lift'")
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.use_sobol = bool(use_sobol)
        self.rqmc = int(rqmc_randomizations)
        # Optional forward-variance term structure (edges, values) —
        # e.g. from `xi_curve_from_variance_swaps`; overrides params.xi.
        self.xi_curve = xi_curve
        # Vanilla-pricing sampler: "exact" = the O(n²) exact-covariance
        # matmul; "lift" = the O(n·m) Markovian lift (ops/rough.py:
        # rbergomi_core_lifted — exact marginals, <1%-kernel-error
        # autocovariance); "auto" lifts once the step count passes the
        # matmul's measured knee (steps ≥ 512; QMC stays exact — Sobol's
        # low-dim structure rides the PCA factor). Path-dependent payoffs
        # (asian/barrier/lookback/variance legs) always sample the exact
        # sheet.
        self.sampler = sampler
        self.lift_factors = int(lift_factors)

    @classmethod
    def from_variance_swaps(cls, params: RoughBergomiParams, maturities,
                            var_strikes, **kw) -> "RoughBergomiEngine":
        """Engine whose forward-variance curve reprices the given
        variance-swap quotes exactly (piecewise-constant bootstrap)."""
        return cls(params, xi_curve=xi_curve_from_variance_swaps(
            maturities, var_strikes), **kw)

    def _xi_t(self, T: float):
        if self.xi_curve is None:
            return None
        edges, vals = self.xi_curve
        return jnp.asarray(sample_xi_curve(edges, vals, T, self.num_steps))

    def variance_swap_strike(self, T: float) -> float:
        """Model fair variance-swap strike sqrt((1/T) \\int xi) — exact
        from the curve (E[v_t] = xi(t)), no simulation needed."""
        if self.xi_curve is None:
            return float(np.sqrt(float(self.params.xi)))
        xi_t = np.asarray(self._xi_t(T), np.float64)
        return float(np.sqrt(xi_t.mean()))

    # ── internals ────────────────────────────────────────────────────────
    def _chol(self, T: float) -> Array:
        # PCA factor under QMC: the first Sobol dimensions then drive the
        # largest variance directions (classic QMC construction).
        return jnp.asarray(rbergomi_chol(
            float(self.params.hurst), float(T), self.num_steps,
            transform="pca" if self.use_sobol else "cholesky"))

    def _key(self):
        return jax.random.key(self.seed)

    def _use_lift(self) -> bool:
        if self.sampler == "lift":
            return True
        if self.sampler == "exact":
            return False
        return self.num_steps >= 512 and not self.use_sobol

    def _remat_chunk(self) -> int:
        for m in (64, 32, 16, 8):
            if self.num_steps % m == 0:
                return m
        return 0

    def _payoffs(self, params: RoughBergomiParams, spot, strikes_arr, T,
                 is_call, key, remat_chunk: int = 0) -> Array:
        """(branches, paths, strikes) conditional-Black payoffs via the
        selected sampler (`params` explicit so AD callers trace it)."""
        if self._use_lift():
            c, d, g, tail = rbergomi_lift(
                float(params.hurst), float(T), self.num_steps,
                self.lift_factors)
            return rbergomi_lifted_payoffs(
                params, spot, strikes_arr, T, key, c, d, g, tail,
                num_paths=self.num_paths, num_steps=self.num_steps,
                is_call=is_call, xi_t=self._xi_t(T),
                remat_chunk=remat_chunk)
        return rbergomi_conditional_payoffs(
            params, spot, strikes_arr, T, self._chol(T), key,
            num_paths=self.num_paths, num_steps=self.num_steps,
            is_call=is_call, xi_t=self._xi_t(T))

    # ── public surface ───────────────────────────────────────────────────
    def price(self, spot: float, strikes, T: float,
              is_call: bool = True) -> Dict[str, object]:
        strikes_arr = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))
        disc = float(np.exp(-float(self.params.r) * T))
        scalar = np.ndim(strikes) == 0
        if self.use_sobol:
            chol = self._chol(T)  # the lift path never builds the O(n²) factor
            # Randomized QMC: R independent Owen scrambles of num_paths/R
            # points each; the spread of the R estimates IS the error bar
            # (plain per-path stderr is meaningless for correlated QMC
            # points). Same total path budget as the PRNG estimator.
            from mcos_tpu.ops.sobol import sobol_normals

            per = max(self.num_paths // self.rqmc, 256)
            ests = []
            for r_i in range(self.rqmc):
                z = sobol_normals(per, 2 * self.num_steps, seed=self.seed,
                                  stream=r_i)
                pay = rbergomi_conditional_payoffs(
                    self.params, spot, strikes_arr, T, chol, self._key(),
                    num_paths=per, num_steps=self.num_steps,
                    is_call=is_call, z=z, xi_t=self._xi_t(T))
                ests.append(np.asarray(jnp.mean(pay, axis=(0, 1))))
            ests = np.stack(ests)                     # (R, strikes)
            mean = ests.mean(axis=0)
            se = ests.std(axis=0, ddof=1) / np.sqrt(self.rqmc)
            price, stderr = disc * mean, disc * se
            return {
                "price": float(price[0]) if scalar else price.tolist(),
                "std_error": float(stderr[0]) if scalar
                else stderr.tolist(),
                "num_paths_used": per * self.rqmc,
                "num_steps": self.num_steps,
                "estimator": "conditional-black+rqmc",
                "rqmc_randomizations": self.rqmc,
            }
        estimator = "conditional-black"
        pay = self._payoffs(self.params, spot, strikes_arr, T, is_call,
                            self._key())
        if self._use_lift():
            estimator += "+lift"
        mean, se = jax.device_get(_combine_mean_se(pay))
        price = disc * np.asarray(mean)
        stderr = disc * np.asarray(se)
        return {
            "price": float(price[0]) if scalar else price.tolist(),
            "std_error": float(stderr[0]) if scalar else stderr.tolist(),
            "num_paths_used": self.num_paths,
            "num_steps": self.num_steps,
            "estimator": estimator,
        }

    def greeks(self, spot: float, strike: float, T: float,
               is_call: bool = True) -> Dict[str, float]:
        """delta/gamma by nested AD + eta/rho/xi sensitivities, one pass.

        gamma via grad-of-grad is unbiased here because every per-path
        payoff is a smooth Black price in S0 (see module header).
        """
        key = self._key()
        k_arr = jnp.asarray([strike], jnp.float32)
        disc_T = jnp.asarray(T, jnp.float32)
        # The lifted scan needs rematerialization under AD (the exact
        # sampler is matmul-only and does not).
        remat = self._remat_chunk() if self._use_lift() else 0

        def scalar_price(s, p: RoughBergomiParams):
            pay = self._payoffs(p, s, k_arr, T, is_call, key,
                                remat_chunk=remat)
            return (jnp.exp(-p.r * disc_T) * jnp.mean(pay, axis=(0, 1)))[0]

        s0 = jnp.asarray(spot, jnp.float32)
        price, (d_s, d_p) = jax.value_and_grad(
            scalar_price, argnums=(0, 1))(s0, self.params)
        gamma = jax.grad(jax.grad(scalar_price))(s0, self.params)
        return {
            "price": float(price),
            "delta": float(d_s),
            "gamma": float(gamma),
            "vega_xi": float(d_p.xi),        # dP/d xi (forward variance)
            "d_eta": float(d_p.eta),         # vol-of-vol sensitivity
            "d_rho": float(d_p.rho),         # leverage sensitivity
            "rho_rate": float(d_p.r),        # dP/dr (rate rho)
        }

    def smile(self, spot: float, T: float,
              moneyness: Optional[Sequence[float]] = None
              ) -> Dict[str, object]:
        """Implied-vol smile: batch-price one strike grid, invert each to
        Black-Scholes vol (host f64 Newton, engine/surface.py)."""
        if moneyness is None:
            moneyness = np.linspace(0.85, 1.15, 13)
        m = np.asarray(moneyness, np.float64)
        strikes = spot * m
        res = self.price(spot, strikes, T, is_call=True)
        p = self.params
        ivs = [implied_vol(float(px), spot, float(k), T, float(p.r),
                           float(p.q), True)
               for px, k in zip(res["price"], strikes)]
        return {"moneyness": m.tolist(), "strikes": strikes.tolist(),
                "prices": res["price"], "implied_vols": ivs,
                "std_errors": res["std_error"]}

    def atm_skew(self, spot: float, T: float,
                 dm: float = 0.02) -> Dict[str, float]:
        """d(sigma_imp)/d(log-moneyness) at ATM — the quantity whose
        T -> 0 power-law blowup ~ T^{H-1/2} is the rough-vol signature."""
        sm = self.smile(spot, T, moneyness=[np.exp(-dm), 1.0, np.exp(dm)])
        lo, _, hi = sm["implied_vols"]
        if lo is None or hi is None:
            return {"skew": float("nan"), "T": T}
        return {"skew": (hi - lo) / (2.0 * dm), "T": T,
                "atm_vol": sm["implied_vols"][1]}

    # ── path-dependent payoffs (rough-vol exotics) ───────────────────────
    def _stats(self, spot: float, T: float):
        """(branches, paths) terminal/mean/max/min spot statistics via the
        selected sampler. The lift route (sampler='lift', or 'auto' at
        ≥512 steps) replaces the exact sheet's O(n²) covariance matmul
        with the O(n·m) factor scan, statistically pinned to the exact
        sampler in tests/test_rough.py."""
        if self._use_lift():
            p = self.params
            c, d, g, tail = rbergomi_lift(
                float(p.hurst), float(T), self.num_steps,
                self.lift_factors)
            from mcos_tpu.ops.rough import rbergomi_path_stats_lifted

            return rbergomi_path_stats_lifted(
                p, spot, T, self._key(), c, d, g, tail,
                num_paths=self.num_paths, num_steps=self.num_steps,
                xi_t=self._xi_t(T))
        return rbergomi_path_stats(
            self.params, spot, T, self._chol(T), self._key(),
            num_paths=self.num_paths, num_steps=self.num_steps)

    def _reduce(self, pay: Array, T: float) -> Dict[str, float]:
        mean, se = jax.device_get(_combine_mean_se(pay[..., None]))
        disc = float(np.exp(-float(self.params.r) * T))
        return {
            "price": disc * float(mean[0]),
            "std_error": disc * float(se[0]),
            "num_paths_used": self.num_paths,
            "num_steps": self.num_steps,
        }

    def price_asian(self, spot: float, strike: float, T: float,
                    is_call: bool = True) -> Dict[str, float]:
        """Discretely-averaged arithmetic Asian under rough volatility
        (observations at the simulation grid incl. t_0, matching
        ops/exotics.py's tracker semantics)."""
        st = self._stats(spot, T)
        phi = 1.0 if is_call else -1.0
        return self._reduce(
            jnp.maximum(phi * (st["s_mean"] - strike), 0.0), T)

    def price_barrier(self, spot: float, strike: float, T: float,
                      barrier: float, is_call: bool = True,
                      knock: str = "out",
                      direction: Optional[str] = None) -> Dict[str, float]:
        """Discretely-monitored barrier under rough volatility."""
        st = self._stats(spot, T)
        if direction is None:
            direction = "up" if barrier >= spot else "down"
        hit = (st["s_max"] >= barrier if direction == "up"
               else st["s_min"] <= barrier)
        alive = hit if knock == "in" else ~hit
        phi = 1.0 if is_call else -1.0
        pay = jnp.maximum(phi * (st["s_terminal"] - strike), 0.0) * alive
        out = self._reduce(pay, T)
        out["hit_fraction"] = float(jnp.mean(hit))
        return out

    def price_lookback(self, spot: float, T: float, is_call: bool = True,
                       strike: Optional[float] = None) -> Dict[str, float]:
        """Lookback under rough volatility: floating strike when `strike`
        is None (call pays S_T − min, put pays max − S_T), else fixed."""
        st = self._stats(spot, T)
        if strike is None:
            pay = (st["s_terminal"] - st["s_min"] if is_call
                   else st["s_max"] - st["s_terminal"])
        else:
            phi = 1.0 if is_call else -1.0
            extreme = st["s_max"] if is_call else st["s_min"]
            pay = jnp.maximum(phi * (extreme - strike), 0.0)
        return self._reduce(pay, T)

    def variance_swap_mc(self, T: float,
                         num_paths: Optional[int] = None
                         ) -> Dict[str, float]:
        """MC fair variance-swap strike from realized variance on the
        grid: K² = (1/T)·E[Σ (Δlog S)²]. Pins `variance_swap_strike`
        (the curve value, exact since E[v_t] = ξ(t)) up to the O(dt)
        drift² and discretization terms — the round-trip that ties the
        forward-variance curve to what a replicating desk realizes."""
        from mcos_tpu.ops.rough import rbergomi_log_paths

        n = int(num_paths or self.num_paths)
        sheet = rbergomi_log_paths(
            self.params, T, self._chol(T), self._key(),
            num_paths=n, num_steps=self.num_steps,
            xi_t=self._xi_t(T))                          # (2, paths, n)
        dlog = jnp.diff(
            jnp.concatenate([jnp.zeros_like(sheet[..., :1]), sheet],
                            axis=-1), axis=-1)
        rv = jnp.sum(dlog * dlog, axis=-1) / T           # (2, paths)
        mean = float(jnp.mean(rv))
        se = float(jnp.std(jnp.mean(rv, axis=0))) / np.sqrt(n)
        return {
            "fair_variance": mean,
            "fair_vol_strike": float(np.sqrt(max(mean, 0.0))),
            "std_error_variance": se,
            "curve_strike": self.variance_swap_strike(T),
            "num_paths_used": n,
        }

    def corridor_variance_swap(self, spot: float, T: float,
                               lower: float = 0.0,
                               upper: float = float("inf"),
                               num_paths: Optional[int] = None
                               ) -> Dict[str, float]:
        """Corridor variance swap: realized variance accrues only on
        observations where the PREVIOUS fix lies inside [lower, upper]
        (the standard accrual convention). The full corridor reduces
        exactly to `variance_swap_mc` (test-pinned); tight down-corridors
        isolate the crash-variance the rough left tail carries."""
        from mcos_tpu.ops.rough import rbergomi_log_paths

        n = int(num_paths or self.num_paths)
        sheet = rbergomi_log_paths(
            self.params, T, self._chol(T), self._key(),
            num_paths=n, num_steps=self.num_steps,
            xi_t=self._xi_t(T))                          # (2, paths, m)
        log_with0 = jnp.concatenate(
            [jnp.zeros_like(sheet[..., :1]), sheet], axis=-1)
        dlog = jnp.diff(log_with0, axis=-1)
        s_prev = spot * jnp.exp(log_with0[..., :-1])     # previous fixes
        in_corr = (s_prev >= lower) & (s_prev <= upper)
        rv = jnp.sum(dlog * dlog * in_corr, axis=-1) / T
        mean = float(jnp.mean(rv))
        se = float(jnp.std(jnp.mean(rv, axis=0))) / np.sqrt(n)
        return {
            "fair_variance": mean,
            "fair_vol_strike": float(np.sqrt(max(mean, 0.0))),
            "std_error_variance": se,
            "accrual_fraction": float(jnp.mean(in_corr)),
            "corridor": [float(lower), float(min(upper, 1e308))],
            "num_paths_used": n,
        }

    def terminal_sample(self, spot: float, T: float,
                        num_paths: Optional[int] = None) -> np.ndarray:
        """Terminal spots from the plain estimator (for histograms/risk)."""
        n = int(num_paths or self.num_paths)
        s = rbergomi_terminal(self.params, spot, T, self._chol(T),
                              self._key(), num_paths=n,
                              num_steps=self.num_steps)
        return np.asarray(s).reshape(-1)


# ─────────────────────────────────────────────────────────────────────────────
# Calibration: fit (eta, rho, xi) per H over the Hurst grid
# ─────────────────────────────────────────────────────────────────────────────
def _rbergomi_cal_objective(x, data, *, hurst, num_paths, num_steps):
    """Weighted price-space SSE over the (maturity, strike) grid.

    One DE/Adam candidate: x = [eta, rho, xi]. The same draws (same key,
    same chols) price every candidate — CRN makes the objective a
    deterministic smooth function, so DE's ranking is noise-free and
    Adam's gradient is exact for the sampled measure. Maturities vmap
    over their own Cholesky factors; H is static per call (it shapes the
    host-built covariance, so the Hurst axis is an outer grid search).
    """
    params = RoughBergomiParams(xi=x[2], eta=x[0], rho=x[1],
                                r=data["r"], q=data["q"], hurst=hurst)

    def one_maturity(chol, T, strikes, key):
        pay = rbergomi_conditional_payoffs(
            params, data["spot"], strikes, T, chol, key,
            num_paths=num_paths, num_steps=num_steps, is_call=True)
        return jnp.exp(-data["r"] * T) * jnp.mean(pay, axis=(0, 1))

    model = jax.vmap(one_maturity)(data["chols"], data["Ts"],
                                   data["strikes"], data["keys"])
    return jnp.sum(data["weights"] * (model - data["market"]) ** 2)


def calibrate_rbergomi(spot, maturities, strikes, market_prices,
                       r: float = None, q: float = None,
                       weights=None,
                       hurst_grid=(0.05, 0.07, 0.10, 0.15, 0.25, 0.40),
                       num_paths: int = 16_384, num_steps: int = 48,
                       pop_size: int = 24, iters: int = 40,
                       polish_steps: int = 80, seed: int = 0
                       ) -> Dict[str, object]:
    """Fit rough Bergomi to a call-price surface.

    (eta, rho, xi) are fit by the repo's vmapped-DE + Adam stack per
    Hurst-grid point; H is selected by the best polished objective. Using
    SEVERAL maturities is what identifies H — the T^{H-1/2} skew
    term-structure separates (H, eta) where a single slice cannot.

    Args:
        maturities: (m,) years; strikes: (m, k); market_prices: (m, k)
        call prices; weights: optional (m, k) quote weights.
    """
    from mcos_tpu.config import DIVIDEND_YIELD, RISK_FREE_RATE
    r = RISK_FREE_RATE if r is None else float(r)
    q = DIVIDEND_YIELD if q is None else float(q)
    mats = np.asarray(maturities, np.float64)
    strikes = np.asarray(strikes, np.float64)
    market = np.asarray(market_prices, np.float64)
    if weights is None:
        weights = np.ones_like(market)
    weights = np.asarray(weights, np.float64) / np.sum(weights)

    base_keys = jax.random.split(jax.random.key(seed), len(mats))
    bounds = np.array([RBERGOMI_CAL_BOUNDS["eta"],
                       RBERGOMI_CAL_BOUNDS["rho"],
                       RBERGOMI_CAL_BOUNDS["xi"]], np.float32)
    best = None
    per_h = {}
    for h in hurst_grid:
        chols = np.stack([rbergomi_chol(float(h), float(t), num_steps)
                          for t in mats])
        data = {"spot": jnp.float32(spot),
                "Ts": jnp.asarray(mats, jnp.float32),
                "strikes": jnp.asarray(strikes, jnp.float32),
                "market": jnp.asarray(market, jnp.float32),
                "weights": jnp.asarray(weights, jnp.float32),
                "chols": jnp.asarray(chols),
                "keys": base_keys,
                "r": jnp.float32(r), "q": jnp.float32(q)}
        statics = (("hurst", float(h)), ("num_paths", num_paths),
                   ("num_steps", num_steps))
        res = differential_evolution(
            _rbergomi_cal_objective, bounds, jax.random.key(seed + 1),
            pop_size=pop_size, iters=iters, args=data,
            static_kwargs=statics)
        x, fun = adam_polish(_rbergomi_cal_objective, res.x, bounds,
                             steps=polish_steps, lr=0.02, args=data,
                             static_kwargs=statics)
        entry = {"hurst": float(h), "eta": float(x[0]), "rho": float(x[1]),
                 "xi": float(x[2]), "objective": float(fun)}
        per_h[f"{h:g}"] = entry
        if best is None or entry["objective"] < best["objective"]:
            best = entry
    params = RoughBergomiParams(xi=best["xi"], eta=best["eta"],
                                rho=best["rho"], r=r, q=q,
                                hurst=best["hurst"])
    return {
        "params": params,
        **best,
        "rmse_price": float(np.sqrt(best["objective"])),
        "hurst_grid": dict(sorted(per_h.items(),
                                  key=lambda kv: kv[1]["objective"])),
        "n_quotes": int(market.size),
    }
