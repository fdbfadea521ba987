"""Two-stage SVJ calibration engine.

Re-design of the reference's calibration stack
(reference: engine/calibration.py:29-271). Semantics preserved:

- Stage 1 fits the Heston core (κ, θ, ξ, ρ, v0) on 0.95-1.05 forward
  moneyness; Stage 2 fits jumps (λ, μ_J, σ_J) on 0.80-1.20 with the core
  frozen (calibration.py:184-231).
- Vega/spread weights w = Vega/BidAsk, normalized (calibration.py:29-50).
- Objective = weighted SSE of model-vs-market prices + Tikhonov on ξ/ρ/λ +
  soft Feller penalty 10·(ξ²−2κθ)² (calibration.py:53-135).
- Forward-space moneyness K/F (calibration.py:163-164); history log
  (calibration.py:244-251).

Architecture differences (the device-first part):

- The differential-evolution population is a *vmapped batch*: each generation
  prices population × strikes in one fused MC call on device, instead of the
  reference's Python loop (population × iterations × strikes × full engine
  re-build, explicitly `workers=1` at calibration.py:203,226 — its scaling
  wall, SURVEY.md §3.3).
- Strikes are a vectorized axis of one shared path set per objective
  evaluation (the reference regenerates Sobol + runs 2 kernel calls *per
  strike per member*).
- Stage 1 gets an optional gradient polish (Adam in a sigmoid box) using the
  pricer's pathwise differentiability. Stage 2 stays derivative-free: the
  jump-occurrence indicator 1{U < λdt} has zero pathwise derivative in λ
  (SURVEY.md §7 "hard parts"), so gradients would silently under-inform λ.
- `sharded_calibration_step` exposes one optimizer step over a 2-D
  ("batch" × "paths") device mesh — strikes data-parallel, paths sharded,
  psum-reduced loss — the framework's multi-chip training step.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from mcos_tpu.config import (
    CALIBRATION_CONFIG,
    PARAM_BOUNDS,
    REGULARIZATION,
)
from mcos_tpu.engine.pricer import mc_price_core
from mcos_tpu.models.params import SVJParams, forward_price
from mcos_tpu.ops import simulate
from mcos_tpu.ops.bs import bs_price, bs_vega
from mcos_tpu.utils.optim import adam_polish, differential_evolution

logger = logging.getLogger("mcos_tpu.calibration")

Array = jax.Array

HESTON_BOUNDS = np.array([
    PARAM_BOUNDS["kappa"], PARAM_BOUNDS["theta"], PARAM_BOUNDS["xi"],
    PARAM_BOUNDS["rho"], PARAM_BOUNDS["v0"],
], np.float32)
JUMP_BOUNDS = np.array([
    PARAM_BOUNDS["lambda_j"], PARAM_BOUNDS["mu_j"], PARAM_BOUNDS["sigma_j"],
], np.float32)


def compute_vega_weights(
    spot, strikes, T, r, q, atm_vol,
    bid_ask_spreads: Optional[Array] = None,
) -> Array:
    """w_i = Vega_i / BidAskSpread_i, normalized (calibration.py:29-50).

    Vectorized over strikes (the reference loops in Python).
    """
    strikes = jnp.asarray(strikes, jnp.float32)
    vegas = jnp.maximum(bs_vega(spot, strikes, T, r, q, atm_vol), 1e-10)
    if bid_ask_spreads is not None:
        weights = vegas / jnp.maximum(jnp.asarray(bid_ask_spreads), 1e-4)
    else:
        weights = vegas
    return weights / jnp.sum(weights)


def _feller_penalty(kappa, theta, xi):
    """Soft Feller penalty 10·(ξ² − 2κθ)² when violated (calibration.py:67-70)."""
    violation = xi * xi - 2.0 * kappa * theta
    return jnp.where(violation > 0, 10.0 * violation * violation, 0.0)


def _chain_prices(params: SVJParams, spot, strikes, T, key, *,
                  num_paths: int, num_steps: int, is_call: bool) -> Array:
    """Model prices for a strike chain off one shared path set (CRN by key)."""
    res = mc_price_core(
        params, spot, strikes, T, key,
        num_paths=num_paths, num_steps=num_steps, is_call=is_call,
        antithetic=True, control_variate=True, cv_mode="companion",
    )
    return res["price"]


def heston_objective(
    x: Array, data: Dict, *, num_paths: int, num_steps: int,
    is_call: bool = True,
) -> Array:
    """Stage-1 objective over [κ, θ, ξ, ρ, v0] (calibration.py:53-95).

    Jumps off (λ=0; σ_J=0.01 placeholder exactly as the reference uses).
    `data` is a traced pytree {spot, strikes, T, market_prices, weights, r,
    q, key} so repeated calibrations with the same shapes reuse the compiled
    optimizer loop (the statics ride `static_kwargs`). Differentiable in x;
    deterministic given data["key"] (CRN).
    """
    kappa, theta, xi, rho, v0 = x[0], x[1], x[2], x[3], x[4]
    params = SVJParams(kappa=kappa, theta=theta, xi=xi, rho=rho, v0=v0,
                       lambda_j=0.0, mu_j=0.0, sigma_j=0.01,
                       r=data["r"], q=data["q"])
    model = _chain_prices(params, data["spot"], data["strikes"], data["T"],
                          data["key"], num_paths=num_paths,
                          num_steps=num_steps, is_call=is_call)
    err = jnp.sum(data["weights"] * (model - data["market_prices"]) ** 2)
    reg = (REGULARIZATION["xi"] * xi**2 + REGULARIZATION["rho"] * rho**2)
    return err + reg + _feller_penalty(kappa, theta, xi)


def svj_objective(
    x_jump: Array, data: Dict, *, num_paths: int, num_steps: int,
    is_call: bool = True,
) -> Array:
    """Stage-2 objective over [λ, μ_J, σ_J] with the core frozen
    (calibration.py:98-135). `data` additionally carries `heston_x`."""
    hx = data["heston_x"]
    params = SVJParams(
        kappa=hx[0], theta=hx[1], xi=hx[2], rho=hx[3], v0=hx[4],
        lambda_j=x_jump[0], mu_j=x_jump[1], sigma_j=x_jump[2],
        r=data["r"], q=data["q"])
    model = _chain_prices(params, data["spot"], data["strikes"], data["T"],
                          data["key"], num_paths=num_paths,
                          num_steps=num_steps, is_call=is_call)
    err = jnp.sum(data["weights"] * (model - data["market_prices"]) ** 2)
    return err + REGULARIZATION["lambda_j"] * x_jump[0] ** 2


class CalibrationEngine:
    """Two-stage SVJ calibration (reference engine/calibration.py:138-271 API).

    Result dict keys mirror the reference so downstream consumers translate
    1:1 (`params`, `stage1_result`, `stage2_result`, `warnings`,
    `feller_satisfied`).
    """

    def __init__(self, config=None):
        self.config = config or CALIBRATION_CONFIG
        self.history: List[Dict] = []

    def calibrate(
        self,
        spot: float,
        strikes,
        T: float,
        market_prices,
        is_call: bool = True,
        r: float = 0.065,
        q: float = 0.012,
        bid_ask_spreads=None,
        atm_vol: float = 0.15,
        num_paths: int = 100_000,
        num_steps: int = 50,
        seed: int = 42,
        pop_size: int = 24,
        polish: bool = True,
        mesh: Optional[Mesh] = None,
        pop_axis: str = "paths",
    ) -> Dict:
        """Two-stage fit (see class docstring). `mesh` shards the DE
        POPULATION axis across devices (utils/optim.py) — each device
        evaluates pop/n_dev full 100k-path objectives per generation, so a
        whole-chain calibration scales past one chip (the reference's
        scaling wall: population × iters × strikes × full MC at workers=1,
        SURVEY.md §3.3). The Adam polish stays single-device (one
        candidate). Same seed ⇒ same optimum up to f32 reduction order.
        """
        strikes = np.asarray(strikes, np.float32)
        market_prices = np.asarray(market_prices, np.float32)
        cfg = self.config

        # Forward-space moneyness and stage masks (calibration.py:163-176).
        F = float(forward_price(spot, r, q, T))
        moneyness = strikes / F
        m1 = ((moneyness >= cfg.stage1_moneyness_range[0])
              & (moneyness <= cfg.stage1_moneyness_range[1]))
        m2 = ((moneyness >= cfg.stage2_moneyness_range[0])
              & (moneyness <= cfg.stage2_moneyness_range[1]))
        if not m1.any():
            m1 = np.ones_like(m1)  # degenerate chain: use everything
        if not m2.any():
            m2 = np.ones_like(m2)

        bas = np.asarray(bid_ask_spreads) if bid_ask_spreads is not None else None
        w1 = compute_vega_weights(spot, strikes[m1], T, r, q, atm_vol,
                                  bas[m1] if bas is not None else None)
        w2 = compute_vega_weights(spot, strikes[m2], T, r, q, atm_vol,
                                  bas[m2] if bas is not None else None)

        key = jax.random.key(seed)
        k_price, k_de1, k_de2 = jax.random.split(key, 3)

        # ── Stage 1: Heston core ────────────────────────────────────────────
        logger.info("Stage 1: Heston core on %d strikes", int(m1.sum()))
        statics = (("num_paths", num_paths), ("num_steps", num_steps),
                   ("is_call", is_call))
        data1 = {
            "spot": jnp.float32(spot), "strikes": jnp.asarray(strikes[m1]),
            "T": jnp.float32(T),
            "market_prices": jnp.asarray(market_prices[m1]), "weights": w1,
            "r": jnp.float32(r), "q": jnp.float32(q), "key": k_price,
        }
        # Warm-start member: reference defaults with the surface-consistent
        # v0 = θ = ATM_IV² initialization (models.py:152-158 heuristic).
        x0_heston = jnp.asarray(
            [3.0, atm_vol**2, 0.5, -0.7, atm_vol**2], jnp.float32)
        iters1 = max(cfg.stage1_max_iter // 4, 25)  # vmapped DE converges in
        res1 = differential_evolution(heston_objective, HESTON_BOUNDS, k_de1,  # fewer, bigger steps
                                      pop_size=pop_size, iters=iters1,
                                      x0=x0_heston, args=data1,
                                      static_kwargs=statics,
                                      mesh=mesh, pop_axis=pop_axis)
        x1, f1 = res1.x, res1.fun
        if polish:
            x1p, f1p = adam_polish(heston_objective, x1, HESTON_BOUNDS,
                                   steps=40, lr=self.config.learning_rate,
                                   args=data1, static_kwargs=statics)
            better = float(f1p) < float(f1)
            x1 = x1p if better else x1
            f1 = f1p if better else f1
        logger.info("Stage 1 done: κ=%.3f θ=%.4f ξ=%.3f ρ=%.3f v0=%.4f err=%.6g",
                    *[float(v) for v in x1], float(f1))

        # ── Stage 2: jumps, core frozen ─────────────────────────────────────
        logger.info("Stage 2: jump params on %d strikes", int(m2.sum()))
        data2 = {
            "spot": jnp.float32(spot), "strikes": jnp.asarray(strikes[m2]),
            "T": jnp.float32(T),
            "market_prices": jnp.asarray(market_prices[m2]), "weights": w2,
            "r": jnp.float32(r), "q": jnp.float32(q), "key": k_price,
            "heston_x": x1,
        }
        iters2 = max(cfg.stage2_max_iter // 4, 25)
        res2 = differential_evolution(svj_objective, JUMP_BOUNDS, k_de2,
                                      pop_size=pop_size, iters=iters2,
                                      x0=jnp.asarray([1.0, -0.05, 0.10],
                                                     jnp.float32),
                                      args=data2, static_kwargs=statics,
                                      mesh=mesh, pop_axis=pop_axis)
        x2, f2 = res2.x, res2.fun
        logger.info("Stage 2 done: λ=%.3f μ_J=%.4f σ_J=%.4f err=%.6g",
                    *[float(v) for v in x2], float(f2))

        final = SVJParams(
            kappa=float(x1[0]), theta=float(x1[1]), xi=float(x1[2]),
            rho=float(x1[3]), v0=float(x1[4]),
            lambda_j=float(x2[0]), mu_j=float(x2[1]), sigma_j=float(x2[2]),
            r=r, q=q)
        warnings = final.validate()

        entry = {
            "params": [float(v) for v in final.to_array()],
            "stage1_error": float(f1),
            "stage2_error": float(f2),
            "warnings": warnings,
        }
        self.history.append(entry)

        try:
            # Error bars off the exact COS oracle at the MC-fitted optimum
            # (the Jacobian is model-structure information — MC noise in
            # the point estimate does not belong in it).
            uncertainty = self.parameter_uncertainty(
                final, spot, strikes, T, market_prices, is_call,
                bid_ask_spreads=bid_ask_spreads, atm_vol=atm_vol)
        except (np.linalg.LinAlgError, ValueError, FloatingPointError):
            uncertainty = None
        return {
            "params": final,
            "stage1_result": {"error": float(f1), "nit": int(res1.nit),
                              "success": bool(np.isfinite(float(f1)))},
            "stage2_result": {"error": float(f2), "nit": int(res2.nit),
                              "success": bool(np.isfinite(float(f2)))},
            "warnings": warnings,
            "feller_satisfied": final.feller_satisfied,
            "uncertainty": uncertainty,
        }

    def calibrate_fast(
        self,
        spot: float,
        strikes,
        T: float,
        market_prices,
        is_call: bool = True,
        r: float = 0.065,
        q: float = 0.012,
        bid_ask_spreads=None,
        atm_vol: float = 0.15,
        seed: int = 42,
        regime_adjustments: Optional[Dict] = None,
    ) -> Dict:
        """Two-stage calibration against the semi-analytic COS/Bates pricer.

        The SVJ model is Bates(1996) — it has a closed-form characteristic
        function, so the calibration objective needs no Monte Carlo at all:
        one chain evaluation is a (strikes × N) cosine expansion, ~10⁶×
        cheaper than the reference's 100k-path MC per strike per member
        (calibration.py:53-135, its scaling wall). Same two-stage masks,
        weights, Tikhonov and Feller penalties; scipy differential evolution
        on the host (the objective is host numpy by design). The MC engine
        is reserved for what actually needs it (exotics, risk, Greeks).

        `regime_adjustments`: the dict emitted by
        `RegimeDetector.classify()["calibration_adjustments"]` — tightens or
        widens the ξ/λ/ρ search bounds and scales the Tikhonov weights per
        regime. The reference *promises* this wiring ("Switches calibration
        constraints per regime", regime.py:9) but never connects detector to
        calibrator; this closes the loop.
        """
        from scipy.optimize import differential_evolution as scipy_de

        from mcos_tpu.ops.cos_pricer import cos_price

        strikes = np.asarray(strikes, np.float64)
        market_prices = np.asarray(market_prices, np.float64)
        cfg = self.config

        F = float(forward_price(spot, r, q, T))
        moneyness = strikes / F
        m1 = ((moneyness >= cfg.stage1_moneyness_range[0])
              & (moneyness <= cfg.stage1_moneyness_range[1]))
        m2 = ((moneyness >= cfg.stage2_moneyness_range[0])
              & (moneyness <= cfg.stage2_moneyness_range[1]))
        if not m1.any():
            m1 = np.ones_like(m1)
        if not m2.any():
            m2 = np.ones_like(m2)
        bas = np.asarray(bid_ask_spreads) if bid_ask_spreads is not None else None
        w1 = np.asarray(compute_vega_weights(
            spot, strikes[m1], T, r, q, atm_vol,
            bas[m1] if bas is not None else None))
        w2 = np.asarray(compute_vega_weights(
            spot, strikes[m2], T, r, q, atm_vol,
            bas[m2] if bas is not None else None))

        # Regime-conditioned search space and regularization strength.
        heston_bounds = HESTON_BOUNDS.tolist()
        jump_bounds = JUMP_BOUNDS.tolist()
        reg_scale = 1.0
        if regime_adjustments:
            adj = regime_adjustments
            if "xi_bounds" in adj:
                heston_bounds[2] = list(adj["xi_bounds"])
            if "rho_bounds" in adj:
                heston_bounds[3] = list(adj["rho_bounds"])
            if "lambda_bounds" in adj:
                jump_bounds[0] = list(adj["lambda_bounds"])
            reg_scale = float(adj.get("regularization_scale", 1.0))

        def obj1(x):
            kappa, theta, xi, rho, v0 = x
            params = SVJParams(kappa=kappa, theta=theta, xi=xi, rho=rho,
                               v0=v0, lambda_j=0.0, mu_j=0.0, sigma_j=0.01,
                               r=r, q=q)
            model = cos_price(params, spot, strikes[m1], T, is_call)
            err = float(np.sum(w1 * (model - market_prices[m1]) ** 2))
            reg = reg_scale * (REGULARIZATION["xi"] * xi**2
                               + REGULARIZATION["rho"] * rho**2)
            viol = xi * xi - 2.0 * kappa * theta
            return err + reg + (10.0 * viol * viol if viol > 0 else 0.0)

        res1 = scipy_de(obj1, heston_bounds,
                        maxiter=cfg.stage1_max_iter, tol=cfg.ftol, seed=seed,
                        polish=True)
        hx = res1.x
        logger.info("fast stage 1: κ=%.3f θ=%.4f ξ=%.3f ρ=%.3f v0=%.4f "
                    "err=%.6g", *hx, res1.fun)

        def obj2(xj):
            lam, mu_j, sig_j = xj
            params = SVJParams(kappa=hx[0], theta=hx[1], xi=hx[2], rho=hx[3],
                               v0=hx[4], lambda_j=lam, mu_j=mu_j,
                               sigma_j=sig_j, r=r, q=q)
            model = cos_price(params, spot, strikes[m2], T, is_call)
            err = float(np.sum(w2 * (model - market_prices[m2]) ** 2))
            return err + reg_scale * REGULARIZATION["lambda_j"] * lam**2

        res2 = scipy_de(obj2, jump_bounds,
                        maxiter=cfg.stage2_max_iter, tol=cfg.ftol, seed=seed,
                        polish=True)
        jx = res2.x
        logger.info("fast stage 2: λ=%.3f μ_J=%.4f σ_J=%.4f err=%.6g",
                    *jx, res2.fun)

        final = SVJParams(kappa=float(hx[0]), theta=float(hx[1]),
                          xi=float(hx[2]), rho=float(hx[3]), v0=float(hx[4]),
                          lambda_j=float(jx[0]), mu_j=float(jx[1]),
                          sigma_j=float(jx[2]), r=r, q=q)
        warnings = final.validate()
        self.history.append({
            "params": [float(v) for v in final.to_array()],
            "stage1_error": float(res1.fun),
            "stage2_error": float(res2.fun),
            "warnings": warnings,
        })
        try:
            uncertainty = self.parameter_uncertainty(
                final, spot, strikes, T, market_prices, is_call,
                bid_ask_spreads=bid_ask_spreads, atm_vol=atm_vol)
        except (np.linalg.LinAlgError, ValueError, FloatingPointError):
            uncertainty = None  # error bars are a diagnostic, never fatal
        return {
            "params": final,
            "stage1_result": {"error": float(res1.fun), "nit": int(res1.nit),
                              "success": bool(res1.success)},
            "stage2_result": {"error": float(res2.fun), "nit": int(res2.nit),
                              "success": bool(res2.success)},
            "warnings": warnings,
            "feller_satisfied": final.feller_satisfied,
            "uncertainty": uncertainty,
        }

    def calibrate_from_chain(
        self,
        chain,
        spot: float,
        T: float,
        is_call: bool = True,
        exercise: str = "european",
        r: float = 0.065,
        q: float = 0.012,
        seed: int = 42,
        regime_adjustments: Optional[Dict] = None,
        min_strikes: int = 4,
    ) -> Dict:
        """One-call desk workflow: option-chain quotes → SVJ parameters.

        `chain` is a CSV path or the dict from
        `utils.chain_loader.load_chain` (native parser when built). Takes
        the liquid slice at expiry `T` on one side, then:

        - exercise="american" (NSE single-stock chains are
          American-exercise): de-Americanize every quote through the CRR
          tree (`engine.surface.deamericanize_quotes`) and calibrate the
          European-equivalent BS prices. Feeding raw American mids to a
          European characteristic-function model books the early-exercise
          premium as spurious variance (test-pinned: the naive path
          overstates v0).
        - exercise="european" (index options): calibrate the mids directly.

        The ATM implied vol (de-Americanized when applicable) seeds the
        vega weights instead of a fixed 15%. The fit itself is the exact
        two-stage COS calibration (`calibrate_fast`).
        """
        from mcos_tpu.engine.surface import deamericanize_quotes, implied_vol
        from mcos_tpu.utils.chain_loader import (
            chain_to_calibration_inputs,
            load_chain,
        )

        if exercise not in ("european", "american"):
            raise ValueError(f"exercise must be 'european' or 'american', "
                             f"got {exercise!r}")
        if isinstance(chain, str):
            chain = load_chain(chain)
        inputs = chain_to_calibration_inputs(
            chain, T, side="call" if is_call else "put")
        strikes = np.asarray(inputs["strikes"], np.float64)
        market = np.asarray(inputs["market_prices"], np.float64)
        spreads = np.asarray(inputs["bid_ask_spreads"], np.float64)
        if strikes.size < min_strikes:
            raise ValueError(f"only {strikes.size} liquid quotes at T={T} "
                             f"(need >= {min_strikes})")

        dropped = 0
        ivs = None
        if exercise == "american":
            ivs, market, keep = deamericanize_quotes(
                spot, strikes, T, market, r, q, is_call)
            dropped = int(strikes.size - keep.sum())
            strikes, spreads = strikes[keep], spreads[keep]
            if strikes.size < min_strikes:
                raise ValueError(
                    f"only {strikes.size} de-Americanizable quotes at T={T} "
                    f"({dropped} dropped; need >= {min_strikes})")

        atm_idx = int(np.argmin(np.abs(
            strikes - spot * np.exp((r - q) * T))))
        if ivs is not None:
            atm_vol = float(ivs[atm_idx])
        else:
            iv0 = implied_vol(float(market[atm_idx]), spot,
                              float(strikes[atm_idx]), T, r, q, is_call)
            atm_vol = float(iv0) if iv0 else 0.15

        result = self.calibrate_fast(
            spot, strikes, T, market, is_call=is_call, r=r, q=q,
            bid_ask_spreads=spreads, atm_vol=atm_vol, seed=seed,
            regime_adjustments=regime_adjustments)
        result["exercise"] = exercise
        result["n_quotes"] = int(strikes.size)
        result["n_dropped"] = dropped
        result["atm_vol_estimate"] = atm_vol
        if ivs is not None:
            result["deamericanized_ivs"] = [float(x) for x in ivs]
        return result

    _UNC_PARAM_NAMES = ("kappa", "theta", "xi", "rho", "v0",
                        "lambda_j", "mu_j", "sigma_j")

    def parameter_uncertainty(
        self,
        params: SVJParams,
        spot: float,
        strikes,
        T: float,
        market_prices,
        is_call: bool = True,
        bid_ask_spreads=None,
        atm_vol: float = 0.15,
    ) -> Dict:
        """Gauss-Newton parameter covariance at a calibrated optimum.

        Weighted-least-squares asymptotics: with objective
        Σᵢ wᵢ (modelᵢ(θ) − marketᵢ)² the estimator covariance is
            cov(θ̂) = s² (Jᵀ W J)⁻¹,   s² = RSS_w / max(n − p, 1),
        with J the model-price Jacobian ∂modelᵢ/∂θⱼ. J comes from central
        f64 finite differences of the exact COS/Bates oracle
        (ops/cos_pricer.py) — 16 chain evaluations, no MC noise in the
        Jacobian. Returns per-parameter standard errors, the correlation
        matrix, and identifiability diagnostics (condition number of JᵀWJ;
        near-unit |correlation| rows mean the chain cannot separate those
        parameters — the classic ξ/ρ/λ confounding on a single expiry).

        Capability absent from the reference (point estimates only,
        calibration.py:234-267): a desk cannot risk-manage a fit it has no
        error bars on.
        """
        from mcos_tpu.ops.cos_pricer import cos_price

        strikes = np.asarray(strikes, np.float64)
        market = np.asarray(market_prices, np.float64)
        r, q = float(params.r), float(params.q)
        bas = (np.asarray(bid_ask_spreads)
               if bid_ask_spreads is not None else None)
        w = np.asarray(compute_vega_weights(spot, strikes, T, r, q,
                                            atm_vol, bas), np.float64)

        names = self._UNC_PARAM_NAMES
        x0 = np.array([float(getattr(params, n)) for n in names], np.float64)
        # Lower bumping floors where the CF parameterization degenerates
        # (ξ→0 divides by ξ²; variance levels must stay positive).
        lo = {"theta": 1e-6, "xi": 1e-3, "v0": 1e-6, "lambda_j": 0.0,
              "sigma_j": 1e-4, "kappa": 1e-4}
        hi = {"rho": 0.999}

        def model(x: np.ndarray) -> np.ndarray:
            p = SVJParams(**dict(zip(names, x)), r=r, q=q)
            return np.asarray(cos_price(p, spot, strikes, T, is_call),
                              np.float64)

        resid = model(x0) - market
        J = np.zeros((strikes.size, x0.size))
        for j, name in enumerate(names):
            h = max(1e-4, 1e-3 * abs(x0[j]))
            up = min(x0[j] + h, hi.get(name, np.inf))
            dn = max(x0[j] - h, lo.get(name, -np.inf))
            if up - dn < 1e-12:  # pinned at a degenerate point
                continue
            xu, xd = x0.copy(), x0.copy()
            xu[j], xd[j] = up, dn
            J[:, j] = (model(xu) - model(xd)) / (up - dn)

        n, p_dim = strikes.size, x0.size
        dof = max(n - p_dim, 1)
        s2 = float(np.sum(w * resid**2) / dof)
        A = J.T @ (w[:, None] * J)
        cov = s2 * np.linalg.pinv(A, rcond=1e-12)
        se = np.sqrt(np.maximum(np.diag(cov), 0.0))
        denom = np.outer(se, se)
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = np.where(denom > 0, cov / np.where(denom > 0, denom, 1.0),
                            0.0)
        np.fill_diagonal(corr, 1.0)
        return {
            "param_names": list(names),
            "estimates": x0.tolist(),
            "std_errors": se.tolist(),
            "rel_errors_pct": [
                float(abs(s / v) * 100) if abs(v) > 1e-12 else None
                for s, v in zip(se, x0)],
            "correlation": [[float(c) for c in row] for row in corr],
            "residual_rms": float(np.sqrt(np.mean(resid**2))),
            "s2": s2,
            "dof": int(n - p_dim),
            "condition_number": float(np.linalg.cond(A)),
            "identifiable": bool(np.linalg.cond(A) < 1e12),
        }

    def calibrate_term_structure(
        self,
        spot: float,
        strikes,
        maturities,
        market_prices,
        is_call: bool = True,
        r: float = 0.065,
        q: float = 0.012,
        atm_vols=None,
        seed: int = 42,
    ) -> Dict:
        """Fit a full `TermStructureSVJ` across maturities.

        The reference *models* maturity-dependent θ(T)/ξ(T)/λ(T)
        (models.py:88-144) and bootstraps curves from heuristics
        (models.py:161-194), but ships no term-structure *calibrator*. Here:

        Stage A: `calibrate_fast` on the longest maturity pins the shared
        parameters (κ, ρ, μ_J, σ_J, v0) — the reference's own
        fixed-across-maturities set (models.py:98).
        Stage B: per maturity, fit (θ_T, ξ_T, λ_T) within
        TERM_STRUCTURE_BOUNDS against that expiry's chain (COS objective,
        no MC). Returns the TermStructureSVJ plus per-maturity errors.

        Args:
            market_prices: shape (num_maturities, num_strikes).
            atm_vols: per-maturity ATM vols for vega weights (default 0.15).
        """
        from scipy.optimize import differential_evolution as scipy_de

        from mcos_tpu.config import TERM_STRUCTURE_BOUNDS
        from mcos_tpu.models.params import TermStructureSVJ
        from mcos_tpu.ops.cos_pricer import cos_price

        strikes = np.asarray(strikes, np.float64)
        maturities = np.asarray(maturities, np.float64)
        market_prices = np.asarray(market_prices, np.float64)
        if atm_vols is None:
            atm_vols = np.full(maturities.shape, 0.15)
        atm_vols = np.asarray(atm_vols, np.float64)

        # ── Stage A: shared params from the longest maturity ───────────────
        i_ref = int(np.argmax(maturities))
        base = self.calibrate_fast(
            spot, strikes, float(maturities[i_ref]),
            market_prices[i_ref], is_call=is_call, r=r, q=q,
            atm_vol=float(atm_vols[i_ref]), seed=seed)
        shared = base["params"]
        logger.info("term-structure stage A (T=%.3f): κ=%.3f ρ=%.3f "
                    "μ_J=%.4f σ_J=%.4f v0=%.4f", maturities[i_ref],
                    float(shared.kappa), float(shared.rho),
                    float(shared.mu_j), float(shared.sigma_j),
                    float(shared.v0))

        ts = TermStructureSVJ(
            kappa=float(shared.kappa), rho=float(shared.rho),
            mu_j=float(shared.mu_j), sigma_j=float(shared.sigma_j),
            v0=float(shared.v0), r=r, q=q)

        bounds = [list(TERM_STRUCTURE_BOUNDS["theta_T"]),
                  list(TERM_STRUCTURE_BOUNDS["xi_T"]),
                  list(TERM_STRUCTURE_BOUNDS["lambda_T"])]
        slice_errors = {}

        # ── Stage B: per-maturity (θ, ξ, λ) slices ─────────────────────────
        for i, T_i in enumerate(maturities):
            w = np.asarray(compute_vega_weights(
                spot, strikes, float(T_i), r, q, float(atm_vols[i])))
            market_i = market_prices[i]

            def obj(x, T_i=T_i, w=w, market_i=market_i):
                theta_t, xi_t, lam_t = x
                params = SVJParams(
                    kappa=float(shared.kappa), theta=theta_t, xi=xi_t,
                    rho=float(shared.rho), v0=float(shared.v0),
                    lambda_j=lam_t, mu_j=float(shared.mu_j),
                    sigma_j=float(shared.sigma_j), r=r, q=q)
                model = cos_price(params, spot, strikes, float(T_i), is_call)
                return float(np.sum(w * (model - market_i) ** 2))

            res = scipy_de(obj, bounds, maxiter=150, tol=1e-10,
                           seed=seed + i, polish=True)
            theta_t, xi_t, lam_t = res.x
            ts.theta_curve[float(T_i)] = float(theta_t)
            ts.xi_curve[float(T_i)] = float(xi_t)
            ts.lambda_curve[float(T_i)] = float(lam_t)
            slice_errors[float(T_i)] = float(res.fun)
            logger.info("term-structure slice T=%.3f: θ=%.4f ξ=%.3f λ=%.3f "
                        "err=%.6g", T_i, theta_t, xi_t, lam_t, res.fun)

        return {
            "term_structure": ts,
            "shared_params": shared,
            "slice_errors": slice_errors,
            "stage_a_result": base,
        }

    def get_history(self) -> List[Dict]:
        """Parameter-evolution log (calibration.py:269-271)."""
        return self.history


# ─────────────────────────────────────────────────────────────────────────────
# Mesh-sharded training step (multi-chip calibration)
# ─────────────────────────────────────────────────────────────────────────────
def make_sharded_calibration_step(
    mesh: Mesh,
    *,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    lr: float = 0.05,
    r: float = None,
    q: float = None,
    batch_axis: str = "batch",
    path_axis: str = "paths",
):
    """Build one jitted optimizer step of Heston calibration over a 2-D mesh.

    Sharding: strikes are data-parallel over `batch_axis`; each strike shard
    prices its chain with MC paths sharded over `path_axis` and psum-reduced.
    The weighted-SSE loss is psum-reduced over both axes; `jax.grad` flows
    through the shard_map (pathwise derivatives through the simulator), and an
    Adam update advances the sigmoid-box parameters — the framework's
    "training step" (flagship multi-chip program).

    Returns (step_fn, init_fn):
        init_fn(x0) -> (u, opt_state)
        step_fn(u, opt_state, batch) -> (u, opt_state, loss)
        where batch = (spot, strikes, T, market_prices, weights, key) and
        strikes/market_prices/weights are sharded over `batch_axis`.
    """
    import optax

    from mcos_tpu.utils.optim import from_box, to_box

    opt = optax.adam(lr)
    n_path_dev = mesh.shape[path_axis]
    paths_per_device = -(-num_paths // n_path_dev)
    bounds = jnp.asarray(HESTON_BOUNDS)
    # Discounting must follow the market data's curve, not the model default:
    # fitting with the wrong r biases every parameter (advisor finding r1).
    rate_kwargs = {}
    if r is not None:
        rate_kwargs["r"] = float(r)
    if q is not None:
        rate_kwargs["q"] = float(q)

    def local_loss(u, spot, strikes, T, market, weights, key):
        x = to_box(u, bounds)
        kappa, theta, xi, rho, v0 = x[0], x[1], x[2], x[3], x[4]
        params = SVJParams(kappa=kappa, theta=theta, xi=xi, rho=rho, v0=v0,
                           lambda_j=0.0, mu_j=0.0, sigma_j=0.01,
                           **rate_kwargs)
        # Per-device paths: fold in the path-shard index (CRN across steps).
        pidx = jax.lax.axis_index(path_axis)
        dev_key = jax.random.fold_in(key, pidx)
        s_final, _, g_final = simulate.simulate_terminal(
            params, spot, T, dev_key,
            num_paths=paths_per_device, num_steps=num_steps,
            antithetic=True, companion=True,
        )
        discount = jnp.exp(-params.r * T)
        pay = simulate.combine_antithetic(
            simulate.vanilla_payoff(
                s_final[None], strikes[:, None, None], is_call).swapaxes(0, 1))
        ctrl = simulate.combine_antithetic(
            simulate.vanilla_payoff(
                g_final[None], strikes[:, None, None], is_call).swapaxes(0, 1))
        bs_ref = bs_price(spot, strikes, T, params.r, params.q,
                          jnp.sqrt(params.v0), is_call)
        eff = pay - (ctrl - bs_ref[:, None] / discount)
        # Global per-strike mean over the path axis.
        pay_sum = jax.lax.psum(jnp.sum(eff, axis=-1), path_axis)
        n_glob = jnp.float32(eff.shape[-1]) * n_path_dev
        model = discount * pay_sum / n_glob
        # Local strike-shard SSE, reduced over the batch axis.
        sse = jnp.sum(weights * (model - market) ** 2)
        sse = jax.lax.psum(sse, batch_axis)
        reg = (REGULARIZATION["xi"] * xi**2 + REGULARIZATION["rho"] * rho**2)
        return sse + reg + _feller_penalty(kappa, theta, xi)

    sharded_loss = jax.shard_map(
        local_loss, mesh=mesh,
        in_specs=(P(), P(), P(batch_axis), P(), P(batch_axis), P(batch_axis),
                  P()),
        out_specs=P(),
        check_vma=False,
    )

    @jax.jit
    def step_fn(u, opt_state, spot, strikes, T, market, weights, key):
        loss, grad = jax.value_and_grad(
            lambda u_: sharded_loss(u_, spot, strikes, T, market, weights,
                                    key))(u)
        updates, opt_state = opt.update(grad, opt_state)
        u = optax.apply_updates(u, updates)
        return u, opt_state, loss

    def init_fn(x0):
        u0 = from_box(jnp.asarray(x0, jnp.float32), bounds)
        return u0, opt.init(u0)

    return step_fn, init_fn
