"""Calibration engine: vega weights, objectives, DE recovery, two-stage flow.

Full market-quality calibration runs are accelerator-scale work; these tests shrink
paths/iterations and check (a) machinery correctness and (b) that the fit
actually reduces the pricing error on a synthetic chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcos_tpu.engine import calibration as cal
from mcos_tpu.engine.pricer import MonteCarloEngine
from mcos_tpu.models.params import SVJParams, gbm_params
from mcos_tpu.ops.bs import bs_price
from mcos_tpu.utils.optim import differential_evolution, to_box, from_box

SPOT, T = 22500.0, 0.25
R, Q = 0.065, 0.012


def test_vega_weights_normalized_and_atm_peaked():
    strikes = np.linspace(0.85, 1.15, 7) * SPOT
    w = np.asarray(cal.compute_vega_weights(SPOT, strikes, T, R, Q, 0.2))
    assert w.sum() == pytest.approx(1.0, abs=1e-5)
    assert w.argmax() in (3, 4)  # ATM-ish strike dominates
    spreads = np.ones(7)
    spreads[0] = 100.0  # wide quote → crushed weight
    w2 = np.asarray(cal.compute_vega_weights(SPOT, strikes, T, R, Q, 0.2,
                                             bid_ask_spreads=spreads))
    assert w2[0] < w[0] * 0.1


def test_de_minimizes_quadratic():
    bounds = np.array([[-5, 5], [-5, 5], [-5, 5]], np.float32)
    target = jnp.asarray([1.0, -2.0, 3.0])
    res = differential_evolution(
        lambda x: jnp.sum((x - target) ** 2), bounds, jax.random.key(0),
        pop_size=24, iters=120)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(target),
                               atol=0.02)
    assert float(res.fun) < 1e-3
    # history is monotone non-increasing
    h = np.asarray(res.history)
    assert np.all(np.diff(h) <= 1e-9)


def test_box_reparam_roundtrip():
    bounds = np.array([[0.1, 15.0], [0.005, 1.5]], np.float32)
    x = jnp.asarray([3.0, 0.04])
    u = from_box(x, bounds)
    np.testing.assert_allclose(np.asarray(to_box(u, bounds)), np.asarray(x),
                               rtol=1e-5)


def test_heston_objective_prefers_truth():
    """Objective evaluated at the generating parameters beats wrong ones."""
    true = gbm_params(0.2, r=R, q=Q)  # σ=0.2 ⇒ v0=θ=0.04
    strikes = np.linspace(0.95, 1.05, 5) * SPOT
    market = np.array([float(bs_price(SPOT, k, T, R, Q, 0.2, True))
                       for k in strikes], np.float32)
    w = cal.compute_vega_weights(SPOT, strikes, T, R, Q, 0.2)
    data = dict(spot=jnp.float32(SPOT), strikes=jnp.asarray(strikes),
                T=jnp.float32(T), market_prices=jnp.asarray(market),
                weights=w, r=jnp.float32(R), q=jnp.float32(Q),
                key=jax.random.key(0))
    kw = dict(num_paths=20_000, num_steps=32)
    # x = [kappa, theta, xi, rho, v0]
    f_true = float(cal.heston_objective(
        jnp.asarray([1.0, 0.04, 0.05, -0.1, 0.04]), data, **kw))
    f_wrong = float(cal.heston_objective(
        jnp.asarray([1.0, 0.09, 0.05, -0.1, 0.09]), data, **kw))
    assert f_true < f_wrong


def test_two_stage_calibration_recovers_vol_level():
    """End-to-end two-stage fit on a synthetic BS chain: the calibrated v0
    must land near the generating σ² and the final chain error must be small
    relative to the option premia."""
    sigma_true = 0.18
    strikes = np.linspace(0.90, 1.10, 9) * SPOT
    market = np.array([float(bs_price(SPOT, k, T, R, Q, sigma_true, True))
                       for k in strikes], np.float32)

    eng = cal.CalibrationEngine()
    result = eng.calibrate(
        SPOT, strikes, T, market, r=R, q=Q, atm_vol=sigma_true,
        num_paths=16_384, num_steps=32, pop_size=12, polish=True, seed=0)

    p = result["params"]
    assert isinstance(p, SVJParams)
    # Single-maturity chains only identify the *integrated* variance
    # v̄ = θ + (v0−θ)(1−e^{−κT})/(κT): (κ, θ, v0) individually are degenerate
    # (true of the reference's calibration too). Assert the identifiable
    # quantity.
    kappa, theta, v0 = float(p.kappa), float(p.theta), float(p.v0)
    decay = (1.0 - np.exp(-kappa * T)) / (kappa * T)
    v_bar = theta + (v0 - theta) * decay
    assert v_bar == pytest.approx(sigma_true**2, abs=0.006)

    # Refit quality: model chain within 1% of spot-scale ATM premium.
    model = MonteCarloEngine(p, num_paths=50_000, num_steps=128,
                             use_sobol=False, seed=9).price_batch(
        SPOT, strikes, T)
    errs = [abs(m["price"] - mk) for m, mk in zip(model, market)]
    atm_premium = market[4]
    assert max(errs) < 0.05 * atm_premium

    assert len(eng.get_history()) == 1
    assert "stage1_result" in result and "stage2_result" in result


def test_calibrate_fast_recovers_svj_params():
    """COS-objective calibration on a synthetic Bates chain: exact pricer in
    the loop means the true parameters are recoverable to high fidelity."""
    from mcos_tpu.ops.cos_pricer import cos_price
    import time

    true = SVJParams(kappa=3.0, theta=0.05, xi=0.5, rho=-0.6, v0=0.0324,
                     lambda_j=1.5, mu_j=-0.07, sigma_j=0.12, r=R, q=Q)
    strikes = np.linspace(0.85, 1.15, 13) * SPOT
    market = cos_price(true, SPOT, strikes, T, True)

    eng = cal.CalibrationEngine()
    t0 = time.time()
    result = eng.calibrate_fast(SPOT, strikes, T, market, r=R, q=Q,
                                atm_vol=0.18, seed=1)
    elapsed = time.time() - t0
    p = result["params"]
    refit = cos_price(p, SPOT, strikes, T, True)
    atm = market[6]
    # Two-stage fits cap out around ~1% on jumpy chains: stage 1 forces the
    # Heston core to absorb jump effects near the money, then freezes it
    # (the reference has the same structural limit, calibration.py:184-231).
    assert np.max(np.abs(refit - market)) < 0.015 * atm
    # (κ, θ, v0) individually — and even the diffusive integrated variance —
    # are not identified on a single jumpy maturity: the frozen Heston core
    # absorbs part of the jump variance. Refit quality above is the
    # meaningful criterion; sanity-bound the total variance level only.
    kappa, theta, v0 = float(p.kappa), float(p.theta), float(p.v0)
    decay = (1.0 - np.exp(-kappa * T)) / (kappa * T)
    v_bar = theta + (v0 - theta) * decay
    assert 0.01 < v_bar < 0.10
    assert elapsed < 120  # full two-stage DE in seconds, not hours


def test_regime_conditioned_bounds():
    """Regime adjustments constrain the fitted parameters (C11→C7 wiring the
    reference promises at regime.py:9 but never connects)."""
    from mcos_tpu.engine.regime import RegimeDetector
    from mcos_tpu.ops.cos_pricer import cos_price

    true = SVJParams(kappa=3.0, theta=0.05, xi=2.5, rho=-0.6, v0=0.04,
                     lambda_j=5.0, mu_j=-0.07, sigma_j=0.12, r=R, q=Q)
    strikes = np.linspace(0.9, 1.1, 9) * SPOT
    market = cos_price(true, SPOT, strikes, T, True)
    calm_adj = RegimeDetector().classify(0.1, 10, 0.01)[
        "calibration_adjustments"]
    from mcos_tpu.config import CalibrationConfig
    eng = cal.CalibrationEngine(
        config=CalibrationConfig(stage1_max_iter=40, stage2_max_iter=40))
    res = eng.calibrate_fast(SPOT, strikes, T, market, r=R, q=Q,
                             atm_vol=0.2, seed=2,
                             regime_adjustments=calm_adj)
    p = res["params"]
    # Calm-regime ceilings bind: ξ ≤ 1.5, λ ≤ 3 even though the chain was
    # generated with ξ=2.5, λ=5.
    assert float(p.xi) <= calm_adj["xi_bounds"][1] + 1e-6
    assert float(p.lambda_j) <= calm_adj["lambda_bounds"][1] + 1e-6


def test_term_structure_calibration():
    """Full θ(T)/ξ(T)/λ(T) curve fit across three maturities."""
    from mcos_tpu.models.params import TermStructureSVJ
    from mcos_tpu.ops.cos_pricer import cos_price

    true_ts = TermStructureSVJ(
        kappa=3.0, rho=-0.6, mu_j=-0.06, sigma_j=0.12, v0=0.0324, r=R, q=Q,
        theta_curve={0.1: 0.035, 0.25: 0.045, 0.5: 0.055},
        xi_curve={0.1: 0.8, 0.25: 0.5, 0.5: 0.4},
        lambda_curve={0.1: 2.0, 0.25: 1.2, 0.5: 0.8})
    strikes = np.linspace(0.88, 1.12, 11) * SPOT
    mats = np.array([0.1, 0.25, 0.5])
    market = np.stack([
        cos_price(true_ts.get_params_at_maturity(float(t)), SPOT, strikes,
                  float(t), True) for t in mats])

    from mcos_tpu.config import CalibrationConfig
    eng = cal.CalibrationEngine(
        config=CalibrationConfig(stage1_max_iter=60, stage2_max_iter=60))
    out = eng.calibrate_term_structure(SPOT, strikes, mats, market,
                                       r=R, q=Q, atm_vols=[0.19, 0.2, 0.21],
                                       seed=0)
    ts = out["term_structure"]
    # Refit: every maturity's chain reproduced within 1% of its ATM premium.
    for i, t in enumerate(mats):
        model = cos_price(ts.get_params_at_maturity(float(t)), SPOT, strikes,
                          float(t), True)
        atm = market[i][5]
        assert np.max(np.abs(model - market[i])) < 0.02 * atm, f"T={t}"
    # Curves populated at all maturities.
    assert set(ts.theta_curve) == {0.1, 0.25, 0.5}


def test_de_cache_reuse_across_calibrations():
    """Second calibration with identical shapes must reuse the compiled DE
    loop (review finding: per-request closures forced full recompiles)."""
    import time

    import jax

    from mcos_tpu.ops.bs import bs_price as _bs

    # Other suite modules may already have compiled the DE loop, which would
    # make `first` warm and the cold/warm ratio below meaningless — start
    # from a clean jit cache so the first call always pays compilation.
    jax.clear_caches()

    strikes = np.linspace(0.95, 1.05, 5) * SPOT
    market = np.array([float(_bs(SPOT, k, T, R, Q, 0.18, True))
                       for k in strikes], np.float32)
    kw = dict(r=R, q=Q, atm_vol=0.18, num_paths=8192, num_steps=16,
              pop_size=8, polish=False)
    eng = cal.CalibrationEngine(config=__import__(
        "mcos_tpu.config", fromlist=["CalibrationConfig"]).CalibrationConfig(
        stage1_max_iter=20, stage2_max_iter=20))
    t0 = time.time()
    eng.calibrate(SPOT, strikes, T, market, seed=0, **kw)
    first = time.time() - t0
    t0 = time.time()
    eng.calibrate(SPOT, strikes, T, market * 1.01, seed=1, **kw)
    second = time.time() - t0
    assert second < 0.5 * first, (first, second)


def test_parameter_uncertainty_diagnostics():
    """Gauss-Newton error bars: correct WLS scaling (doubling the residual
    noise doubles every standard error — same Jacobian), a proper
    correlation matrix, and zero bars for a perfect fit."""
    from mcos_tpu.ops.cos_pricer import cos_price

    p = SVJParams(kappa=2.0, theta=0.05, xi=0.5, rho=-0.6, v0=0.04,
                  lambda_j=0.8, mu_j=-0.05, sigma_j=0.12, r=R, q=Q)
    strikes = np.linspace(0.85, 1.15, 15) * SPOT
    truth = np.asarray(cos_price(p, SPOT, strikes, T, True), np.float64)
    rng = np.random.default_rng(7)
    noise = rng.standard_normal(truth.size) * 5.0

    eng = cal.CalibrationEngine()
    u1 = eng.parameter_uncertainty(p, SPOT, strikes, T, truth + noise)
    u2 = eng.parameter_uncertainty(p, SPOT, strikes, T, truth + 2 * noise)
    se1 = np.asarray(u1["std_errors"])
    se2 = np.asarray(u2["std_errors"])
    assert np.all(np.isfinite(se1)) and np.all(se1 >= 0)
    mask = se1 > 0
    assert mask.any()
    assert np.allclose(se2[mask] / se1[mask], 2.0, rtol=1e-6)

    corr = np.asarray(u1["correlation"])
    assert np.allclose(np.diag(corr), 1.0)
    assert np.all(np.abs(corr) <= 1.0 + 1e-6)
    assert u1["dof"] == strikes.size - 8
    assert u1["param_names"][0] == "kappa"

    u0 = eng.parameter_uncertainty(p, SPOT, strikes, T, truth)
    assert np.asarray(u0["std_errors"]).max() == pytest.approx(0.0, abs=1e-6)
    assert u0["residual_rms"] < 1e-8
