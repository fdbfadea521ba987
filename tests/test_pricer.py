"""MonteCarloEngine: BS oracle, control variate, batch pricing, Sobol driver."""

import numpy as np
import pytest

from mcos_tpu.engine.pricer import MonteCarloEngine
from mcos_tpu.models.params import SVJParams, gbm_params
from mcos_tpu.ops.bs import bs_price

SPOT = 22500.0
T = 0.04


@pytest.fixture(scope="module")
def bs_oracle_params():
    return gbm_params(0.2, r=0.065, q=0.012)


@pytest.mark.parametrize("use_sobol", [False, True])
def test_degenerate_svj_matches_bs(bs_oracle_params, use_sobol):
    """The reference's core oracle (verify.py:26-42) on both random drivers."""
    eng = MonteCarloEngine(bs_oracle_params, num_paths=50_000, num_steps=100,
                           use_sobol=use_sobol)
    res = eng.price(SPOT, SPOT, T, is_call=True)
    ref = float(bs_price(SPOT, SPOT, T, 0.065, 0.012, 0.2, True))
    tol = max(3 * res["std_error"], 1.0)
    assert abs(res["price"] - ref) < tol
    assert abs(res["price"] - ref) < 20.0  # reference ₹20 gate


def test_companion_cv_collapses_stderr_in_bs_limit(bs_oracle_params):
    """In the BS limit the GBM companion leg is the payoff itself — the
    control variate must remove (nearly) all variance."""
    eng_cv = MonteCarloEngine(bs_oracle_params, num_paths=20_000, num_steps=50,
                              use_sobol=False, use_control_variate=True)
    eng_raw = MonteCarloEngine(bs_oracle_params, num_paths=20_000, num_steps=50,
                               use_sobol=False, use_control_variate=False)
    se_cv = eng_cv.price(SPOT, SPOT, T)["std_error"]
    se_raw = eng_raw.price(SPOT, SPOT, T)["std_error"]
    assert se_cv < 0.05 * se_raw


def test_cv_is_unbiased_for_svj():
    """The companion CV must NOT drag the SVJ price toward Black-Scholes.

    (The reference's CV does exactly that — monte_carlo.py:358-366 uses the SVJ
    payoff itself as the control leg, so its CV price estimates the BS price.)
    """
    svj = SVJParams(kappa=3.0, theta=0.09, xi=0.6, rho=-0.7, v0=0.04,
                    lambda_j=2.0, mu_j=-0.08, sigma_j=0.15)
    kw = dict(num_paths=100_000, num_steps=64, use_sobol=False, seed=7)
    p_cv = MonteCarloEngine(svj, use_control_variate=True, **kw).price(
        SPOT, SPOT, 0.5)
    p_raw = MonteCarloEngine(svj, use_control_variate=False, **kw).price(
        SPOT, SPOT, 0.5)
    # CV and raw estimates agree within joint confidence bands...
    joint = 4 * np.hypot(p_cv["std_error"], p_raw["std_error"])
    assert abs(p_cv["price"] - p_raw["price"]) < max(joint, 5.0)
    # ...and the SVJ price differs from the σ=√v0 BS reference (θ≫v0 + jumps).
    assert abs(p_cv["price"] - p_cv["bs_ref"]) > 10 * p_cv["std_error"]


def test_reference_cv_mode_reproduces_bias():
    """cv_mode='reference' reproduces the reference's arithmetic: the CV price
    estimates bs_ref, not the SVJ price (documented parity quirk)."""
    svj = SVJParams(kappa=3.0, theta=0.09, xi=0.6, rho=-0.7, v0=0.04,
                    lambda_j=2.0, mu_j=-0.08, sigma_j=0.15)
    eng = MonteCarloEngine(svj, num_paths=50_000, num_steps=64,
                           use_sobol=False, cv_mode="reference")
    res = eng.price(SPOT, SPOT, 0.5)
    assert abs(res["price"] - res["bs_ref"]) < max(6 * res["std_error"], 2.0)


def test_sobol_beats_prng_on_smooth_payoff():
    """QMC should cut error vs PRNG on the raw (no-CV) estimator."""
    p = gbm_params(0.2, r=0.065, q=0.012)
    ref = float(bs_price(SPOT, SPOT, 0.25, 0.065, 0.012, 0.2, True))

    def err(use_sobol, seed):
        eng = MonteCarloEngine(p, num_paths=16_384, num_steps=32, seed=seed,
                               use_sobol=use_sobol, use_control_variate=False)
        return abs(eng.price(SPOT, SPOT, 0.25)["price"] - ref)

    sob = np.mean([err(True, s) for s in range(3)])
    prn = np.mean([err(False, s) for s in range(3)])
    assert sob < prn


def test_put_prices(bs_oracle_params):
    eng = MonteCarloEngine(bs_oracle_params, num_paths=50_000, num_steps=50,
                           use_sobol=False)
    res = eng.price(SPOT, SPOT * 1.02, T, is_call=False)
    ref = float(bs_price(SPOT, SPOT * 1.02, T, 0.065, 0.012, 0.2, False))
    assert abs(res["price"] - ref) < max(3 * res["std_error"], 1.0)


def test_full_svj_prices_sane():
    svj = SVJParams(kappa=5.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04,
                    lambda_j=1.0, mu_j=-0.05, sigma_j=0.10)
    eng = MonteCarloEngine(svj, num_paths=50_000, num_steps=100, use_sobol=False)
    call = eng.price(SPOT, SPOT, T, True)
    put = eng.price(SPOT, SPOT, T, False)
    assert 0 < call["price"] < SPOT
    assert 0 < put["price"] < SPOT
    assert call["std_error"] < call["price"]


def test_price_batch_consistent_with_single():
    p = gbm_params(0.2)
    eng = MonteCarloEngine(p, num_paths=20_000, num_steps=50, use_sobol=False)
    strikes = [SPOT * m for m in (0.95, 1.0, 1.05)]
    batch = eng.price_batch(SPOT, strikes, T)
    assert len(batch) == 3
    # Batch shares one path set — single-strike call with same seed must agree.
    single = eng.price(SPOT, strikes[1], T)
    assert batch[1]["price"] == pytest.approx(single["price"], abs=1e-3)
    # Monotone in strike for calls.
    assert batch[0]["price"] > batch[1]["price"] > batch[2]["price"]


def test_sample_paths_shape():
    eng = MonteCarloEngine(SVJParams(), num_paths=1000, num_steps=252)
    paths = eng.get_sample_paths(SPOT, 0.1, num_samples=50)
    assert paths.shape[0] == 50
    assert paths.shape[1] == max(int(252 * 0.1), 50) + 1
    assert np.all(paths[:, 0] == SPOT)


def test_maturity_scaled_steps():
    eng = MonteCarloEngine(SVJParams(), num_paths=1000, num_steps=252,
                           use_sobol=False)
    res = eng.price(SPOT, SPOT, 0.01)
    assert res["num_steps"] == 10  # floor (monte_carlo.py:287)
    res2 = eng.price(SPOT, SPOT, 1.0)
    assert res2["num_steps"] == 252


def test_convergence_series():
    p = gbm_params(0.2, r=0.065, q=0.012)
    eng = MonteCarloEngine(p, num_paths=50_000, num_steps=50, use_sobol=False)
    conv = eng.convergence(SPOT, SPOT, T)
    counts = conv["num_paths"]
    assert counts[-1] == 50_000
    assert all(a < b for a, b in zip(counts, counts[1:]))
    # stderr shrinks ~1/sqrt(n): last checkpoint much tighter than first.
    assert conv["std_error"][-1] < 0.3 * conv["std_error"][0]
    # Final estimate within 3 sigma of BS.
    ref = float(bs_price(SPOT, SPOT, T, 0.065, 0.012, 0.2, True))
    assert abs(conv["price"][-1] - ref) < 3 * conv["std_error"][-1] + 1.0


def test_price_to_tolerance():
    svj = SVJParams(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
                    lambda_j=1.0, mu_j=-0.05, sigma_j=0.1)
    eng = MonteCarloEngine(svj, num_paths=10_000, num_steps=64,
                           use_sobol=False, use_control_variate=False)
    res = eng.price_to_tolerance(SPOT, SPOT, 0.25, tolerance=0.002,
                                 max_paths=400_000, batch_paths=50_000)
    assert res["tolerance_met"]
    assert res["std_error"] / res["price"] <= 0.002
    assert res["num_paths_used"] <= 400_000
    assert res["num_batches"] >= 1
    # Tighter tolerance needs more paths.
    res2 = eng.price_to_tolerance(SPOT, SPOT, 0.25, tolerance=0.02,
                                  max_paths=400_000, batch_paths=50_000)
    assert res2["num_paths_used"] <= res["num_paths_used"]
    # Cap respected when tolerance is unreachable.
    res3 = eng.price_to_tolerance(SPOT, SPOT, 0.25, tolerance=1e-9,
                                  max_paths=150_000, batch_paths=50_000)
    assert res3["num_paths_used"] == 150_000
    assert not res3["tolerance_met"]


def test_optimal_beta_cv():
    """Optimal-beta CV: never worse than beta=1, and beta<1 when vol-of-vol
    decorrelates the SVJ payoff from its GBM companion."""
    svj = SVJParams(kappa=2.0, theta=0.09, xi=1.2, rho=-0.8, v0=0.04,
                    lambda_j=3.0, mu_j=-0.1, sigma_j=0.2)
    kw = dict(num_paths=50_000, num_steps=64, use_sobol=False, seed=13)
    one = MonteCarloEngine(svj, cv_beta="one", **kw).price(SPOT, SPOT, 0.5)
    opt_eng = MonteCarloEngine(svj, cv_beta="optimal", **kw)
    opt = opt_eng.price(SPOT, SPOT, 0.5)
    assert opt["std_error"] <= one["std_error"] * 1.01
    # Same estimand: prices agree within joint bands.
    joint = 5 * np.hypot(opt["std_error"], one["std_error"])
    assert abs(opt["price"] - one["price"]) < max(joint, 3.0)


def test_qe_scheme_via_engine():
    """MonteCarloEngine(scheme='qe') prices a rough-Heston-ish chain within
    the COS oracle band at a step count where Euler is biased."""
    from mcos_tpu.ops.cos_pricer import cos_price

    p = SVJParams(kappa=1.0, theta=0.09, xi=1.0, rho=-0.7, v0=0.04,
                  lambda_j=0.0, mu_j=0.0, sigma_j=0.01)
    exact = float(cos_price(p, SPOT, [SPOT], 1.0, True)[0])
    eng = MonteCarloEngine(p, num_paths=200_000, num_steps=16,
                           use_sobol=False, scheme="qe", seed=2)
    res = eng.price(SPOT, SPOT, 1.0)
    assert res["num_steps"] == 16
    assert abs(res["price"] - exact) < 4 * res["std_error"] + 0.003 * exact


def test_sobol_draws_cache_is_bounded_by_bytes(monkeypatch):
    """The device-resident Sobol cache evicts oldest-first past its byte
    budget, and always keeps the entry just added."""
    from mcos_tpu.engine import pricer

    monkeypatch.setattr(pricer, "_SOBOL_DRAWS_CACHE", type(
        pricer._SOBOL_DRAWS_CACHE)())
    p = SVJParams()
    one = pricer._draws_nbytes(pricer.MonteCarloEngine(
        p, num_paths=1024, seed=0)._sobol_draws(8))
    monkeypatch.setattr(pricer, "_SOBOL_DRAWS_CACHE_MAX_BYTES", 2 * one)
    for seed in range(1, 5):
        pricer.MonteCarloEngine(p, num_paths=1024, seed=seed)._sobol_draws(8)
    keys = list(pricer._SOBOL_DRAWS_CACHE)
    assert len(keys) == 2 and keys[-1] == ("euler", 8, 1024, 4)
    monkeypatch.setattr(pricer, "_SOBOL_DRAWS_CACHE_MAX_BYTES", 1)
    pricer.MonteCarloEngine(p, num_paths=1024, seed=9)._sobol_draws(8)
    assert list(pricer._SOBOL_DRAWS_CACHE) == [("euler", 8, 1024, 9)]
