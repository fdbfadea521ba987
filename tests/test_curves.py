"""Deterministic rate term structures (ops/curves.py + engine wiring).

Exactness oracles: flat-equivalent substitution must be BIT-IDENTICAL for
Europeans; the LSM sheet drift offsets satisfy the per-date forward
martingale; European-degenerate LSM under a steep curve pins BS(r_eff).
"""

import math

import jax
import numpy as np
import pytest

from mcos_tpu.engine.american import AmericanEngine
from mcos_tpu.engine.pricer import MonteCarloEngine
from mcos_tpu.models.params import gbm_params
from mcos_tpu.ops.bs import bs_price
from mcos_tpu.ops.curves import RateCurve

S, K, T = 100.0, 100.0, 1.0
SIGMA = 0.25
STEEP = RateCurve([0.25, 0.5, 0.75], [0.01, 0.04, 0.08])  # then 8% flat…
# …actually last knot extends flat: [0,.25)=1%, [.25,.5)=4%, [.5,∞)=8%.


# ── curve calculus ───────────────────────────────────────────────────────────
def test_curve_validation():
    with pytest.raises(ValueError):
        RateCurve([], [])
    with pytest.raises(ValueError):
        RateCurve([0.5, 0.25], [0.01, 0.02])
    with pytest.raises(ValueError):
        RateCurve([0.0], [0.01])


def test_integral_and_discount():
    c = STEEP
    assert c.rate(0.1) == 0.01 and c.rate(0.3) == 0.04 and c.rate(2.0) == 0.08
    r_int = 0.25 * 0.01 + 0.25 * 0.04 + 0.5 * 0.08
    assert c.integral(1.0) == pytest.approx(r_int, rel=1e-14)
    assert c.integral(0.4) == pytest.approx(0.25 * 0.01 + 0.15 * 0.04)
    assert c.discount(1.0) == pytest.approx(math.exp(-r_int), rel=1e-14)
    assert c.r_eff(1.0) == pytest.approx(r_int)
    flat = RateCurve.flat(0.06)
    assert flat.integral(3.0) == pytest.approx(0.18)


def test_grid_vectors_consistency():
    c = STEEP
    n = 64
    sdf = c.grid_step_dfs(T, n)
    assert np.prod(sdf.astype(np.float64)) == pytest.approx(c.discount(T),
                                                            rel=1e-5)
    off = c.grid_log_offsets(T, n, c.r_eff(T))
    assert off[-1] == pytest.approx(0.0, abs=1e-7)   # R(T) − r_eff·T = 0
    flat_off = RateCurve.flat(0.06).grid_log_offsets(T, n, 0.06)
    np.testing.assert_allclose(flat_off, 0.0, atol=1e-7)


# ── European wiring ──────────────────────────────────────────────────────────
def _mc(curve=None, r=0.06):
    return MonteCarloEngine(gbm_params(SIGMA, r=r, q=0.0), num_paths=50_000,
                            num_steps=64, seed=7, use_sobol=False,
                            rate_curve=curve)


def test_european_curve_bit_identical_to_r_eff():
    r_eff = STEEP.r_eff(T)
    with_curve = _mc(STEEP).price(S, K, T)
    flat = _mc(r=r_eff).price(S, K, T)
    assert with_curve["price"] == flat["price"]
    assert with_curve["std_error"] == flat["std_error"]


def test_european_curve_matches_bs():
    res = _mc(STEEP).price(S, K, T)
    ref = float(bs_price(S, K, T, STEEP.r_eff(T), 0.0, SIGMA, True))
    assert abs(res["price"] - ref) < 3 * max(res["std_error"], 1e-4)


def test_curve_with_cash_dividends_uses_curve_pv():
    from mcos_tpu.ops.dividends import DividendSchedule

    cash = DividendSchedule([0.3, 0.6], [2.0, 1.5], "cash")
    eng = MonteCarloEngine(gbm_params(SIGMA, r=0.06, q=0.0),
                           num_paths=20_000, num_steps=32, seed=7,
                           use_sobol=False,
                           dividends=cash, rate_curve=STEEP)
    pv = 2.0 * STEEP.discount(0.3) + 1.5 * STEEP.discount(0.6)
    assert eng._spot_eff(S, T) == pytest.approx(S - pv, rel=1e-12)


def test_auxiliary_paths_honor_curve():
    """price_to_tolerance, price_importance, and convergence must price at
    r_eff like .price() — regression for paths that passed raw self.params
    (curve silently ignored)."""
    curve_eng, flat_eng = _mc(STEEP), _mc(r=STEEP.r_eff(T))

    tol_c = curve_eng.price_to_tolerance(S, K, T, tolerance=1e-3,
                                         max_paths=200_000)
    tol_f = flat_eng.price_to_tolerance(S, K, T, tolerance=1e-3,
                                        max_paths=200_000)
    assert tol_c["price"] == tol_f["price"]  # same seed, same params

    imp_c = curve_eng.price_importance(S, K * 1.4, T)
    imp_f = flat_eng.price_importance(S, K * 1.4, T)
    assert imp_c["price"] == imp_f["price"]

    con_c = curve_eng.convergence(S, K, T)
    con_f = flat_eng.convergence(S, K, T)
    assert con_c["price"] == con_f["price"]
    # and the series converges to the same limit .price() quotes
    full = curve_eng.price(S, K, T)
    assert con_c["price"][-1] == pytest.approx(full["price"], rel=5e-3)


def test_viz_samples_honor_curve():
    """Viz paths/terminal samples drift at r_eff: E[S_T]·DF(T) ≈ S
    (martingale) under the curve — regression for sampling at raw r."""
    eng = MonteCarloEngine(gbm_params(SIGMA, r=0.06, q=0.0),
                           num_paths=50_000, num_steps=64, seed=7,
                           use_sobol=False,
                           rate_curve=STEEP)
    terms = np.asarray(eng.terminal_samples(S, T, num_samples=200_000),
                       np.float64)
    fwd = terms.mean()
    se = terms.std() / np.sqrt(terms.size)
    f_curve = S * math.exp(STEEP.integral(T))
    f_flat = S * math.exp(0.06 * T)
    assert abs(fwd - f_curve) < 4 * se
    assert abs(fwd - f_flat) > 6 * se  # distinguishable from the raw-r drift


def test_api_convergence_rate_curve():
    from mcos_tpu.api.server import handle_convergence

    base = {"spot": S, "strike": K, "T": T, "num_paths": 50_000,
            "params": {"v0": SIGMA**2, "theta": SIGMA**2, "xi": 1e-4,
                       "kappa": 1.0, "rho": 0.0, "lambda_j": 0.0,
                       "r": 0.06, "q": 0.0}}
    curve_knots = [{"t": 0.25, "r": 0.01}, {"t": 0.5, "r": 0.04},
                   {"t": 0.75, "r": 0.08}]
    out = handle_convergence({**base, "rate_curve": curve_knots})
    ref = float(bs_price(S, K, T, STEEP.r_eff(T), 0.0, SIGMA, True))
    ref_raw = float(bs_price(S, K, T, 0.06, 0.0, SIGMA, True))
    last, se = out["price"][-1], out["std_error"][-1]
    assert abs(last - ref) < 4 * max(se, 1e-4)
    assert abs(last - ref_raw) > abs(last - ref)  # not the flat-r price


# ── American LSM under a curve ───────────────────────────────────────────────
def _am(curve=None, r=0.06, num_paths=80_000):
    return AmericanEngine(gbm_params(SIGMA, r=r, q=0.0),
                          num_paths=num_paths, num_steps=64, seed=5,
                          rate_curve=curve)


def test_lsm_flat_curve_matches_scalar():
    """A flat curve must reproduce the scalar-rate engine (same paths; the
    only difference is f32 per-step vs accumulated discounting)."""
    flat = RateCurve.flat(0.06)
    a = _am(flat).price(S, K, T, is_call=False)
    b = _am(None).price(S, K, T, is_call=False)
    assert a["price"] == pytest.approx(b["price"], rel=5e-4)


def test_lsm_sheet_martingale_under_curve():
    """Offsets are exact: E[S(t_k)]·e^{−R(t_k)} = S₀ at every grid date."""
    from mcos_tpu.engine.american import _record_log_paths

    params = gbm_params(SIGMA, r=STEEP.r_eff(T), q=0.0)
    steps, paths = 64, 120_000
    lp = np.asarray(_record_log_paths(params, S, T, jax.random.key(11),
                                      num_paths=paths, num_steps=steps))
    off = STEEP.grid_log_offsets(T, steps, STEEP.r_eff(T))
    sheet = np.exp(lp.astype(np.float64) + off[:, None])
    cum = STEEP.grid_integrals(T, steps)
    for k in (15, 31, 63):
        vals = sheet[k] * math.exp(-cum[k])
        se = vals.std() / math.sqrt(paths)
        assert abs(vals.mean() - S) < 3.5 * se, k


def test_lsm_european_degenerate_under_curve_matches_bs():
    eng = _am(STEEP)
    res = eng.price(S, K, T, is_call=False, exercise_every=10_000)
    ref = float(bs_price(S, K, T, STEEP.r_eff(T), 0.0, SIGMA, False))
    assert abs(res["price"] - ref) < 3.5 * res["std_error"]


def test_lsm_put_cheap_early_discounting_adds_value():
    """Back-loaded rates discount early exercise less than the flat
    equivalent → the American put must be worth MORE under the curve than
    under flat r_eff (CRN: same seed/paths modulo deterministic offsets)."""
    curve = RateCurve([0.5], [0.0])  # 0% for 6m…
    steep = RateCurve([0.5, 50.0], [0.0, 0.24])  # …then 24%
    a_curve = _am(steep).price(S, 115.0, T, is_call=False)
    a_flat = _am(curve.flat(steep.r_eff(T))).price(S, 115.0, T,
                                                   is_call=False)
    assert a_curve["price"] > a_flat["price"] + 2 * (
        a_curve["std_error"] + a_flat["std_error"])


def test_american_greeks_under_curve_finite():
    g = _am(STEEP, num_paths=40_000).greeks(S, K, 0.5, is_call=False)
    assert -1.0 < g["delta"] < 0.0
    assert np.isfinite(g["rho"]) and np.isfinite(g["vega_per_vol_point"])
    with pytest.raises(ValueError):
        _am(STEEP).price_bounds(S, K, 0.5)


# ── API ──────────────────────────────────────────────────────────────────────
def test_api_rate_curve():
    from mcos_tpu.api.server import ApiError, handle_american, handle_price

    base = {"spot": S, "strike": K, "T": T, "num_paths": 20_000,
            "params": {"v0": SIGMA**2, "theta": SIGMA**2, "xi": 1e-4,
                       "kappa": 1.0, "rho": 0.0, "lambda_j": 0.0,
                       "r": 0.06, "q": 0.0},
            "rate_curve": [{"t": 0.25, "r": 0.01}, {"t": 0.5, "r": 0.04},
                           {"t": 0.75, "r": 0.08}]}
    out = handle_price(base)
    ref = float(bs_price(S, K, T, STEEP.r_eff(T), 0.0, SIGMA, True))
    assert out["price"] == pytest.approx(ref, rel=0.02)
    am = handle_american({**base})
    assert am["price"] > 0
    with pytest.raises(ApiError):
        handle_american({**base, "with_bounds": True})
