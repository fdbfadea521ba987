"""Discrete dividend support (ops/dividends.py + engine wiring).

Oracles:
- proportional dividends commute with multiplicative dynamics → engine with
  a schedule must be BIT-IDENTICAL to the bare engine at the adjusted spot;
- the compounded-cash path model drops by exactly D at the ex-date and its
  forward F = S₀e^{(r−q)T} − Σ D_i e^{(r−q)(T−t_i)} is closed-form (martingale
  test within MC bands);
- American-call early exercise exists iff dividends do (Merton): the LSM
  price with exercise rights must exceed its own European degenerate
  (exercise_every = num_steps, same paths) exactly when a big dividend is in
  the schedule.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcos_tpu.engine.american import (AmericanEngine, _dividend_sheets,
                                      _record_log_paths, lsm_price)
from mcos_tpu.engine.greeks import GreeksEngine
from mcos_tpu.engine.pricer import MonteCarloEngine
from mcos_tpu.models.params import gbm_params
from mcos_tpu.ops.bs import bs_price
from mcos_tpu.ops.dividends import (DividendSchedule, cash_to_proportional,
                                    effective_spot, forward_with_dividends,
                                    proportional_factor, pv_cash)

S, K, T = 100.0, 100.0, 0.75
R, SIGMA = 0.06, 0.25

CASH = DividendSchedule([0.25, 0.55], [2.0, 1.5], "cash")
PROP = DividendSchedule([0.25, 0.55], [0.02, 0.015], "proportional")


# ── schedule math ────────────────────────────────────────────────────────────
def test_schedule_validation():
    with pytest.raises(ValueError):
        DividendSchedule([0.2, 0.1], [1.0, 1.0], "cash")       # not increasing
    with pytest.raises(ValueError):
        DividendSchedule([-0.1], [1.0], "cash")                # t <= 0
    with pytest.raises(ValueError):
        DividendSchedule([0.1], [1.5], "proportional")         # d >= 1
    with pytest.raises(ValueError):
        DividendSchedule([0.1], [1.0], "special")              # bad kind


def test_pv_and_factor():
    assert pv_cash(CASH, R, T) == pytest.approx(
        2.0 * math.exp(-R * 0.25) + 1.5 * math.exp(-R * 0.55))
    assert pv_cash(CASH, R, 0.3) == pytest.approx(2.0 * math.exp(-R * 0.25))
    assert proportional_factor(PROP, T) == pytest.approx(0.98 * 0.985)
    # Inclusive ex-date-on-expiry convention.
    assert proportional_factor(PROP, 0.55) == pytest.approx(0.98 * 0.985)


def test_cash_to_proportional_preserves_forward():
    """d_i = D_i/F(t_i⁻) reproduces the compounded-cash forward exactly."""
    q = 0.01
    prop = cash_to_proportional(CASH, S, R, q)
    f_cash = forward_with_dividends(S, CASH, R, q, T)
    f_prop = S * math.exp((R - q) * T) * proportional_factor(prop, T)
    assert f_prop == pytest.approx(f_cash, rel=1e-12)


def test_grid_amounts_snap():
    grid = CASH.grid_amounts(T, 64)
    assert grid is not None and grid.shape == (64,)
    assert grid.sum() == pytest.approx(3.5)
    # Interior-date clamp: a dividend essentially at expiry lands at n-1.
    late = DividendSchedule([T * 0.999], [1.0], "cash").grid_amounts(T, 64)
    assert late[62] == pytest.approx(1.0) and late[63] == 0.0
    assert DividendSchedule([2 * T], [1.0], "cash").grid_amounts(T, 64) is None


def test_effective_spot_escrow_overflow():
    with pytest.raises(ValueError):
        effective_spot(1.0, CASH, R, T)  # dividends exceed the spot


# ── European wiring: spot substitution must be exact ─────────────────────────
def _engine(divs=None, **kw):
    return MonteCarloEngine(gbm_params(SIGMA, r=R, q=0.0), num_paths=50_000,
                            num_steps=64, seed=7, use_sobol=False,
                            dividends=divs, **kw)


def test_european_proportional_bit_identical_to_adjusted_spot():
    f = proportional_factor(PROP, T)
    with_divs = _engine(PROP).price(S, K, T)
    bare = _engine().price(S * f, K, T)
    assert with_divs["price"] == bare["price"]
    assert with_divs["std_error"] == bare["std_error"]
    assert with_divs["dividend_model"] == "proportional-exact"


def test_european_cash_escrowed_bit_identical():
    pv = pv_cash(CASH, R, T)
    with_divs = _engine(CASH).price(S, K, T)
    bare = _engine().price(S - pv, K, T)
    assert with_divs["price"] == bare["price"]
    assert with_divs["dividend_model"] == "escrowed"


def test_european_proportional_matches_bs_oracle():
    f = proportional_factor(PROP, T)
    res = _engine(PROP).price(S, K, T)
    ref = float(bs_price(S * f, K, T, R, 0.0, SIGMA, True))
    assert abs(res["price"] - ref) < 3 * max(res["std_error"], 1e-4)


def test_dividends_lower_call_raise_put():
    call_d = _engine(CASH).price(S, K, T, is_call=True)["price"]
    call_0 = _engine().price(S, K, T, is_call=True)["price"]
    put_d = _engine(CASH).price(S, K, T, is_call=False)["price"]
    put_0 = _engine().price(S, K, T, is_call=False)["price"]
    assert call_d < call_0
    assert put_d > put_0


# ── Greeks chain rule ────────────────────────────────────────────────────────
def test_greeks_proportional_chain_rule():
    eng = GreeksEngine(gbm_params(SIGMA, r=R, q=0.0), num_paths=50_000)
    f = proportional_factor(PROP, T)
    out = eng.all_greeks_dividends(S, K, T, True, PROP)
    base = eng.all_greeks(S * f, K, T, True)
    assert out["delta"]["pathwise"] == pytest.approx(
        f * base["delta"]["pathwise"])
    assert out["gamma"]["gamma"] == pytest.approx(
        f * f * base["gamma"]["gamma"])
    assert out["vega"]["ad_vega_v0"] == base["vega"]["ad_vega_v0"]
    assert out["dividends"]["model"] == "proportional-exact"


def test_greeks_cash_rho_term():
    eng = GreeksEngine(gbm_params(SIGMA, r=R, q=0.0), num_paths=50_000)
    pv = pv_cash(CASH, R, T)
    out = eng.all_greeks_dividends(S, K, T, True, CASH)
    base = eng.all_greeks(S - pv, K, T, True)
    ds_dr = sum(t * a * math.exp(-R * t)
                for t, a in zip(CASH.times, CASH.amounts))
    assert out["rho"]["rho"] == pytest.approx(
        base["rho"]["rho"] + base["delta"]["pathwise"] * ds_dr)
    assert out["delta"]["pathwise"] == base["delta"]["pathwise"]


# ── compounded-cash path model ───────────────────────────────────────────────
def _sheets(div_sched, num_paths=60_000, num_steps=48):
    params = gbm_params(SIGMA, r=R, q=0.0)
    lp = _record_log_paths(params, S, T, jax.random.key(11),
                           num_paths=num_paths, num_steps=num_steps)
    s_paths = jnp.exp(lp)
    grid = jnp.asarray(div_sched.grid_amounts(T, num_steps))
    s_ex, s_cum = _dividend_sheets(s_paths, grid, div_sched.kind, floor=1e-4)
    return np.asarray(s_paths), np.asarray(s_ex), np.asarray(s_cum), \
        np.asarray(grid)


def test_cash_sheets_drop_exactly_d():
    _, s_ex, s_cum, grid = _sheets(CASH)
    for k in np.nonzero(grid)[0]:
        np.testing.assert_allclose(s_cum[k] - s_ex[k], grid[k], rtol=1e-5)
    quiet = np.nonzero(grid == 0)[0][0]
    np.testing.assert_array_equal(s_cum[quiet], s_ex[quiet])


def test_cash_forward_martingale():
    """E[S_div(T)] must equal the closed-form dividend forward (3σ)."""
    _, s_ex, _, _ = _sheets(CASH)
    mean = s_ex[-1].mean()
    se = s_ex[-1].std() / math.sqrt(s_ex.shape[1])
    f_ref = forward_with_dividends(S, CASH, R, 0.0, T)
    assert abs(mean - f_ref) < 3 * se


def test_proportional_sheets_match_factors():
    s_paths, s_ex, _, _ = _sheets(PROP)
    f = proportional_factor(PROP, T)
    np.testing.assert_allclose(s_ex[-1], s_paths[-1] * f, rtol=1e-6)


# ── American with dividends ──────────────────────────────────────────────────
BIG = DividendSchedule([0.4], [8.0], "cash")  # 8% of spot, mid-life


def _lsm(div, exercise_every=1, is_call=True, num_steps=48):
    params = gbm_params(SIGMA, r=R, q=0.0)
    kw = {}
    if div is not None:
        kw = {"div_grid": jnp.asarray(div.grid_amounts(T, num_steps)),
              "div_kind": div.kind}
    return jax.device_get(lsm_price(
        params, S, K, T, jax.random.key(3), num_paths=100_000,
        num_steps=num_steps, is_call=is_call,
        exercise_every=exercise_every, **kw))


def test_american_call_early_exercise_iff_dividends():
    """Merton: no early exercise without dividends; a large cash dividend
    creates a genuine premium. Same key → same paths, so the comparison is
    CRN-exact."""
    steps = 48
    # No dividends: American == European on the same paths (tiny tolerance
    # for the rare false exercise).
    am0 = _lsm(None)
    eu0 = _lsm(None, exercise_every=steps)
    assert am0["price"] <= eu0["price"] * 1.002 + 1e-3
    # Big dividend: the exercise right is worth real money.
    am_d = _lsm(BIG)
    eu_d = _lsm(BIG, exercise_every=steps)
    premium = am_d["price"] - eu_d["price"]
    assert premium > 3 * (am_d["std_error"] + eu_d["std_error"])


def test_american_put_with_dividends_worth_more():
    put_d = _lsm(BIG, is_call=False)
    put_0 = _lsm(None, is_call=False)
    assert put_d["price"] > put_0["price"] + 3 * (
        put_d["std_error"] + put_0["std_error"])


def test_american_engine_dividends_end_to_end():
    eng = AmericanEngine(gbm_params(SIGMA, r=R, q=0.0), num_paths=60_000,
                         num_steps=64, seed=5, dividends=BIG)
    res = eng.price(S, K, T, is_call=True)
    bare = AmericanEngine(gbm_params(SIGMA, r=R, q=0.0), num_paths=60_000,
                          num_steps=64, seed=5).price(S, K, T, is_call=True)
    assert res["price"] < bare["price"]           # dividends hurt calls
    g = eng.greeks(S, K, T, is_call=True)
    assert 0.0 < g["delta"] < 1.0
    assert np.isfinite(g["gamma"]) and np.isfinite(g["vega_per_vol_point"])
    with pytest.raises(ValueError):
        eng.price_bounds(S, K, T)


# ── API wiring ───────────────────────────────────────────────────────────────
def test_api_price_and_american_with_dividends():
    from mcos_tpu.api.server import ApiError, handle_american, handle_price

    base = {"spot": S, "strike": K, "T": T, "num_paths": 20_000,
            "params": {"v0": SIGMA**2, "theta": SIGMA**2, "xi": 1e-4,
                       "kappa": 1.0, "rho": 0.0, "lambda_j": 0.0,
                       "r": R, "q": 0.0}}
    divs = [{"t": 0.25, "amount": 2.0}, {"t": 0.55, "amount": 1.5}]
    with_d = handle_price({**base, "dividends": divs})
    without = handle_price(base)
    assert with_d["dividend_model"] == "escrowed"
    assert with_d["price"] < without["price"]

    am = handle_american({**base, "num_paths": 20_000, "dividends": divs})
    assert am["price"] > 0
    with pytest.raises(ApiError):
        handle_american({**base, "dividends": divs, "with_bounds": True})
    with pytest.raises(ApiError):   # escrow infeasible → 400
        handle_price({**base, "spot": 3.0, "dividends": divs})


def test_api_greeks_dividends():
    from mcos_tpu.api.server import ApiError, handle_greeks

    base = {"spot": S, "strike": K, "T": T, "num_paths": 20_000,
            "params": {"v0": SIGMA**2, "theta": SIGMA**2, "xi": 1e-4,
                       "kappa": 1.0, "rho": 0.0, "lambda_j": 0.0,
                       "r": R, "q": 0.0},
            "dividends": [{"t": 0.25, "amount": 0.02}],
            "dividend_kind": "proportional"}
    out = handle_greeks(base)
    assert out["dividends"]["model"] == "proportional-exact"
    assert 0.0 < out["delta"]["pathwise"] < 1.0
    with pytest.raises(ApiError):
        handle_greeks({**base, "strikes": [90.0, 100.0]})


def test_api_greeks_dividends_cross_block_consistent():
    """with_cross + dividends: the cross block must be computed at the
    effective spot with the chain factor, not the raw un-dividended
    contract (regression — the two halves of one response disagreed)."""
    from mcos_tpu.api import schemas
    from mcos_tpu.api.server import handle_greeks
    from mcos_tpu.engine.greeks import GreeksEngine
    from mcos_tpu.ops.dividends import DividendSchedule, effective_spot

    params = {"v0": SIGMA**2, "theta": SIGMA**2, "xi": 1e-4,
              "kappa": 1.0, "rho": 0.0, "lambda_j": 0.0, "r": R, "q": 0.0}
    base = {"spot": S, "strike": K, "T": T, "num_paths": 20_000,
            "params": params, "with_cross": True,
            "dividends": [{"t": 0.25, "amount": 0.03}],
            "dividend_kind": "proportional"}
    out = handle_greeks(base)

    sched = DividendSchedule([0.25], [0.03], "proportional")
    eff, f = effective_spot(S, sched, R, T)
    eng = GreeksEngine(schemas.SVJParamsRequest(**params).to_params(),
                       num_paths=20_000)
    expect = eng.cross_greeks(eff, K, T, True)
    assert out["cross"]["vanna"] == pytest.approx(expect["vanna"] * f,
                                                  rel=1e-9)
    assert out["cross"]["volga"] == pytest.approx(expect["volga"], rel=1e-9)
