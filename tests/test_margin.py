"""SPAN-style margin engine (engine/margin.py).

Structural oracles: CRN makes a perfectly hedged book margin EXACTLY zero;
long-option margin is bounded by premium; subadditivity (max of sums ≤ sum
of maxes); worst scenario direction follows the position's sign.
"""

import numpy as np
import pytest

from mcos_tpu.engine.margin import MarginEngine
from mcos_tpu.models.params import SVJParams, gbm_params

S = 100.0
P = SVJParams(kappa=2.0, theta=0.04, xi=0.5, rho=-0.6, v0=0.05,
              lambda_j=0.5, mu_j=-0.05, sigma_j=0.1, r=0.06, q=0.0)


@pytest.fixture(scope="module")
def eng():
    return MarginEngine(P, num_paths=60_000, num_steps=64, seed=9)


def test_hedged_book_margins_zero(eng):
    out = eng.margin(S, [100.0, 100.0], [0.5, 0.5], [True, True],
                     [5.0, -5.0])
    assert out["margin"] == 0.0
    assert all(abs(x) < 1e-9 for x in out["risk_array"])


def test_short_call_margin_positive_and_worst_is_up(eng):
    out = eng.margin(S, [100.0], [0.5], [True], [-1.0])
    assert out["margin"] > 0
    assert "price+" in out["worst_scenario"]
    assert out["num_scenarios"] == 16
    assert len(out["risk_array"]) == 16


def test_short_put_worst_is_down(eng):
    out = eng.margin(S, [100.0], [0.5], [False], [-1.0])
    assert out["margin"] > 0
    assert "price-" in out["worst_scenario"]


def test_long_option_margin_bounded_by_premium(eng):
    out = eng.margin(S, [100.0], [0.5], [True], [1.0])
    premium = out["net_option_value"]
    assert 0.0 <= out["margin"] <= premium + 1e-9


def test_subadditivity(eng):
    a = eng.margin(S, [95.0], [0.5], [False], [-2.0])
    b = eng.margin(S, [105.0], [0.5], [True], [-3.0])
    both = eng.margin(S, [95.0, 105.0], [0.5, 0.5], [False, True],
                      [-2.0, -3.0])
    assert both["margin"] <= a["margin"] + b["margin"] + 1e-9
    # A strangle's scenarios can't both bite: strictly subadditive here.
    assert both["margin"] < a["margin"] + b["margin"] - 1e-6


def test_scan_identity_matches_direct_repricing():
    """The payoff-axis spot transform must agree with actually moving the
    spot (independent paths → statistical agreement)."""
    from mcos_tpu.engine.pricer import MonteCarloEngine

    gbm = gbm_params(0.2, r=0.06, q=0.0)
    eng = MarginEngine(gbm, num_paths=100_000, num_steps=64, seed=1)
    out = eng.margin(S, [100.0], [0.5], [True], [-1.0])
    # Worst scenario for a short call: price +PSR (vol shift tiny for GBM —
    # it DOES shift v0/theta, so compare against the shifted-dynamics price).
    from mcos_tpu.engine.margin import _vol_shift

    up = _vol_shift(gbm, 0.04)
    mc = MonteCarloEngine(up, num_paths=200_000, num_steps=64, seed=5,
                          use_sobol=False)
    v_up = mc.price(S * 1.06, 100.0, 0.5)["price"]
    mc_b = MonteCarloEngine(gbm, num_paths=200_000, num_steps=64, seed=5,
                            use_sobol=False)
    v_base = mc_b.price(S, 100.0, 0.5)["price"]
    direct_loss = v_up - v_base            # short call: loss when value rises
    assert out["margin"] == pytest.approx(direct_loss, rel=0.05)


def test_multi_maturity_book(eng):
    out = eng.margin(S, [95.0, 100.0, 105.0], [0.25, 0.5, 1.0],
                     [False, True, True], [-1.0, -2.0, 1.0])
    assert out["margin"] > 0
    assert np.isfinite(out["net_option_value"])


def test_api_margin_endpoint():
    from mcos_tpu.api.server import ApiError, handle_margin

    body = {"spot": S, "strikes": [100.0], "Ts": [0.5], "is_calls": [True],
            "quantities": [-1.0], "num_paths": 20_000,
            "params": {"v0": 0.04, "theta": 0.04, "xi": 0.5, "kappa": 2.0,
                       "rho": -0.6, "lambda_j": 0.0, "r": 0.06, "q": 0.0}}
    out = handle_margin(body)
    assert out["margin"] > 0 and out["num_scenarios"] == 16
    with pytest.raises(ApiError):
        handle_margin({**body, "quantities": [1.0, 2.0]})
