"""TDSVJEngine + sequential bootstrap calibration of consistent td dynamics."""

import numpy as np
import pytest

from mcos_tpu.engine.termsvj import (TDSVJEngine, bootstrap_calibrate_td)
from mcos_tpu.models.params import SVJParams, TermStructureSVJ
from mcos_tpu.ops.tdsvj import cos_price_td

S = 22500.0
R, Q = 0.065, 0.012
SHARED = SVJParams(kappa=3.0, theta=0.06, xi=0.5, rho=-0.7, v0=0.04,
                   lambda_j=1.5, mu_j=-0.07, sigma_j=0.12, r=R, q=Q)


def test_engine_mc_matches_cos_chain():
    """The engine's MC chain must hit its own COS oracle within bands."""
    eng = TDSVJEngine(SHARED, [0.1, 0.25], [0.02, 0.09], [0.8, 0.3],
                      [3.0, 0.5], num_paths=200_000, num_steps=256,
                      seed=5)
    strikes = np.array([0.95, 1.0, 1.05]) * S
    T = 0.25
    exact = eng.cos_chain(S, strikes, T)
    rows = eng.price_batch(S, strikes, T)
    for i, row in enumerate(rows):
        tol = 4 * row["std_error"] + 0.002 * exact[i]
        assert abs(row["price"] - exact[i]) < tol, (
            f"K={strikes[i]}: MC={row['price']:.3f} COS={exact[i]:.3f}")


def test_engine_cv_reduces_stderr():
    """The companion CV must not hurt (β* estimate) — compare stderrs."""
    kw = dict(num_paths=100_000, num_steps=128, seed=7)
    cv = TDSVJEngine(SHARED, [0.25], [0.06], [0.5], [1.5],
                     control_variate=True, **kw)
    raw = TDSVJEngine(SHARED, [0.25], [0.06], [0.5], [1.5],
                      control_variate=False, **kw)
    row_cv = cv.price(S, S, 0.25)
    row_raw = raw.price(S, S, 0.25)
    assert row_cv["std_error"] < row_raw["std_error"]


def test_engine_from_term_structure():
    ts = TermStructureSVJ(kappa=3.0, rho=-0.7, mu_j=-0.05, sigma_j=0.1,
                          v0=0.04, theta_curve={0.1: 0.04, 1.0: 0.09},
                          xi_curve={0.1: 0.7, 1.0: 0.5},
                          lambda_curve={0.1: 1.5, 1.0: 1.0})
    eng = TDSVJEngine.from_term_structure(ts, horizon=1.0, n_segments=4,
                                          num_paths=50_000, num_steps=64)
    assert eng.seg_ends.size == 4 and eng.seg_ends[-1] == pytest.approx(1.0)
    row = eng.price(S, S, 0.5)
    assert row["price"] > 0 and np.isfinite(row["std_error"])


def test_bootstrap_recovers_segments():
    """Round trip: synth market chains from known segments → bootstrap must
    reprice every expiry to ~exactly (errors ≪ 1 rupee²) and reproduce the
    td price function."""
    true_ends = np.array([0.10, 0.30])
    true_th = np.array([0.03, 0.08])
    true_xi = np.array([0.70, 0.40])
    true_lam = np.array([2.00, 0.80])
    strikes = np.array([0.92, 0.96, 1.0, 1.04, 1.08]) * S
    mats = true_ends
    market = np.stack([
        cos_price_td(SHARED, S, strikes, float(T), true_ends, true_th,
                     true_xi, true_lam)
        for T in mats
    ])

    fit = bootstrap_calibrate_td(S, mats, strikes, market, SHARED,
                                 seed=11, maxiter=80)
    np.testing.assert_allclose(fit["seg_ends"], true_ends)
    for T_i, err in fit["errors"].items():
        assert err < 1e-2, f"T={T_i}: sse={err}"

    # Repricing the strip under the fitted segments matches the market.
    for i, T in enumerate(mats):
        model = cos_price_td(SHARED, S, strikes, float(T), fit["seg_ends"],
                             fit["thetas"], fit["xis"], fit["lams"])
        np.testing.assert_allclose(model, market[i], atol=0.25)


def test_bootstrap_validates_inputs():
    strikes = np.array([S])
    with pytest.raises(ValueError):
        bootstrap_calibrate_td(S, [0.3, 0.1], strikes, np.zeros((2, 1)),
                               SHARED)
    with pytest.raises(ValueError):
        bootstrap_calibrate_td(S, [0.1, 0.3], strikes, np.zeros((3, 1)),
                               SHARED)


def test_api_termsvj_modes():
    """The /api/termsvj handler: price/compare/smile/calibrate + 400s."""
    from mcos_tpu.api import server as api

    segs = [{"t_end": 0.1, "theta": 0.03, "xi": 0.7, "lambda_j": 2.0},
            {"t_end": 0.25, "theta": 0.08, "xi": 0.4, "lambda_j": 0.5}]
    base = {"spot": S, "T": 0.25, "segments": segs,
            "num_paths": 20_000, "num_steps": 32}

    out = api.handle_termsvj(dict(base))
    assert out["price"] > 0 and "cos_price" in out and "segments" in out

    cmp_out = api.handle_termsvj({**base, "mode": "compare",
                                  "strikes": [S, 1.05 * S]})
    assert len(cmp_out["rows"]) == 2
    assert all("abs_error_sigma" in r for r in cmp_out["rows"])

    sm = api.handle_termsvj({**base, "mode": "smile"})
    assert len(sm["smile"]) == 5 and all(r["iv"] > 0 for r in sm["smile"])

    with pytest.raises(api.ApiError):
        api.handle_termsvj({**base, "segments": []})
    with pytest.raises(api.ApiError):
        api.handle_termsvj({**base, "mode": "calibrate"})
    with pytest.raises(api.ApiError):
        api.handle_termsvj({**base, "mode": "nope"})


def test_api_termsvj_calibrate_roundtrip():
    """Handler calibrate mode recovers segments from synthetic chains."""
    from mcos_tpu.api import server as api

    true = dict(seg_ends=np.array([0.1, 0.3]), th=np.array([0.03, 0.08]),
                xi=np.array([0.7, 0.4]), lam=np.array([2.0, 0.8]))
    # 5 strikes: 3 underdetermine (θ, ξ, λ) — a wrong segment-1 fit can
    # reprice 3 points exactly and then poison the segment-2 bootstrap.
    strikes = (np.array([0.92, 0.96, 1.0, 1.04, 1.08]) * S).tolist()
    market = [
        cos_price_td(SHARED, S, strikes, float(T), true["seg_ends"],
                     true["th"], true["xi"], true["lam"]).tolist()
        for T in true["seg_ends"]
    ]
    out = api.handle_termsvj({
        "spot": S, "mode": "calibrate", "strikes": strikes,
        "maturities": true["seg_ends"].tolist(), "market_prices": market,
        "params": {"kappa": 3.0, "rho": -0.7, "v0": 0.04, "mu_j": -0.07,
                   "sigma_j": 0.12, "r": R, "q": Q},
    })
    assert len(out["segments"]) == 2
    # 3-strike chain: sub-rupee² SSE ⇒ ~0.02% relative repricing error
    # (tight recovery is pinned by test_bootstrap_recovers_segments).
    for err in out["errors"].values():
        assert err < 1.0


def test_api_termsvj_forward_start_mode():
    from mcos_tpu.api import server as api

    segs = [{"t_end": 0.1, "theta": 0.03, "xi": 0.7, "lambda_j": 2.0},
            {"t_end": 0.25, "theta": 0.08, "xi": 0.4, "lambda_j": 0.5}]
    out = api.handle_termsvj({
        "spot": S, "T": 0.25, "mode": "forward_start", "t1": 0.1,
        "segments": segs, "num_paths": 20_000, "num_steps": 50})
    assert out["price"] > 0 and 0 < out["t1_effective"] < 0.25
    with pytest.raises(api.ApiError):
        api.handle_termsvj({"spot": S, "T": 0.25, "mode": "forward_start",
                            "segments": segs})  # missing t1
    with pytest.raises(api.ApiError):
        api.handle_termsvj({"spot": S, "T": 0.25, "mode": "forward_start",
                            "t1": 0.3, "segments": segs})  # t1 >= T


def test_td_cliquet_degenerate_matches_closed_form():
    """Constant-GBM segments ⇒ the td cliquet equals cliquet_bs exactly
    (per-period returns iid lognormal)."""
    from mcos_tpu.engine.cliquet import cliquet_bs
    from mcos_tpu.models.params import gbm_params

    sigma, T, n_per = 0.2, 1.0, 4
    p = gbm_params(sigma, r=R, q=Q)
    eng = TDSVJEngine(p, [T], [sigma**2], [1e-4], [0.0],
                      num_paths=150_000, num_steps=64, seed=13)
    out = eng.price_cliquet(T, n_periods=n_per, local_floor=0.0,
                            local_cap=0.05)
    exact = cliquet_bs(T, n_per, R, Q, sigma, 0.0, 0.05, 1.0)
    tol = max(5 * out["std_error"], 5e-5)
    assert abs(out["price"] - exact) < tol, (out["price"], exact, tol)


def test_td_cliquet_regime_split_prices_differ():
    """A calm→stressed segment split must move the cliquet away from the
    uniform-average constant model (the coupon accrual is regime-ordered)."""
    eng_td = TDSVJEngine(SHARED, [0.5, 1.0], [0.01, 0.16], [0.3, 0.3],
                         [0.0, 0.0], num_paths=150_000, num_steps=64,
                         seed=3)
    td = eng_td.price_cliquet(1.0, n_periods=4, local_cap=0.04)
    # Uniform constant θ at the time-average: same total variance budget.
    eng_c = TDSVJEngine(SHARED, [1.0], [0.085], [0.3], [0.0],
                        num_paths=150_000, num_steps=64, seed=3)
    cn = eng_c.price_cliquet(1.0, n_periods=4, local_cap=0.04)
    noise = 5 * (td["std_error"] + cn["std_error"])
    assert abs(td["price"] - cn["price"]) > noise, (td, cn)


def test_api_termsvj_cliquet_mode():
    from mcos_tpu.api import server as api

    segs = [{"t_end": 0.5, "theta": 0.02, "xi": 0.5, "lambda_j": 1.0},
            {"t_end": 1.0, "theta": 0.09, "xi": 0.5, "lambda_j": 1.0}]
    out = api.handle_termsvj({
        "spot": S, "T": 1.0, "mode": "cliquet", "segments": segs,
        "n_periods": 4, "local_cap": 0.05, "num_paths": 20_000,
        "num_steps": 32})
    assert out["price"] > 0 and out["n_periods"] == 4


def test_td_greeks_degenerate_match_bs():
    """AD delta/vega under constant-GBM td arrays == closed-form BS."""
    from mcos_tpu.models.params import gbm_params
    from mcos_tpu.ops.bs import bs_delta, bs_vega

    sigma, T = 0.2, 0.25
    p = gbm_params(sigma, r=R, q=Q)
    eng = TDSVJEngine(p, [T], [sigma**2], [1e-4], [0.0],
                      num_paths=100_000, num_steps=64, seed=2)
    g = eng.greeks(S, S, T)
    d_bs = float(bs_delta(S, S, T, R, Q, sigma, True))
    v_bs = float(bs_vega(S, S, T, R, Q, sigma))
    # The AD pass runs (MC − companion) + exact BS: in the degenerate limit
    # the MC and companion legs cancel pathwise, leaving the exact BS
    # derivative (a few-ulp band).
    assert abs(g["delta"] - d_bs) < 5e-4, (g["delta"], d_bs)
    assert abs(g["vega"] - v_bs) / v_bs < 5e-3, (g["vega"], v_bs)


def test_td_greeks_vega_sees_time_dependence():
    """v0-vega differs between calm→stressed and stressed→calm segment
    orders even when the two specs share the time-averaged θ, ξ, λ —
    only a consistent td model resolves the ordering."""
    kw = dict(num_paths=150_000, num_steps=128, seed=4)
    up = TDSVJEngine(SHARED, [0.125, 0.25], [0.02, 0.10], [0.5, 0.5],
                     [1.0, 1.0], **kw)
    down = TDSVJEngine(SHARED, [0.125, 0.25], [0.10, 0.02], [0.5, 0.5],
                       [1.0, 1.0], **kw)
    g_up = up.greeks(S, S, 0.25)
    g_down = down.greeks(S, S, 0.25)
    # Early θ feeds variance that acts over MORE remaining time: the
    # stressed-early spec must carry the higher price; and dP/dv0 must
    # differ (v0 shocks decay toward different θ paths).
    assert g_down["price"] > g_up["price"]
    assert abs(g_up["dP_dv0"] - g_down["dP_dv0"]) > 1e-4


def test_api_termsvj_greeks_mode():
    from mcos_tpu.api import server as api

    segs = [{"t_end": 0.25, "theta": 0.05, "xi": 0.5, "lambda_j": 1.0}]
    out = api.handle_termsvj({
        "spot": S, "T": 0.25, "mode": "greeks", "segments": segs,
        "num_paths": 20_000, "num_steps": 32})
    assert 0 < out["delta"] < 1 and out["vega"] > 0


def test_td_american_european_limit_matches_td_cos():
    """exercise_every = num_steps ⇒ no early right ⇒ the LSM td price is
    the European td price; pin against the chained-Riccati COS oracle."""
    eng = TDSVJEngine(SHARED, [0.1, 0.25], [0.02, 0.09], [0.8, 0.3],
                      [3.0, 0.5], num_paths=150_000, num_steps=64,
                      seed=17)
    strike = 1.04 * S
    out = eng.price_american(S, strike, 0.25, is_call=False,
                             exercise_every=64)
    exact = float(cos_price_td(SHARED, S, [strike], 0.25,
                               eng.seg_ends, eng.thetas, eng.xis,
                               eng.lams, is_call=False)[0])
    tol = 4 * out["std_error"] + 0.004 * exact
    assert abs(out["price"] - exact) < tol, (out["price"], exact, tol)


def test_td_american_premium_nonnegative_and_orders():
    """American ≥ European under td dynamics; and the put's early-exercise
    premium is larger when the stressed regime comes LATE (holding through
    calm first costs carry, so more exercise happens early → check both
    orderings price sanely)."""
    kw = dict(num_paths=100_000, num_steps=64, seed=19)
    eng = TDSVJEngine(SHARED, [0.1, 0.25], [0.02, 0.09], [0.8, 0.3],
                      [3.0, 0.5], **kw)
    strike = 1.05 * S
    am = eng.price_american(S, strike, 0.25, is_call=False)
    eu = eng.price_american(S, strike, 0.25, is_call=False,
                            exercise_every=64)
    assert am["price"] >= eu["price"] - 3 * eu["std_error"]
    assert am["price"] >= am["intrinsic"]


def test_api_termsvj_american_mode():
    from mcos_tpu.api import server as api

    segs = [{"t_end": 0.25, "theta": 0.06, "xi": 0.5, "lambda_j": 1.0}]
    out = api.handle_termsvj({
        "spot": S, "T": 0.25, "mode": "american", "strike": 1.05 * S,
        "is_call": False, "segments": segs, "num_paths": 20_000,
        "num_steps": 32})
    assert out["price"] >= out["intrinsic"] > 0


def test_api_termsvj_varswap_mode():
    from mcos_tpu.api import server as api

    segs = [{"t_end": 0.1, "theta": 0.02, "xi": 0.8, "lambda_j": 3.0},
            {"t_end": 0.25, "theta": 0.09, "xi": 0.3, "lambda_j": 0.5}]
    out = api.handle_termsvj({
        "spot": S, "T": 0.25, "mode": "varswap", "segments": segs,
        "num_paths": 20_000, "num_steps": 64})
    assert out["fair_variance"] > 0
    assert out["fair_variance"] == pytest.approx(
        out["diffusion_leg"] + out["jump_leg"], rel=1e-12)
