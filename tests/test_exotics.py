"""Exotic pricing: closed-form oracles, CV effectiveness, no-arbitrage
orderings, barrier in-out parity."""

import jax
import numpy as np
import pytest

from mcos_tpu.engine.exotics import ExoticEngine
from mcos_tpu.models.params import SVJParams, gbm_params
from mcos_tpu.ops import exotics as ops_exotics
from mcos_tpu.ops.bs import bs_price

S, K, T = 100.0, 100.0, 1.0
R, Q, SIGMA = 0.05, 0.01, 0.25


@pytest.fixture(scope="module")
def gbm_engine():
    return ExoticEngine(gbm_params(SIGMA, r=R, q=Q), num_paths=100_000,
                        num_steps=64, seed=3)


def test_geometric_asian_matches_closed_form(gbm_engine):
    res = gbm_engine.price_asian(S, K, T, averaging="geometric")
    cf = float(ops_exotics.geometric_asian_bs(S, K, T, R, Q, SIGMA,
                                              res["num_steps"], True))
    assert abs(res["price"] - cf) < max(4 * res["std_error"], 0.02)
    # In the BS limit the geometric CV is the payoff itself: σ collapses.
    assert res["std_error"] < 0.01


def test_arithmetic_asian_cv_effectiveness(gbm_engine):
    res = gbm_engine.price_asian(S, K, T, averaging="arithmetic")
    raw = ExoticEngine(gbm_params(SIGMA, r=R, q=Q), num_paths=100_000,
                       num_steps=64, seed=3,
                       use_control_variate=False).price_asian(S, K, T)
    # Kemna-Vorst control: ≥10× stderr reduction, β ≈ 1, same price.
    assert res["std_error"] < 0.1 * raw["std_error"]
    assert res["cv_beta"] == pytest.approx(1.0, abs=0.15)
    assert abs(res["price"] - raw["price"]) < 4 * raw["std_error"]
    # Arithmetic mean ≥ geometric mean ⇒ arithmetic Asian call ≥ geometric.
    geo = gbm_engine.price_asian(S, K, T, averaging="geometric")
    assert res["price"] > geo["price"]


def test_asian_below_european(gbm_engine):
    """Averaging reduces effective volatility: Asian call < European call."""
    asian = gbm_engine.price_asian(S, K, T)
    euro = float(bs_price(S, K, T, R, Q, SIGMA, True))
    assert asian["price"] < euro


def test_barrier_in_out_parity(gbm_engine):
    """knock-in + knock-out = vanilla (same paths, exact identity)."""
    barrier = 120.0
    out = gbm_engine.price_barrier(S, K, T, barrier, knock="out")
    kin = gbm_engine.price_barrier(S, K, T, barrier, knock="in")
    euro = float(bs_price(S, K, T, R, Q, SIGMA, True))
    total = out["raw_mc_price"] + kin["raw_mc_price"]
    assert total == pytest.approx(euro, abs=max(
        6 * (out["std_error"] + kin["std_error"]), 0.15))


def test_barrier_orderings(gbm_engine):
    euro = float(bs_price(S, K, T, R, Q, SIGMA, True))
    tight = gbm_engine.price_barrier(S, K, T, 110.0, knock="out")
    wide = gbm_engine.price_barrier(S, K, T, 160.0, knock="out")
    assert tight["price"] < wide["price"] <= euro + 0.1
    # Down-and-out call with a far barrier ≈ vanilla.
    dout = gbm_engine.price_barrier(S, K, T, 40.0, knock="out")
    assert dout["price"] == pytest.approx(euro, rel=0.05)


def test_lookback_floating_call(gbm_engine):
    res = gbm_engine.price_lookback(S, T, is_call=True)
    cf = float(ops_exotics.lookback_float_bs(S, T, R, Q, SIGMA, True))
    # Discrete monitoring undershoots the continuous extremum: MC ≤ CF,
    # within the O(1/√n) band (≈ 0.58·σ·S·√(T/n)).
    gap = 0.583 * SIGMA * S * np.sqrt(T / res["num_steps"])
    assert res["price"] < cf
    assert cf - res["price"] < 2.5 * gap
    # Floating lookback call ≥ ATM European call (dominates pathwise).
    euro = float(bs_price(S, K, T, R, Q, SIGMA, True))
    assert res["price"] > euro


def test_lookback_fixed_vs_floating(gbm_engine):
    fixed = gbm_engine.price_lookback(S, T, is_call=True, strike=K)
    # Fixed-strike lookback call pays (max−K)+ ≥ (S_T−K)+ pathwise.
    euro = float(bs_price(S, K, T, R, Q, SIGMA, True))
    assert fixed["price"] > euro


def test_exotics_on_full_svj():
    svj = SVJParams(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
                    lambda_j=1.0, mu_j=-0.05, sigma_j=0.1)
    eng = ExoticEngine(svj, num_paths=50_000, num_steps=64, seed=4)
    asian = eng.price_asian(S, K, 0.5)
    barrier = eng.price_barrier(S, K, 0.5, 130.0, knock="out")
    lb = eng.price_lookback(S, 0.5)
    for res in (asian, barrier, lb):
        assert np.isfinite(res["price"]) and res["price"] >= 0
        assert res["std_error"] < res["price"] + 1.0


def test_path_stats_consistency():
    p = gbm_params(0.2)
    stats = ops_exotics.simulate_path_stats(
        p, 100.0, 0.5, jax.random.key(0), num_paths=4096, num_steps=32)
    assert bool((stats["max_s"] >= stats["s_final"]).all())
    assert bool((stats["min_s"] <= stats["s_final"]).all())
    assert bool((stats["max_s"] >= stats["avg"]).all())
    assert bool((stats["min_s"] <= stats["avg"]).all())
    # Geometric mean ≤ arithmetic mean, pathwise.
    geo = np.exp(np.asarray(stats["log_avg"]))
    assert (geo <= np.asarray(stats["avg"]) + 1e-3).all()


def test_asian_greeks_ad_vs_fd():
    """Pathwise AD delta for the arithmetic Asian agrees with a CRN central
    difference (same engine seed ⇒ shared paths)."""
    eng = ExoticEngine(gbm_params(0.2, r=0.05, q=0.01), num_paths=50_000,
                       num_steps=64, seed=3)
    g = eng.greeks(100.0, 100.0, 0.5, kind="asian")
    assert g["method"] == "pathwise_ad"
    h = 1.0
    p_up = eng.price_asian(101.0, 100.0, 0.5)["price"]
    p_dn = eng.price_asian(99.0, 100.0, 0.5)["price"]
    fd = (p_up - p_dn) / (2 * h)
    assert g["delta"] == pytest.approx(fd, abs=0.03)
    # ATM Asian call delta sits near e^{-qT}/2-ish; sanity band.
    assert 0.3 < g["delta"] < 0.8
    assert g["vega"] > 0  # long vol


def test_lookback_greeks_signs():
    eng = ExoticEngine(gbm_params(0.25, r=0.05, q=0.0), num_paths=30_000,
                       num_steps=64, seed=5)
    g = eng.greeks(100.0, 0.0, 0.5, kind="lookback", floating=True)
    # Floating-strike lookbacks are homogeneous degree 1 in spot, so the
    # pathwise delta must equal price/spot exactly — a three-way pin of the
    # AD machinery against Euler's theorem.
    assert g["delta"] == pytest.approx(g["price"] / 100.0, rel=1e-4)
    assert g["vega"] > 0


def test_barrier_greeks_fd():
    eng = ExoticEngine(gbm_params(0.2, r=0.05, q=0.01), num_paths=60_000,
                       num_steps=64, seed=7)
    g = eng.greeks(100.0, 100.0, 0.5, kind="barrier", barrier=130.0,
                   knock="out")
    assert g["method"] == "crn_fd_homogeneity"
    # Up-and-out call: positive delta near the money, SHORT vega (higher
    # vol raises knock-out probability).
    assert 0.0 < g["delta"] < 1.0
    assert g["vega"] < 0


def test_variance_swap_closed_form_vs_mc():
    """Fair variance strike (CIR mean integral + jump second moment) must
    match the MC realized quadratic variation of simulated paths."""
    import jax

    from mcos_tpu.engine.exotics import variance_swap_fair_strike
    from mcos_tpu.models.params import SVJParams
    from mcos_tpu.ops.simulate import simulate_paths_recorded

    p = SVJParams(kappa=3.0, theta=0.05, xi=0.3, rho=-0.5, v0=0.09,
                  lambda_j=2.0, mu_j=-0.04, sigma_j=0.06)
    T = 0.5
    out = variance_swap_fair_strike(p, T)
    assert out["jump_leg"] == pytest.approx(2.0 * (0.04**2 + 0.06**2))

    paths = simulate_paths_recorded(p, 100.0, T, jax.random.key(3),
                                    num_paths=4000, num_steps=128)
    lp = np.log(np.asarray(paths, np.float64))
    rv = np.sum(np.diff(lp, axis=1) ** 2, axis=1) / T
    se = rv.std() / np.sqrt(len(rv))
    assert abs(rv.mean() - out["fair_variance"]) < 4 * se + 2e-3


def test_digital_matches_bs_closed_form():
    """GBM mode: digital call = e^{-rT} N(d2); delta from the homogeneity
    FD agrees with the analytic digital delta."""
    from scipy.stats import norm

    S, K, T, r, q, sig = 100.0, 102.0, 0.25, 0.05, 0.01, 0.2
    eng = ExoticEngine(gbm_params(sig, r=r, q=q), num_paths=200_000,
                       num_steps=64, seed=11)
    out = eng.price_digital(S, K, T, is_call=True)
    st = sig * np.sqrt(T)
    d2 = (np.log(S / K) + (r - q - sig**2 / 2) * T) / st
    ref = np.exp(-r * T) * norm.cdf(d2)
    assert out["price"] == pytest.approx(ref, abs=4 * out["std_error"] + 1e-3)
    ref_delta = np.exp(-r * T) * norm.pdf(d2) / (S * st)
    assert out["delta"] == pytest.approx(ref_delta, rel=0.15)


# ─────────────────────────────────────────────────────────────────────────────
# Continuous monitoring: Reiner-Rubinstein closed forms + BGK correction
# ─────────────────────────────────────────────────────────────────────────────
def test_barrier_bs_in_out_parity():
    from mcos_tpu.ops.exotics import barrier_bs
    from mcos_tpu.ops.bs import bs_price
    S, K, T, r, q, sig = 100.0, 100.0, 0.5, 0.05, 0.01, 0.25
    for d, B, c in [("up", 120.0, True), ("down", 85.0, True),
                    ("up", 120.0, False), ("down", 95.0, False),
                    ("up", 105.0, True), ("down", 95.0, True)]:
        i = barrier_bs(S, K, T, r, q, sig, B, c, "in", d)
        o = barrier_bs(S, K, T, r, q, sig, B, c, "out", d)
        van = float(bs_price(S, K, T, r, q, sig, c))
        # bs_price is the jax f32 vanilla; parity itself is exact in f64
        assert i + o == pytest.approx(van, rel=2e-6)
        assert i >= 0 and o >= 0


def test_barrier_bs_started_through_is_knocked():
    from mcos_tpu.ops.exotics import barrier_bs
    from mcos_tpu.ops.bs import bs_price
    # spot already beyond the barrier: 'in' = vanilla, 'out' = 0.
    v_in = barrier_bs(100.0, 100.0, 0.5, 0.05, 0.01, 0.25, 95.0, True,
                      "in", "up")
    assert v_in == pytest.approx(
        float(bs_price(100, 100, 0.5, 0.05, 0.01, 0.25, True)), rel=2e-6)
    assert barrier_bs(100.0, 100.0, 0.5, 0.05, 0.01, 0.25, 95.0, True,
                      "out", "up") == 0.0


def test_bgk_continuous_monitoring_hits_closed_form():
    """BGK-shifted MC must land an order of magnitude closer to the
    continuous closed form than the raw discrete MC."""
    from mcos_tpu.ops.exotics import barrier_bs
    gp = gbm_params(0.25, r=0.05, q=0.01)
    eng = ExoticEngine(gp, num_paths=200_000, num_steps=256, seed=3)
    for B, c, d in [(120.0, True, "up"), (88.0, False, "down")]:
        cont = eng.price_barrier(100.0, 100.0, 0.5, B, is_call=c,
                                 monitoring="continuous")
        disc = eng.price_barrier(100.0, 100.0, 0.5, B, is_call=c)
        cf = barrier_bs(100.0, 100.0, 0.5, 0.05, 0.01, 0.25, B, c,
                        "out", d)
        gap_cont = abs(cont["price"] - cf)
        gap_disc = abs(disc["price"] - cf)
        assert gap_cont < 0.15 * gap_disc           # kills the sqrt(dt) term
        assert gap_cont < 4 * cont["std_error"] + 0.02  # O(dt) remainder
        assert cont["monitoring"] == "continuous"
        assert cont["barrier"] == B                 # reported, not shifted


def test_bgk_remainder_shrinks_with_steps():
    from mcos_tpu.ops.exotics import barrier_bs
    gp = gbm_params(0.25, r=0.05, q=0.01)
    cf = barrier_bs(100.0, 100.0, 0.5, 0.05, 0.01, 0.25, 115.0, True,
                    "out", "up")
    gaps = []
    for steps in (64, 512):
        eng = ExoticEngine(gp, num_paths=300_000, num_steps=steps, seed=5)
        res = eng.price_barrier(100.0, 100.0, 0.5, 115.0,
                                monitoring="continuous")
        gaps.append(abs(res["price"] - cf))
    assert gaps[1] < gaps[0]


# ─────────────────────────────────────────────────────────────────────────────
# One-touch digitals
# ─────────────────────────────────────────────────────────────────────────────
def test_one_touch_matches_reflection_closed_form():
    from mcos_tpu.ops.exotics import one_touch_bs
    gp = gbm_params(0.25, r=0.05, q=0.01)
    eng = ExoticEngine(gp, num_paths=300_000, num_steps=256, seed=3)
    for barrier in (115.0, 88.0):
        res = eng.price_one_touch(100.0, 0.5, barrier)
        assert abs(res["price"] - res["closed_form_gbm"]) < \
            4 * res["std_error"] + 3e-3
        assert 0.0 <= res["touch_probability"] <= 1.0
    # pay-at-hit >= pay-at-expiry (earlier cash), both vs closed forms
    hit = eng.price_one_touch(100.0, 0.5, 115.0, pay_at_hit=True)
    exp_ = eng.price_one_touch(100.0, 0.5, 115.0)
    assert hit["price"] > exp_["price"]
    assert hit["closed_form_gbm"] == pytest.approx(
        one_touch_bs(100.0, 0.5, 0.05, 0.01, 0.25, 115.0, "up",
                     pay_at_hit=True), rel=1e-12)


def test_one_touch_r0_at_hit_equals_at_expiry():
    from mcos_tpu.ops.exotics import one_touch_bs
    a = one_touch_bs(100.0, 0.5, 0.0, 0.01, 0.25, 115.0, "up", True)
    b = one_touch_bs(100.0, 0.5, 0.0, 0.01, 0.25, 115.0, "up", False)
    assert a == pytest.approx(b, rel=1e-12)


def test_one_touch_started_through():
    from mcos_tpu.ops.exotics import one_touch_bs
    assert one_touch_bs(100.0, 0.5, 0.05, 0.0, 0.2, 95.0, "up") == 1.0


# ─────────────────────────────────────────────────────────────────────────────
# Brownian-bridge monitoring: exact continuous barriers at ANY step count
# ─────────────────────────────────────────────────────────────────────────────
def test_bridge_exact_at_coarse_steps():
    """Bridge survival weights remove the O(1/sqrt(n)) discretization bias
    entirely under GBM: at a COARSE grid (32 steps/yr on a 6-month option,
    i.e. 16 steps) the bridge MC must sit on the Reiner-Rubinstein price
    within MC noise, where discrete monitoring is off by ~10x the stderr."""
    from mcos_tpu.ops.exotics import barrier_bs
    gp = gbm_params(0.25, r=0.05, q=0.01)
    eng = ExoticEngine(gp, num_paths=300_000, num_steps=32, seed=7)
    for B, c, d in [(115.0, True, "up"), (88.0, False, "down")]:
        cf = barrier_bs(100.0, 100.0, 0.5, 0.05, 0.01, 0.25, B, c,
                        "out", d)
        br = eng.price_barrier(100.0, 100.0, 0.5, B, is_call=c,
                               monitoring="bridge")
        disc = eng.price_barrier(100.0, 100.0, 0.5, B, is_call=c)
        assert abs(br["price"] - cf) < 4 * br["std_error"] + 1e-3
        assert abs(br["price"] - cf) < 0.2 * abs(disc["price"] - cf)
        assert br["monitoring"] == "bridge"


def test_bridge_beats_bgk_at_coarse_steps():
    """BGK kills the sqrt(dt) term but keeps an O(dt) remainder; the bridge
    has none. At 16 effective steps the bridge gap must not exceed the BGK
    gap (both vs the continuous closed form)."""
    from mcos_tpu.ops.exotics import barrier_bs
    gp = gbm_params(0.25, r=0.05, q=0.01)
    eng = ExoticEngine(gp, num_paths=300_000, num_steps=32, seed=11)
    cf = barrier_bs(100.0, 100.0, 0.5, 0.05, 0.01, 0.25, 112.0, True,
                    "out", "up")
    br = eng.price_barrier(100.0, 100.0, 0.5, 112.0, monitoring="bridge")
    bgk = eng.price_barrier(100.0, 100.0, 0.5, 112.0,
                            monitoring="continuous")
    assert abs(br["price"] - cf) < abs(bgk["price"] - cf) + \
        2 * br["std_error"]


def test_bridge_in_out_parity_per_path():
    """pay_in + pay_out = vanilla * (surv + 1 - surv) holds per path by
    construction -> the raw MC means satisfy in+out = European exactly
    (same seed, same path set)."""
    gp = gbm_params(0.25, r=0.05, q=0.01)
    # CV off so std_error IS the raw stderr of each leg; the sum's noise
    # is the MC *vanilla* noise, bounded by sigma_in + sigma_out.
    eng = ExoticEngine(gp, num_paths=100_000, num_steps=64, seed=3,
                       use_control_variate=False)
    o = eng.price_barrier(100.0, 100.0, 0.5, 115.0, knock="out",
                          monitoring="bridge")
    i = eng.price_barrier(100.0, 100.0, 0.5, 115.0, knock="in",
                          monitoring="bridge")
    van = float(bs_price(100.0, 100.0, 0.5, 0.05, 0.01, 0.25, True))
    assert i["raw_mc_price"] + o["raw_mc_price"] == pytest.approx(
        van, abs=4 * (i["std_error"] + o["std_error"]) + 1e-3)
    # CV on: each leg is pulled to its own exact mean -> the parity gets
    # TIGHTER, not looser.
    cv = ExoticEngine(gp, num_paths=100_000, num_steps=64, seed=3)
    ocv = cv.price_barrier(100.0, 100.0, 0.5, 115.0, knock="out",
                           monitoring="bridge")
    icv = cv.price_barrier(100.0, 100.0, 0.5, 115.0, knock="in",
                           monitoring="bridge")
    assert icv["price"] + ocv["price"] == pytest.approx(van, abs=0.02)


def test_bridge_companion_cv_reduces_variance():
    """The bridge-weighted companion leg's continuous expectation is the
    exact Reiner-Rubinstein price -> a valid, strongly-correlated CV."""
    gp = gbm_params(0.25, r=0.05, q=0.01)
    cv = ExoticEngine(gp, num_paths=100_000, num_steps=64, seed=3)
    raw = ExoticEngine(gp, num_paths=100_000, num_steps=64, seed=3,
                       use_control_variate=False)
    a = cv.price_barrier(100.0, 100.0, 0.5, 120.0, monitoring="bridge")
    b = raw.price_barrier(100.0, 100.0, 0.5, 120.0, monitoring="bridge")
    # GBM limit: companion == SVJ leg, CV collapses the variance entirely
    assert a["std_error"] < 0.05 * b["std_error"]
    assert abs(a["price"] - b["price"]) < 4 * b["std_error"]


def test_bridge_cv_unbiased_under_svj():
    """Under full SVJ the companion is correlated but not identical; the
    CV-adjusted bridge price must agree with the raw bridge MC (unbiased),
    and the fitted-beta CV can only shrink the stderr (Rao: the optimal
    coefficient never increases variance — the cut is modest here because
    xi=0.4 + jumps decorrelate the constant-vol companion)."""
    p = SVJParams(kappa=2.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.05,
                  lambda_j=0.4, mu_j=-0.08, sigma_j=0.12, r=0.05, q=0.01)
    cv = ExoticEngine(p, num_paths=200_000, num_steps=64, seed=9)
    raw = ExoticEngine(p, num_paths=200_000, num_steps=64, seed=9,
                       use_control_variate=False)
    a = cv.price_barrier(100.0, 100.0, 0.5, 118.0, monitoring="bridge")
    b = raw.price_barrier(100.0, 100.0, 0.5, 118.0, monitoring="bridge")
    assert abs(a["price"] - b["price"]) < 4 * b["std_error"]
    assert a["std_error"] <= 1.005 * b["std_error"]


def test_one_touch_bridge_matches_reflection_and_rao_blackwellizes():
    """Bridge touch probability = 1 - prod(bridge survivals): matches the
    reflection-principle closed form at a coarse grid, with stderr no
    larger than the indicator estimator's (Rao-Blackwell)."""
    gp = gbm_params(0.25, r=0.05, q=0.01)
    eng = ExoticEngine(gp, num_paths=300_000, num_steps=32, seed=5)
    for barrier in (115.0, 88.0):
        br = eng.price_one_touch(100.0, 0.5, barrier, monitoring="bridge")
        ind = eng.price_one_touch(100.0, 0.5, barrier,
                                  monitoring="continuous")
        assert abs(br["price"] - br["closed_form_gbm"]) < \
            4 * br["std_error"] + 1e-3
        assert br["std_error"] <= ind["std_error"] * 1.05
        assert 0.0 <= br["touch_probability"] <= 1.0


def test_bridge_ad_barrier_greeks_match_rr_derivatives():
    """The smooth bridge weight restores a valid pathwise derivative for
    barriers: ONE jax.grad pass must reproduce f64 central differences of
    the Reiner-Rubinstein closed form in the GBM limit (delta, vega per
    vol point, rho)."""
    from mcos_tpu.ops.exotics import barrier_bs
    gp = gbm_params(0.25, r=0.05, q=0.01)
    eng = ExoticEngine(gp, num_paths=200_000, num_steps=64, seed=3)
    for B, d in [(120.0, "up"), (85.0, "down")]:
        g = eng.greeks(100.0, 100.0, 0.5, kind="barrier", barrier=B,
                       monitoring="bridge")
        assert g["method"] == "pathwise_ad_bridge"

        def f(s=100.0, sig=0.25, r=0.05):
            return barrier_bs(s, 100.0, 0.5, r, 0.01, sig, B, True,
                              "out", d)
        d_fd = (f(s=100.5) - f(s=99.5)) / 1.0
        v_fd = (f(sig=0.251) - f(sig=0.249)) / 0.002
        r_fd = (f(r=0.0501) - f(r=0.0499)) / 0.0002
        assert g["price"] == pytest.approx(f(), rel=0.02)
        assert g["delta"] == pytest.approx(d_fd, rel=0.08, abs=2e-3)
        assert g["vega"] == pytest.approx(v_fd, rel=0.05, abs=0.05)
        assert g["rho"] == pytest.approx(r_fd, rel=0.05, abs=0.05)


def test_bridge_ad_one_touch_delta():
    """One-touch bridge AD delta vs f64 FD of the reflection closed form
    (one_touch_bs returns the discounted pay-at-expiry price)."""
    from mcos_tpu.ops.exotics import one_touch_bs
    gp = gbm_params(0.25, r=0.05, q=0.01)
    eng = ExoticEngine(gp, num_paths=200_000, num_steps=64, seed=3)
    g = eng.greeks(100.0, 0.0, 0.5, kind="one_touch", barrier=115.0,
                   monitoring="bridge")

    def f(s):
        return one_touch_bs(s, 0.5, 0.05, 0.01, 0.25, 115.0, "up", False)
    d_fd = (f(100.5) - f(99.5)) / 1.0
    assert g["price"] == pytest.approx(f(100.0), rel=0.02)
    assert g["delta"] == pytest.approx(d_fd, rel=0.05, abs=1e-3)
    assert np.isfinite(g["vega"]) and np.isfinite(g["rho"])
