"""Time-dependent SVJ: chained-Riccati CF oracle vs the td MC scan.

The reference's term structure (engine/models.py:88-144) prices each expiry
under its own constant-param model; this module's td dynamics are ONE
consistent process, so the tests pin (a) the CF recursion against the
single-segment Bates CF, (b) the td MC simulator against the td COS oracle
on genuinely time-varying segments — the td analogue of
test_cos_pricer.py::test_mc_matches_cos_full_svj.
"""

import jax
import numpy as np
import pytest

from mcos_tpu.models.params import SVJParams, TermStructureSVJ
from mcos_tpu.ops.cos_pricer import cos_price
from mcos_tpu.ops.simulate import (combine_antithetic, mc_mean_stderr,
                                   simulate_terminal, vanilla_payoff)
from mcos_tpu.ops.tdsvj import (cos_price_td, normalize_segments,
                                segments_from_term_structure,
                                simulate_terminal_td, step_param_arrays)

S, T = 22500.0, 0.25
R, Q = 0.065, 0.012
BASE = SVJParams(kappa=3.0, theta=0.06, xi=0.5, rho=-0.7, v0=0.04,
                 lambda_j=1.5, mu_j=-0.07, sigma_j=0.12, r=R, q=Q)

# A strongly time-varying spec: calm first 40% of the horizon, stressed tail.
SEG_ENDS = np.array([0.10, 0.25])
THETAS = np.array([0.02, 0.09])
XIS = np.array([0.80, 0.30])
LAMS = np.array([3.00, 0.50])


def test_single_segment_reduces_to_bates():
    """One segment with (θ, ξ, λ) = constants must equal cos_price exactly."""
    strikes = np.linspace(0.85, 1.15, 7) * S
    td = cos_price_td(BASE, S, strikes, T, [T], [BASE.theta], [BASE.xi],
                      [BASE.lambda_j])
    const = cos_price(BASE, S, strikes, T, True)
    np.testing.assert_allclose(td, const, rtol=1e-10, atol=1e-8)


def test_constant_multi_segment_reduces_to_bates():
    """Splitting a constant model into 5 segments must not change prices."""
    strikes = np.array([0.9, 1.0, 1.1]) * S
    ends = np.linspace(T / 5, T, 5)
    td = cos_price_td(BASE, S, strikes, T, ends,
                      np.full(5, BASE.theta), np.full(5, BASE.xi),
                      np.full(5, BASE.lambda_j))
    const = cos_price(BASE, S, strikes, T, True)
    np.testing.assert_allclose(td, const, rtol=1e-9)


def test_td_put_call_parity():
    strikes = np.array([0.9, 1.0, 1.1]) * S
    calls = cos_price_td(BASE, S, strikes, T, SEG_ENDS, THETAS, XIS, LAMS,
                         is_call=True)
    puts = cos_price_td(BASE, S, strikes, T, SEG_ENDS, THETAS, XIS, LAMS,
                        is_call=False)
    parity = S * np.exp(-Q * T) - strikes * np.exp(-R * T)
    np.testing.assert_allclose(calls - puts, parity, atol=1e-6 * S)


def test_td_differs_from_any_constant_blend():
    """The td price must NOT equal the constant-param price at either
    segment's levels — i.e. the time dependence is actually active."""
    strike = np.array([S])
    td = cos_price_td(BASE, S, strike, T, SEG_ENDS, THETAS, XIS, LAMS)[0]
    p_early = BASE.replace(theta=0.02, xi=0.8, lambda_j=3.0)
    p_late = BASE.replace(theta=0.09, xi=0.3, lambda_j=0.5)
    early = cos_price(p_early, S, strike, T, True)[0]
    late = cos_price(p_late, S, strike, T, True)[0]
    assert abs(td - early) > 1.0 and abs(td - late) > 1.0
    assert min(early, late) < td < max(early, late)


def test_step_param_arrays_segment_assignment():
    ends, th, xi, lam = normalize_segments(SEG_ENDS, THETAS, XIS, LAMS, T)
    th_t, xi_t, lam_t = step_param_arrays(ends, th, xi, lam, T, 100)
    # Steps 0..39 midpoints < 0.10 (40% of the horizon), steps 40.. after.
    assert np.all(th_t[:39] == 0.02) and np.all(th_t[41:] == 0.09)
    assert np.all(xi_t[:39] == 0.80) and np.all(lam_t[41:] == 0.50)


def test_normalize_segments_validation():
    with pytest.raises(ValueError):
        normalize_segments([0.2, 0.1], [1, 1], [1, 1], [1, 1], T)
    with pytest.raises(ValueError):
        normalize_segments([], [], [], [], T)
    # T beyond the last edge: flat extension.
    ends, *_ = normalize_segments([0.1], [0.04], [0.5], [1.0], 0.5)
    assert ends[-1] == pytest.approx(0.5)


def test_td_scan_constant_params_matches_constant_scan():
    """Constant per-step arrays must reproduce simulate_terminal bit-for-bit
    (same keys, same step math)."""
    key = jax.random.PRNGKey(7)
    n_paths, n_steps = 4096, 64
    s_const, v_const, g_const = simulate_terminal(
        BASE, S, T, key, n_paths, n_steps, antithetic=True, companion=True)
    ones = np.ones(n_steps)
    s_td, v_td, g_td = simulate_terminal_td(
        BASE, ones * BASE.theta, ones * BASE.xi, ones * BASE.lambda_j,
        S, T, key, n_paths, n_steps, antithetic=True, companion=True)
    np.testing.assert_array_equal(np.asarray(s_td), np.asarray(s_const))
    np.testing.assert_array_equal(np.asarray(v_td), np.asarray(v_const))
    np.testing.assert_array_equal(np.asarray(g_td), np.asarray(g_const))


def test_td_mc_matches_td_cos():
    """THE td oracle test: the td MC scan must reproduce the chained-Riccati
    COS price on strongly time-varying segments within MC + Euler bands."""
    strikes = np.array([0.92, 1.0, 1.08], np.float32) * S
    exact = cos_price_td(BASE, S, strikes, T, SEG_ENDS, THETAS, XIS, LAMS)

    ends, th, xi, lam = normalize_segments(SEG_ENDS, THETAS, XIS, LAMS, T)
    n_paths, n_steps = 300_000, 512
    th_t, xi_t, lam_t = step_param_arrays(ends, th, xi, lam, T, n_steps)
    key = jax.random.PRNGKey(11)
    s_fin, _, _ = simulate_terminal_td(
        BASE, th_t, xi_t, lam_t, S, T, key, n_paths, n_steps,
        antithetic=True, companion=False)
    disc = np.exp(-R * T)
    for i, k in enumerate(strikes):
        pay = combine_antithetic(vanilla_payoff(s_fin, k, True))
        mean, se = mc_mean_stderr(pay)
        mc = disc * float(mean)
        tol = 4 * disc * float(se) + 0.0015 * exact[i]
        assert abs(mc - exact[i]) < tol, (
            f"K={k}: MC={mc:.3f} COS={exact[i]:.3f} tol={tol:.3f}")


def test_segments_from_term_structure_strips_forwards():
    """Forward stripping must recover the aggregate curves: Σ θ_s τ_s =
    θ(T)·T (linear quantities) and Σ ξ_s² τ_s = ξ(T)²·T."""
    ts = TermStructureSVJ(theta_curve={0.1: 0.04, 1.0: 0.09},
                          xi_curve={0.1: 0.7, 1.0: 0.5},
                          lambda_curve={0.1: 1.5, 1.0: 1.0})
    T_end = 1.0
    ends, th, xi, lam = segments_from_term_structure(ts, T_end, n_segments=8)
    tau = np.diff(np.concatenate([[0.0], ends]))
    agg_theta = ts._interp(ts.theta_curve, T_end, 0.04)
    agg_xi = ts._interp(ts.xi_curve, T_end, 0.5)
    agg_lam = ts._interp(ts.lambda_curve, T_end, 1.0)
    assert np.sum(th * tau) == pytest.approx(agg_theta * T_end, rel=1e-9)
    assert np.sum(xi**2 * tau) == pytest.approx(agg_xi**2 * T_end, rel=1e-9)
    assert np.sum(lam * tau) == pytest.approx(agg_lam * T_end, rel=1e-9)
    # Short-maturity levels dominate early segments (inverted ξ curve).
    assert xi[0] > xi[-1] and th[0] < th[-1]


def test_segments_from_steeply_inverted_curve_stay_admissible():
    """A curve inverted steeply enough that cumulative ξ²(t)·t decreases has
    NO non-negative instantaneous strip (aggregate-level arbitrage); the
    floors must keep the output admissible rather than emit negative ξ²."""
    ts = TermStructureSVJ(xi_curve={0.1: 1.0, 1.0: 0.4})
    _, _, xi, _ = segments_from_term_structure(ts, 1.0, n_segments=8)
    assert np.all(xi >= 1e-4 - 1e-12) and np.all(np.isfinite(xi))


def test_reset_simulator_degenerate_forward_start_matches_bs():
    """ξ→0, λ=0, θ=v0 ⇒ the td forward start equals the closed-form BS
    forward start (the reference's own degenerate-oracle trick,
    verify.py:29-30, applied to the path-dependent product)."""
    from mcos_tpu.engine.cliquet import forward_start_bs
    from mcos_tpu.engine.termsvj import TDSVJEngine
    from mcos_tpu.models.params import gbm_params

    sigma = 0.2
    p = gbm_params(sigma, r=R, q=Q)
    eng = TDSVJEngine(p, [T], [sigma**2], [1e-4], [0.0],
                      num_paths=200_000, num_steps=128, seed=9)
    t1 = 0.125
    out = eng.price_forward_start(S, t1, T, k=1.0, is_call=True)
    exact = forward_start_bs(out["t1_effective"], T, 1.0, R, Q, sigma, True)
    tol = max(5 * out["std_error"], 3e-4)
    assert abs(out["price"] - exact) < tol, (out["price"], exact, tol)


def test_td_forward_start_differs_from_constant_blend():
    """On strongly time-varying segments the forward start must differ from
    BOTH constant-parameter alternatives a per-maturity swap could offer —
    the number only the consistent model can produce."""
    from mcos_tpu.engine.cliquet import CliquetEngine
    from mcos_tpu.engine.termsvj import TDSVJEngine

    t1, k = 0.1, 1.0
    eng_td = TDSVJEngine(BASE, SEG_ENDS, THETAS, XIS, LAMS,
                         num_paths=200_000, num_steps=200, seed=3)
    td = eng_td.price_forward_start(S, t1, T, k=k)

    outs = []
    for th, xi, lam in ((0.02, 0.8, 3.0), (0.09, 0.3, 0.5)):
        ce = CliquetEngine(BASE.replace(theta=th, xi=xi, lambda_j=lam),
                           num_paths=200_000, steps_per_period=100, seed=3)
        outs.append(ce.price_forward_start(t1, T, k=k))
    # Both engines price the unit-notional performance payoff, so values
    # compare directly. The td price must be distinguishable from EITHER
    # constant-parameter alternative beyond joint MC noise — a per-maturity
    # swap can only ever produce one of those two numbers.
    for o in outs:
        noise = 5 * (td["std_error"] + o["std_error"])
        assert abs(td["price"] - o["price"]) > noise, (
            td["price"], o["price"], noise)


def test_td_varswap_constant_limit_matches_exotics_closed_form():
    """One constant segment ⇒ td fair strike == the CIR closed form."""
    from mcos_tpu.engine.exotics import variance_swap_fair_strike
    from mcos_tpu.ops.tdsvj import td_variance_swap_fair_strike

    ref = variance_swap_fair_strike(BASE, T)
    td = td_variance_swap_fair_strike(
        BASE, [T], [BASE.theta], [BASE.xi], [BASE.lambda_j], T)
    for k in ("fair_variance", "diffusion_leg", "jump_leg"):
        assert td[k] == pytest.approx(ref[k], rel=1e-12), k


def test_td_varswap_mc_roundtrip():
    """The td closed form must match realized variance simulated under the
    td dynamics (Σ dlog² → ∫v dt + ΣJ², discrete-sampling bias O(dt))."""
    from mcos_tpu.engine.termsvj import TDSVJEngine

    eng = TDSVJEngine(BASE, SEG_ENDS, THETAS, XIS, LAMS,
                      num_paths=100_000, num_steps=256, seed=23)
    out = eng.variance_swap(T)
    # 4σ MC band + 1% discretization/drift² allowance.
    tol = 4 * out["mc_std_error"] + 0.01 * out["fair_variance"]
    assert abs(out["mc_fair_variance"] - out["fair_variance"]) < tol, out


def test_td_varswap_segment_additivity():
    """Chained-measure consistency: QV(0,T)·T = QV(0,t₁)·t₁ + (forward leg),
    where the forward leg restarts the recursion at the exact E[v_{t₁}]."""
    from mcos_tpu.ops.tdsvj import td_variance_swap_fair_strike

    t1 = float(SEG_ENDS[0])
    full = td_variance_swap_fair_strike(BASE, SEG_ENDS, THETAS, XIS, LAMS,
                                        T)["fair_variance"] * T
    front = td_variance_swap_fair_strike(
        BASE, SEG_ENDS, THETAS, XIS, LAMS, t1)["fair_variance"] * t1
    # Forward leg: v starts at the exact E[v_{t1}] under segment 1.
    kappa = BASE.kappa
    v_t1 = THETAS[0] + (BASE.v0 - THETAS[0]) * np.exp(-kappa * t1)
    tail = td_variance_swap_fair_strike(
        BASE.replace(v0=float(v_t1)), [T - t1], [THETAS[1]], [XIS[1]],
        [LAMS[1]], T - t1)["fair_variance"] * (T - t1)
    assert full == pytest.approx(front + tail, rel=1e-10)
