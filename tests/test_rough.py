"""Rough Bergomi: covariance closed forms, BS limits, estimator agreement,
AD Greeks, and the rough ATM-skew power law.

Oracles: brute-force quadrature for the Volterra covariance; Black-Scholes
in the eta -> 0 limit; estimator cross-validation (conditional vs plain);
the t^{2H} variance law of the Riemann-Liouville fBM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.integrate import quad

from mcos_tpu.engine.rough import RoughBergomiEngine
from mcos_tpu.ops.bs import bs_delta, bs_gamma, bs_price
from mcos_tpu.ops.rough import (RoughBergomiParams, rbergomi_chol,
                                rbergomi_conditional_payoffs, rbergomi_core,
                                rbergomi_terminal, volterra_cov,
                                volterra_increment_cov)

H = 0.07
FULL = RoughBergomiParams(xi=0.04, eta=1.9, rho=-0.9, hurst=H)


# ─────────────────────────────────────────────────────────────────────────────
# Covariance closed forms
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("s,t", [(0.3, 1.0), (0.5, 0.5), (0.9, 1.0),
                                 (0.1, 2.0), (1.7, 0.2)])
def test_volterra_cov_matches_quadrature(s, t):
    g = H - 0.5
    lo = min(s, t)
    brute = 2 * H * quad(lambda u: (t - u) ** g * (s - u) ** g, 0.0, lo,
                         points=[lo], limit=200)[0]
    assert volterra_cov(np.float64(s), np.float64(t), H) == pytest.approx(
        brute, rel=1e-8)


def test_volterra_cov_half_hurst_is_brownian():
    # H = 1/2 ⇒ W~ = W ⇒ C(s, t) = min(s, t).
    s = np.array([0.2, 0.7, 1.3])
    t = np.array([0.5, 0.5, 0.5])
    np.testing.assert_allclose(volterra_cov(s, t, 0.5), np.minimum(s, t),
                               rtol=1e-12)


def test_volterra_variance_power_law():
    t = np.array([0.1, 0.5, 2.0])
    np.testing.assert_allclose(volterra_cov(t, t, H), t ** (2 * H),
                               rtol=1e-12)


def test_increment_cov_matches_quadrature():
    n, T = 8, 1.0
    dt = T / n
    tg = dt * np.arange(1, n + 1)
    cc = volterra_increment_cov(tg, H, dt)
    g = H - 0.5
    for i, j in [(5, 2), (3, 3), (7, 0)]:
        brute = np.sqrt(2 * H) * quad(lambda u: (tg[i] - u) ** g,
                                      tg[j] - dt, tg[j], points=[tg[j]],
                                      limit=200)[0]
        assert cc[i, j] == pytest.approx(brute, rel=1e-8)
    assert cc[2, 5] == 0.0  # future increments are independent


def test_chol_reproduces_covariance():
    L = rbergomi_chol(H, 1.0, 16).astype(np.float64)
    cov = L @ L.T
    t = (1.0 / 16) * np.arange(1, 17)
    np.testing.assert_allclose(cov[:16, :16],
                               volterra_cov(t[:, None], t[None, :], H),
                               atol=1e-6)
    np.testing.assert_allclose(np.diag(cov[16:, 16:]), 1.0 / 16, atol=1e-6)


# ─────────────────────────────────────────────────────────────────────────────
# Simulation law
# ─────────────────────────────────────────────────────────────────────────────
def test_variance_process_is_martingale_in_xi():
    # E[v_t] = xi exactly (lognormal Wick exponential).
    vm, _, i2 = rbergomi_core(FULL, 1.0, jnp.asarray(rbergomi_chol(H, 1.0, 64)),
                              jax.random.key(0), num_paths=40_000,
                              num_steps=64)
    np.testing.assert_allclose(np.asarray(vm), 0.04, rtol=0.05)
    assert float(i2.mean()) == pytest.approx(0.04, rel=0.03)


def test_martingale_terminal_spot():
    T = 0.5
    s = rbergomi_terminal(FULL, 100.0, T, jnp.asarray(rbergomi_chol(H, T, 64)),
                          jax.random.key(1), num_paths=200_000, num_steps=64)
    fwd = float(np.exp((FULL.r - FULL.q) * T)) * 100.0
    mean = float(s.mean())
    se = float(s.std()) / np.sqrt(s.shape[0] * s.shape[1] / 2)
    assert abs(mean - fwd) < 4 * se + 0.05


# ─────────────────────────────────────────────────────────────────────────────
# Pricing oracles
# ─────────────────────────────────────────────────────────────────────────────
def _cond_price(p, spot, Ks, T, n, paths, seed=1):
    L = jnp.asarray(rbergomi_chol(float(p.hurst), T, n))
    pay = rbergomi_conditional_payoffs(p, spot, jnp.asarray(Ks, jnp.float32),
                                       T, L, jax.random.key(seed),
                                       num_paths=paths, num_steps=n,
                                       is_call=True)
    comb = pay.mean(axis=0)
    disc = np.exp(-p.r * T)
    return (disc * np.asarray(comb.mean(axis=0)),
            disc * np.asarray(comb.std(axis=0)) / np.sqrt(comb.shape[0]))


def test_degenerate_rho0_is_exact_bs():
    # eta→0, rho=0: the conditional estimator is deterministic ⇒ exact BS.
    p = RoughBergomiParams(xi=0.04, eta=1e-8, rho=0.0, hurst=H)
    mc, _ = _cond_price(p, 100.0, [90.0, 100.0, 110.0], 0.5, 32, 512)
    for px, k in zip(mc, [90.0, 100.0, 110.0]):
        ref = float(bs_price(100.0, k, 0.5, p.r, p.q, 0.2, True))
        assert px == pytest.approx(ref, abs=2e-3)


def test_degenerate_correlated_within_ci():
    p = RoughBergomiParams(xi=0.04, eta=1e-8, rho=-0.9, hurst=H)
    mc, se = _cond_price(p, 100.0, [95.0, 105.0], 0.5, 32, 100_000)
    for px, s, k in zip(mc, se, [95.0, 105.0]):
        ref = float(bs_price(100.0, k, 0.5, p.r, p.q, 0.2, True))
        assert abs(px - ref) < 4 * s + 5e-3


def test_conditional_matches_plain_estimator():
    T, n = 0.25, 64
    Ks = [90.0, 100.0, 110.0]
    mc_c, se_c = _cond_price(FULL, 100.0, Ks, T, n, 100_000, seed=2)
    st = rbergomi_terminal(FULL, 100.0, T,
                           jnp.asarray(rbergomi_chol(H, T, n)),
                           jax.random.key(3), num_paths=200_000, num_steps=n)
    pays = jnp.maximum(st[..., None] - jnp.asarray(Ks), 0.0).mean(axis=0)
    disc = np.exp(-FULL.r * T)
    mc_p = disc * np.asarray(pays.mean(axis=0))
    se_p = disc * np.asarray(pays.std(axis=0)) / np.sqrt(pays.shape[0])
    sig = np.abs(mc_c - mc_p) / np.hypot(se_c, se_p)
    assert np.all(sig < 4.0), sig


def test_put_call_parity_exact_per_path():
    # The conditional Black payoff satisfies parity path-by-path.
    T, n = 0.5, 32
    L = jnp.asarray(rbergomi_chol(H, T, n))
    kw = dict(num_paths=2_000, num_steps=n)
    c = rbergomi_conditional_payoffs(FULL, 100.0, 100.0, T, L,
                                     jax.random.key(4), is_call=True, **kw)
    p = rbergomi_conditional_payoffs(FULL, 100.0, 100.0, T, L,
                                     jax.random.key(4), is_call=False, **kw)
    _, i1, i2 = rbergomi_core(FULL, T, L, jax.random.key(4), **kw)
    f_eff = 100.0 * jnp.exp((FULL.r - FULL.q) * T + FULL.rho * i1
                            - 0.5 * FULL.rho ** 2 * i2)
    np.testing.assert_allclose(np.asarray(c[..., 0] - p[..., 0]),
                               np.asarray(f_eff) - 100.0, atol=2e-3)


# ─────────────────────────────────────────────────────────────────────────────
# Engine: Greeks by nested AD, smile, skew power law
# ─────────────────────────────────────────────────────────────────────────────
def test_engine_ad_greeks_match_bs_in_degenerate_limit():
    p = RoughBergomiParams(xi=0.04, eta=1e-8, rho=0.0, hurst=H)
    eng = RoughBergomiEngine(p, num_paths=4_096, num_steps=32)
    g = eng.greeks(100.0, 105.0, 0.5)
    assert g["delta"] == pytest.approx(
        float(bs_delta(100, 105, 0.5, p.r, p.q, 0.2, True)), abs=1e-4)
    assert g["gamma"] == pytest.approx(
        float(bs_gamma(100, 105, 0.5, p.r, p.q, 0.2)), abs=1e-4)


def test_engine_ad_delta_gamma_match_crn_fd():
    eng = RoughBergomiEngine(FULL, num_paths=32_768, num_steps=32, seed=5)
    g = eng.greeks(100.0, 100.0, 0.25)
    h = 0.5
    pu = eng.price(100.0 + h, 100.0, 0.25)["price"]
    pm = eng.price(100.0, 100.0, 0.25)["price"]
    pd = eng.price(100.0 - h, 100.0, 0.25)["price"]
    assert g["delta"] == pytest.approx((pu - pd) / (2 * h), abs=2e-3)
    assert g["gamma"] == pytest.approx((pu - 2 * pm + pd) / h**2, abs=2e-3)


def test_smile_is_downward_skewed():
    eng = RoughBergomiEngine(FULL, num_paths=32_768, num_steps=32, seed=6)
    sm = eng.smile(100.0, 0.25, moneyness=[0.9, 1.0, 1.1])
    ivs = sm["implied_vols"]
    assert all(v is not None for v in ivs)
    assert ivs[0] > ivs[1] > ivs[2]      # negative-rho skew


def test_atm_skew_steepens_as_maturity_shrinks():
    # |skew(T1)| / |skew(T2)| ≈ (T1/T2)^{H-1/2} for T1 < T2 — the rough
    # signature (±35% tolerance at MC resolution).
    eng = RoughBergomiEngine(FULL, num_paths=65_536, num_steps=64, seed=7)
    s_short = eng.atm_skew(100.0, 0.1)["skew"]
    s_long = eng.atm_skew(100.0, 0.8)["skew"]
    assert s_short < 0 and s_long < 0
    ratio = s_short / s_long
    expect = (0.1 / 0.8) ** (H - 0.5)
    assert 0.65 * expect < ratio < 1.35 * expect


# ─────────────────────────────────────────────────────────────────────────────
# Path-dependent payoffs under rough vol
# ─────────────────────────────────────────────────────────────────────────────
def _deg_engines():
    from mcos_tpu.engine.exotics import ExoticEngine
    from mcos_tpu.models.params import gbm_params
    p0 = RoughBergomiParams(xi=0.04, eta=1e-8, rho=0.0, r=0.05, q=0.01,
                            hurst=H)
    rb = RoughBergomiEngine(p0, num_paths=131_072, num_steps=64, seed=9)
    # ExoticEngine scales steps by maturity: 128/yr -> 64 at T=0.5, so both
    # engines observe the same grid (the tracker-semantics pin needs that).
    ex = ExoticEngine(gbm_params(0.2, r=0.05, q=0.01), num_paths=262_144,
                      num_steps=128, seed=11)
    return rb, ex


@pytest.mark.parametrize("which", ["asian", "barrier", "lookback"])
def test_rough_exotics_degenerate_match_gbm_engine(which):
    rb, ex = _deg_engines()
    if which == "asian":
        r = rb.price_asian(100.0, 100.0, 0.5)
        g = ex.price_asian(100.0, 100.0, 0.5)
    elif which == "barrier":
        r = rb.price_barrier(100.0, 100.0, 0.5, 120.0)
        g = ex.price_barrier(100.0, 100.0, 0.5, 120.0)
    else:
        r = rb.price_lookback(100.0, 0.5)
        g = ex.price_lookback(100.0, 0.5)
    joint = np.hypot(r["std_error"], max(g["std_error"], 1e-4))
    assert abs(r["price"] - g["price"]) < 4 * joint


def test_rough_barrier_in_out_parity():
    eng = RoughBergomiEngine(FULL, num_paths=65_536, num_steps=64, seed=12)
    van = eng.price(100.0, 100.0, 0.5)["price"]
    uo = eng.price_barrier(100.0, 100.0, 0.5, 130.0, knock="out")
    ui = eng.price_barrier(100.0, 100.0, 0.5, 130.0, knock="in")
    # in + out = vanilla; vanilla comes from the (lower-variance)
    # conditional estimator, the barrier legs from the plain path sheet.
    joint = 4 * np.hypot(uo["std_error"], ui["std_error"]) + 0.02
    assert abs(uo["price"] + ui["price"] - van) < joint


def test_rough_asian_below_vanilla_and_barrier_monotone():
    eng = RoughBergomiEngine(FULL, num_paths=65_536, num_steps=64, seed=13)
    van = eng.price(100.0, 100.0, 0.5)["price"]
    asian = eng.price_asian(100.0, 100.0, 0.5)["price"]
    assert asian < van            # averaging strictly reduces variance
    b_lo = eng.price_barrier(100.0, 100.0, 0.5, 115.0)["price"]
    b_hi = eng.price_barrier(100.0, 100.0, 0.5, 140.0)["price"]
    assert b_lo < b_hi <= van + 0.02   # higher barrier knocks out less


# ─────────────────────────────────────────────────────────────────────────────
# Calibration
# ─────────────────────────────────────────────────────────────────────────────
def test_calibration_recovers_rough_parameters():
    """Fit to a synthetic 2-maturity surface generated from known params:
    the Hurst grid must select the true H (the skew term-structure
    identifies it) and (eta, rho, xi) must land near truth."""
    from mcos_tpu.engine.rough import calibrate_rbergomi

    true = RoughBergomiParams(xi=0.04, eta=1.9, rho=-0.9, r=0.05, q=0.01,
                              hurst=H)
    spot, mats = 100.0, [0.1, 0.5]
    strikes = np.stack([spot * np.linspace(0.92, 1.08, 7) for _ in mats])
    market = np.asarray([
        RoughBergomiEngine(true, num_paths=131_072, num_steps=48,
                           seed=99).price(spot, ks, t)["price"]
        for t, ks in zip(mats, strikes)])

    fit = calibrate_rbergomi(spot, mats, strikes, market, r=0.05, q=0.01,
                             hurst_grid=(H, 0.3), num_paths=8_192,
                             num_steps=48, pop_size=12, iters=25,
                             polish_steps=40)
    assert fit["hurst"] == H                    # grid selects the true H
    assert abs(fit["eta"] - 1.9) < 0.35
    assert abs(fit["rho"] + 0.9) < 0.10
    assert fit["xi"] == pytest.approx(0.04, abs=0.004)
    assert fit["rmse_price"] < 0.05
    assert fit["params"].hurst == H


# ─────────────────────────────────────────────────────────────────────────────
# QMC driving
# ─────────────────────────────────────────────────────────────────────────────
def test_pca_factor_reproduces_covariance():
    A = rbergomi_chol(H, 1.0, 16, transform="pca").astype(np.float64)
    L = rbergomi_chol(H, 1.0, 16).astype(np.float64)
    np.testing.assert_allclose(A @ A.T, L @ L.T, atol=1e-6)


def test_rqmc_price_matches_prng_within_bars():
    Ks = [90.0, 100.0, 110.0]
    prng = RoughBergomiEngine(FULL, num_paths=65_536, num_steps=32, seed=3)
    qmc = RoughBergomiEngine(FULL, num_paths=65_536, num_steps=32, seed=3,
                             use_sobol=True)
    a, b = prng.price(100.0, Ks, 0.25), qmc.price(100.0, Ks, 0.25)
    assert b["estimator"] == "conditional-black+rqmc"
    for x, y, sx, sy in zip(a["price"], b["price"], a["std_error"],
                            b["std_error"]):
        assert abs(x - y) < 4 * np.hypot(sx, sy)
    # ATM: the PCA+Sobol pairing should not be WORSE than PRNG
    assert b["std_error"][1] < 1.5 * a["std_error"][1]


# ─────────────────────────────────────────────────────────────────────────────
# Forward-variance term structure
# ─────────────────────────────────────────────────────────────────────────────
def test_xi_bootstrap_reprices_variance_swaps_exactly():
    from mcos_tpu.ops.rough import (sample_xi_curve,
                                    xi_curve_from_variance_swaps)
    mats = [0.25, 0.5, 1.0, 2.0]
    kv = [0.18, 0.20, 0.22, 0.23]
    edges, vals = xi_curve_from_variance_swaps(mats, kv)
    assert np.all(vals > 0)
    for t, k in zip(mats, kv):
        xi_t = sample_xi_curve(edges, vals, t, 400)
        assert np.sqrt(xi_t.mean()) == pytest.approx(k, abs=2e-4)
    # decreasing total variance is calendar arbitrage → rejected
    with pytest.raises(ValueError):
        xi_curve_from_variance_swaps([0.5, 1.0], [0.30, 0.15])


def test_variance_process_follows_xi_curve():
    from mcos_tpu.ops.rough import (sample_xi_curve,
                                    xi_curve_from_variance_swaps)
    edges, vals = xi_curve_from_variance_swaps([0.25, 1.0], [0.18, 0.22])
    T, n = 1.0, 64
    xi_t = sample_xi_curve(edges, vals, T, n)
    vm, _, _ = rbergomi_core(
        FULL, T, jnp.asarray(rbergomi_chol(H, T, n)), jax.random.key(0),
        num_paths=40_000, num_steps=n, xi_t=jnp.asarray(xi_t))
    np.testing.assert_allclose(np.asarray(vm), xi_t, rtol=0.07)


def test_engine_from_variance_swaps():
    eng = RoughBergomiEngine.from_variance_swaps(
        FULL, [0.25, 0.5, 1.0], [0.18, 0.20, 0.22], num_paths=16_384,
        num_steps=32, seed=3)
    assert eng.variance_swap_strike(1.0) == pytest.approx(0.22, abs=1e-3)
    # flat-curve engine (single quote) must agree with the flat-xi engine
    flat_q = RoughBergomiEngine.from_variance_swaps(
        FULL, [1.0], [0.2], num_paths=16_384, num_steps=32, seed=3)
    flat = RoughBergomiEngine(
        RoughBergomiParams(xi=0.04, eta=FULL.eta, rho=FULL.rho, hurst=H),
        num_paths=16_384, num_steps=32, seed=3)
    a = flat_q.price(100.0, 100.0, 1.0)
    b = flat.price(100.0, 100.0, 1.0)
    assert a["price"] == pytest.approx(b["price"], abs=1e-4)
    g = flat_q.greeks(100.0, 100.0, 1.0)
    assert np.isfinite(g["delta"]) and np.isfinite(g["gamma"])


def test_variance_swap_mc_round_trips_the_curve():
    """Realized variance on the grid must recover the curve's fair strike
    (E[v_t] = xi(t)) up to O(dt) drift terms — flat and bootstrapped."""
    flat = RoughBergomiEngine(FULL, num_paths=65_536, num_steps=64, seed=3)
    out = flat.variance_swap_mc(1.0)
    assert out["fair_vol_strike"] == pytest.approx(out["curve_strike"],
                                                   abs=0.004)
    curved = RoughBergomiEngine.from_variance_swaps(
        FULL, [0.25, 1.0], [0.18, 0.22], num_paths=65_536, num_steps=64,
        seed=3)
    o2 = curved.variance_swap_mc(1.0)
    assert o2["curve_strike"] == pytest.approx(0.22, abs=1e-3)
    assert o2["fair_vol_strike"] == pytest.approx(0.22, abs=0.004)


def test_corridor_variance_swap():
    """Full corridor reduces exactly to the plain variance swap; under the
    leverage effect the down-corridor concentrates realized variance far
    beyond its accrual share while the up-corridor dilutes it."""
    eng = RoughBergomiEngine(FULL, num_paths=65_536, num_steps=64, seed=3)
    full = eng.corridor_variance_swap(100.0, 1.0)
    plain = eng.variance_swap_mc(1.0)
    assert full["fair_variance"] == pytest.approx(plain["fair_variance"],
                                                  rel=1e-6)
    down = eng.corridor_variance_swap(100.0, 1.0, upper=95.0)
    up = eng.corridor_variance_swap(100.0, 1.0, lower=105.0)
    assert down["fair_variance"] > up["fair_variance"]
    assert down["accrual_fraction"] < up["accrual_fraction"]
    # variance per unit accrual time: the crash-concentration statement
    assert (down["fair_variance"] / down["accrual_fraction"]
            > 2.0 * up["fair_variance"] / up["accrual_fraction"])


def test_conditional_factor_reproduces_covariance():
    """The conditional (dW-exact + rank-k residual + diagonal tail)
    factorization must reproduce the dW block, the W~/dW cross-covariance,
    AND every Var[W~_t] exactly; only off-diagonal residual correlations
    are rank-truncated."""
    from mcos_tpu.ops.rough import (rbergomi_conditional_factor,
                                    volterra_cov, volterra_increment_cov)

    h, T, n, k = 0.07, 0.5, 64, 16
    fac, tail = rbergomi_conditional_factor(h, T, n, rank=k)
    fac = np.asarray(fac, np.float64)
    tail = np.asarray(tail, np.float64)
    assert fac.shape == (2 * n, n + k) and tail.shape == (n,)
    cov = fac @ fac.T
    cov[:n, :n] += np.diag(tail)          # the sampler adds this part
    dt = T / n
    t = dt * np.arange(1, n + 1)
    np.testing.assert_allclose(cov[n:, n:], dt * np.eye(n), atol=1e-7)
    np.testing.assert_allclose(cov[:n, n:],
                               volterra_increment_cov(t, h, dt), atol=1e-6)
    ref_w = volterra_cov(t[:, None], t[None, :], h)
    # Var[W~_t] exact (the Wick-relevant quantity): t^{2H} on the diagonal
    np.testing.assert_allclose(np.diag(cov[:n, :n]), np.diag(ref_w),
                               rtol=1e-5)


def test_conditional_truncated_factor_matches_exact_smile():
    """The long-dated escape hatch from the O(steps^2) matmul: dW sampled
    exactly, W~ regressed on dW with a rank-32 PCA residual + exact
    diagonal tail. Must reprice the whole smile (OTM puts through OTM
    calls — skew-sensitive) within joint MC bands of the exact Cholesky
    sampler at ~half the matmul width. (Naive joint-covariance PCA FAILS
    this — the flat dt-spectrum dW block is what it discards first.)"""
    from mcos_tpu.ops.rough import (RoughBergomiParams, rbergomi_chol,
                                    rbergomi_conditional_factor,
                                    rbergomi_conditional_payoffs)

    p = RoughBergomiParams(xi=0.04, eta=1.9, rho=-0.9, hurst=0.07)
    T, n, paths = 0.5, 256, 65_536
    strikes = jnp.asarray([85.0, 95.0, 100.0, 105.0, 115.0])
    fac, tail = rbergomi_conditional_factor(p.hurst, T, n, rank=32)
    assert fac.shape == (2 * n, n + 32)

    disc = float(np.exp(-p.r * T))
    pay_full = rbergomi_conditional_payoffs(
        p, 100.0, strikes, T, jnp.asarray(rbergomi_chol(p.hurst, T, n)),
        jax.random.key(11), num_paths=paths, num_steps=n,
        is_call=True).mean(axis=0)
    pay_tr = rbergomi_conditional_payoffs(
        p, 100.0, strikes, T, jnp.asarray(fac), jax.random.key(11),
        num_paths=paths, num_steps=n, is_call=True,
        diag_tail=jnp.asarray(tail)).mean(axis=0)
    for i in range(strikes.shape[0]):
        pf = disc * float(pay_full[:, i].mean())
        sf = disc * float(pay_full[:, i].std()) / np.sqrt(paths)
        pt = disc * float(pay_tr[:, i].mean())
        st = disc * float(pay_tr[:, i].std()) / np.sqrt(paths)
        joint = np.hypot(sf, st)
        assert abs(pf - pt) < max(4 * joint, 0.012 * pf), (
            float(strikes[i]), pf, pt)


def test_factor_rank_validation():
    from mcos_tpu.ops.rough import (rbergomi_chol,
                                    rbergomi_conditional_factor)

    with pytest.raises(ValueError):
        rbergomi_chol(0.07, 0.5, 64, transform="cholesky", rank=16)
    with pytest.raises(ValueError):
        rbergomi_chol(0.07, 0.5, 64, transform="conditional")
    with pytest.raises(ValueError):
        rbergomi_conditional_factor(0.07, 0.5, 64, rank=0)


# ─────────────────────────────────────────────────────────────────────────────
# Markovian lift (O(n·m) sampler)
# ─────────────────────────────────────────────────────────────────────────────
def test_lift_variance_marginals_exact():
    """The tail top-up makes every delivered Var[W~_t] exact, so
    E[v_t] = xi must hold at every grid point (Wick compensator with the
    exact t^{2H})."""
    from mcos_tpu.ops.rough import rbergomi_core_lifted, rbergomi_lift

    n, paths = 128, 60_000
    c, d, g, tail = rbergomi_lift(H, 1.0, n)
    vm, _, _ = rbergomi_core_lifted(FULL, 1.0, jax.random.key(2),
                                    c, d, g, tail,
                                    num_paths=paths, num_steps=n)
    vm = np.asarray(vm)
    # Lognormal with log-var up to eta^2 ~ 3.6: the mean estimator is
    # heavy-tailed, so test the pooled average and a loose per-point band.
    assert abs(vm.mean() - FULL.xi) < 0.15 * FULL.xi
    assert np.all(vm > 0.2 * FULL.xi) and np.all(vm < 5.0 * FULL.xi)


def test_lift_tail_shrinks_with_factors():
    """More exponential nodes capture more of the kernel, leaving less
    for the diagonal top-up (sub-dt mass stays — it is incompressible)."""
    from mcos_tpu.ops.rough import rbergomi_lift

    _, _, _, tail8 = rbergomi_lift(H, 1.0, 256, n_factors=8)
    _, _, _, tail24 = rbergomi_lift(H, 1.0, 256, n_factors=24)
    assert tail24.sum() <= tail8.sum() + 1e-9


def test_lift_half_hurst_is_brownian():
    """H = 1/2 degenerates the kernel to a constant: the lift is exactly
    one factor with x = 0, the tail vanishes, and W~ IS the driving BM."""
    from mcos_tpu.ops.rough import rbergomi_lift

    c, d, g, tail = rbergomi_lift(0.5, 1.0, 64)
    assert c.shape == (1,) and abs(float(c[0]) - 1.0) < 1e-6
    assert abs(float(d[0]) - 1.0) < 1e-7 and abs(float(g[0]) - 1.0) < 1e-7
    assert float(np.max(tail)) < 1e-7


def test_lift_prices_match_exact_sampler():
    """The headline pin: lifted vanilla prices vs the exact-covariance
    sampler across the smile, at matched path budgets."""
    from mcos_tpu.ops.rough import rbergomi_lifted_payoffs, rbergomi_lift

    T, n, paths = 0.5, 256, 1 << 16
    strikes = jnp.asarray([85.0, 95.0, 100.0, 105.0, 115.0], jnp.float32)
    disc = float(np.exp(-FULL.r * T))
    chol = jnp.asarray(rbergomi_chol(H, T, n))
    pay_ex = rbergomi_conditional_payoffs(
        FULL, 100.0, strikes, T, chol, jax.random.key(5),
        num_paths=paths, num_steps=n, is_call=True).mean(axis=0)
    c, d, g, tail = rbergomi_lift(H, T, n)
    pay_li = rbergomi_lifted_payoffs(
        FULL, 100.0, strikes, T, jax.random.key(6), c, d, g, tail,
        num_paths=paths, num_steps=n, is_call=True).mean(axis=0)
    for i in range(strikes.shape[0]):
        pe = disc * float(pay_ex[:, i].mean())
        se = disc * float(pay_ex[:, i].std()) / np.sqrt(paths)
        pl_ = disc * float(pay_li[:, i].mean())
        sl = disc * float(pay_li[:, i].std()) / np.sqrt(paths)
        joint = float(np.hypot(se, sl))
        assert abs(pe - pl_) < max(5 * joint, 0.015 * pe), (
            float(strikes[i]), pe, pl_)


def test_lift_engine_routing_and_greeks():
    """sampler='lift' prices within bars of sampler='exact' and its AD
    delta/gamma stay smooth (remat path); 'auto' lifts at >= 512 steps."""
    p = RoughBergomiParams(xi=0.04, eta=1.5, rho=-0.7, hurst=0.1)
    kw = dict(num_paths=1 << 15, num_steps=128, seed=9)
    ex = RoughBergomiEngine(p, sampler="exact", **kw)
    li = RoughBergomiEngine(p, sampler="lift", **kw)
    re_ = ex.price(100.0, 100.0, 0.5)
    rl = li.price(100.0, 100.0, 0.5)
    assert rl["estimator"].endswith("+lift")
    joint = float(np.hypot(re_["std_error"], rl["std_error"]))
    assert abs(re_["price"] - rl["price"]) < max(5 * joint,
                                                 0.02 * re_["price"])
    gl = li.greeks(100.0, 100.0, 0.5)
    assert 0.3 < gl["delta"] < 0.8
    assert gl["gamma"] > 0.0
    assert np.isfinite(gl["d_eta"]) and np.isfinite(gl["vega_xi"])
    # auto: knee at 512 steps
    assert not RoughBergomiEngine(p, num_steps=256)._use_lift()
    assert RoughBergomiEngine(p, num_steps=512)._use_lift()
    assert not RoughBergomiEngine(p, num_steps=512,
                                  use_sobol=True)._use_lift()
    with pytest.raises(ValueError):
        RoughBergomiEngine(p, sampler="nope")


def test_lift_path_stats_match_exact_sampler():
    """Round-5 pin: the lifted path-stats sampler
    (`rbergomi_path_stats_lifted`, the O(n·m) factor scan) reproduces the
    exact-covariance sheet's path-dependent laws — asian mean, running
    max/min, terminal — so asian/barrier/lookback payoffs can ride the
    lift instead of paying the exact sampler's O(n²) matmul."""
    from mcos_tpu.ops.rough import (rbergomi_lift, rbergomi_path_stats,
                                    rbergomi_path_stats_lifted)

    T, n, paths = 0.5, 256, 1 << 14
    chol = jnp.asarray(rbergomi_chol(H, T, n))
    ex = rbergomi_path_stats(FULL, 100.0, T, chol, jax.random.key(7),
                             num_paths=paths, num_steps=n)
    c, d, g, tail = rbergomi_lift(H, T, n)
    li = rbergomi_path_stats_lifted(FULL, 100.0, T, jax.random.key(8),
                                    c, d, g, tail, num_paths=paths,
                                    num_steps=n)
    for k in ("s_terminal", "s_mean", "s_max", "s_min"):
        assert li[k].shape == ex[k].shape == (2, paths)
        assert bool(jnp.all(jnp.isfinite(li[k])))

    def mean_se(pay):
        comb = jnp.mean(pay, axis=0)
        return (float(jnp.mean(comb)),
                float(jnp.std(comb)) / np.sqrt(paths))

    payoffs = {
        "asian_atm": lambda st: jnp.maximum(st["s_mean"] - 100.0, 0.0),
        "lookback_float": lambda st: st["s_terminal"] - st["s_min"],
        "barrier_up_survival": lambda st: (st["s_max"] < 115.0).astype(
            jnp.float32),
        "terminal_otm": lambda st: jnp.maximum(st["s_terminal"] - 110.0,
                                               0.0),
    }
    for name, fn in payoffs.items():
        pe, se = mean_se(fn(ex))
        pl_, sl = mean_se(fn(li))
        joint = float(np.hypot(se, sl))
        assert abs(pe - pl_) < max(5 * joint, 0.02 * abs(pe)), (
            name, pe, pl_, joint)


def test_lift_engine_path_dependent_routing():
    """sampler='lift' asian/barrier/lookback prices sit within joint MC
    bands of sampler='exact' (the engine-level half of the item-4 pin);
    the t_1..t_n observation grid matches between the two samplers."""
    p = RoughBergomiParams(xi=0.04, eta=1.5, rho=-0.7, hurst=0.1)
    kw = dict(num_paths=1 << 14, num_steps=128)
    ex = RoughBergomiEngine(p, sampler="exact", seed=4, **kw)
    li = RoughBergomiEngine(p, sampler="lift", seed=5, **kw)

    for name, call in (
        ("asian", lambda e: e.price_asian(100.0, 100.0, 0.5)),
        ("lookback", lambda e: e.price_lookback(100.0, 0.5)),
        ("barrier", lambda e: e.price_barrier(100.0, 100.0, 0.5, 120.0,
                                              knock="out")),
    ):
        re_ = call(ex)
        rl = call(li)
        joint = float(np.hypot(re_["std_error"], rl["std_error"]))
        assert abs(re_["price"] - rl["price"]) < max(
            5 * joint, 0.03 * re_["price"]), (name, re_, rl)
    # the barrier hit law agrees too (not just the censored payoff)
    hb_e = ex.price_barrier(100.0, 100.0, 0.5, 110.0)["hit_fraction"]
    hb_l = li.price_barrier(100.0, 100.0, 0.5, 110.0)["hit_fraction"]
    assert abs(hb_e - hb_l) < 0.02
