"""2-D ADI Heston PDE engine vs the COS oracle / BS / LSM.

The third independent numerical route to the flagship model (MC, COS, now
a deterministic (x, v) finite-difference grid); three methods agreeing is
the strongest internal consistency argument the framework can make.
"""

import numpy as np
import pytest

from mcos_tpu.engine.pde import HestonPDEEngine
from mcos_tpu.models.params import SVJParams
from mcos_tpu.ops.bs import bs_price
from mcos_tpu.ops.cos_pricer import cos_price, heston_price

HESTON = SVJParams(kappa=3.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04,
                   lambda_j=0.0)


def test_adi_matches_cos_european():
    eng = HestonPDEEngine(HESTON)
    for K, T, is_call in [(100.0, 0.5, True), (110.0, 0.5, True),
                          (90.0, 0.25, True), (100.0, 1.0, True),
                          (100.0, 0.5, False), (95.0, 0.5, False)]:
        got = eng.price(100.0, K, T, is_call=is_call)["price"]
        exact = float(heston_price(HESTON, 100.0, [K], T, is_call)[0])
        assert got == pytest.approx(exact, abs=0.015), (K, T, is_call)


def test_adi_feller_violating_regime():
    """kappa=1, theta=0.09, xi=1 (2*kappa*theta < xi^2): the v=0 edge is
    attainable; the degenerate-PDE edge row must keep the solve accurate."""
    p = SVJParams(kappa=1.0, theta=0.09, xi=1.0, rho=-0.5, v0=0.09,
                  lambda_j=0.0)
    eng = HestonPDEEngine(p)
    for K, T in [(100.0, 0.5), (120.0, 0.5), (100.0, 0.1)]:
        got = eng.price(100.0, K, T, is_call=True)["price"]
        exact = float(heston_price(p, 100.0, [K], T, True)[0])
        assert got == pytest.approx(exact, abs=0.03), (K, T)


def test_adi_degenerate_bs():
    """xi -> 0, v0 = theta freezes the variance: the 2-D solve must
    reproduce closed-form Black-Scholes."""
    p = SVJParams(kappa=3.0, theta=0.04, xi=1e-4, rho=0.0, v0=0.04,
                  lambda_j=0.0)
    eng = HestonPDEEngine(p)
    got = eng.price(100.0, 100.0, 0.5, is_call=True)["price"]
    exact = float(bs_price(100.0, 100.0, 0.5, p.r, p.q, 0.2, True))
    assert got == pytest.approx(exact, abs=0.01)


def test_adi_put_call_parity():
    eng = HestonPDEEngine(HESTON)
    c = eng.price(100.0, 100.0, 0.5, is_call=True)["price"]
    p = eng.price(100.0, 100.0, 0.5, is_call=False)["price"]
    par = 100.0 * np.exp(-HESTON.q * 0.5) - 100.0 * np.exp(-HESTON.r * 0.5)
    assert c - p == pytest.approx(par, abs=0.01)


def test_adi_delta_gamma_match_cos_fd():
    eng = HestonPDEEngine(HESTON)
    res = eng.price(100.0, 100.0, 0.5, is_call=True)
    h = 0.5
    pu = float(heston_price(HESTON, 100.0 + h, [100.0], 0.5, True)[0])
    pd = float(heston_price(HESTON, 100.0 - h, [100.0], 0.5, True)[0])
    p0 = float(heston_price(HESTON, 100.0, [100.0], 0.5, True)[0])
    assert res["delta"] == pytest.approx((pu - pd) / (2 * h), abs=2e-3)
    assert res["gamma"] == pytest.approx((pu - 2 * p0 + pd) / h**2,
                                         rel=0.05)


def test_adi_douglas_close_to_cs():
    cs = HestonPDEEngine(HESTON).price(100.0, 100.0, 0.5)["price"]
    dg = HestonPDEEngine(HESTON, scheme="douglas").price(
        100.0, 100.0, 0.5)["price"]
    assert dg == pytest.approx(cs, abs=0.02)


def test_adi_american_put_bracket():
    """American ADI put: above the European COS price, above intrinsic,
    and within MC noise of the independent LSM estimate."""
    from mcos_tpu.engine.american import AmericanEngine

    eng = HestonPDEEngine(HESTON)
    am = eng.price(90.0, 100.0, 0.5, is_call=False, american=True)["price"]
    eu = float(heston_price(HESTON, 90.0, [100.0], 0.5, False)[0])
    assert am > eu
    assert am >= 10.0  # intrinsic
    lsm = AmericanEngine(HESTON, num_paths=100_000, num_steps=64,
                         seed=3).price(90.0, 100.0, 0.5, is_call=False)
    # LSM is a (slightly low-biased) MC estimate; the PDE is deterministic.
    assert abs(am - lsm["price"]) < 5 * lsm["std_error"] + 0.05 * am


def test_adi_rejects_bad_scheme():
    with pytest.raises(ValueError, match="scheme"):
        HestonPDEEngine(HESTON, scheme="euler")


# ── Bates/SVJ PIDE: the jump integral as one MXU matmul per step ──────────

SVJ = SVJParams()  # lam=1, mu_J=-0.05, sig_J=0.10 on the HESTON diffusion


def test_pide_matches_cos_full_svj():
    """lambda_j > 0 turns the solve into the Bates PIDE; the COS pricer
    with the full SVJ CF is EXACT for this model — the strongest oracle
    the PDE route has. Tolerance matches the pure-Heston rows (the jump
    stage adds no visible error at n_t=128)."""
    eng = HestonPDEEngine(SVJ)
    for K, T, is_call in [(100.0, 0.5, True), (110.0, 0.5, True),
                          (90.0, 0.25, True), (100.0, 1.0, True),
                          (100.0, 0.5, False), (95.0, 0.5, False)]:
        got = eng.price(100.0, K, T, is_call=is_call)["price"]
        exact = float(cos_price(SVJ, 100.0, [K], T, is_call)[0])
        assert got == pytest.approx(exact, abs=0.015), (K, T, is_call)


def test_pide_heavy_jumps_feller_violating():
    """lam=3, mu_J=-0.10, sig_J=0.20 on a Feller-violating diffusion:
    jump mass is ~35% of total variance and the v=0 edge is attainable."""
    p = SVJParams(kappa=1.0, theta=0.09, xi=1.0, rho=-0.5, v0=0.09,
                  lambda_j=3.0, mu_j=-0.10, sigma_j=0.20)
    eng = HestonPDEEngine(p)
    for K, T in [(100.0, 0.5), (120.0, 0.5), (80.0, 0.5), (100.0, 0.1)]:
        got = eng.price(100.0, K, T, is_call=True)["price"]
        exact = float(cos_price(p, 100.0, [K], T, True)[0])
        assert got == pytest.approx(exact, abs=0.03), (K, T)


def test_pide_lambda_continuity():
    """lam -> 0 must land on the diffusion-only branch: the jump code
    path (compensated drift + matmul + tails) vanishes smoothly."""
    a = HestonPDEEngine(SVJParams(lambda_j=0.0)).price(
        100.0, 100.0, 0.5)["price"]
    b = HestonPDEEngine(SVJParams(lambda_j=1e-8)).price(
        100.0, 100.0, 0.5)["price"]
    assert a == pytest.approx(b, abs=1e-5)


def test_pide_american_put_bracket():
    """American put under FULL SVJ: above the European COS price, above
    intrinsic, and within MC noise of the independent LSM estimate (the
    only other American-under-jumps route in the framework)."""
    from mcos_tpu.engine.american import AmericanEngine

    eng = HestonPDEEngine(SVJ)
    am = eng.price(90.0, 100.0, 0.5, is_call=False, american=True)["price"]
    eu = float(cos_price(SVJ, 90.0, [100.0], 0.5, False)[0])
    assert am > eu
    assert am >= 10.0
    lsm = AmericanEngine(SVJ, num_paths=100_000, num_steps=64,
                         seed=3).price(90.0, 100.0, 0.5, is_call=False)
    assert abs(am - lsm["price"]) < 5 * lsm["std_error"] + 0.05 * am


def test_pide_barrier_jump_overshoot():
    """KO barriers under jumps: the absorbing edge plus the tail term
    (jump mass landing beyond the barrier pays the knock-out value) —
    far barrier reproduces the vanilla, tight barrier is far below it,
    and KO <= vanilla structurally."""
    eng = HestonPDEEngine(SVJ)
    van = eng.price(100.0, 100.0, 0.5, True)["price"]
    far = eng.price_barrier(100.0, 100.0, 0.5, 300.0, True,
                            knock="out", direction="up")["price"]
    tight = eng.price_barrier(100.0, 100.0, 0.5, 115.0, True,
                              knock="out", direction="up")["price"]
    assert far == pytest.approx(van, abs=0.02)
    assert tight < 0.5 * van


def test_api_pde_endpoint_modes():
    from mcos_tpu.api.server import handle_pde

    # Heston 2-D American with a COS European oracle cross-check.
    eur = handle_pde({"spot": 100.0, "strike": 100.0, "T": 0.5,
                      "with_oracle": True, "params": {"lambda_j": 0.0}})
    assert eur["cos_oracle"]["abs_error"] < 0.02
    am = handle_pde({"spot": 90.0, "strike": 100.0, "T": 0.5,
                     "is_call": False, "american": True,
                     "params": {"lambda_j": 0.0}})
    assert am["price"] >= 10.0  # intrinsic floor via projection
    # BS 1-D with the exercise boundary.
    bs = handle_pde({"spot": 90.0, "strike": 100.0, "T": 0.5,
                     "is_call": False, "model": "bs", "american": True,
                     "with_boundary": True})
    assert len(bs["exercise_boundary"]["t"]) == bs["n_t"]
    # Jumps route through the Bates PIDE; the oracle is the exact
    # full-SVJ COS price.
    pide = handle_pde({"spot": 100.0, "strike": 100.0, "T": 0.5,
                       "with_oracle": True, "params": {"lambda_j": 1.0}})
    assert "pide" in pide["method"]
    assert pide["cos_oracle"]["abs_error"] < 0.02


def test_adi_vega_matches_cos_fd():
    """The grid's v-axis gradient is dP/dv0; pin it against a central FD
    of the COS oracle in v0 (conventions match engine/greeks.py)."""
    eng = HestonPDEEngine(HESTON)
    res = eng.price(100.0, 100.0, 0.5, is_call=True)
    h = 0.004
    pu = float(heston_price(HESTON.replace(v0=0.04 + h), 100.0, [100.0],
                            0.5, True)[0])
    pd = float(heston_price(HESTON.replace(v0=0.04 - h), 100.0, [100.0],
                            0.5, True)[0])
    fd = (pu - pd) / (2 * h)
    assert res["ad_vega_v0"] == pytest.approx(fd, rel=0.03)
    assert res["vega_per_vol_point"] == pytest.approx(fd * 2 * 0.2,
                                                     rel=0.03)


# ── Barrier ADI: absorbing-edge knock-outs ──────────────────────────────


def test_adi_barrier_gbm_matches_reiner_rubinstein():
    """xi→0 GBM limit: the absorbing-edge grid must reproduce the
    continuous Reiner-Rubinstein closed form (up-and-out and
    down-and-out)."""
    from mcos_tpu.ops.exotics import barrier_bs

    p = SVJParams(kappa=3.0, theta=0.0625, xi=1e-4, rho=0.0, v0=0.0625,
                  lambda_j=0.0, r=0.05, q=0.01)
    eng = HestonPDEEngine(p)
    uo = eng.price_barrier(100.0, 100.0, 0.5, 125.0, True, "out", "up")
    cf = barrier_bs(100.0, 100.0, 0.5, 0.05, 0.01, 0.25, 125.0, True,
                    "out", "up")
    assert uo["price"] == pytest.approx(cf, abs=0.02)
    do = eng.price_barrier(100.0, 100.0, 0.5, 80.0, True, "out", "down")
    cf_d = barrier_bs(100.0, 100.0, 0.5, 0.05, 0.01, 0.25, 80.0, True,
                      "out", "down")
    assert do["price"] == pytest.approx(cf_d, abs=0.02)


def test_adi_double_barrier_gbm_matches_corridor_oracle():
    from mcos_tpu.ops.exotics import double_barrier_bs

    p = SVJParams(kappa=3.0, theta=0.09, xi=1e-4, rho=0.0, v0=0.09,
                  lambda_j=0.0, r=0.05, q=0.01)
    eng = HestonPDEEngine(p)
    ko = eng.price_barrier(100.0, 100.0, 0.5, 125.0, True, "out",
                           barrier_lo=85.0)
    cf = double_barrier_bs(100.0, 100.0, 0.5, 0.05, 0.01, 0.3, 85.0,
                           125.0)
    assert ko["price"] == pytest.approx(cf, abs=0.02)


def test_adi_barrier_heston_cross_checks_bridge_mc():
    """THE headline check: continuous KO under FULL Heston priced two
    independent ways — absorbing-edge ADI grid vs bridge-weighted MC
    (ExoticEngine, λ=0).

    The grid also QUANTIFIES the bridge's known approximation under
    stochastic vol: the survival weight freezes the pre-step variance
    over each interval (exact under GBM, O(dt)-biased when v moves), so
    the MC must converge to the deterministic grid as steps refine —
    measured 4.09 (64 steps) → 4.17 (256) → 4.19 (1024) against the
    grid's 4.198 on this contract. Pin the direction AND the limit."""
    from mcos_tpu.engine.exotics import ExoticEngine

    eng = HestonPDEEngine(HESTON)
    adi = eng.price_barrier(100.0, 100.0, 0.5, 120.0, True, "out",
                            "up")["price"]

    def mc(steps):
        return ExoticEngine(HESTON, num_paths=100_000, num_steps=steps,
                            seed=11).price_barrier(
            100.0, 100.0, 0.5, 120.0, is_call=True, knock="out",
            direction="up", monitoring="bridge")

    coarse, fine = mc(64), mc(512)
    # Bias shrinks with refinement...
    assert abs(adi - fine["price"]) < abs(adi - coarse["price"])
    # ...and the refined MC lands on the grid within noise + grid error.
    assert abs(adi - fine["price"]) < 4 * fine["std_error"] + 0.01 * adi


def test_adi_barrier_parity_and_rebates():
    eng = HestonPDEEngine(HESTON)
    ki = eng.price_barrier(100.0, 100.0, 0.5, 120.0, True, "in", "up")
    # Parity route reports its own decomposition.
    assert ki["price"] == pytest.approx(ki["vanilla"] - ki["knock_out"],
                                        abs=1e-9)
    ko0 = eng.price_barrier(100.0, 100.0, 0.5, 120.0, True, "out", "up")
    ko_r = eng.price_barrier(100.0, 100.0, 0.5, 120.0, True, "out", "up",
                             rebate=5.0)
    ko_rh = eng.price_barrier(100.0, 100.0, 0.5, 120.0, True, "out", "up",
                              rebate=5.0, rebate_at_hit=True)
    assert ko_r["price"] > ko0["price"]          # rebate adds value
    assert ko_rh["price"] >= ko_r["price"]       # at-hit pays earlier (r>0)


def test_adi_barrier_validation():
    eng = HestonPDEEngine(HESTON)
    with pytest.raises(ValueError, match="spot < barrier"):
        eng.price_barrier(130.0, 100.0, 0.5, 120.0, True, "out", "up")
    with pytest.raises(ValueError, match="rebate"):
        eng.price_barrier(100.0, 100.0, 0.5, 120.0, True, "in", "up",
                          rebate=1.0)
    with pytest.raises(ValueError, match="inside"):
        eng.price_barrier(80.0, 100.0, 0.5, 120.0, True, "out",
                          barrier_lo=85.0)


# ── Properties: random Heston parameterizations ─────────────────────────

from hypothesis import given, settings, strategies as st  # noqa: E402

h_kappa = st.floats(0.5, 6.0)
h_theta = st.floats(0.01, 0.25)
h_xi = st.floats(0.05, 1.0)
h_rho = st.floats(-0.9, 0.2)
h_v0 = st.floats(0.01, 0.25)


@settings(max_examples=8, deadline=None)
@given(h_kappa, h_theta, h_xi, h_rho, h_v0)
def test_property_adi_matches_cos(kappa, theta, xi, rho, v0):
    """Random Heston parameterizations: the grid stays on the COS oracle
    (one compile — only traced floats vary across examples)."""
    p = SVJParams(kappa=kappa, theta=theta, xi=xi, rho=rho, v0=v0,
                  lambda_j=0.0)
    got = HestonPDEEngine(p).price(100.0, 105.0, 0.5)["price"]
    exact = float(heston_price(p, 100.0, [105.0], 0.5, True)[0])
    assert abs(got - exact) < max(0.04, 4e-3 * exact)


@settings(max_examples=6, deadline=None)
@given(h_xi, h_rho, h_v0)
def test_property_adi_barrier_ordering(xi, rho, v0):
    """For every parameterization: KO <= vanilla, KO widens as the barrier
    moves away, and KO + KI == vanilla by construction."""
    p = SVJParams(kappa=3.0, theta=0.06, xi=xi, rho=rho, v0=v0,
                  lambda_j=0.0)
    eng = HestonPDEEngine(p)
    van = eng.price(100.0, 100.0, 0.5)["price"]
    ko_near = eng.price_barrier(100.0, 100.0, 0.5, 115.0)["price"]
    ko_far = eng.price_barrier(100.0, 100.0, 0.5, 140.0)["price"]
    assert ko_near <= ko_far + 5e-3
    assert ko_far <= van + 5e-3


def test_adi_exercise_boundary_surface():
    """S*(t, v) under full Heston: the put boundary approaches K near
    expiry (r > q here), decreases in variance (higher vol -> exercise
    deeper ITM), and its v0 slice matches the 1-D CN boundary in the
    frozen-vol limit."""
    from mcos_tpu.engine.pde import PDEEngine

    eng = HestonPDEEngine(HESTON, n_t=64)
    bd = eng.exercise_boundary(90.0, 100.0, 0.5, is_call=False)
    surf = np.asarray(bd["s_star"])            # (n_t, n_v)
    sl = np.asarray(bd["s_star_at_v0"])
    assert surf.shape == (64, eng.n_v)
    # Near-expiry limit: boundary -> K (within one grid cell + limit gap).
    assert sl[-1] > 95.0
    # Monotone in v where defined (compare low-v vs high-v rows at mid-T).
    row = surf[len(surf) // 2]
    lo_v = row[2:10][np.isfinite(row[2:10])]
    hi_v = row[-30:][np.isfinite(row[-30:])]
    if len(lo_v) and len(hi_v):
        assert lo_v.mean() > hi_v.mean()
    # Frozen-vol limit vs the 1-D CN boundary.
    pfr = SVJParams(kappa=3.0, theta=0.04, xi=1e-4, rho=0.0, v0=0.04,
                    lambda_j=0.0)
    b2 = HestonPDEEngine(pfr, n_t=64).exercise_boundary(
        90.0, 100.0, 0.5, is_call=False)
    b1 = PDEEngine(sigma=0.2, r=pfr.r, q=pfr.q,
                   n_t=64).exercise_boundary(90.0, 100.0, 0.5, False)
    s2 = np.asarray(b2["s_star_at_v0"])
    s1 = np.interp(b2["t"], b1["t"], np.asarray(b1["s_star"]))
    both = np.isfinite(s1) & np.isfinite(s2)
    assert both.sum() > 20
    assert np.nanmax(np.abs(s1[both] - s2[both])) < 3.0  # ~3% of K


def test_api_pde_heston_boundary():
    from mcos_tpu.api.server import handle_pde

    out = handle_pde({"spot": 90.0, "strike": 100.0, "T": 0.5,
                      "is_call": False, "american": True,
                      "with_boundary": True, "n_t": 32,
                      "params": {"lambda_j": 0.0}})
    bd = out["exercise_boundary"]
    assert len(bd["t"]) == 32 and len(bd["v"]) == out["n_v"]
    assert len(bd["s_star"]) == 32


def test_pide_jump_stress_regime_guarded():
    """Advisor r3: lambda_j=20, T=30 returned NaN (the explicit IMEX jump
    stage ran at lam*dt ~ 4.7, far past its stability region) and
    lambda_j=5, T=30 silently drifted 2.6% of spot (under-resolved
    midpoint cell-mass quadrature). The engine now auto-sub-steps to
    lam*dt <= 0.5, refines x to dx <= 0.75*sigma_j, and applies the
    delta^2/24 quadrature correction (O(dx^4))."""
    spot = 100.0
    p5 = SVJParams(kappa=2.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04,
                   lambda_j=5.0, mu_j=-0.05, sigma_j=0.10)
    out = HestonPDEEngine(p5).price(spot, 100.0, 30.0, is_call=True)
    exact = float(cos_price(p5, spot, [100.0], 30.0, True)[0])
    assert np.isfinite(out["price"])
    assert abs(out["price"] - exact) / spot < 6e-3     # was 2.6e-2
    assert out["n_t"] >= 2 * 5 * 30                    # sub-stepped

    p20 = SVJParams(kappa=2.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04,
                    lambda_j=20.0, mu_j=-0.05, sigma_j=0.10)
    out20 = HestonPDEEngine(p20).price(spot, 100.0, 30.0, is_call=True)
    exact20 = float(cos_price(p20, spot, [100.0], 30.0, True)[0])
    assert np.isfinite(out20["price"])                 # was NaN
    assert abs(out20["price"] - exact20) / spot < 2e-2
    assert out20["n_x"] > 201                          # x-refined


def test_pide_sigma_j_zero_rejected():
    """sigma_j == 0 with lambda_j > 0 has no density for the cell-mass
    quadrature to integrate: engine raises ValueError, API maps to 400
    (advisor r3 — previously flowed into a host-side division by zero)."""
    from mcos_tpu.api.server import ApiError, handle_pde

    p = SVJParams(lambda_j=1.0, mu_j=-0.05, sigma_j=0.0)
    with pytest.raises(ValueError, match="sigma_j"):
        HestonPDEEngine(p).price(100.0, 100.0, 0.5)
    with pytest.raises(ApiError) as ei:
        handle_pde({"spot": 100.0, "strike": 100.0, "T": 0.5,
                    "params": {"lambda_j": 1.0, "sigma_j": 0.0}})
    assert ei.value.status == 400
    # Negative sigma_j is rejected at the schema layer for every route.
    from mcos_tpu.api.validation import ValidationError

    from mcos_tpu.api import schemas
    with pytest.raises(ValidationError):
        schemas.SVJParamsRequest(sigma_j=-0.1)
