"""Mesh-sharded pricing on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcos_tpu.engine.pricer import MonteCarloEngine
from mcos_tpu.models.params import SVJParams, gbm_params
from mcos_tpu.ops.bs import bs_price
from mcos_tpu.parallel import families as pfam
from mcos_tpu.parallel import mesh as pmesh


def test_virtual_device_count():
    assert jax.device_count() == 8


def test_sharded_price_matches_bs_oracle():
    p = gbm_params(0.2, r=0.065, q=0.012)
    m = pmesh.make_mesh()
    res = pmesh.sharded_price(
        p, 22500.0, [22500.0], 0.04, jax.random.key(0),
        mesh=m, num_paths=80_000, num_steps=50,
    )
    ref = float(bs_price(22500.0, 22500.0, 0.04, 0.065, 0.012, 0.2, True))
    assert abs(float(res["price"][0]) - ref) < max(
        3 * float(res["std_error"][0]), 1.0)


def test_sharded_price_svj_matches_single_device():
    svj = SVJParams(kappa=3.0, theta=0.06, xi=0.4, rho=-0.6, v0=0.04,
                    lambda_j=1.0, mu_j=-0.05, sigma_j=0.1)
    m = pmesh.make_mesh()
    res = pmesh.sharded_price(
        svj, 22500.0, [22000.0, 22500.0, 23000.0], 0.25, jax.random.key(1),
        mesh=m, num_paths=80_000, num_steps=64,
    )
    eng = MonteCarloEngine(svj, num_paths=80_000, num_steps=256,  # 256*0.25=64
                           use_sobol=False, seed=11)
    single = eng.price_batch(22500.0, [22000.0, 22500.0, 23000.0], 0.25)
    for i in range(3):
        joint = 5 * np.hypot(float(res["std_error"][i]),
                             single[i]["std_error"])
        assert abs(float(res["price"][i]) - single[i]["price"]) < max(joint, 2.0)


def test_sharded_price_deterministic():
    p = gbm_params(0.2)
    m = pmesh.make_mesh()
    kw = dict(mesh=m, num_paths=16_000, num_steps=16)
    r1 = pmesh.sharded_price(p, 100.0, [100.0], 0.5, jax.random.key(3), **kw)
    r2 = pmesh.sharded_price(p, 100.0, [100.0], 0.5, jax.random.key(3), **kw)
    assert float(r1["price"][0]) == float(r2["price"][0])


def test_mesh_2d_shapes():
    m = pmesh.make_mesh_2d(batch=2)
    assert m.shape["batch"] == 2 and m.shape["paths"] == 4


def test_sharded_calibration_step_descends():
    """Three optimizer steps on the 2-D (batch x paths) mesh: the psum-reduced
    loss must be finite and decrease (grad flows through the shard_map)."""
    import jax.numpy as jnp
    from mcos_tpu.engine.calibration import make_sharded_calibration_step

    mesh = pmesh.make_mesh_2d(batch=2)
    step_fn, init_fn = make_sharded_calibration_step(
        mesh, num_paths=2048, num_steps=8, lr=0.1)
    u, opt_state = init_fn(jnp.asarray([3.0, 0.09, 0.5, -0.7, 0.09],
                                       jnp.float32))
    strikes = jnp.linspace(21000.0, 24000.0, 4, dtype=jnp.float32)
    # Market generated at sigma=0.18: the start point (v0=theta=0.09) is
    # far off, so gradient steps must reduce the SSE.
    from mcos_tpu.ops.bs import bs_price
    market = bs_price(22500.0, strikes, 0.25, 0.065, 0.012, 0.18, True)
    weights = jnp.full((4,), 0.25, jnp.float32)

    losses = []
    for i in range(3):
        u, opt_state, loss = step_fn(
            u, opt_state, jnp.float32(22500.0), strikes, jnp.float32(0.25),
            market, weights, jax.random.key(0))
        losses.append(float(loss))
    assert all(np.isfinite(l) for l in losses)
    assert losses[-1] < losses[0]


def test_sharded_qe_scheme():
    from mcos_tpu.ops.bs import bs_price
    p = gbm_params(0.2, r=0.065, q=0.012)
    m = pmesh.make_mesh()
    res = pmesh.sharded_price(
        p, 22500.0, [22500.0], 0.25, jax.random.key(4),
        mesh=m, num_paths=80_000, num_steps=16, scheme="qe")
    ref = float(bs_price(22500.0, 22500.0, 0.25, 0.065, 0.012, 0.2, True))
    assert abs(float(res["price"][0]) - ref) < max(
        4 * float(res["std_error"][0]), 1.0)


def test_sharded_portfolio_var_matches_single_device():
    """Mesh-sharded VaR path (psum moments + distributed exact tail) agrees
    with the single-device estimator on the same workload."""
    import numpy as np
    from jax.sharding import Mesh

    from mcos_tpu.engine.risk import portfolio_var

    spots = [100.0, 200.0, 50.0, 80.0]
    sigmas = [0.2, 0.3, 0.25, 0.15]
    corr = np.eye(4) * 0.7 + 0.3
    w = [0.4, 0.2, 0.2, 0.2]

    sharded = portfolio_var(spots, sigmas, corr, w, 0.1,
                            num_paths=400_000, num_steps=8)
    assert sharded["num_devices"] == len(jax.devices())
    single = portfolio_var(spots, sigmas, corr, w, 0.1,
                           num_paths=400_000, num_steps=8,
                           mesh=Mesh(np.asarray(jax.devices()[:1]),
                                     ("paths",)))
    for k in ("var", "cvar", "mean", "std", "skewness"):
        assert sharded[k] == pytest.approx(single[k], rel=0.05, abs=2e-3), k


def test_sharded_portfolio_var_analytic_lognormal():
    """One asset: S_T/S_0 is exactly lognormal, so the 99% VaR has the
    closed form 1 − exp(μ_log − 2.326·σ√T)."""
    import numpy as np

    from mcos_tpu.engine.risk import portfolio_var

    sigma, T = 0.2, 0.05
    out = portfolio_var([100.0], [sigma], np.eye(1), [1.0], T,
                        r=0.0, q=0.0, num_paths=1_000_000, num_steps=4)
    s = sigma * np.sqrt(T)
    mu_log = -0.5 * sigma**2 * T
    exact = 1.0 - np.exp(mu_log - 2.326 * s)
    assert out["var"] == pytest.approx(exact, rel=0.02)
    assert out["cvar"] > out["var"]


def test_sharded_rough_price_matches_bs_and_single_device():
    """8-device rough Bergomi pricing: degenerate limit hits BS exactly
    (deterministic conditional estimator), full params within joint CI of
    a single-device run."""
    from mcos_tpu.ops.rough import (RoughBergomiParams, rbergomi_chol,
                                    rbergomi_conditional_payoffs)

    m = pmesh.make_mesh()
    deg = RoughBergomiParams(xi=0.04, eta=1e-8, rho=0.0, hurst=0.07)
    out = pfam.sharded_rough_price(
        deg, 100.0, [95.0, 105.0], 0.5, jax.random.key(3), mesh=m,
        num_paths=8_192, num_steps=32)
    for px, k in zip(np.asarray(out["price"]), [95.0, 105.0]):
        ref = float(bs_price(100.0, k, 0.5, deg.r, deg.q, 0.2, True))
        assert px == pytest.approx(ref, abs=5e-3)
    assert float(out["num_paths_used"]) >= 8_192

    full = RoughBergomiParams(xi=0.04, eta=1.9, rho=-0.9, hurst=0.07)
    sh = pfam.sharded_rough_price(
        full, 100.0, [100.0], 0.25, jax.random.key(5), mesh=m,
        num_paths=65_536, num_steps=32)
    chol = jnp.asarray(rbergomi_chol(0.07, 0.25, 32))
    pay = rbergomi_conditional_payoffs(
        full, 100.0, jnp.asarray([100.0]), 0.25, chol, jax.random.key(9),
        num_paths=65_536, num_steps=32, is_call=True).mean(axis=0)
    disc = float(np.exp(-full.r * 0.25))
    single = disc * float(pay.mean())
    se1 = disc * float(pay.std()) / np.sqrt(pay.shape[0])
    joint = np.hypot(float(sh["std_error"][0]), se1)
    assert abs(float(sh["price"][0]) - single) < 4 * joint


# ── engine-wide sharding (round 3): greeks / exotics / HHW / SLV / Sobol ─────
def test_sharded_all_greeks_matches_bs_closed_form():
    """Sharded AD greeks on degenerate GBM params: the companion CV
    collapses the estimator onto Black-Scholes, so every Greek must hit
    the closed form tightly (same oracle GreeksEngine's tests use)."""
    from mcos_tpu.ops import bs as bso

    S, K, T, sig, r, q = 22500.0, 22500.0, 0.25, 0.2, 0.065, 0.012
    p = gbm_params(sig, r=r, q=q)
    m = pmesh.make_mesh()
    g = pmesh.sharded_all_greeks(p, S, K, T, jax.random.key(0), mesh=m,
                                 num_paths=40_000, num_steps=32)
    assert g["num_devices"] == 8

    f = lambda s, t, rr: bso.bs_price(s, K, t, rr, q, sig, True)  # noqa: E731
    delta = float(jax.grad(f, 0)(S, T, r))
    gamma = float(jax.grad(jax.grad(f, 0), 0)(S, T, r))
    theta = -float(jax.grad(f, 1)(S, T, r))
    rho = float(jax.grad(f, 2)(S, T, r))
    assert g["delta"] == pytest.approx(delta, abs=5e-3)
    assert g["gamma"] == pytest.approx(gamma, rel=0.05)
    assert g["theta_daily"] == pytest.approx(theta, rel=0.03)
    assert g["rho"] == pytest.approx(rho, rel=0.03)
    # vega vs closed-form dP/dsigma = (2 sigma dP/dv0 by chain rule)
    vega_sig = float(jax.grad(
        lambda ss: bso.bs_price(S, K, T, r, q, ss, True))(sig))
    assert g["vega_per_vol_point"] == pytest.approx(vega_sig, rel=0.05)


def test_sharded_all_greeks_matches_single_engine_svj():
    """Full SVJ: the sharded greeks agree with GreeksEngine.all_greeks on
    the same workload (different path sets — statistical tolerance)."""
    from mcos_tpu.engine.greeks import GreeksEngine

    svj = SVJParams(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
                    lambda_j=1.0, mu_j=-0.05, sigma_j=0.1)
    S, K, T = 22500.0, 22500.0, 0.25
    m = pmesh.make_mesh()
    g = pmesh.sharded_all_greeks(svj, S, K, T, jax.random.key(2), mesh=m,
                                 num_paths=80_000, num_steps=32)
    eng = GreeksEngine(svj, num_paths=80_000, num_steps=128, seed=7)
    ref = eng.all_greeks(S, K, T)
    assert g["delta"] == pytest.approx(ref["delta"]["pathwise"], abs=0.02)
    assert g["vega_per_vol_point"] == pytest.approx(
        ref["vega"]["vega_per_vol_point"], rel=0.10)
    assert g["theta_daily"] == pytest.approx(ref["theta"]["theta_daily"],
                                             rel=0.10)
    assert g["rho"] == pytest.approx(ref["rho"]["rho"], rel=0.10)
    assert g["gamma"] == pytest.approx(ref["gamma"]["gamma"], rel=0.25)
    assert g["lambda_j"] == pytest.approx(ref["jumps"]["lambda_j"],
                                          rel=0.25, abs=20.0)


def test_sharded_exotic_matches_single_device():
    """Sharded Asian/barrier vs ExoticEngine on the same workload."""
    from mcos_tpu.engine.exotics import ExoticEngine

    svj = SVJParams(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
                    lambda_j=1.0, mu_j=-0.05, sigma_j=0.1)
    m = pmesh.make_mesh()
    eng = ExoticEngine(svj, num_paths=65_536, num_steps=128, seed=5)

    sh = pmesh.sharded_exotic_price(
        svj, 100.0, 100.0, 0.5, jax.random.key(1), mesh=m, kind="asian",
        num_paths=65_536, num_steps=64)
    ref = eng.price_asian(100.0, 100.0, 0.5)
    joint = np.hypot(float(sh["std_error"]), ref["std_error"])
    assert abs(float(sh["price"]) - ref["price"]) < max(5 * joint, 0.05)

    shb = pmesh.sharded_exotic_price(
        svj, 100.0, 100.0, 0.5, jax.random.key(1), mesh=m, kind="barrier",
        barrier=120.0, num_paths=65_536, num_steps=64, knock="out",
        direction="up")
    refb = eng.price_barrier(100.0, 100.0, 0.5, barrier=120.0)
    jointb = np.hypot(float(shb["std_error"]), refb["std_error"])
    assert abs(float(shb["price"]) - refb["price"]) < max(5 * jointb, 0.08)


def test_sharded_hhw_matches_single_device():
    """Sharded HHW vs HHWEngine, plus the discounted-martingale bound."""
    from mcos_tpu.engine.hhw import HHWEngine
    from mcos_tpu.ops.hhw import HHWParams

    p = HHWParams(kappa=2.0, theta=0.05, xi=0.4, v0=0.04, a=0.1, b=0.05,
                  sigma_r=0.012, r0=0.05, rho_sv=-0.6, rho_sr=0.3, q=0.01)
    m = pmesh.make_mesh()
    sh = pfam.sharded_hhw_price(p, 100.0, [100.0], 1.0, jax.random.key(4),
                                 mesh=m, num_paths=100_000, num_steps=48)
    eng = HHWEngine(p, num_paths=100_000, num_steps=48, seed=9)
    ref = eng.price(100.0, 100.0, 1.0)
    joint = np.hypot(float(sh["std_error"][0]), ref["std_error"])
    assert abs(float(sh["price"][0]) - ref["price"]) < max(5 * joint, 0.05)


def test_sharded_slv_flat_surface_matches_bs():
    """Flat 20% IV: SLV leverage must reproduce BS regardless of the
    Heston mixing — the sharded global-cloud pooling keeps that exact."""
    from mcos_tpu.engine.localvol import LocalVolSurface

    S, T, sig, r, q = 100.0, 0.5, 0.2, 0.065, 0.012
    strikes = [S * mny for mny in np.linspace(0.8, 1.2, 9)]
    surf = LocalVolSurface.from_iv_points(S, strikes, [0.25, 0.5, 1.0],
                                          np.full((3, 9), sig), r=r, q=q)
    rows, t_mid = surf.step_tables(T, 32)
    heston = SVJParams(kappa=2.0, theta=0.04, xi=0.6, rho=-0.7, v0=0.04,
                       lambda_j=0.0, r=r, q=q)
    m = pmesh.make_mesh()
    out = pfam.sharded_slv_price(
        heston, rows, t_mid, float(surf.y_grid[0]),
        float(surf.y_grid[1] - surf.y_grid[0]), S, [90.0, 100.0, 110.0], T,
        jax.random.key(6), mesh=m, num_paths=8 * 16_384, num_steps=32)
    for i, k in enumerate([90.0, 100.0, 110.0]):
        ref = float(bs_price(S, k, T, r, q, sig, True))
        tol = max(4 * float(out["std_error"][i]), 0.015 * ref + 0.02)
        assert abs(float(out["price"][i]) - ref) < tol, (k, ref)


def test_sharded_slv_pools_global_cloud():
    """The psum'd particle statistics must make the N-device result track
    the single-device result with the SAME total particle count (not the
    much noisier N-independent-clouds estimate). Statistical pin."""
    from mcos_tpu.engine.localvol import LocalVolSurface
    from mcos_tpu.engine.slv import slv_terminal

    S, T, r, q = 100.0, 0.5, 0.065, 0.012
    strikes = [S * mny for mny in np.linspace(0.8, 1.2, 9)]
    iv = 0.2 + 0.25 * (np.log(np.asarray(strikes) / S)[None, :] ** 2)
    surf = LocalVolSurface.from_iv_points(S, strikes, [0.25, 0.5, 1.0],
                                          np.tile(iv, (3, 1)), r=r, q=q)
    rows, t_mid = surf.step_tables(T, 24)
    heston = SVJParams(kappa=2.0, theta=0.04, xi=0.8, rho=-0.7, v0=0.04,
                       lambda_j=0.0, r=r, q=q)
    m = pmesh.make_mesh()
    n_total = 8 * 8_192
    sh = pfam.sharded_slv_price(
        heston, rows, t_mid, float(surf.y_grid[0]),
        float(surf.y_grid[1] - surf.y_grid[0]), S, [85.0], T,
        jax.random.key(8), mesh=m, num_paths=n_total, num_steps=24)
    s = slv_terminal(heston, jnp.asarray(rows), jnp.asarray(t_mid),
                     float(surf.y_grid[0]),
                     float(surf.y_grid[1] - surf.y_grid[0]), S, T,
                     jax.random.key(18), num_paths=n_total, num_steps=24)
    pay = np.maximum(np.asarray(s) - 85.0, 0.0).mean(axis=0)
    disc = float(np.exp(-r * T))
    single = disc * pay.mean()
    se1 = disc * pay.std() / np.sqrt(pay.shape[0])
    joint = np.hypot(float(sh["std_error"][0]), se1)
    assert abs(float(sh["price"][0]) - single) < max(5 * joint, 0.05)


def test_sharded_sobol_reconstructs_single_host_sequence():
    """The structural pin for sharded QMC: with lambda=0 (jump uniforms
    irrelevant) the 8-device offset-sliced Sobol price equals the
    single-host Sobol price to f32 reassociation noise — the device union
    IS the same point set, not a statistical cousin."""
    heston = SVJParams(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
                       lambda_j=0.0, mu_j=0.0, sigma_j=0.01)
    S, T = 22500.0, 0.25
    strikes = [22000.0, 22500.0, 23000.0]
    n = 32_768  # power of two: no truncation anywhere
    m = pmesh.make_mesh()
    sh = pmesh.sharded_sobol_price(heston, S, strikes, T, mesh=m,
                                   num_paths=n, num_steps=16, seed=42)
    eng = MonteCarloEngine(heston, num_paths=n, num_steps=64,  # 64*0.25=16
                           use_sobol=True, seed=42)
    single = eng.price_batch(S, strikes, T)
    for i in range(3):
        assert float(sh["price"][i]) == pytest.approx(
            single[i]["price"], rel=2e-3), strikes[i]


def test_sharded_sobol_rqmc_variance_matches_single_device():
    """Sharded RQMC: independent scramble seeds give iid estimates whose
    spread matches the single-device RQMC spread (QMC quality survives
    sharding). Cheap proxy: R=4 replicates, ratio of spreads within 4x."""
    heston = SVJParams(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
                       lambda_j=0.0, mu_j=0.0, sigma_j=0.01)
    S, T, n = 22500.0, 0.25, 8_192
    m = pmesh.make_mesh()
    reps_sh, reps_single = [], []
    for s in range(4):
        sh = pmesh.sharded_sobol_price(heston, S, [S], T, mesh=m,
                                       num_paths=n, num_steps=8, seed=100 + s)
        reps_sh.append(float(sh["price"][0]))
        eng = MonteCarloEngine(heston, num_paths=n, num_steps=32,
                               use_sobol=True, seed=100 + s)
        reps_single.append(eng.price(S, S, T)["price"])
    # identical seeds → identical points → near-identical replicate sets
    assert np.allclose(reps_sh, reps_single, rtol=2e-3)


def test_engine_auto_mesh_routes_and_matches():
    """MonteCarloEngine(mesh="auto") routes through the sharded drivers and
    reproduces the single-device estimator (the serving surface inherits
    this via MCOS_AUTO_MESH=1, set by the API server's main())."""
    p = gbm_params(0.2, r=0.065, q=0.012)
    # Sobol driver: the sharded device union IS the single-host point set,
    # so with lambda=0 (no PRNG jump uniforms in play) prices pin tightly.
    eng_auto = MonteCarloEngine(p, num_paths=1 << 15, num_steps=64,
                                use_sobol=True, seed=7, mesh="auto")
    eng_one = MonteCarloEngine(p, num_paths=1 << 15, num_steps=64,
                               use_sobol=True, seed=7)
    pa = eng_auto.price(22500.0, 22500.0, 0.25)
    po = eng_one.price(22500.0, 22500.0, 0.25)
    assert abs(pa["price"] - po["price"]) < max(
        3 * np.hypot(pa["std_error"], po["std_error"]), 0.5)
    assert pa["num_paths_used"] >= 1 << 15
    # PRNG driver: device-folded keys -> statistically identical estimator.
    eng_auto2 = MonteCarloEngine(p, num_paths=64_000, num_steps=64,
                                 use_sobol=False, seed=9, mesh="auto")
    eng_one2 = MonteCarloEngine(p, num_paths=64_000, num_steps=64,
                                use_sobol=False, seed=9)
    pa2 = eng_auto2.price(22500.0, 22500.0, 0.25)
    po2 = eng_one2.price(22500.0, 22500.0, 0.25)
    assert abs(pa2["price"] - po2["price"]) < max(
        5 * np.hypot(pa2["std_error"], po2["std_error"]), 2.0)


def test_engine_auto_mesh_env_toggle(monkeypatch):
    """MCOS_AUTO_MESH=1 makes a plain engine shard; =0 leaves it single."""
    from mcos_tpu.engine import pricer as pricer_mod

    p = gbm_params(0.2)
    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    eng = MonteCarloEngine(p, num_paths=8192, num_steps=16, use_sobol=False)
    assert eng._resolved_mesh() is not None
    assert eng._resolved_mesh().shape["paths"] == 8
    monkeypatch.setenv("MCOS_AUTO_MESH", "0")
    assert eng._resolved_mesh() is None
    # Exotic estimator configs fall back to single-device drivers: the
    # result dict still carries the single-device decomposition keys.
    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    eng_ref = MonteCarloEngine(p, num_paths=8192, num_steps=16,
                               use_sobol=False, cv_mode="reference")
    res = eng_ref.price(100.0, 100.0, 0.25)
    assert "raw_mc_price" in res and "bs_cv_adjustment" in res


def test_sharded_drivers_reuse_compiled_fn():
    """The hot sharded drivers must reuse ONE jitted shard_map per (mesh,
    config) — a fresh jax.jit per call re-traces on every serving request."""
    pmesh._sharded_price_fn.cache_clear()
    pmesh._sharded_sobol_fn.cache_clear()
    p = gbm_params(0.2)
    m = pmesh.make_mesh()
    for _ in range(3):
        pmesh.sharded_price(p, 100.0, [100.0], 0.5, jax.random.key(3),
                            mesh=m, num_paths=8192, num_steps=8)
        pmesh.sharded_sobol_price(p, 100.0, [100.0], 0.5, mesh=m,
                                  num_paths=8192, num_steps=8)
    assert pmesh._sharded_price_fn.cache_info().hits >= 2
    assert pmesh._sharded_price_fn.cache_info().misses == 1
    assert pmesh._sharded_sobol_fn.cache_info().hits >= 2
    assert pmesh._sharded_sobol_fn.cache_info().misses == 1


def test_sharded_vmax_is_max_not_sum():
    """v_max must pool as max-of-device-maxima, not psum (a summed max
    reported ~n_dev x the truth and fired spurious variance guards); both
    sharded drivers must also carry the guard diagnostics at all."""
    from mcos_tpu.engine.pricer import mc_price_core

    p = SVJParams(kappa=1.0, theta=0.09, xi=1.0, rho=-0.6, v0=0.09,
                  lambda_j=1.0, mu_j=-0.05, sigma_j=0.1)
    m = pmesh.make_mesh()
    assert m.shape["paths"] == 8
    res = pmesh.sharded_price(p, 22500.0, [22500.0], 0.5, jax.random.key(2),
                              mesh=m, num_paths=64_000, num_steps=64)
    single = mc_price_core(
        p, 22500.0, jnp.asarray([22500.0], jnp.float32), 0.5,
        jax.random.key(2), num_paths=64_000, num_steps=64, is_call=True,
        antithetic=True, control_variate=True, cv_mode="companion",
        cv_beta="one", scheme="euler")
    # Max over 8 device-local maxima of a same-law sample: same order of
    # magnitude as the single-device max (a psum bug gives ~8x).
    assert float(res["v_max"]) < 3 * float(single["v_max"])
    assert float(res["frac_nonfinite"]) == 0.0
    q = pmesh.sharded_sobol_price(p, 22500.0, [22500.0], 0.5, mesh=m,
                                  num_paths=1 << 14, num_steps=32)
    assert "v_max" in q and "frac_nonfinite" in q
    assert np.isfinite(float(q["v_max"]))


def test_sharded_td_price_matches_cos_oracle():
    """Engine-wide sharding extends to the td-SVJ driver: the 8-device psum
    price must hit the chained-Riccati COS oracle within joint bands."""
    from mcos_tpu.ops.tdsvj import (cos_price_td, normalize_segments,
                                    step_param_arrays)

    svj = SVJParams(kappa=3.0, theta=0.06, xi=0.5, rho=-0.7, v0=0.04,
                    lambda_j=1.5, mu_j=-0.07, sigma_j=0.12)
    T = 0.25
    ends, th, xi, lam = normalize_segments(
        [0.1, 0.25], [0.02, 0.09], [0.8, 0.3], [3.0, 0.5], T)
    steps = 128
    th_t, xi_t, lam_t = step_param_arrays(ends, th, xi, lam, T, steps)
    strikes = [22000.0, 22500.0, 23000.0]
    exact = cos_price_td(svj, 22500.0, strikes, T, ends, th, xi, lam)

    m = pmesh.make_mesh()
    res = pfam.sharded_td_price(
        svj, th_t, xi_t, lam_t, 22500.0, strikes, T, jax.random.key(2),
        mesh=m, num_paths=160_000, num_steps=steps)
    assert int(res["num_paths_used"]) >= 160_000
    for i in range(3):
        tol = 4 * float(res["std_error"][i]) + 0.004 * float(exact[i])
        assert abs(float(res["price"][i]) - exact[i]) < tol, (
            f"K={strikes[i]}: sharded={float(res['price'][i]):.3f} "
            f"COS={exact[i]:.3f} tol={tol:.3f}")


def test_sharded_td_price_deterministic():
    p = gbm_params(0.2)
    ones = np.ones(16, np.float32)
    m = pmesh.make_mesh()
    kw = dict(mesh=m, num_paths=16_000, num_steps=16)
    r1 = pfam.sharded_td_price(p, ones * 0.04, ones * 1e-4, ones * 0.0,
                                100.0, [100.0], 0.5, jax.random.key(3), **kw)
    r2 = pfam.sharded_td_price(p, ones * 0.04, ones * 1e-4, ones * 0.0,
                                100.0, [100.0], 0.5, jax.random.key(3), **kw)
    assert float(r1["price"][0]) == float(r2["price"][0])


def test_td_engine_mesh_route_matches_cos():
    """TDSVJEngine(mesh=...) routes price_batch through sharded_td_price
    (the auto-mesh serving path for /api/termsvj)."""
    from mcos_tpu.engine.termsvj import TDSVJEngine

    svj = SVJParams(kappa=3.0, theta=0.06, xi=0.5, rho=-0.7, v0=0.04,
                    lambda_j=1.5, mu_j=-0.07, sigma_j=0.12)
    eng = TDSVJEngine(svj, [0.1, 0.25], [0.02, 0.09], [0.8, 0.3],
                      [3.0, 0.5], num_paths=120_000, num_steps=128,
                      seed=6, mesh=pmesh.make_mesh())
    rows = eng.price_batch(22500.0, [22500.0], 0.25)
    assert rows[0]["num_devices"] == jax.device_count()
    exact = float(eng.cos_chain(22500.0, [22500.0], 0.25)[0])
    tol = 4 * rows[0]["std_error"] + 0.004 * exact
    assert abs(rows[0]["price"] - exact) < tol


def test_sharded_bridge_barrier_matches_closed_form():
    """Sharded bridge-monitored barrier: the Reiner-Rubinstein oracle holds
    on the 8-virtual-device mesh (GBM limit), with the bridge companion CV
    pooled through psum moments."""
    from mcos_tpu.models.params import gbm_params
    from mcos_tpu.ops.exotics import barrier_bs

    gp = gbm_params(0.25, r=0.05, q=0.01)
    m = pmesh.make_mesh()
    cf = barrier_bs(100.0, 100.0, 0.5, 0.05, 0.01, 0.25, 115.0, True,
                    "out", "up")
    sh = pmesh.sharded_exotic_price(
        gp, 100.0, 100.0, 0.5, jax.random.key(2), mesh=m, kind="barrier",
        barrier=115.0, num_paths=131_072, num_steps=32, knock="out",
        direction="up", monitoring="bridge",
        bridge_ctrl_exact=float(cf * np.exp(0.05 * 0.5)))
    assert abs(float(sh["price"]) - cf) < 4 * float(sh["std_error"]) + 2e-3
    # The GBM-limit companion collapses the pooled variance.
    assert float(sh["std_error"]) < 5e-3


def test_sharded_american_matches_pooled_single_device():
    """The distributed LSM regression must be EXACTLY the pooled regression:
    rebuild the union path sheet on one device (same per-device key folds)
    and run the same backward induction — prices agree to f32 roundoff, not
    just statistically."""
    from mcos_tpu.engine.american import (_basis_fn, _exercise_mask,
                                          _payoff_fn, _record_log_paths,
                                          lsm_backward_cashflows)

    svj = SVJParams(kappa=3.0, theta=0.06, xi=0.4, rho=-0.6, v0=0.04,
                    lambda_j=0.5, mu_j=-0.05, sigma_j=0.1)
    m = pmesh.make_mesh()
    n_dev = jax.device_count()
    ppd, steps = 512, 16
    key = jax.random.key(7)
    res = pmesh.sharded_american_price(
        svj, 100.0, 105.0, 0.5, key, mesh=m, num_paths=n_dev * ppd,
        num_steps=steps, is_call=False)

    # Union sheet: concatenate the per-device sheets in device order.
    sheets = [
        _record_log_paths(svj, 100.0, 0.5, jax.random.fold_in(key, d),
                          num_paths=ppd, num_steps=steps)
        for d in range(n_dev)
    ]
    s = jnp.exp(jnp.concatenate(sheets, axis=1))
    payoff = _payoff_fn(jnp.float32(105.0), False)
    basis = _basis_fn(jnp.float32(105.0), False, 3)
    dt = 0.5 / steps
    sdf = jnp.full((steps,), jnp.exp(-svj.r * jnp.float32(dt)))
    allowed = jnp.asarray(_exercise_mask(steps, 1))
    cf = lsm_backward_cashflows(payoff(s[-1]), s, s, allowed, sdf,
                                payoff, basis)
    ref = max(float(jnp.mean(cf)), 5.0)
    assert res["price"] == pytest.approx(ref, rel=1e-3, abs=0.02)
    assert res["num_devices"] == n_dev


def test_sharded_american_european_degenerate_matches_bs():
    """exercise_every >= num_steps leaves no early date: the sharded LSM
    price must be the European MC estimate — pinned to closed-form BS in
    the GBM limit."""
    from mcos_tpu.models.params import gbm_params

    gp = gbm_params(0.2, r=0.065, q=0.012)
    m = pmesh.make_mesh()
    res = pmesh.sharded_american_price(
        gp, 22500.0, 23000.0, 0.25, jax.random.key(11), mesh=m,
        num_paths=160_000, num_steps=16, is_call=False, exercise_every=16)
    ref = float(bs_price(22500.0, 23000.0, 0.25, 0.065, 0.012, 0.2, False))
    assert abs(res["price"] - ref) < 4 * res["std_error"] + 1.0


def test_sharded_american_put_premium_over_european():
    """An American put on a dividend-less stock still carries an early
    exercise premium from the r > 0 strike carry; the sharded price must
    sit above the European closed form and below spotless-arbitrage caps."""
    from mcos_tpu.models.params import gbm_params

    gp = gbm_params(0.2, r=0.065, q=0.0)
    m = pmesh.make_mesh()
    res = pmesh.sharded_american_price(
        gp, 90.0, 100.0, 1.0, jax.random.key(13), mesh=m,
        num_paths=160_000, num_steps=32, is_call=False)
    eur = float(bs_price(90.0, 100.0, 1.0, 0.065, 0.0, 0.2, False))
    assert res["price"] > eur + 2 * res["std_error"]
    assert res["price"] <= 100.0


def test_sharded_basket_matches_single_engine():
    """Sharded basket price (pooled optimal-beta geometric control) agrees
    with the single-device BasketEngine at the same global path budget."""
    from mcos_tpu.engine.basket import BasketEngine

    a1 = SVJParams(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
                   lambda_j=0.5, mu_j=-0.05, sigma_j=0.1)
    a2 = SVJParams(kappa=2.0, theta=0.09, xi=0.5, rho=-0.5, v0=0.06,
                   lambda_j=0.3, mu_j=-0.03, sigma_j=0.08)
    corr = [[1.0, 0.6], [0.6, 1.0]]
    eng = BasketEngine([a1, a2], corr, num_paths=64_000, num_steps=64,
                       seed=5)
    single = eng.price([100.0, 120.0], [0.5, 0.5], 110.0, 0.25)
    m = pmesh.make_mesh()
    sh = pfam.sharded_basket_price(
        eng, [100.0, 120.0], [0.5, 0.5], 110.0, 0.25, jax.random.key(5),
        mesh=m)
    joint = 5 * np.hypot(sh["std_error"], single["std_error"])
    assert abs(sh["price"] - single["price"]) < max(joint, 0.05)
    assert sh["num_devices"] == jax.device_count()
    # The pooled control must actually bite (beta near its GBM-limit value).
    assert 0.3 < sh["cv_beta"] < 2.0


def test_american_engine_mesh_route_matches_single():
    """AmericanEngine(mesh=...) routes price() through the distributed-LSM
    driver and agrees with the single-device engine."""
    from mcos_tpu.engine.american import AmericanEngine

    svj = SVJParams(kappa=3.0, theta=0.06, xi=0.4, rho=-0.6, v0=0.04,
                    lambda_j=0.5, mu_j=-0.05, sigma_j=0.1)
    kw = dict(num_paths=32_768, num_steps=64, seed=9)
    sh = AmericanEngine(svj, mesh=pmesh.make_mesh(), **kw).price(
        95.0, 100.0, 0.5, is_call=False)
    single = AmericanEngine(svj, **kw).price(95.0, 100.0, 0.5, is_call=False)
    assert sh["num_devices"] == jax.device_count()
    assert "num_devices" not in single
    joint = 5 * np.hypot(sh["std_error"], single["std_error"])
    assert abs(sh["price"] - single["price"]) < max(joint, 0.05)


def test_basket_engine_mesh_route_matches_single():
    """BasketEngine(mesh=...) routes price() through the sharded driver."""
    from mcos_tpu.engine.basket import BasketEngine

    a1 = SVJParams(v0=0.04, theta=0.05)
    a2 = SVJParams(v0=0.06, theta=0.07)
    corr = [[1.0, 0.4], [0.4, 1.0]]
    kw = dict(num_paths=32_768, num_steps=32, seed=3)
    sh = BasketEngine([a1, a2], corr, mesh=pmesh.make_mesh(), **kw).price(
        [100.0, 110.0], [0.6, 0.4], 105.0, 0.25)
    single = BasketEngine([a1, a2], corr, **kw).price(
        [100.0, 110.0], [0.6, 0.4], 105.0, 0.25)
    assert sh["num_devices"] == jax.device_count()
    joint = 5 * np.hypot(sh["std_error"], single["std_error"])
    assert abs(sh["price"] - single["price"]) < max(joint, 0.05)


# ─────────────────────────────────────────────────────────────────────────────
# Sharded MLMC (r4)
# ─────────────────────────────────────────────────────────────────────────────
def test_sharded_mlmc_level_matches_pooled_single_device():
    """One sharded level = the union of 8 key-folded single-device runs,
    pooled by exact moment sums (f32-roundoff identical)."""
    from mcos_tpu.engine.mlmc import _coupled_level

    svj = SVJParams(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
                    lambda_j=0.5, mu_j=-0.05, sigma_j=0.1)
    m = pmesh.make_mesh()
    key = jax.random.key(7)
    ppd, level, base = 1024, 2, 4
    fn = pmesh._sharded_mlmc_level_fn(m, ppd, level, base, True, "paths")
    stats = jax.device_get(fn(svj, jnp.float32(100.0), jnp.float32(100.0),
                              jnp.float32(0.5), key))
    acc_n = acc_s = acc_s2 = 0.0
    for d in range(8):
        mu, mu2 = _coupled_level(
            svj, 100.0, 100.0, 0.5, jax.random.fold_in(key, d),
            num_paths=ppd, num_coarse_steps=base * 2 ** (level - 1),
            is_call=True)
        acc_n += ppd
        acc_s += float(mu) * ppd
        acc_s2 += float(mu2) * ppd
    assert float(stats["n"]) == acc_n
    assert float(stats["sum"]) == pytest.approx(acc_s, rel=1e-5)
    assert float(stats["sumsq"]) == pytest.approx(acc_s2, rel=1e-5)


def test_sharded_mlmc_price_matches_bs_oracle():
    p = gbm_params(0.2, r=0.065, q=0.012)
    m = pmesh.make_mesh()
    res = pmesh.sharded_mlmc_price(p, 100.0, 100.0, 0.5, mesh=m,
                                   eps=0.05, pilot_paths=4096, seed=5)
    ref = float(bs_price(100.0, 100.0, 0.5, 0.065, 0.012, 0.2, True))
    tol = max(4 * res["std_error"] + 2 * res["bias_estimate"], 0.15)
    assert abs(res["price"] - ref) < tol
    assert res["num_devices"] == 8
    assert res["num_levels"] >= 3


# ─────────────────────────────────────────────────────────────────────────────
# Sharded XVA exposure (r4)
# ─────────────────────────────────────────────────────────────────────────────
def _exposure_engine(num_paths=16_384):
    from mcos_tpu.engine.exposure import ExposureEngine

    positions = [
        {"kind": "call", "strike": 100.0, "T": 1.0, "qty": 2.0, "asset": 0},
        {"kind": "put", "strike": 95.0, "T": 0.75, "qty": -1.0, "asset": 1},
        {"kind": "forward", "strike": 102.0, "T": 1.0, "qty": 1.0,
         "asset": 0},
    ]
    return ExposureEngine([100.0, 80.0], [0.25, 0.35],
                          [[1.0, 0.4], [0.4, 1.0]], positions,
                          num_paths=num_paths, seed=11)


def test_sharded_exposure_moments_match_pooled_single_device():
    """EE/ENE/gross pool as exact moment sums over the 8 key-folded
    device slices; PFE comes off the exact-tail union."""
    from mcos_tpu.engine.exposure import _exposure_values

    eng = _exposure_engine()
    m = pmesh.make_mesh()
    prof = pmesh.sharded_exposure_profile(eng, mesh=m, num_dates=8)
    ppd = eng.num_paths // 8
    kind, strike, mat, qty, asset = (jnp.asarray(a) for a in eng.pos_arrays)
    dates = jnp.asarray(np.asarray(prof["dates"], np.float32))
    key = jax.random.key(eng.seed)
    ee = np.zeros(8)
    pos_all = []
    for d in range(8):
        net, _, _ = _exposure_values(
            jnp.asarray(eng.spots), jnp.asarray(eng.sigmas),
            jnp.asarray(eng.chol), jnp.float32(eng.r), jnp.asarray(eng.q),
            dates, jax.random.fold_in(key, d), kind, strike, mat, qty,
            asset, num_paths=ppd)
        pos = np.maximum(np.asarray(net), 0.0)
        pos_all.append(pos)
        ee += pos.mean(axis=1) * ppd
    ee /= eng.num_paths
    np.testing.assert_allclose(np.asarray(prof["ee"]), ee, rtol=2e-5)
    # PFE: k-th order statistic of the union path set, exactly.
    pos_union = np.concatenate(pos_all, axis=1)
    k = max(int(np.ceil(0.025 * pos_union.shape[1])), 1)
    pfe_ref = np.sort(pos_union, axis=1)[:, -k]
    np.testing.assert_allclose(np.asarray(prof["pfe"]), pfe_ref, rtol=2e-5)


def test_sharded_exposure_profile_sane():
    eng = _exposure_engine(8_192)
    m = pmesh.make_mesh()
    prof = pmesh.sharded_exposure_profile(eng, mesh=m, num_dates=8)
    ee = np.asarray(prof["ee"])
    pfe = np.asarray(prof["pfe"])
    assert np.all(pfe >= ee - 1e-5)          # tail above the mean
    assert np.all(np.asarray(prof["gross_ee"]) >= ee - 1e-4)
    assert prof["epe"] > 0.0
    assert prof["num_devices"] == 8


# ─────────────────────────────────────────────────────────────────────────────
# DE population sharding (r4): calibrate(mesh=...)
# ─────────────────────────────────────────────────────────────────────────────
def test_de_population_sharding_matches_unsharded():
    """with_sharding_constraint partitions the same program — the DE
    trajectory is identical up to f32 reduction order."""
    from mcos_tpu.utils.optim import differential_evolution

    def rosen(x):
        return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2

    bounds = np.array([[-2.0, 2.0], [-1.0, 3.0]], np.float32)
    key = jax.random.key(3)
    r0 = differential_evolution(rosen, bounds, key, pop_size=32, iters=60)
    r1 = differential_evolution(rosen, bounds, key, pop_size=32, iters=60,
                                mesh=pmesh.make_mesh())
    assert float(r1.fun) == pytest.approx(float(r0.fun), abs=1e-5)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               atol=1e-4)
    # Non-divisible populations round up to the axis size.
    r2 = differential_evolution(rosen, bounds, key, pop_size=10, iters=20,
                                mesh=pmesh.make_mesh())
    assert np.isfinite(float(r2.fun))


def test_calibrate_population_sharded_matches_single_device():
    """Full two-stage calibrate() with the DE population sharded over the
    8-device mesh lands on the single-device optimum (same seed, same
    draws; only the vmapped member axis is partitioned)."""
    from mcos_tpu.engine.calibration import CalibrationEngine
    from mcos_tpu.ops.cos_pricer import cos_price

    true = SVJParams(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.045,
                     lambda_j=0.8, mu_j=-0.06, sigma_j=0.12)
    spot, T = 100.0, 0.4
    strikes = np.array([90.0, 95.0, 100.0, 105.0, 110.0], np.float32)
    market = np.asarray(cos_price(true, spot, strikes, T, True))
    kw = dict(is_call=True, r=float(true.r), q=float(true.q),
              num_paths=8_192, num_steps=16, seed=4, pop_size=16,
              polish=False)
    single = CalibrationEngine().calibrate(spot, strikes, T, market, **kw)
    sharded = CalibrationEngine().calibrate(spot, strikes, T, market,
                                            mesh=pmesh.make_mesh(), **kw)
    a = np.asarray(single["params"].to_array(), np.float64)
    b = np.asarray(sharded["params"].to_array(), np.float64)
    np.testing.assert_allclose(b, a, rtol=5e-3, atol=5e-3)
    assert sharded["stage1_result"]["error"] == pytest.approx(
        single["stage1_result"]["error"], rel=1e-3)


# ─────────────────────────────────────────────────────────────────────────────
# Sharded basket-American duality bracket (r4)
# ─────────────────────────────────────────────────────────────────────────────
def test_sharded_basket_bounds_matches_pooled_single_device():
    """Same trained coefficients, same key-folded path union: the sharded
    bracket's pooled moments must equal an explicit 8-slice pooling of the
    shared pair estimators (f32 roundoff)."""
    from mcos_tpu.engine.basket import BasketEngine
    from mcos_tpu.engine.basket_american import (_dual_pairs,
                                                 _lower_bound_pairs,
                                                 lsm_basket_train)

    svj = SVJParams(kappa=3.0, theta=0.04, xi=1e-3, rho=0.0, v0=0.04,
                    lambda_j=0.0)
    eng = BasketEngine([svj, svj], [[1.0, 0.3], [0.3, 1.0]],
                       num_paths=2048, num_steps=8, seed=21)
    m = pmesh.make_mesh()
    res = pmesh.sharded_basket_bounds(
        eng, [100.0, 100.0], 100.0, 0.5, mesh=m, kind="max", n_ex=4,
        steps_per_period=1, n_outer=512, n_inner=8)
    assert res["num_devices"] == 8
    assert res["upper_bound"] >= res["lower_bound"] - 3 * (
        res["lower_se"] + res["upper_se"])

    # Reproduce the lower bound by explicit pooling.
    spots_a = jnp.asarray([100.0, 100.0], jnp.float32)
    r_num = float(svj.r)
    k_train, k_eval, k_dual = jax.random.split(jax.random.key(eng.seed), 3)
    static = dict(n_ex=4, steps_per_period=1, kind="max", is_call=True)
    coefs = lsm_basket_train(eng._batch, spots_a, eng._chol, 100.0, 0.5,
                             r_num, k_train, num_paths=eng.num_paths,
                             **static)
    acc = []
    for d in range(8):
        pair = _lower_bound_pairs(
            eng._batch, spots_a, eng._chol, 100.0, 0.5, r_num,
            jax.random.fold_in(k_eval, d), coefs["policy"],
            num_paths=2048 // 8, **static)
        acc.append(np.asarray(pair))
    pooled = np.concatenate(acc)
    lo_ref = max(float(pooled.mean()),
                 0.0)  # ATM max-call intrinsic = 0
    assert res["lower_bound"] == pytest.approx(lo_ref, rel=1e-5, abs=1e-5)

    hi_acc = []
    for d in range(8):
        pair = _dual_pairs(
            eng._batch, spots_a, eng._chol, 100.0, 0.5, r_num,
            jax.random.fold_in(k_dual, d), coefs["value"],
            n_outer=512 // 8, n_inner=8, **static)
        hi_acc.append(np.asarray(pair))
    hi_ref = float(np.concatenate(hi_acc).mean())
    assert res["upper_bound"] == pytest.approx(hi_ref, rel=1e-5, abs=1e-5)


def test_sharded_pde_chain_matches_single_engine():
    """Batch-sharded ADI chain = per-contract single-device solves exactly
    (same program, vmapped + sharded; no stochastic component at all).
    Covers jumps (PIDE tables batched per contract), odd batch padding,
    and the American projection."""
    from mcos_tpu.engine.pde import HestonPDEEngine

    p = SVJParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04,
                  lambda_j=0.4, mu_j=-0.06, sigma_j=0.12)
    eng = HestonPDEEngine(p, n_x=101, n_v=51, n_t=32)
    m = pmesh.make_mesh(axis_name="batch")
    contracts = [(90.0, 0.25), (100.0, 0.25), (110.0, 0.5)]  # pads 3 -> 8
    rows = pmesh.sharded_pde_chain(eng, 100.0, contracts, mesh=m,
                                   is_call=True)
    assert len(rows) == 3 and rows[0]["num_devices"] == 8
    for row in rows:
        single = eng.price(100.0, row["strike"], row["T"], is_call=True)
        assert row["price"] == pytest.approx(single["price"],
                                             rel=1e-5, abs=1e-4)
        assert row["delta"] == pytest.approx(single["delta"], abs=1e-5)

    am = pmesh.sharded_pde_chain(eng, 100.0, [(100.0, 0.5), (110.0, 0.5)],
                                 mesh=m, is_call=False, american=True)
    for row in am:
        single = eng.price(100.0, row["strike"], row["T"], is_call=False,
                           american=True)
        assert row["price"] == pytest.approx(single["price"],
                                             rel=1e-5, abs=1e-4)


# ─────────────────────────────────────────────────────────────────────────────
# Round-5 family drivers (parallel/families.py): every remaining MC model
# family rides the ONE sharded_moments combinator; each pin reproduces the
# family's single-device estimator (or its exact oracle) on the pooled
# union sample.
# ─────────────────────────────────────────────────────────────────────────────
def test_sharded_moments_is_the_only_shardmap_shape():
    """The combinator refactor's point: moment-pooled drivers must not
    hand-roll their own shard_map — mesh.py keeps ONE jax.shard_map per
    pooled-moment family plus the few genuinely different programs
    (regression pooling, exact-tail gather, batch partitioning), and
    families.py none at all."""
    import pathlib

    root = pathlib.Path(pmesh.__file__).parent
    assert (root / "families.py").read_text().count("jax.shard_map(") == 0
    # mesh.py keeps: the combinator, the grad-shared price/greeks pair
    # (all_gather v_max — pmax has no JVP), exotic (device-side
    # ctrl_exact), Sobol (offset slicing, not key folding), American
    # (normal-equation pooling), portfolio (4 moments + top-k tail),
    # MLMC (pre-reduced level means), exposure (per-date tail gather),
    # dual bounds (nested sims), PDE (batch partition), calibration.
    assert (root / "mesh.py").read_text().count("jax.shard_map(") <= 11


def test_sharded_svcj_matches_single_device():
    from mcos_tpu.engine.svcj import _svcj_price_core
    from mcos_tpu.models.params import SVCJParams
    from mcos_tpu.parallel.families import sharded_svcj_price

    p = SVCJParams()
    ks = [95.0, 100.0, 105.0]
    m = pmesh.make_mesh()
    res = sharded_svcj_price(p, 100.0, ks, 0.25, jax.random.key(0),
                             mesh=m, num_paths=32_000, num_steps=16)
    single = jax.device_get(_svcj_price_core(
        p, 100.0, np.asarray(ks, np.float32), 0.25, 11,
        num_paths=32_000, num_steps=16, is_call=True))
    for i in range(3):
        joint = 5 * np.hypot(float(res["std_error"][i]),
                             float(single["std_error"][i]))
        assert abs(float(res["price"][i])
                   - float(single["price"][i])) < max(joint, 0.5)
    assert float(res["num_paths_used"]) == 32_000
    assert float(res["frac_nonfinite"]) == 0.0
    assert np.isfinite(float(res["v_max"]))


def test_sharded_levy_matches_cos_oracle():
    """VG + NIG exact terminal samplers sharded: no discretization bias,
    so the pooled price pins the COS oracle within pure-MC bands."""
    from mcos_tpu.ops.levy import (NIGParams, VGParams, nig_cos_price,
                                   vg_cos_price)
    from mcos_tpu.parallel.families import sharded_levy_price

    ks = np.asarray([90.0, 100.0, 110.0])
    m = pmesh.make_mesh()
    for p, cos in ((VGParams(), vg_cos_price), (NIGParams(), nig_cos_price)):
        res = sharded_levy_price(p, 100.0, ks, 0.5, jax.random.key(1),
                                 mesh=m, num_paths=64_000)
        exact = cos(p, 100.0, ks, 0.5, True)
        for i in range(3):
            se = float(res["std_error"][i])
            assert abs(float(res["price"][i]) - exact[i]) < max(5 * se, 0.3)
    with pytest.raises(TypeError):
        sharded_levy_price(SVJParams(), 100.0, [100.0], 0.5,
                           jax.random.key(2), mesh=m, num_paths=800)


def test_levy_price_mc_mesh_route_matches_single():
    """ops/levy.py:levy_price_mc with an explicit mesh reproduces the
    single-device estimator (and honors the MCOS_AUTO_MESH toggle shape)."""
    from mcos_tpu.ops.levy import VGParams, levy_price_mc

    p = VGParams()
    m = pmesh.make_mesh()
    pm, sm = levy_price_mc(p, 100.0, [100.0], 0.5, jax.random.key(3),
                           num_paths=64_000, mesh=m)
    p1, s1 = levy_price_mc(p, 100.0, [100.0], 0.5, jax.random.key(3),
                           num_paths=64_000)
    joint = 5 * np.hypot(float(sm[0]), float(s1[0]))
    assert abs(float(pm[0]) - float(p1[0])) < max(joint, 0.3)


def test_sharded_roughheston_matches_single_device():
    from mcos_tpu.engine.roughheston import _nodes, _rh_price_core
    from mcos_tpu.ops.roughheston import RoughHestonParams
    from mcos_tpu.parallel.families import sharded_roughheston_price

    p = RoughHestonParams()
    m = pmesh.make_mesh()
    res = sharded_roughheston_price(
        p, 100.0, [100.0], 0.25, jax.random.key(3), mesh=m,
        num_paths=16_000, num_steps=512, n_factors=8)
    c, x = _nodes(p, 0.25, 8)
    single = jax.device_get(_rh_price_core(
        p, 100.0, np.asarray([100.0], np.float32), 0.25, 5, c, x,
        num_paths=16_000, num_steps=512, is_call=True))
    joint = 5 * np.hypot(float(res["std_error"][0]),
                         float(single["std_error"][0]))
    assert abs(float(res["price"][0])
               - float(single["price"][0])) < max(joint, 0.3)
    assert float(res["frac_nonfinite"]) == 0.0


def test_sharded_localvol_flat_matches_bs():
    """Flat-IV Dupire surface sharded over the mesh = BS exactly in law."""
    from mcos_tpu.engine.localvol import LocalVolSurface
    from mcos_tpu.parallel.families import sharded_localvol_price

    surf = LocalVolSurface.from_iv_points(
        100.0, [80.0, 90.0, 100.0, 110.0, 120.0], [0.25, 0.5],
        np.full((2, 5), 0.2), r=0.065, q=0.012)
    m = pmesh.make_mesh()
    res = sharded_localvol_price(surf, 100.0, [100.0], 0.25,
                                 jax.random.key(4), mesh=m,
                                 num_paths=64_000, num_steps=16)
    ref = float(bs_price(100.0, 100.0, 0.25, 0.065, 0.012, 0.2, True))
    assert abs(float(res["price"][0]) - ref) < max(
        4 * float(res["std_error"][0]), 0.15)


def test_sharded_cliquet_gbm_pins_closed_form():
    """GBM degenerate: the companion control IS the payoff, so the pooled
    optimal-β estimator collapses to the exact closed form (cliquet_bs) —
    a machine-precision pin of the whole CV cross-moment plumbing."""
    from mcos_tpu.engine.cliquet import cliquet_bs
    from mcos_tpu.parallel.families import sharded_cliquet_price

    p = gbm_params(0.2, r=0.065, q=0.012)
    m = pmesh.make_mesh()
    res = sharded_cliquet_price(p, 1.0, jax.random.key(5), mesh=m,
                                num_paths=32_000, n_periods=4,
                                steps_per_period=4)
    exact = cliquet_bs(1.0, 4, 0.065, 0.012, 0.2, 0.0, 0.08)
    assert abs(float(res["price"]) - exact) < max(
        5 * float(res["std_error"]), 2e-3)
    assert float(res["std_error"]) < 1e-3   # residual variance ~ 0
    assert abs(float(res["cv_beta"]) - 1.0) < 0.05


def test_sharded_quanto_gbm_pins_closed_form():
    """GBM degenerate quanto: pooled optimal-β CV collapses onto the
    closed-form quanto-BS (both legs share the identical tilt)."""
    from mcos_tpu.engine.quanto import quanto_bs
    from mcos_tpu.parallel.families import sharded_quanto_price

    p = gbm_params(0.2, r=0.03, q=0.01)     # params.r = foreign rate
    m = pmesh.make_mesh()
    res = sharded_quanto_price(p, 0.05, 0.12, -0.4, 100.0, 100.0, 0.5,
                               jax.random.key(6), mesh=m,
                               num_paths=32_000, num_steps=16)
    exact = quanto_bs(100.0, 100.0, 0.5, 0.05, 0.03, 0.01, 0.2, 0.12,
                      -0.4, True)
    assert abs(float(res["price"]) - exact) < max(
        5 * float(res["std_error"]), 0.02)


def test_sharded_worstof_autocall_matches_single_engine():
    from mcos_tpu.engine.autocallable import WorstOfAutocallableEngine
    from mcos_tpu.parallel.families import sharded_worstof_autocall

    eng = WorstOfAutocallableEngine(
        [SVJParams(), SVJParams()], [[1.0, 0.6], [0.6, 1.0]],
        num_paths=16_000, steps_per_period=4)
    single = eng.price(1.0, n_obs=4)
    m = pmesh.make_mesh()
    res = sharded_worstof_autocall(eng, 1.0, jax.random.key(7), mesh=m,
                                   n_obs=4)
    joint = 5 * np.hypot(float(res["std_error"]), single["std_error"])
    assert abs(float(res["price"]) - single["price"]) < max(joint, 0.01)
    # Pooled redemption accounting: a probability decomposition.
    probs = np.asarray(res["call_prob_by_date"])
    assert probs.shape == (4,) and (probs >= 0).all()
    assert abs(probs.sum() + res["survival_prob"] - 1.0) < 1e-5
    assert 0.0 <= res["loss_prob"] <= res["survival_prob"] + 1e-6
    assert 0.25 <= res["expected_life"] <= 1.0 + 1e-6
    assert abs(res["expected_life"] - single["expected_life"]) < 0.1


def test_sharded_variance_swap_pins_closed_form():
    from mcos_tpu.parallel.families import sharded_variance_swap

    m = pmesh.make_mesh()
    out = sharded_variance_swap(SVJParams(), 0.5, jax.random.key(8),
                                mesh=m, num_paths=32_000, num_steps=64)
    assert out["mc_vs_closed_sigmas"] < 6.0
    assert out["fair_variance"] > 0 and out["mc_std_error"] > 0


def test_families_engines_honor_auto_mesh(monkeypatch):
    """MCOS_AUTO_MESH=1 routes EVERY family engine through its sharded
    driver (the serving toggle must cover the whole
    engine surface, not just pricer/termsvj/american); =0 single-device.
    Same-seed mesh-vs-single agreement within joint MC bands."""
    from mcos_tpu.engine.cliquet import CliquetEngine
    from mcos_tpu.engine.quanto import QuantoEngine
    from mcos_tpu.engine.svcj import SVCJEngine
    from mcos_tpu.engine.volderivs import VolDerivsEngine
    from mcos_tpu.models.params import SVCJParams

    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    sv = SVCJEngine(SVCJParams(), num_paths=16_000, num_steps=64)
    r_mesh = sv.price(100.0, 100.0, 0.25)
    monkeypatch.setenv("MCOS_AUTO_MESH", "0")
    r_one = sv.price(100.0, 100.0, 0.25)
    joint = 5 * np.hypot(r_mesh["std_error"], r_one["std_error"])
    assert abs(r_mesh["price"] - r_one["price"]) < max(joint, 0.5)
    assert r_mesh["num_paths_used"] == 16_000

    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    cq = CliquetEngine(gbm_params(0.2), num_paths=16_000,
                       steps_per_period=4)
    rc = cq.price_cliquet(1.0)
    monkeypatch.setenv("MCOS_AUTO_MESH", "0")
    rc1 = cq.price_cliquet(1.0)
    assert abs(rc["price"] - rc1["price"]) < max(
        5 * np.hypot(rc["std_error"], rc1["std_error"]), 2e-3)

    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    qe = QuantoEngine(gbm_params(0.2, r=0.03), 0.05, 0.12, -0.4,
                      num_paths=16_000, num_steps=16)
    rq = qe.price(100.0, 100.0, 0.5)
    monkeypatch.setenv("MCOS_AUTO_MESH", "0")
    rq1 = qe.price(100.0, 100.0, 0.5)
    assert abs(rq["price"] - rq1["price"]) < max(
        5 * np.hypot(rq["std_error"], rq1["std_error"]), 0.05)
    assert "quanto_adjustment_bs" in rq

    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    vd = VolDerivsEngine(SVJParams(), num_paths=16_000, num_steps=64)
    rv = vd.variance_swap(0.5)
    assert rv["mc_vs_closed_sigmas"] < 6.0 and rv["num_paths"] == 16_000


def test_localvol_and_worstof_engines_honor_auto_mesh(monkeypatch):
    from mcos_tpu.engine.autocallable import WorstOfAutocallableEngine
    from mcos_tpu.engine.localvol import LocalVolEngine, LocalVolSurface

    surf = LocalVolSurface.from_iv_points(
        100.0, [80.0, 90.0, 100.0, 110.0, 120.0], [0.25, 0.5],
        np.full((2, 5), 0.2), r=0.065, q=0.012)
    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    lv = LocalVolEngine(surf, num_paths=32_000, num_steps=64)
    rm = lv.price(100.0, 100.0, 0.25)
    monkeypatch.setenv("MCOS_AUTO_MESH", "0")
    r1 = lv.price(100.0, 100.0, 0.25)
    assert abs(rm["price"] - r1["price"]) < max(
        5 * np.hypot(rm["std_error"], r1["std_error"]), 0.2)

    eng = WorstOfAutocallableEngine(
        [SVJParams(), SVJParams()], [[1.0, 0.6], [0.6, 1.0]],
        num_paths=16_000, steps_per_period=4)
    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    am = eng.price(1.0, n_obs=4)
    monkeypatch.setenv("MCOS_AUTO_MESH", "0")
    a1 = eng.price(1.0, n_obs=4)
    assert abs(am["price"] - a1["price"]) < max(
        5 * np.hypot(am["std_error"], a1["std_error"]), 0.01)
    assert len(am["call_prob_by_date"]) == 4


def test_roughheston_engine_honors_auto_mesh(monkeypatch):
    from mcos_tpu.engine.roughheston import RoughHestonEngine
    from mcos_tpu.ops.roughheston import RoughHestonParams

    eng = RoughHestonEngine(RoughHestonParams(), num_paths=8_000,
                            num_steps=2048, n_factors=8, seed=3)
    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    rm = eng.price(100.0, 100.0, 0.25)
    monkeypatch.setenv("MCOS_AUTO_MESH", "0")
    r1 = eng.price(100.0, 100.0, 0.25)
    assert abs(rm["price"] - r1["price"]) < max(
        5 * np.hypot(rm["std_error"], r1["std_error"]), 0.3)


# ─────────────────────────────────────────────────────────────────────────────
# f32 accumulation audit at 1e8 payoffs: the device
# pools are (n, Σ, Σ²) in f32 (CLAUDE.md invariant) — at 2^27 payoffs per
# device the mantissa carries ~7 decimal digits against a ~10⁹-wide Σ².
# XLA's pairwise tree reduction keeps the relative error ~ε·log₂(n), not
# ε·n, so the contract should hold with orders of magnitude to spare —
# this test PROVES it against an f64 host reference on identical draws.
# ─────────────────────────────────────────────────────────────────────────────
def _audit_lognormal_payoffs(dev_key, scale, *, ppd):
    """Synthetic option-scale payoffs: max(100·e^Z − 100, 0) — the
    heavy-right-tail shape whose Σ² stresses f32 the hardest."""
    z = jax.random.normal(dev_key, (ppd,), jnp.float32)
    return jnp.maximum(100.0 * jnp.exp(scale * z) - 100.0, 0.0)[None, :]


def test_f32_moment_pools_hold_contract_at_1e8_paths():
    """Pooled price/stderr from the REAL sharded_moments f32 path at 1e8
    payoffs across 8 pool slices vs an exact f64 host reduction of the
    SAME f32 payoffs: drift must sit far inside the 0.1%-of-premium
    accuracy contract (reference engine/config.py:25)."""
    m = pmesh.make_mesh()
    n_dev = int(np.prod(list(m.shape.values())))
    ppd = 100_000_000 // 8
    key = jax.random.key(123)
    stats = pmesh.sharded_moments(
        _audit_lognormal_payoffs, key, (jnp.float32(0.2),),
        mesh=m, statics=(("ppd", ppd),))
    pooled = pmesh.pool_moments(stats)
    price32 = float(pooled["price"][0])
    se32 = float(pooled["std_error"][0])

    # Exact f64 reference on the identical f32 payoff stream, slice by
    # slice (the combinator folds the key by axis index — reproduce it).
    n_tot, s_tot, ss_tot = 0.0, 0.0, 0.0
    for i in range(n_dev):
        dev_key = jax.random.fold_in(key, i)
        eff = np.asarray(
            _audit_lognormal_payoffs(dev_key, jnp.float32(0.2), ppd=ppd),
            np.float64)
        n_tot += eff.shape[-1]
        s_tot += eff.sum()
        ss_tot += (eff * eff).sum()
    mean64 = s_tot / n_tot
    se64 = np.sqrt(max(ss_tot / n_tot - mean64 * mean64, 0.0) / n_tot)

    assert float(pooled["num_paths_used"]) == 8 * ppd
    # 0.1%-of-premium contract, with ~100x headroom demanded: the f32
    # pools must land within 1e-5 relative of the f64 truth.
    assert abs(price32 - mean64) < 1e-5 * mean64, (price32, mean64)
    assert abs(se32 - se64) < 1e-3 * se64, (se32, se64)
