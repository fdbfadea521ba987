"""Sequential smoke test of the full engine stack (role of the reference's
verify.py:1-97, extended to the capabilities it lacks).

Run: python smoke_test.py          (uses the default backend — GPU if attached)
     JAX_PLATFORMS=cpu python smoke_test.py
Exit code 0 iff every stage passes.
"""

import sys
import time

import numpy as np

FAILURES = []


def stage(name):
    print(f"\n[{name}]")


def check(label, ok):
    print(f"    {label}: {'PASS' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(label)


def main():
    import jax

    print("=" * 64)
    print("mcos_tpu — engine smoke test (24 stages)")
    print("devices:", jax.devices())
    print("=" * 64)

    # 1. Models / substrate
    stage("1. models")
    from mcos_tpu.models.params import SVJParams, forward_price, gbm_params
    p = SVJParams(kappa=5.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04,
                  lambda_j=0.0, mu_j=0.0, sigma_j=0.01)
    check("Feller satisfied (2·5·0.04 > 0.09)", p.feller_satisfied)
    fwd = float(forward_price(22500.0, 0.065, 0.012, 0.04))
    check(f"forward {fwd:.2f} > spot", fwd > 22500)

    # 2. Black-Scholes analytics
    stage("2. black-scholes")
    from mcos_tpu.ops.bs import bs_price
    atm = float(bs_price(22500, 22500, 0.04, 0.065, 0.012, 0.2, True))
    print(f"    ATM call: {atm:.4f}")
    check("ATM call in sane band", 300 < atm < 500)

    # 3. MC vs BS oracle (the reference's key test, verify.py:26-42)
    stage("3. MC-vs-BS oracle (50k paths, degenerate SVJ)")
    from mcos_tpu.engine.pricer import MonteCarloEngine
    bs_params = gbm_params(0.2, r=0.065, q=0.012)
    eng = MonteCarloEngine(bs_params, num_paths=50_000, num_steps=100)
    t0 = time.time()
    res = eng.price(22500, 22500, 0.04, True)
    dt = (time.time() - t0) * 1000
    diff = abs(res["price"] - atm)
    print(f"    MC={res['price']:.4f}  BS={atm:.4f}  |diff|={diff:.4f}  "
          f"se={res['std_error']:.6f}  ({dt:.0f}ms)")
    check("|MC − BS| < max(3σ, 0.01)", diff < max(3 * res["std_error"], 0.01))
    check("|MC − BS| < 20 (reference gate)", diff < 20)

    # 4. Full SVJ pricing
    stage("4. SVJ call+put")
    svj = SVJParams(kappa=5.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04,
                    lambda_j=1.0, mu_j=-0.05, sigma_j=0.10)
    eng2 = MonteCarloEngine(svj, num_paths=50_000, num_steps=100)
    t0 = time.time()
    call = eng2.price(22500, 22500, 0.04, True)
    put = eng2.price(22500, 22500, 0.04, False)
    dt = (time.time() - t0) * 1000
    print(f"    call={call['price']:.4f} put={put['price']:.4f} ({dt:.0f}ms)")
    parity = 22500 * np.exp(-0.012 * 0.04) - 22500 * np.exp(-0.065 * 0.04)
    check("put-call parity within noise",
          abs((call["price"] - put["price"]) - parity)
          < max(6 * (call["std_error"] + put["std_error"]), 2.0))

    # 5. AD Greeks vs closed form
    stage("5. greeks (one AD pass) vs BS closed form")
    from mcos_tpu.engine.greeks import GreeksEngine
    from mcos_tpu.ops.bs import bs_delta
    ge = GreeksEngine(bs_params, num_paths=50_000, num_steps=252, seed=1)
    d = ge.delta(22500, 22500, 0.04)
    ref_delta = float(bs_delta(22500, 22500, 0.04, 0.065, 0.012, 0.2, True))
    print(f"    AD delta={d['pathwise']:.4f}  FD={d['finite_diff']:.4f}  "
          f"BS={ref_delta:.4f}  diff%={d['diff_pct']:.2f}")
    check("delta within 1% of BS", abs(d["pathwise"] - ref_delta) < 0.01)

    # 6. Regime detection (verify.py:58-69 canned inputs)
    stage("6. regime")
    from mcos_tpu.engine.regime import RegimeDetector
    det = RegimeDetector()
    r = [det.classify(0.12, 25, 0.02)["regime"],
         det.classify(0.22, 60, 0.06)["regime"],
         det.classify(0.35, 85, 0.12)["regime"]]
    print(f"    {r}")
    check("calm/event/crisis", r == ["calm", "event", "crisis"])

    # 7. Guards
    stage("7. guards")
    from mcos_tpu.engine.guards import PricingGuard
    pre = PricingGuard(svj).check_pre_price(22500, 22500, 0.04)
    check("pre-price guard passes sane params", pre["pass"])
    bad = PricingGuard(svj.replace(v0=99.0)).check_pre_price(22500, 22500, 0.04)
    check("pre-price guard rejects v0=99", not bad["pass"])

    # 8. Risk metrics (verify.py:80-91)
    stage("8. risk metrics")
    from mcos_tpu.engine.risk import compute_risk_metrics
    rng = np.random.default_rng(42)
    m = compute_risk_metrics(rng.standard_normal(10_000) * 0.02 - 0.001)
    print(f"    VaR={m['var']:.4f} CVaR={m['cvar']:.4f} "
          f"skew={m['skewness']:.3f} kurt={m['kurtosis']:.3f}")
    check("VaR ≈ 2.33σ", abs(m["var"] - (2.326 * 0.02 + 0.001)) < 0.01)

    # 9. IV surface
    stage("9. implied vol")
    from mcos_tpu.engine.surface import implied_vol
    iv = implied_vol(atm, 22500, 22500, 0.04, 0.065, 0.012, True)
    print(f"    IV(BS ATM price) = {iv:.5f}")
    check("IV round-trip", iv is not None and abs(iv - 0.2) < 1e-3)

    # 10. Sharded pricing on the device mesh
    stage("10. mesh-sharded pricing")
    from mcos_tpu.parallel.mesh import make_mesh, sharded_price
    mesh = make_mesh()
    sh = sharded_price(bs_params, 22500.0, [22500.0], 0.04, jax.random.key(0),
                       mesh=mesh, num_paths=64_000, num_steps=50)
    sh_price = float(sh["price"][0])
    print(f"    {mesh.shape}: price={sh_price:.4f}")
    check("sharded price within 3σ of BS",
          abs(sh_price - atm) < max(3 * float(sh["std_error"][0]), 0.5))

    # 11. Full-SVJ MC vs the semi-analytic Bates (COS) oracle
    stage("11. full-SVJ MC vs COS oracle")
    from mcos_tpu.ops.cos_pricer import cos_price
    svj_o = SVJParams(kappa=3.0, theta=0.06, xi=0.5, rho=-0.7, v0=0.04,
                      lambda_j=1.5, mu_j=-0.07, sigma_j=0.12,
                      r=0.065, q=0.012)
    exact = float(cos_price(svj_o, 22500.0, [22500.0], 0.25, True)[0])
    mc = MonteCarloEngine(svj_o, num_paths=200_000, num_steps=1024,
                          use_sobol=False, seed=3).price(22500, 22500, 0.25)
    gap = abs(mc["price"] - exact)
    tol = 4 * mc["std_error"] + 0.002 * exact
    print(f"    MC={mc['price']:.3f}  COS={exact:.3f}  |diff|={gap:.3f}  "
          f"tol={tol:.3f}")
    check("MC within COS bands (full SVJ dynamics)", gap < tol)

    stage("12. rough Bergomi (conditional estimator vs BS limit)")
    from mcos_tpu.engine.rough import RoughBergomiEngine
    from mcos_tpu.ops.rough import RoughBergomiParams
    rp0 = RoughBergomiParams(xi=0.04, eta=1e-8, rho=0.0, r=0.065, q=0.012,
                             hurst=0.07)
    rb = RoughBergomiEngine(rp0, num_paths=4_096, num_steps=32)
    rres = rb.price(22500.0, 22500.0 * 1.02, 0.25)
    rbs = float(bs_price(22500.0, 22500.0 * 1.02, 0.25, 0.065, 0.012, 0.2,
                         True))
    print(f"    rough(eta→0)={rres['price']:.3f}  BS={rbs:.3f}")
    check("rough degenerate hits BS", abs(rres["price"] - rbs) < 0.05)
    rfull = RoughBergomiEngine(
        RoughBergomiParams(xi=0.04, eta=1.9, rho=-0.9, hurst=0.07),
        num_paths=32_768, num_steps=32)
    sk = rfull.atm_skew(22500.0, 0.1)["skew"]
    print(f"    ATM skew (T=0.1): {sk:.3f}")
    check("rough skew steep and negative", sk < -0.4)

    stage("13. exposure / CVA (martingale EE oracle)")
    from mcos_tpu.engine.exposure import ExposureEngine
    xe = ExposureEngine([22500.0], [0.2], [[1.0]],
                        [{"kind": "call", "strike": 22500.0, "T": 0.5}],
                        r=0.065, q=[0.012], num_paths=50_000)
    prof = xe.profile(num_dates=6, horizon=0.45)
    c0 = float(bs_price(22500, 22500, 0.5, 0.065, 0.012, 0.2, True))
    disc_ee = [np.exp(-0.065 * t) * e
               for t, e in zip(prof["dates"], prof["ee"])]
    drift = max(abs(e - c0) for e in disc_ee) / c0
    print(f"    e^-rt·EE vs C0={c0:.1f}: max drift {drift * 100:.2f}%")
    check("discounted EE flat at C0 (martingale)", drift < 0.02)
    check("PFE dominates EE", all(p_ >= e_ for p_, e_
                                  in zip(prof["pfe"], prof["ee"])))

    stage("14. SSVI surface (round-trip + no-arb)")
    from mcos_tpu.engine.ssvi import calibrate_ssvi, ssvi_total_variance
    mats_s = np.array([0.25, 0.5, 1.0])
    fwds_s = 22500.0 * np.exp(0.053 * mats_s)
    ks = np.stack([f * np.exp(np.linspace(-0.2, 0.2, 9)) for f in fwds_s])
    w_true = np.asarray(ssvi_total_variance(
        np.log(ks / fwds_s[:, None]), (0.04 * mats_s)[:, None],
        -0.65, 1.1, 0.4))
    ssvi = calibrate_ssvi(mats_s, fwds_s, ks,
                          np.sqrt(w_true / mats_s[:, None]), iters=80)
    print(f"    fit rho={ssvi['rho']:.3f} (true -0.65), "
          f"rmse={ssvi['rmse_total_variance']:.2e}")
    check("SSVI recovers rho", abs(ssvi["rho"] + 0.65) < 0.05)
    check("SSVI fit arbitrage-free", ssvi["arbitrage"]["butterfly_free"])

    stage("15. PDE second opinion (Crank-Nicolson vs BS/CRR)")
    from mcos_tpu.engine.pde import PDEEngine
    pde = PDEEngine(sigma=0.2, r=0.065, q=0.012)
    pres = pde.price(22500.0, 22500.0, 0.25)
    pde_ref = float(bs_price(22500.0, 22500.0, 0.25, 0.065, 0.012, 0.2,
                             True))
    print(f"    PDE={pres['price']:.3f}  BS={pde_ref:.3f}")
    check("PDE matches BS to 5e-4 rel",
          abs(pres["price"] - pde_ref) < 5e-4 * pde_ref)
    am = pde.price(22500.0, 24000.0, 0.25, is_call=False, american=True)
    eu = pde.price(22500.0, 24000.0, 0.25, is_call=False)
    check("American put above European (projected CN)",
          am["price"] > eu["price"])

    stage("16. Variance Gamma (exact sampler vs its COS oracle)")
    import jax.numpy as jnp
    from mcos_tpu.ops.levy import VGParams, vg_cos_price, vg_price_mc
    vgp = VGParams(sigma=0.2, nu=0.2, theta=-0.14, r=0.065, q=0.012)
    vg_cos = vg_cos_price(vgp, 22500.0, [22500.0], 0.25, True)[0]
    vg_mc, vg_se = vg_price_mc(vgp, 22500.0, jnp.asarray([22500.0]),
                               0.25, jax.random.key(4),
                               num_paths=200_000, is_call=True)
    gap_vg = abs(float(vg_mc[0]) - vg_cos)
    print(f"    MC={float(vg_mc[0]):.3f}  COS={vg_cos:.3f}  "
          f"({gap_vg / max(float(vg_se[0]), 1e-9):.1f}σ)")
    check("VG exact sampler within COS bands",
          gap_vg < 4 * float(vg_se[0]) + 1e-2)

    stage("17. discrete dividends (compounded-cash forward oracle)")
    from mcos_tpu.engine.american import AmericanEngine
    from mcos_tpu.ops.dividends import (DividendSchedule,
                                        forward_with_dividends)
    big_div = DividendSchedule([0.4], [900.0], "cash")
    am_d = AmericanEngine(bs_params, num_paths=100_000, num_steps=48, seed=5,
                          dividends=big_div)
    a_div = am_d.price(22500.0, 22500.0, 0.75, is_call=True)
    a_eu = am_d.price(22500.0, 22500.0, 0.75, is_call=True,
                      exercise_every=10_000)
    prem = a_div["price"] - a_eu["price"]
    f_div = forward_with_dividends(22500.0, big_div, float(bs_params.r),
                                   float(bs_params.q), 0.75)
    print(f"    american={a_div['price']:.2f} european={a_eu['price']:.2f} "
          f"early-ex premium={prem:.2f}  F_div={f_div:.1f}")
    check("dividend early-exercise premium > 0",
          prem > 2 * (a_div["std_error"] + a_eu["std_error"]))

    stage("18. rate curve (flat-equivalent exactness)")
    from mcos_tpu.ops.curves import RateCurve
    steep = RateCurve([0.25, 0.5], [0.01, 0.09])
    mc_curve = MonteCarloEngine(bs_params, num_paths=100_000, seed=7,
                                use_sobol=False, rate_curve=steep)
    res_c = mc_curve.price(22500.0, 22500.0, 0.5)
    bs_c = float(bs_price(22500.0, 22500.0, 0.5, steep.r_eff(0.5),
                          float(bs_params.q), 0.2, True))
    gap_c = abs(res_c["price"] - bs_c)
    print(f"    MC(curve)={res_c['price']:.3f}  BS(r_eff)={bs_c:.3f}")
    check("curve pricing == BS(r_eff) within 3σ",
          gap_c < 3 * res_c["std_error"] + 1e-2)

    stage("19. vol derivatives (VIX parity) + SPAN margin")
    from mcos_tpu.engine.margin import MarginEngine
    from mcos_tpu.engine.volderivs import VolDerivsEngine
    vd = VolDerivsEngine(svj, num_paths=50_000, seed=3)
    fut = vd.vix_future(0.5)["future"]
    c_vx = vd.vix_option(0.5, 0.22, True)
    p_vx = vd.vix_option(0.5, 0.22, False)
    parity = abs((c_vx["price"] - p_vx["price"])
                 - c_vx["discount_factor"] * (fut - 0.22))
    print(f"    VIX future={fut:.4f}  parity gap={parity:.2e}")
    check("VIX option put-call parity", parity < 1e-8)
    mg = MarginEngine(svj, num_paths=50_000, seed=9)
    hedged = mg.margin(22500.0, [22500.0] * 2, [0.25] * 2, [True] * 2,
                       [4.0, -4.0])
    short = mg.margin(22500.0, [22500.0], [0.25], [True], [-1.0])
    print(f"    hedged margin={hedged['margin']:.4f}  "
          f"short-call margin={short['margin']:.2f}")
    check("hedged book margins zero", hedged["margin"] == 0.0)
    check("short option margins positive", short["margin"] > 0)

    # 20. Time-dependent SVJ (td MC vs chained-Riccati COS)
    stage("20. time-dependent SVJ (td MC vs segment-chained COS)")
    from mcos_tpu.engine.termsvj import TDSVJEngine
    td = TDSVJEngine(svj, [0.1, 0.25], [0.02, 0.09], [0.8, 0.3],
                     [3.0, 0.5], num_paths=100_000, num_steps=128, seed=5)
    row = td.price(22500.0, 22500.0, 0.25)
    exact_td = float(td.cos_chain(22500.0, [22500.0], 0.25)[0])
    gap = abs(row["price"] - exact_td)
    tol = 4 * row["std_error"] + 0.002 * exact_td
    print(f"    td MC={row['price']:.4f}  td COS={exact_td:.4f}  "
          f"|diff|={gap:.4f}  tol={tol:.4f}")
    check("td MC within oracle band", gap < tol)

    stage("21. second-order greeks + scenario matrix + calib error bars")
    from mcos_tpu.engine.greeks import GreeksEngine
    from mcos_tpu.engine.risk import StressTestEngine
    from mcos_tpu.models.params import gbm_params

    geng = GreeksEngine(gbm_params(0.2), num_paths=50_000, num_steps=64,
                        seed=5)
    so = geng.second_order_greeks(22500.0, 22500.0, 0.25)

    def _bs_ref():
        import jax as _jax

        from mcos_tpu.ops import bs as _bs

        def price(s, sig, t):
            return _bs.bs_price(s, 22500.0, t, 0.065, 0.012, sig, True)

        d_s = _jax.grad(price, argnums=0)
        gma = _jax.grad(d_s, argnums=0)
        a = (22500.0, 0.2, 0.25)
        return (-float(_jax.grad(d_s, argnums=2)(*a)),
                float(_jax.grad(gma, argnums=0)(*a)))

    charm_ref, speed_ref = _bs_ref()
    print(f"    charm={so['charm']:.5f} (BS {charm_ref:.5f})  "
          f"speed={so['speed']:.3e} (BS {speed_ref:.3e})")
    check("charm matches BS AD oracle",
          abs(so["charm"] - charm_ref) < 0.1 * abs(charm_ref))
    check("speed matches BS AD oracle",
          abs(so["speed"] - speed_ref) < 0.2 * abs(speed_ref))

    sten = StressTestEngine(svj, num_paths=20_000, seed=1)
    mat = sten.scenario_matrix(22500.0, 22500.0, 0.25)
    rows_monotone = all(
        a < b for row in mat["prices"] for a, b in zip(row, row[1:]))
    check("scenario matrix monotone in spot at every vol level",
          rows_monotone)

    from mcos_tpu.engine.calibration import CalibrationEngine
    from mcos_tpu.ops.cos_pricer import cos_price as _cosp

    kchain = np.linspace(0.9, 1.1, 11) * 22500.0
    truth = np.asarray(_cosp(svj, 22500.0, kchain, 0.25, True))
    unc = CalibrationEngine().parameter_uncertainty(
        svj, 22500.0, kchain, 0.25, truth + 2.0)
    ses = np.asarray(unc["std_errors"])
    print(f"    κ se={ses[0]:.3g}  ξ se={ses[2]:.3g}  "
          f"cond={unc['condition_number']:.2e}")
    check("calibration error bars finite", bool(np.all(np.isfinite(ses))))

    stage("22. double-barrier corridor (bridge MC vs image-series oracle)")
    from mcos_tpu.engine.exotics import ExoticEngine
    from mcos_tpu.ops.exotics import double_barrier_bs

    deng = ExoticEngine(gbm_params(0.3, r=0.05, q=0.01), num_paths=100_000,
                        num_steps=32, seed=7)
    dko = deng.price_double_barrier(100.0, 100.0, 0.5, 85.0, 125.0)
    dcf = double_barrier_bs(100.0, 100.0, 0.5, 0.05, 0.01, 0.3, 85.0, 125.0)
    print(f"    bridge double-KO={dko['price']:.5f}  corridor "
          f"quadrature={dcf:.5f}  se={dko['std_error']:.2e}")
    check("bridge double-KO matches corridor oracle at 32 steps",
          abs(dko["price"] - dcf) < 4 * dko["std_error"] + 2e-3)
    dnt = deng.price_double_no_touch(100.0, 0.5, 85.0, 125.0)
    dot = deng.price_double_no_touch(100.0, 0.5, 85.0, 125.0, touch=True)
    check("corridor digitals are complements (DNT + DOT = e^{-rT})",
          abs(dnt["price"] + dot["price"]
              - float(np.exp(-0.05 * 0.5))) < 2e-4)

    stage("23. ADI Heston PDE (2-D grid vs COS, American projection)")
    from mcos_tpu.engine.pde import HestonPDEEngine
    from mcos_tpu.ops.cos_pricer import heston_price

    hp = SVJParams(kappa=3.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04,
                   lambda_j=0.0)
    heng = HestonPDEEngine(hp)
    hres = heng.price(100.0, 100.0, 0.5, is_call=True)
    hcos = float(heston_price(hp, 100.0, [100.0], 0.5, True)[0])
    print(f"    ADI={hres['price']:.4f}  COS={hcos:.4f}  "
          f"delta={hres['delta']:.4f}")
    check("ADI Heston matches the COS oracle", abs(hres["price"] - hcos)
          < 0.02)
    ham = heng.price(90.0, 100.0, 0.5, is_call=False, american=True)
    check("ADI American put above European and intrinsic",
          ham["price"] >= 10.0
          and ham["price"] > float(heston_price(hp, 90.0, [100.0], 0.5,
                                                False)[0]))

    stage("24. multi-asset Bermudan LSM (Broadie-Glasserman max-call)")
    from mcos_tpu.engine.basket import BasketEngine

    bgp = gbm_params(0.2, r=0.05, q=0.10)
    beng = BasketEngine([bgp, bgp], [[1.0, 0.0], [0.0, 1.0]],
                        num_paths=100_000, seed=7)
    mc = beng.price_american([100.0, 100.0], 100.0, 3.0, kind="max",
                             n_ex=9, steps_per_period=1)
    print(f"    Bermudan max-call={mc['price']:.4f}  "
          f"(published table: 13.90)  se={mc['std_error']:.4f}")
    check("max-call lands on the published benchmark band",
          13.70 < mc["price"] < 14.05)

    print("\n" + "=" * 64)
    if FAILURES:
        print(f"FAILED: {len(FAILURES)} checks: {FAILURES}")
        return 1
    print("ALL SMOKE CHECKS PASSED")
    print("Serve the API:  python -m mcos_tpu.api.server --port 8000")
    return 0


if __name__ == "__main__":
    sys.exit(main())
