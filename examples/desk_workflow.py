"""End-to-end desk workflow on the pricing framework.

The full loop a NIFTY options desk runs each morning, as library calls:

    quote → calibrate to the chain → price the book → Greeks → stress →
    exotics → hedge-backtest → risk report

Run: python examples/desk_workflow.py  (CPU or GPU)
Every stage prints one line; the script exits non-zero on any failed sanity
check, so it doubles as an integration smoke for the documented workflow.
"""

import sys

import numpy as np

sys.path.insert(0, ".")  # repo-root execution

import mcos_tpu as m                                  # noqa: E402
from mcos_tpu.engine.basket import BasketEngine       # noqa: E402
from mcos_tpu.engine.exotics import (                 # noqa: E402
    ExoticEngine, variance_swap_fair_strike)
from mcos_tpu.engine.risk import (                    # noqa: E402
    HedgingBacktest, StressTestEngine, portfolio_var)
from mcos_tpu.models.params import SVJParams          # noqa: E402


def stage(name, value):
    print(f"[{name:<12}] {value}")


def main():
    # ── 1. market snapshot (offline fallback quote) ─────────────────────
    from mcos_tpu.api.quotes import fetch_quote

    q = fetch_quote("NIFTY")
    spot = q["price"]
    stage("quote", f"NIFTY {spot:.1f} σ={q['volatility']:.1%} ({q['source']})")

    # ── 2. calibrate the SVJ model to a synthetic chain (COS-generated) ──
    strikes = np.linspace(0.92, 1.08, 9) * spot
    true = SVJParams(kappa=3.0, theta=0.05, xi=0.45, rho=-0.65, v0=0.055,
                     lambda_j=1.2, mu_j=-0.05, sigma_j=0.1)
    T = 0.1
    market = np.asarray(m.cos_price(true, spot, strikes, T, True))
    eng = m.CalibrationEngine()
    fit = eng.calibrate_fast(spot, strikes, T, market, atm_vol=0.22)
    fitted = fit["params"]
    refit = np.asarray(m.cos_price(fitted, spot, strikes, T, True))
    rmse = float(np.sqrt(np.mean((refit - market) ** 2)))
    stage("calibrate", f"κ={float(fitted.kappa):.2f} "
                       f"θ={float(fitted.theta):.4f} "
                       f"v0={float(fitted.v0):.4f} rmse={rmse:.3f}")
    assert rmse < 0.01 * spot, "calibration failed to fit the chain"

    # ── 3. price + honest error bars (RQMC) ─────────────────────────────
    pricer = m.MonteCarloEngine(fitted, num_paths=200_000)
    atm = pricer.price_rqmc(spot, spot, T, randomizations=4)
    stage("price", f"ATM straddle leg {atm['price']:.2f} "
                   f"± {atm['std_error']:.3f} (RQMC, 4 scrambles)")

    # ── 4. all Greeks off one fused device program ───────────────────────
    greeks = m.GreeksEngine(fitted, num_paths=200_000).all_greeks(
        spot, spot, T)
    stage("greeks", f"Δ={greeks['delta']['pathwise']:.3f} "
                    f"Γ={greeks['gamma']['gamma']:.2e} "
                    f"ν/pt={greeks['vega']['vega_per_vol_point']:.1f} "
                    f"λ-sens={greeks['jumps']['lambda_j']:.2f}")
    assert 0.3 < greeks["delta"]["pathwise"] < 0.7

    # ── 5. stress ladders (3 device programs) ────────────────────────────
    stress = StressTestEngine(fitted, num_paths=100_000).full_stress_report(
        spot, spot, T)
    worst = stress["spot_shocks"][0]
    stage("stress", f"worst ladder rung {worst['shock_pct']:+.0f}% → "
                    f"PnL {worst['pnl']:+.1f}")

    # ── 6. exotics + variance swap ───────────────────────────────────────
    ex = ExoticEngine(fitted, num_paths=100_000)
    asian = ex.price_asian(spot, spot, T)
    vswap = variance_swap_fair_strike(fitted, T)
    stage("exotics", f"Asian {asian['price']:.2f} | var-swap vol strike "
                     f"{vswap['fair_vol_strike']:.1%}")
    assert asian["price"] < atm["price"], "Asian must be cheaper than vanilla"

    # corridor structures: double-KO with a knock rebate + the DNT digital
    # (bridge monitoring: exact continuous knock weights at any step count)
    dko = ex.price_double_barrier(spot, spot, T, 0.85 * spot, 1.25 * spot,
                                  rebate=0.02 * spot)
    dnt = ex.price_double_no_touch(spot, T, 0.85 * spot, 1.25 * spot)
    stage("corridor", f"double-KO+rebate {dko['price']:.2f} | DNT stays "
                      f"{dnt['stay_probability']:.1%}")
    assert 0.0 < dnt["stay_probability"] < 1.0
    plain = ex.price_double_barrier(spot, spot, T, 0.85 * spot,
                                    1.25 * spot)
    assert dko["price"] > plain["price"], "rebate must add value"

    # ── 7. multi-asset book: basket + portfolio VaR ──────────────────────
    corr = np.eye(3) * 0.55 + 0.45
    basket = BasketEngine([fitted] * 3, corr, num_paths=100_000).price(
        [spot] * 3, [1 / 3] * 3, spot, T)
    var = portfolio_var([spot] * 3, [0.2, 0.25, 0.3], corr, [1 / 3] * 3, T,
                        num_paths=1_000_000, num_steps=16)
    stage("portfolio", f"basket {basket['price']:.2f} | 99% VaR "
                       f"{var['var']:.2%} CVaR {var['cvar']:.2%}")

    # ── 8. hedge the short straddle leg in the TRUE jump world ───────────
    bt = HedgingBacktest(fitted, seed=7).run_backtest(
        spot, spot, T, num_scenarios=2000, num_mc_paths=50_000,
        dynamics="svj")
    stage("hedge", f"delta-hedge PnL p1={bt['pnl_percentiles']['1%']:.0f} "
                   f"p50={bt['pnl_percentiles']['50%']:.0f} (SVJ world)")

    # ── 9. model risk: reprice the smile under rough Bergomi ─────────────
    from mcos_tpu.engine.rough import RoughBergomiEngine
    from mcos_tpu.ops.rough import RoughBergomiParams
    rb = RoughBergomiEngine(
        RoughBergomiParams(xi=float(fitted.v0), eta=1.9, rho=-0.9,
                           r=float(fitted.r), q=float(fitted.q), hurst=0.07),
        num_paths=65_536, num_steps=64)
    rsk = rb.atm_skew(spot, T)
    stage("rough", f"rBergomi ATM skew {rsk['skew']:.3f} at T={T} "
                   f"(SVJ world has no T^(H-1/2) blowup)")

    # ── 10. counterparty exposure of the sold book ───────────────────────
    from mcos_tpu.engine.exposure import ExposureEngine
    xva = ExposureEngine(
        [spot], [float(np.sqrt(float(fitted.v0)))], [[1.0]],
        [{"kind": "call", "strike": spot, "T": T, "qty": 1.0}],
        r=float(fitted.r), q=[float(fitted.q)], num_paths=50_000)
    credit = xva.cva(hazard_rate=0.02, lgd=0.6, num_dates=16)
    stage("xva", f"EPE {credit['epe']:.2f} | CVA {credit['cva']:.3f} "
                 f"(flat 2% hazard, 60% LGD)")

    # ── 11. structured desk: worst-of autocallable on the index triplet ──
    from mcos_tpu.engine.autocallable import WorstOfAutocallableEngine
    corr_auto = np.full((3, 3), 0.6)
    np.fill_diagonal(corr_auto, 1.0)
    note = WorstOfAutocallableEngine([fitted] * 3, corr_auto,
                                     num_paths=50_000, seed=11).price(
        1.0, n_obs=4, coupon=0.025)
    stage("autocall", f"worst-of note {note['price']:.4f} | first-call "
                      f"p={note['call_prob_by_date'][0]:.2f} | loss "
                      f"p={note['loss_prob']:.3f}")
    assert 0.5 < note["price"] < 1.3

    # ── 12. next morning: P&L explain on the ATM call ────────────────────
    import dataclasses
    from mcos_tpu.engine.pnl import pnl_explain
    bumped = dataclasses.replace(fitted, v0=float(fitted.v0) * 1.15)
    rep = pnl_explain(fitted, bumped, spot, spot * 0.992, T, T - 1 / 252,
                      spot)
    top = max(rep["attribution"], key=lambda k: abs(rep["attribution"][k]))
    stage("pnl", f"ΔP {rep['total_pnl']:+.2f} | top driver {top} "
                 f"{rep['attribution'][top]:+.2f} | unexplained "
                 f"{rep['unexplained']:+.3f}")
    assert abs(rep["unexplained"]) < 0.05 * abs(rep["total_pnl"]) + 0.5

    # ── 13. quote an illiquid strike: how much is model choice? ──────────
    from mcos_tpu.engine.modelrisk import model_risk_report
    mr = model_risk_report(spot, spot * 0.93, T, is_call=False,
                           svj=fitted, num_paths=65_536)
    stage("modelrisk", f"93% put band "
                       f"{mr['model_risk_band_volpts'] * 100:.2f} volpts "
                       f"across {len(mr['prices'])} models")
    assert mr["model_risk_band_volpts"] > 0

    # ── 14. single-stock desk: dividend-aware American quote ─────────────
    from mcos_tpu.engine.american import AmericanEngine
    from mcos_tpu.ops.dividends import DividendSchedule
    divs = DividendSchedule([T * 0.5], [spot * 0.02], "cash")  # 2% ex-date
    am = AmericanEngine(fitted, num_paths=60_000, num_steps=48, seed=7,
                        dividends=divs)
    a_am = am.price(spot, spot, T, is_call=True)
    a_eu = am.price(spot, spot, T, is_call=True, exercise_every=10_000)
    stage("dividends", f"American {a_am['price']:.2f} vs European "
                       f"{a_eu['price']:.2f} | early-ex premium "
                       f"{a_am['price'] - a_eu['price']:+.2f} "
                       f"(2% cash div mid-life)")
    assert a_am["price"] >= a_eu["price"] - 3 * a_eu["std_error"]

    # ── 15. vol desk: swap strikes + VIX futures off the SAME calibration ─
    from mcos_tpu.engine.volderivs import VolDerivsEngine
    vd = VolDerivsEngine(fitted, num_paths=60_000, seed=3)
    vs = vd.variance_swap(T)
    vw = vd.vol_swap(T)
    vf = vd.vix_future(T)
    stage("volderivs", f"var-strike {100 * vs['fair_variance'] ** 0.5:.2f} | "
                       f"vol-strike {100 * vw['fair_vol_strike']:.2f} "
                       f"(cvx {100 * vw['convexity_discount']:.2f}) | "
                       f"VIX fut {100 * vf['future']:.2f}")
    assert vw["fair_vol_strike"] < vs["fair_variance"] ** 0.5  # Jensen

    # ── 16. risk desk: SPAN margin on the hedged book ─────────────────────
    from mcos_tpu.engine.margin import MarginEngine
    mg = MarginEngine(fitted, num_paths=60_000, seed=9)
    book = mg.margin(spot, [spot * 0.95, spot, spot * 1.05],
                     [T, T, T], [False, True, True], [-10.0, -5.0, 5.0])
    stage("margin", f"SPAN margin {book['margin']:.2f} | worst "
                    f"'{book['worst_scenario']}' | net premium "
                    f"{book['net_option_value']:.2f}")
    assert book["margin"] > 0

    # ── 17. structured desk: term-structure bootstrap → forward-start ─────
    # Fit ONE consistent td process to two expiries' chains (COS objective,
    # earlier segments frozen), then price the product only that model can
    # price: a forward-start spanning both expiries.
    from mcos_tpu.engine.termsvj import TDSVJEngine, bootstrap_calibrate_td
    from mcos_tpu.ops.cos_pricer import cos_price

    mats = np.array([T / 2, T])
    chain_strikes = np.array([0.95, 1.0, 1.05]) * spot
    synth = np.stack([
        np.asarray(cos_price(fitted, spot, chain_strikes, float(m), True))
        for m in mats
    ])
    fit_td = bootstrap_calibrate_td(spot, mats, chain_strikes, synth,
                                    fitted, maxiter=60)
    td_eng = TDSVJEngine(fitted, fit_td["seg_ends"], fit_td["thetas"],
                         fit_td["xis"], fit_td["lams"],
                         num_paths=60_000, num_steps=128, seed=21)
    fs = td_eng.price_forward_start(spot, float(mats[0]), T, k=1.0)
    stage("termsvj", f"bootstrap SSE {max(fit_td['errors'].values()):.4f} | "
                     f"forward-start (t1={mats[0]:.3f}) "
                     f"{fs['price']:.5f} ± {fs['std_error']:.5f}")
    assert fs["price"] > 0 and max(fit_td["errors"].values()) < 5.0

    # ── 18. risk cube + higher-order greeks + fit error bars ──────────────
    # The morning-report trio: how does the book P&L across joint spot×vol
    # moves, how fast do delta/gamma bleed, and how much can the fitted
    # params be trusted?
    cube = StressTestEngine(fitted, num_paths=40_000, seed=9).scenario_matrix(
        spot, spot, T, spot_shocks=[-0.05, -0.02, 0.02, 0.05],
        vol_shocks=[-0.03, 0.03])
    worst = min(min(row) for row in cube["pnl"])
    stage("risk cube", f"{len(cube['pnl'])}×{len(cube['pnl'][0])} spot×vol "
                       f"grid | worst cell P&L {worst:.2f}")
    assert worst < 0  # a long option loses somewhere on the grid

    so = m.GreeksEngine(fitted, num_paths=60_000, num_steps=64,
                        seed=9).second_order_greeks(spot, spot, T)
    stage("2nd order", f"charm {so['charm']:.4f}/y | speed {so['speed']:.2e}"
                       f" | zomma {so['zomma']:.2e} | veta {so['veta']:.2f}")
    assert np.isfinite([so["charm"], so["speed"], so["zomma"],
                        so["veta"]]).all()

    unc = m.CalibrationEngine().parameter_uncertainty(
        fitted, spot, strikes, T, market)
    rel = {n: r for n, r in zip(unc["param_names"], unc["rel_errors_pct"])
           if r is not None}
    tightest = min(rel, key=rel.get)
    stage("error bars", f"best-determined param: {tightest} "
                        f"±{rel[tightest]:.1f}% | cond "
                        f"{unc['condition_number']:.1e}")
    assert all(s >= 0 for s in unc["std_errors"])

    # 20) Second opinions without Monte Carlo: the ADI Heston grid prices
    # the fitted book's vanilla AND its knock-out deterministically; the
    # bridge MC and the grid must agree or something is wrong upstream.
    from mcos_tpu.engine.pde import HestonPDEEngine

    hp = fitted.replace(lambda_j=0.0)
    grid = HestonPDEEngine(hp)
    gv = grid.price(spot, spot, T)
    gb = grid.price_barrier(spot, spot, T, spot * 1.12)
    stage("pde grid", f"vanilla {gv['price']:.2f} "
                      f"(Δ={gv['delta']:.3f}, vega/pt="
                      f"{gv['vega_per_vol_point']:.2f}) | 112% KO "
                      f"{gb['price']:.2f}")
    assert 0 < gb["price"] < gv["price"]

    # 21) The desk's index-dispersion book: a Bermudan worst-of put on two
    # correlated names (the classic autocall hedge leg).
    wo = m.BasketEngine(
        [hp, hp.replace(v0=float(hp.v0) * 1.2)],
        [[1.0, 0.6], [0.6, 1.0]], num_paths=60_000,
        seed=4).price_american([spot, spot], spot, T, kind="min",
                               is_call=False, n_ex=6,
                               steps_per_period=4)
    stage("worst-of", f"Bermudan worst-of put {wo['price']:.2f} "
                      f"(se {wo['std_error']:.3f}, {wo['n_exercise']} "
                      f"rights)")
    assert wo["price"] > 0

    print("\nworkflow complete — all sanity checks passed")


if __name__ == "__main__":
    main()
