"""Benchmark suite over the framework's workload families.

Run: python benchmarks/suite.py [--quick]
Prints one JSON document with a result block per config, headed by the
device it ran on. The repo-root bench.py is the single-line headline.

Configs:
  1. European call: 50k GBM paths × 250 steps, price + CI vs Black-Scholes.
  2. Full-chain Greeks via pathwise AD (one backward pass per chain).
  3. IV surface: vmapped Newton inversion + SABR fit over strikes × expiries.
  4. Path-dependent payoffs: Asian/barrier/lookback with antithetic + CV.
  5. Portfolio risk: multi-asset correlated GBM at 1e8 paths, VaR/ES.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# Runnable as `python benchmarks/suite.py` from anywhere: the package lives
# at the repo root (this file's parent's parent is not installed).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sync(out):
    """Wait for every device value in `out` (async dispatch)."""
    import jax

    return jax.block_until_ready(out)


def timed(fn, *args, warmup=1, trials=3, **kw):
    for _ in range(warmup):
        out = _sync(fn(*args, **kw))
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        out = _sync(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return out, min(times) * 1000


def config1_european(quick):
    import jax
    from mcos_tpu.engine.pricer import mc_price_core
    from mcos_tpu.models.params import gbm_params
    from mcos_tpu.ops.bs import bs_price

    p = gbm_params(0.2, r=0.065, q=0.012)
    n, steps = (25_000, 250)  # 50k total with antithetic

    def run(seed):
        return mc_price_core(p, 22500.0, np.array([22500.0], np.float32),
                             1.0, jax.random.key(seed),
                             num_paths=n, num_steps=steps)

    res, ms = timed(run, 0)
    ref = float(bs_price(22500.0, 22500.0, 1.0, 0.065, 0.012, 0.2, True))
    price = float(res["price"][0])
    se = float(res["std_error"][0])
    return {
        "workload": "European call 50k paths x 250 steps",
        "price": price, "bs_ref": ref, "std_error": se,
        "abs_error": abs(price - ref),
        "within_3sigma": bool(abs(price - ref) < max(3 * se, 1e-2)),
        "latency_ms": round(ms, 2),
        "path_steps_per_sec": round(2 * n * steps / (ms / 1000)),
    }


def config2_greeks_chain(quick):
    import jax
    from mcos_tpu.engine.greeks import price_and_greeks
    from mcos_tpu.models.params import SVJParams

    p = SVJParams()
    n = 50_000 if quick else 200_000
    strikes = np.linspace(0.9, 1.1, 11) * 22500.0

    def chain(seed):
        outs = []
        for k in strikes:
            outs.append(price_and_greeks(
                p, 22500.0, float(k), 0.1, jax.random.key(seed),
                num_paths=n, num_steps=25, is_call=True))
        return outs

    outs, ms = timed(chain, 0, trials=2)
    deltas = [float(o[1]) for o in outs]

    # Full engine contract: every block of all_greeks (incl. CRN-FD
    # cross-checks and the LR lambda estimator) off ONE memoized backward
    # pass per contract (r2: result memo replaced ~6 redundant executions).
    from mcos_tpu.engine.greeks import GreeksEngine
    eng = GreeksEngine(p, num_paths=n, num_steps=25, seed=0)

    def engine_chain():
        return [eng.all_greeks(22500.0, float(k), 0.1) for k in strikes]

    engine_chain()  # warm compile
    t0 = time.perf_counter()
    eng2 = GreeksEngine(p, num_paths=n, num_steps=25, seed=1)
    [eng2.all_greeks(22500.0, float(k), 0.1) for k in strikes]
    eng_ms = (time.perf_counter() - t0) * 1000

    # Chain serving path: pipelined dispatch, ONE host sync for the whole
    # chain (all_greeks_chain) — the /api/greeks `strikes` mode.
    t0 = time.perf_counter()
    eng3 = GreeksEngine(p, num_paths=n, num_steps=25, seed=2)
    eng3.all_greeks_chain(22500.0, [float(k) for k in strikes], 0.1)
    chain_ms = (time.perf_counter() - t0) * 1000

    return {
        "workload": f"11-strike chain, all first-order Greeks, {n} paths",
        "latency_ms": round(ms, 2),
        "ms_per_contract_all_greeks": round(ms / len(strikes), 2),
        "ms_per_contract_full_engine": round(eng_ms / len(strikes), 2),
        "ms_per_contract_full_engine_chain": round(chain_ms / len(strikes),
                                                   2),
        "delta_range": [min(deltas), max(deltas)],
        "backward_passes_per_contract": 1,
        "reference_kernel_passes_per_contract": 13,
    }


def config3_surface(quick):
    from mcos_tpu.engine.surface import calibrate_sabr, implied_vol_grid, sabr_vol
    from mcos_tpu.ops.bs import bs_price

    n_k, n_t = (21, 6)
    strikes = np.linspace(0.8, 1.2, n_k) * 22500.0
    mats = np.linspace(0.05, 1.0, n_t)
    sigma = 0.2 + 0.1 * np.abs(strikes / 22500.0 - 1.0)[None, :] \
        + 0.02 * np.sqrt(mats)[:, None]
    prices = np.asarray(bs_price(22500.0, strikes[None, :], mats[:, None],
                                 0.065, 0.012, sigma, True))

    # Cold first call (scipy import + jit compile) vs warm steady state —
    # serving latency is the warm number; both are reported.
    t0 = time.perf_counter()
    ivs = implied_vol_grid(prices, 22500.0, strikes[None, :], mats[:, None],
                           0.065, 0.012)
    iv_cold_ms = (time.perf_counter() - t0) * 1000
    t0 = time.perf_counter()
    ivs = implied_vol_grid(prices, 22500.0, strikes[None, :], mats[:, None],
                           0.065, 0.012)
    iv_ms = (time.perf_counter() - t0) * 1000
    max_err = float(np.nanmax(np.abs(np.asarray(ivs) - sigma)))

    F = 22500.0 * np.exp(0.053 * 0.25)
    true_ivs = np.asarray(sabr_vol(F, strikes, 0.25, 1.2, 0.8, -0.4, 0.9))
    iters = 60 if quick else 150
    t0 = time.perf_counter()
    fit = calibrate_sabr(F, strikes, 0.25, true_ivs, beta_fixed=0.8,
                         iters=iters)
    sabr_cold_ms = (time.perf_counter() - t0) * 1000
    t0 = time.perf_counter()
    fit = calibrate_sabr(F, strikes, 0.25, true_ivs, beta_fixed=0.8,
                         iters=iters)
    sabr_ms = (time.perf_counter() - t0) * 1000
    return {
        "workload": f"{n_t}x{n_k} IV grid inversion + SABR fit",
        "iv_grid_ms": round(iv_ms, 2),
        "iv_grid_cold_ms": round(iv_cold_ms, 2),
        "iv_max_abs_error": max_err,
        "sabr_fit_ms": round(sabr_ms, 2),
        "sabr_fit_cold_ms": round(sabr_cold_ms, 2),
        "sabr_fit_error": fit["error"],
    }


def config4_exotics(quick):
    from mcos_tpu.engine.exotics import ExoticEngine
    from mcos_tpu.models.params import gbm_params
    from mcos_tpu.ops.exotics import geometric_asian_bs

    n = 100_000 if quick else 500_000
    eng = ExoticEngine(gbm_params(0.25, r=0.05, q=0.01), num_paths=n,
                       num_steps=64, seed=7)
    t0 = time.perf_counter()
    asian = eng.price_asian(100.0, 100.0, 1.0)
    barrier = eng.price_barrier(100.0, 100.0, 1.0, 130.0, knock="out")
    lookback = eng.price_lookback(100.0, 1.0)
    ms = (time.perf_counter() - t0) * 1000
    geo_cf = float(geometric_asian_bs(100.0, 100.0, 1.0, 0.05, 0.01, 0.25,
                                      asian["num_steps"], True))
    return {
        "workload": f"Asian+barrier+lookback, {n} paths x 64 steps each",
        "total_ms_first_call": round(ms, 1),
        "asian": {"price": asian["price"], "se": asian["std_error"],
                  "cv_beta": asian.get("cv_beta"),
                  "geometric_cf_lower_bound": geo_cf},
        "barrier_up_out": {"price": barrier["price"],
                           "se": barrier["std_error"]},
        "lookback_float": {"price": lookback["price"],
                           "se": lookback["std_error"]},
    }


def config5_portfolio(quick):
    import jax
    from mcos_tpu.engine.risk import multi_asset_gbm_terminal, compute_risk_metrics

    n = 10_000_000 if quick else 100_000_000
    a = 4
    corr = np.full((a, a), 0.4, np.float32)
    np.fill_diagonal(corr, 1.0)
    spots = np.full(a, 100.0, np.float32)
    sigmas = np.linspace(0.15, 0.35, a).astype(np.float32)
    w = np.full(a, 1.0 / a, np.float32)

    def run(seed):
        s = multi_asset_gbm_terminal(spots, sigmas, corr, 0.05, 0.0, 0.25,
                                     jax.random.key(seed),
                                     num_paths=n, num_steps=16)
        rel = s / spots[None, :] - 1.0
        return rel @ w

    rets, ms = timed(run, 0, trials=2)
    m = compute_risk_metrics(rets)
    return {
        "workload": f"{a}-asset correlated GBM, {n:.0e} paths x 16 steps",
        "latency_ms": round(ms, 1),
        "asset_path_steps_per_sec": round(a * n * 16 / (ms / 1000)),
        "var_99": m["var"], "cvar_99": m["cvar"],
    }


def config6_serving_default(quick):
    """The /api/price default configuration (Sobol driver, draws simulator
    chosen by ops/backend.simulator_for) through MonteCarloEngine.price."""
    from mcos_tpu.engine.pricer import MonteCarloEngine
    from mcos_tpu.models.params import SVJParams

    n = 100_000 if quick else 500_000
    eng = MonteCarloEngine(SVJParams(), num_paths=n, seed=42, use_sobol=True)
    _, ms = timed(lambda: eng.price(22500.0, 22600.0, 0.25)["price"],
                  trials=3)
    return {"workload": f"/api/price default body: Sobol driver, {n} paths,"
                        " T=0.25 (63 steps)",
            "latency_ms": round(ms, 1)}


def config7_qe_accuracy(quick):
    """Bias-vs-steps ladder in the regime QE is FOR: high vol-of-vol
    Heston violating Feller (kappa=1, theta=0.09, xi=1.0 — 2*kappa*theta =
    0.18 << xi^2 = 1.0, the same regime tests/test_qe_scheme.py pins).
    Euler full truncation carries a large discretization bias here; QE is
    near-exact at 16 steps. Ladder of (scheme, steps) vs the COS oracle
    with sigma bands — the accuracy-per-step win is the point."""
    import jax
    from mcos_tpu.engine.pricer import MonteCarloEngine
    from mcos_tpu.models.params import SVJParams
    from mcos_tpu.ops.cos_pricer import cos_price

    p = SVJParams(kappa=1.0, theta=0.09, xi=1.0, rho=-0.7, v0=0.04,
                  lambda_j=0.0, mu_j=0.0, sigma_j=0.01)
    spot, strike, T = 22500.0, 22500.0, 1.0
    n = 1 << (17 if quick else 19)
    ref = float(cos_price(p, spot, [strike], T, True)[0])
    out = {"workload": f"ATM Heston (Feller-violating, xi=1.0) T=1.0, "
                       f"{n} paths, vs COS oracle",
           "cos_price": ref}
    # num_steps is per-year; at T=1.0 it is the actual step count.
    ladder = [("qe", 16), ("qe", 64),
              ("euler", 16), ("euler", 64), ("euler", 256)]
    if not quick:
        ladder.append(("euler", 1024))
    for scheme, steps in ladder:
        eng = MonteCarloEngine(p, num_paths=n, num_steps=steps, seed=7,
                               use_sobol=False, scheme=scheme)
        res, ms = timed(lambda: eng.price(spot, strike, T)["price"], trials=2)
        price = float(res)
        eng2 = MonteCarloEngine(p, num_paths=n, num_steps=steps, seed=7,
                                use_sobol=False, scheme=scheme)
        se = eng2.price(spot, strike, T)["std_error"]
        out[f"{scheme}_{steps}steps"] = {
            "price": price, "abs_err": round(abs(price - ref), 4),
            "err_sigmas": round(abs(price - ref) / max(se, 1e-9), 1),
            "latency_ms": round(ms, 1)}
    return out


def config9_new_engines(quick):
    """Latency of the round-2 engine families at serving shapes: rough
    Bergomi (exact-covariance MXU sampling), Heston-Hull-White (3-factor
    scan), PDE (tridiagonal scan), worst-of autocallable (periods scan)."""
    import jax

    from mcos_tpu.engine.hhw import HHWEngine
    from mcos_tpu.engine.pde import PDEEngine
    from mcos_tpu.engine.rough import RoughBergomiEngine
    from mcos_tpu.models.params import SVJParams
    from mcos_tpu.ops.hhw import HHWParams
    from mcos_tpu.ops.rough import RoughBergomiParams

    n = 65_536 if quick else 131_072
    out = {}

    rb = RoughBergomiEngine(
        RoughBergomiParams(xi=0.04, eta=1.9, rho=-0.9, hurst=0.07),
        num_paths=n, num_steps=128, seed=1)
    _, ms = timed(lambda s: rb.price(100.0, [90.0, 100.0, 110.0], 0.25),
                  0, trials=3)
    out["rough_3strike_ms"] = round(ms, 1)
    out["rough_path_rate"] = round(2 * n / (ms / 1000))

    hw = HHWEngine(HHWParams(), num_paths=n, num_steps=128, seed=1)
    _, ms = timed(lambda s: hw.price(100.0, 100.0, 2.0), 0, trials=3)
    out["hhw_ms"] = round(ms, 1)
    out["hhw_path_steps_per_sec"] = round(2 * n * 128 / (ms / 1000))

    pde = PDEEngine(sigma=0.2, n_x=401, n_t=256)
    _, ms = timed(lambda s: pde.price(100.0, 100.0, 0.5), 0, trials=3)
    out["pde_401x256_ms"] = round(ms, 1)

    from mcos_tpu.engine.autocallable import WorstOfAutocallableEngine
    import numpy as _np
    corr = _np.full((3, 3), 0.6)
    _np.fill_diagonal(corr, 1.0)
    wo = WorstOfAutocallableEngine([SVJParams()] * 3, corr,
                                   num_paths=n, seed=1)
    _, ms = timed(lambda s: wo.price(1.0, n_obs=4)["price"], 0, trials=2)
    out["worst_of_autocall_ms"] = round(ms, 1)
    return out


def config10_rough_scaling(quick):
    """Rough Bergomi step-axis scaling: the exact-covariance sampler's
    matmul is O(paths·(2n)²), so latency grows quadratically in steps —
    this row measures where the knee is, and what the conditional
    truncated factorization (dW exact + rank-32 residual + diagonal tail,
    ~half the matmul width) buys back at each n. Accuracy of the
    truncation is pinned separately in tests/test_rough.py."""
    import jax
    import jax.numpy as jnp

    from mcos_tpu.ops.rough import (RoughBergomiParams, rbergomi_chol,
                                    rbergomi_conditional_factor,
                                    rbergomi_conditional_payoffs)

    p = RoughBergomiParams(xi=0.04, eta=1.9, rho=-0.9, hurst=0.07)
    paths = 32_768 if quick else 131_072
    T = 1.0
    disc = float(np.exp(-p.r * T))
    out = {"workload": f"ATM T=1, {paths} paths, exact vs conditional "
                       "rank-32 factorization"}
    steps_ladder = (64, 256) if quick else (64, 256, 1024)
    for n in steps_ladder:
        chol = jnp.asarray(rbergomi_chol(p.hurst, T, n))

        def run_exact(_):
            pay = rbergomi_conditional_payoffs(
                p, 100.0, jnp.asarray([100.0]), T, chol, jax.random.key(3),
                num_paths=paths, num_steps=n, is_call=True)
            return float(pay.mean())

        px, ms = timed(run_exact, 0, trials=3)
        row = {"exact_ms": round(ms, 1),
               "exact_paths_per_sec": round(2 * paths / (ms / 1000)),
               "exact_price": round(disc * px, 4)}

        fac, tail = rbergomi_conditional_factor(p.hurst, T, n, rank=32)
        fac = jnp.asarray(fac)
        tail = jnp.asarray(tail)

        def run_cond(_):
            pay = rbergomi_conditional_payoffs(
                p, 100.0, jnp.asarray([100.0]), T, fac, jax.random.key(3),
                num_paths=paths, num_steps=n, is_call=True, diag_tail=tail)
            return float(pay.mean())

        pc, ms_c = timed(run_cond, 0, trials=3)
        row.update(cond_ms=round(ms_c, 1),
                   cond_paths_per_sec=round(2 * paths / (ms_c / 1000)),
                   cond_price=round(disc * pc, 4),
                   speedup=round(ms / ms_c, 2))

        # Markovian lift: O(n·m) factor scan — the route that breaks the
        # O(n²) wall outright (engine sampler="auto" takes it at n ≥ 512).
        from mcos_tpu.ops.rough import (rbergomi_lift,
                                        rbergomi_lifted_payoffs)

        c_l, d_l, g_l, tail_l = rbergomi_lift(p.hurst, T, n)

        def run_lift(_):
            pay = rbergomi_lifted_payoffs(
                p, 100.0, jnp.asarray([100.0]), T, jax.random.key(3),
                c_l, d_l, g_l, tail_l, num_paths=paths, num_steps=n,
                is_call=True)
            return float(pay.mean())

        pl_, ms_l = timed(run_lift, 0, trials=3)
        row.update(lift_ms=round(ms_l, 1),
                   lift_paths_per_sec=round(2 * paths / (ms_l / 1000)),
                   lift_price=round(disc * pl_, 4),
                   lift_speedup=round(ms / ms_l, 2))
        out[f"steps_{n}"] = row

    # Path-DEPENDENT payoffs through the lift: the lifted path-stats
    # sampler (`rbergomi_path_stats_lifted`) against the O(n²) exact
    # sheet. The row times one full (terminal, mean, max, min) stats pass
    # + an ATM asian reduce at the deepest ladder rung.
    from mcos_tpu.ops.rough import (rbergomi_path_stats,
                                    rbergomi_path_stats_lifted)

    n_pd = steps_ladder[-1]
    paths_pd = 32_768 if quick else 131_072
    chol_pd = jnp.asarray(rbergomi_chol(p.hurst, T, n_pd))
    c_p, d_p, g_p, tail_p = rbergomi_lift(p.hurst, T, n_pd)

    def asian_exact(_):
        st = rbergomi_path_stats(p, 100.0, T, chol_pd, jax.random.key(3),
                                 num_paths=paths_pd, num_steps=n_pd)
        return float(jnp.maximum(st["s_mean"] - 100.0, 0.0).mean())

    def asian_lift(_):
        st = rbergomi_path_stats_lifted(
            p, 100.0, T, jax.random.key(3), c_p, d_p, g_p, tail_p,
            num_paths=paths_pd, num_steps=n_pd)
        return float(jnp.maximum(st["s_mean"] - 100.0, 0.0).mean())

    pe_a, ms_ex = timed(asian_exact, 0, trials=3)
    pl_a, ms_li = timed(asian_lift, 0, trials=3)
    row_pd = {
        "workload": f"asian path-stats pass, {paths_pd} paths x 2 "
                    f"branches x {n_pd} steps (exact sheet vs lift)",
        "exact_ms": round(ms_ex, 1),
        "lift_scan_ms": round(ms_li, 1),
        "lift_scan_speedup": round(ms_ex / ms_li, 2),
        "exact_asian": round(disc * pe_a, 4),
        "lift_scan_asian": round(disc * pl_a, 4),
    }
    out[f"path_dependent_{n_pd}"] = row_pd
    return out


def config12_corridor(quick):
    """Double-barrier corridor: the bridge estimator's accuracy-per-step
    win over discrete monitoring (exact continuous knock weights at ANY
    step count vs the O(1/sqrt(n)) grid-extremum bias). GBM limit so `double_barrier_bs` (image-series corridor quadrature,
    host f64) is the exact oracle."""
    import jax

    from mcos_tpu.engine.exotics import ExoticEngine
    from mcos_tpu.models.params import gbm_params
    from mcos_tpu.ops.exotics import double_barrier_bs

    n = 1 << 18 if quick else 1 << 20
    gp = gbm_params(0.3, r=0.05, q=0.01)
    cf = double_barrier_bs(100.0, 100.0, 0.5, 0.05, 0.01, 0.3, 85.0, 125.0)
    out = {"workload": f"double KO 85/125, {n} paths, GBM sigma=0.30",
           "oracle_corridor_quadrature": round(cf, 5), "ladder": []}
    # T=0.5 halves the maturity-scaled step count (floor 10): report the
    # steps the simulation actually took. The bridge rows' bias_abs sits
    # at the f32 floor at EVERY depth (the CV collapses se to ~1e-8, so
    # bias_sigma is not meaningful there — bias_abs is the headline).
    for steps in (16, 32, 64, 128, 256):
        row = {}
        for mon in ("discrete", "bridge"):
            eng = ExoticEngine(gp, num_paths=n, num_steps=steps, seed=7)
            res = eng.price_double_barrier(100.0, 100.0, 0.5, 85.0, 125.0,
                                           monitoring=mon)
            row["steps"] = res["num_steps"]
            se = max(res["std_error"], 1e-12)
            row[mon] = {"price": round(res["price"], 5),
                        "se": float(f"{se:.2e}"),
                        "bias_abs": round(abs(res["price"] - cf), 5)}
        out["ladder"].append(row)

    return out


def config13_pde_multiasset(quick):
    """ADI Heston PDE grid (price + barrier) and the multi-asset Bermudan
    LSM: wall time + accuracy vs their oracles (COS / Reiner-Rubinstein /
    the Broadie-Glasserman table)."""
    import jax

    from mcos_tpu.engine.basket import BasketEngine
    from mcos_tpu.engine.pde import HestonPDEEngine
    from mcos_tpu.models.params import SVJParams, gbm_params
    from mcos_tpu.ops.cos_pricer import heston_price

    p = SVJParams(kappa=3.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04,
                  lambda_j=0.0)
    eng = HestonPDEEngine(p, n_t=64 if quick else 128)
    _, adi_ms = timed(lambda: eng.price(100.0, 100.0, 0.5)["price"],
                      warmup=1, trials=3)
    adi = eng.price(100.0, 100.0, 0.5)
    exact = float(heston_price(p, 100.0, [100.0], 0.5, True)[0])
    _, bar_ms = timed(lambda: eng.price_barrier(
        100.0, 100.0, 0.5, 120.0)["price"], warmup=1, trials=3)

    n = 20_000 if quick else 100_000
    gp = gbm_params(0.2, r=0.05, q=0.10)
    beng = BasketEngine([gp, gp], [[1.0, 0.0], [0.0, 1.0]],
                        num_paths=n, seed=7)
    _, lsm_ms = timed(lambda: beng.price_american(
        [100.0, 100.0], 100.0, 3.0, kind="max", n_ex=9,
        steps_per_period=1)["price"], warmup=1, trials=2)
    mc = beng.price_american([100.0, 100.0], 100.0, 3.0, kind="max",
                             n_ex=9, steps_per_period=1)
    return {
        "workload": f"ADI {eng.n_x}x{eng.n_v}x{eng.n_t} grid; "
                    f"2-asset 9-right max-call, {n} paths",
        "adi_solve_ms": round(adi_ms, 2),
        "adi_abs_error_vs_cos": round(abs(adi["price"] - exact), 5),
        "adi_barrier_solve_ms": round(bar_ms, 2),
        "maxcall_lsm_ms": round(lsm_ms, 2),
        "maxcall_price": round(mc["price"], 4),
        "maxcall_published": 13.90,
        "maxcall_std_error": round(mc["std_error"], 4),
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true",
                        help="smaller workloads (CPU-friendly)")
    parser.add_argument("--only", default=None,
                        help="run only configs whose name contains this "
                             "substring (e.g. --only config7)")
    args = parser.parse_args()

    import jax

    dev = jax.devices()[0]
    report = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}}
    for name, fn in [("config1_european", config1_european),
                     ("config2_greeks_chain", config2_greeks_chain),
                     ("config3_surface", config3_surface),
                     ("config4_exotics", config4_exotics),
                     ("config5_portfolio", config5_portfolio),
                     ("config6_serving_default", config6_serving_default),
                     ("config7_qe_accuracy", config7_qe_accuracy),
                     ("config9_new_engines", config9_new_engines),
                     ("config10_rough_scaling", config10_rough_scaling),
                     ("config12_corridor", config12_corridor),
                     ("config13_pde_multiasset", config13_pde_multiasset)]:
        if args.only and args.only not in name:
            continue
        try:
            report[name] = fn(args.quick)
        except Exception as e:  # noqa: BLE001 — report partial results
            report[name] = {"error": f"{type(e).__name__}: {e}"}
    print(json.dumps(report, indent=2, default=float))


if __name__ == "__main__":
    main()
