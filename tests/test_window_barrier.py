"""Window (partial) barriers: monitoring restricted to [t1, t2] ⊆ [0, T].

Oracle: `window_barrier_bs` — Gauss-Hermite over the free leg to t1 ×
image-series surviving density over the window × BS value of the free leg
after t2 (host f64). It is pinned to `barrier_bs` in the full-window limit
here, so the MC tests never rest on an unverified formula. The MC
estimator is the bridge survival weight gated to the window's steps —
exact continuous monitoring within the window under GBM, smooth for AD.
"""

import jax
import numpy as np
import pytest

from mcos_tpu.engine.exotics import ExoticEngine
from mcos_tpu.models.params import gbm_params
from mcos_tpu.ops import exotics as ops_exotics
from mcos_tpu.ops.bs import bs_price

S, K, T = 100.0, 100.0, 0.5
R_, Q_, SIG = 0.05, 0.01, 0.3
B_UP = 120.0


def wcf(t1, t2, barrier=B_UP, is_call=True, knock="out"):
    return ops_exotics.window_barrier_bs(S, K, T, R_, Q_, SIG, barrier,
                                         t1, t2, is_call=is_call,
                                         knock=knock)


@pytest.fixture(scope="module")
def eng():
    # num_steps=64 with T=0.5 -> 32 simulated steps, dt = 1/64: the test
    # windows below sit exactly on the grid (no snap error vs the oracle).
    return ExoticEngine(gbm_params(SIG, r=R_, q=Q_), num_paths=100_000,
                        num_steps=64, seed=13)


# ─────────────────────────────────────────────────────────────────────────────
# Oracle self-consistency (f64, no MC)
# ─────────────────────────────────────────────────────────────────────────────
def test_oracle_full_window_limit():
    rr = ops_exotics.barrier_bs(S, K, T, R_, Q_, SIG, B_UP, is_call=True,
                                knock="out", direction="up")
    assert wcf(0.0, T) == pytest.approx(rr, abs=1e-12)      # exact branch
    assert wcf(1e-9, T - 1e-9) == pytest.approx(rr, abs=1e-6)  # quadrature
    dn = ops_exotics.barrier_bs(S, K, T, R_, Q_, SIG, 85.0, is_call=False,
                                knock="out", direction="down")
    assert ops_exotics.window_barrier_bs(
        S, K, T, R_, Q_, SIG, 85.0, 1e-9, T - 1e-9,
        is_call=False) == pytest.approx(dn, abs=1e-6)


def test_oracle_orderings_and_parity():
    # f64 vanilla (bs_price is f32 on device — not tight enough here):
    # an up-and-out with an unreachable barrier is the vanilla.
    vanilla = ops_exotics.barrier_bs(S, K, T, R_, Q_, SIG, 1e9,
                                     is_call=True, knock="out",
                                     direction="up")
    full = wcf(0.0, T)
    early = wcf(0.0, 0.25)
    late = wcf(0.25, T)
    inner = wcf(0.125, 0.375)
    # narrower monitoring window => more likely to survive => dearer KO
    assert full <= min(early, late, inner) + 1e-12
    for v in (early, late, inner):
        assert full - 1e-12 <= v <= vanilla + 1e-12
    # degenerate window = vanilla
    assert wcf(0.2, 0.2) == pytest.approx(vanilla, rel=1e-9)
    # in-out parity at any window
    assert wcf(0.125, 0.375) + wcf(0.125, 0.375, knock="in") \
        == pytest.approx(vanilla, rel=1e-9)
    # nesting: wider window is dominated
    assert wcf(0.125, 0.375) >= wcf(0.0625, 0.4375) - 1e-12


# ─────────────────────────────────────────────────────────────────────────────
# Bridge MC vs the oracle (GBM limit)
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("t1,t2", [(0.0, 0.25), (0.25, 0.5), (0.125, 0.375)])
def test_bridge_window_ko_matches_oracle(eng, t1, t2):
    cf = wcf(t1, t2)
    res = eng.price_barrier(S, K, T, B_UP, True, knock="out",
                            monitoring="bridge", window=(t1, t2))
    assert res["window_effective"] == pytest.approx([t1, t2], abs=1e-9)
    assert abs(res["price"] - cf) < 4 * res["std_error"] + 2e-3, (res, cf)


def test_bridge_window_ki_matches_oracle(eng):
    cf = wcf(0.125, 0.375, knock="in")
    res = eng.price_barrier(S, K, T, B_UP, True, knock="in",
                            monitoring="bridge", window=(0.125, 0.375))
    assert abs(res["price"] - cf) < 4 * res["std_error"] + 2e-3, (res, cf)


def test_full_window_equals_plain_bridge(eng):
    plain = eng.price_barrier(S, K, T, B_UP, True, knock="out",
                              monitoring="bridge")
    full = eng.price_barrier(S, K, T, B_UP, True, knock="out",
                             monitoring="bridge", window=(0.0, T))
    # same seed, same algebra (gating mask is all-true): identical draws,
    # identical increments — bit-equal prices
    assert full["price"] == plain["price"]


def test_window_validation(eng):
    with pytest.raises(ValueError):
        eng.price_barrier(S, K, T, B_UP, window=(0.25, 0.1),
                          monitoring="bridge")
    with pytest.raises(ValueError):
        eng.price_barrier(S, K, T, B_UP, window=(0.0, 0.25))  # discrete
    with pytest.raises(ValueError):
        eng.price_barrier(S, K, T, B_UP, window=(0.0, 0.25),
                          monitoring="bridge", rebate=1.0)


def test_window_greeks_match_f64_fd():
    eng = ExoticEngine(gbm_params(SIG, r=R_, q=Q_), num_paths=150_000,
                       num_steps=64, seed=5)
    g = eng.greeks(S, K, T, kind="barrier", barrier=B_UP, knock="out",
                   monitoring="bridge", window=(0.125, 0.375))
    h = 0.05
    fd = (ops_exotics.window_barrier_bs(S + h, K, T, R_, Q_, SIG, B_UP,
                                        0.125, 0.375)
          - ops_exotics.window_barrier_bs(S - h, K, T, R_, Q_, SIG, B_UP,
                                          0.125, 0.375)) / (2 * h)
    assert g["delta"] == pytest.approx(fd, abs=0.03), (g["delta"], fd)


def test_api_window_roundtrip():
    from mcos_tpu.api.server import ApiError, handle_exotic

    gbm = {"kappa": 1.0, "theta": SIG**2, "xi": 0.0, "rho": 0.0,
           "v0": SIG**2, "lambda_j": 0.0, "mu_j": 0.0, "sigma_j": 0.0,
           "r": R_, "q": Q_}
    out = handle_exotic({"spot": S, "T": T, "kind": "barrier", "strike": K,
                         "barrier": B_UP, "knock": "out", "params": gbm,
                         "window": [0.125, 0.375], "num_paths": 20_000,
                         "with_greeks": True})
    assert out["monitoring"] == "bridge"        # window defaults to bridge
    assert np.isfinite(out["greeks"]["delta"])
    # compare at the grid-snapped window the engine actually monitored
    t1_eff, t2_eff = out["window_effective"]
    cf = wcf(t1_eff, t2_eff)
    assert abs(out["price"] - cf) < 6 * out["std_error"] + 5e-3
    with pytest.raises(ApiError):
        handle_exotic({"spot": S, "T": T, "kind": "barrier", "strike": K,
                       "barrier": B_UP, "window": [0.4, 0.1]})
    with pytest.raises(ApiError):
        handle_exotic({"spot": S, "T": T, "kind": "barrier", "strike": K,
                       "barrier": B_UP, "window": [0.1, 0.4],
                       "monitoring": "discrete"})


def test_sharded_window_matches_oracle():
    from mcos_tpu.parallel.mesh import make_mesh, sharded_exotic_price

    mesh = make_mesh()
    steps, dt = 32, T / 32
    w = (int(round(0.125 / dt)), int(round(0.375 / dt)))
    cf = wcf(w[0] * dt, w[1] * dt)
    df = float(np.exp(-R_ * T))
    res = sharded_exotic_price(
        gbm_params(SIG, r=R_, q=Q_), S, K, T, jax.random.key(2), B_UP,
        mesh=mesh, kind="barrier", num_paths=64_000, num_steps=steps,
        is_call=True, knock="out", direction="up", monitoring="bridge",
        bridge_ctrl_exact=cf / df, window=w)
    assert abs(float(res["price"]) - cf) < 4 * float(res["std_error"]) + 2e-3


def test_window_no_touch_oracle_limits():
    df = float(np.exp(-R_ * T))
    a = ops_exotics.window_no_touch_bs(S, T, R_, Q_, SIG, B_UP, 0.0, T)
    b = df - ops_exotics.one_touch_bs(S, T, R_, Q_, SIG, B_UP, "up")
    assert a == pytest.approx(b, abs=1e-12)
    c = ops_exotics.window_no_touch_bs(S, T, R_, Q_, SIG, 125.0, 0.0, T,
                                       barrier_lo=85.0)
    d = ops_exotics.double_no_touch_bs(S, T, R_, Q_, SIG, 85.0, 125.0)
    assert c == pytest.approx(d, abs=1e-12)
    # degenerate window: certain no-touch
    assert ops_exotics.window_no_touch_bs(
        S, T, R_, Q_, SIG, B_UP, 0.2, 0.2) == pytest.approx(df, abs=1e-12)
    # corridor full-window barrier oracle limit
    e = ops_exotics.window_barrier_bs(S, K, T, R_, Q_, SIG, 125.0, 1e-9,
                                      T - 1e-9, barrier_lo=85.0)
    f = ops_exotics.double_barrier_bs(S, K, T, R_, Q_, SIG, 85.0, 125.0)
    assert e == pytest.approx(f, abs=1e-6)


def test_window_one_touch_matches_oracle(eng):
    df = float(np.exp(-R_ * T))
    cf = df - ops_exotics.window_no_touch_bs(S, T, R_, Q_, SIG, B_UP,
                                             0.125, 0.375)
    res = eng.price_one_touch(S, T, B_UP, monitoring="bridge",
                              window=(0.125, 0.375))
    assert res["closed_form_gbm"] == pytest.approx(cf, rel=1e-9)
    assert abs(res["price"] - cf) < 4 * res["std_error"] + 2e-3, (res, cf)
    with pytest.raises(ValueError):
        eng.price_one_touch(S, T, B_UP, monitoring="bridge",
                            window=(0.125, 0.375), pay_at_hit=True)


def test_window_double_ko_matches_oracle(eng):
    cf = ops_exotics.window_barrier_bs(S, K, T, R_, Q_, SIG, 125.0,
                                       0.125, 0.375, barrier_lo=85.0)
    res = eng.price_double_barrier(S, K, T, 85.0, 125.0,
                                   window=(0.125, 0.375))
    assert res["closed_form_gbm"] == pytest.approx(cf, rel=1e-9)
    assert abs(res["price"] - cf) < 4 * res["std_error"] + 3e-3, (res, cf)


def test_window_dnt_matches_oracle_and_complement(eng):
    df = float(np.exp(-R_ * T))
    cf = ops_exotics.window_no_touch_bs(S, T, R_, Q_, SIG, 125.0,
                                        0.125, 0.375, barrier_lo=85.0)
    dnt = eng.price_double_no_touch(S, T, 85.0, 125.0,
                                    window=(0.125, 0.375))
    dot = eng.price_double_no_touch(S, T, 85.0, 125.0, touch=True,
                                    window=(0.125, 0.375))
    assert abs(dnt["price"] - cf) < 4 * dnt["std_error"] + 2e-3, (dnt, cf)
    assert dnt["price"] + dot["price"] == pytest.approx(df, abs=2e-4)


def test_window_dnt_outside_corridor_not_decided_at_t0():
    """Spot outside the corridor at t=0 but monitoring starts later: the
    contract is NOT decided — the spot can re-enter by t1."""
    e = ExoticEngine(gbm_params(SIG, r=R_, q=Q_), num_paths=60_000,
                     num_steps=64, seed=3)
    res = e.price_double_no_touch(130.0, T, 85.0, 125.0,
                                  window=(0.25, 0.5))
    cf = ops_exotics.window_no_touch_bs(130.0, T, R_, Q_, SIG, 125.0,
                                        0.25, 0.5, barrier_lo=85.0)
    assert res["num_paths_used"] > 0          # not the t=0 early return
    assert cf > 0.01                          # genuinely undecided
    assert abs(res["price"] - cf) < 4 * res["std_error"] + 2e-3, (res, cf)


def test_api_window_one_touch_and_corridor():
    from mcos_tpu.api.server import handle_exotic

    gbm = {"kappa": 1.0, "theta": SIG**2, "xi": 0.0, "rho": 0.0,
           "v0": SIG**2, "lambda_j": 0.0, "mu_j": 0.0, "sigma_j": 0.0,
           "r": R_, "q": Q_}
    out = handle_exotic({"spot": S, "T": T, "kind": "one_touch",
                         "barrier": B_UP, "params": gbm,
                         "window": [0.125, 0.375], "num_paths": 20_000})
    assert abs(out["price"] - out["closed_form_gbm"]) \
        < 6 * out["std_error"] + 5e-3
    out2 = handle_exotic({"spot": S, "T": T, "kind": "double_no_touch",
                          "barrier": 125.0, "barrier_lo": 85.0,
                          "params": gbm, "window": [0.125, 0.375],
                          "num_paths": 20_000})
    assert abs(out2["price"] - out2["closed_form_gbm"]) \
        < 6 * out2["std_error"] + 5e-3


def test_window_corridor_greeks_match_f64_fd():
    e = ExoticEngine(gbm_params(SIG, r=R_, q=Q_), num_paths=120_000,
                     num_steps=64, seed=5)
    g = e.greeks(S, K, T, kind="double_barrier", barrier=125.0,
                 barrier_lo=85.0, monitoring="bridge",
                 window=(0.125, 0.375))
    h = 0.05
    fd = (ops_exotics.window_barrier_bs(S + h, K, T, R_, Q_, SIG, 125.0,
                                        0.125, 0.375, barrier_lo=85.0)
          - ops_exotics.window_barrier_bs(S - h, K, T, R_, Q_, SIG, 125.0,
                                          0.125, 0.375, barrier_lo=85.0)
          ) / (2 * h)
    assert g["delta"] == pytest.approx(fd, abs=0.03), (g["delta"], fd)


# ─────────────────────────────────────────────────────────────────────────────
# Review-fix regressions
# ─────────────────────────────────────────────────────────────────────────────
def test_api_one_touch_with_greeks_and_window():
    """one_touch + with_greeks used to 500 (generic greeks branch raised
    'unknown exotic kind'); now routed through the bridge AD pass."""
    from mcos_tpu.api.server import handle_exotic

    out = handle_exotic({"spot": S, "T": T, "kind": "one_touch",
                         "barrier": B_UP, "window": [0.125, 0.375],
                         "num_paths": 20_000, "with_greeks": True})
    assert np.isfinite(out["greeks"]["delta"])
    out2 = handle_exotic({"spot": S, "T": T, "kind": "one_touch",
                          "barrier": B_UP, "num_paths": 20_000,
                          "with_greeks": True})
    assert np.isfinite(out2["greeks"]["delta"])


def test_api_window_rejected_for_non_barrier_kinds():
    """window on asian/lookback used to be silently ignored -> wrong price."""
    from mcos_tpu.api.server import ApiError, handle_exotic

    for kind, extra in (("asian", {"strike": K}),
                        ("lookback", {}),
                        ("variance_swap", {})):
        with pytest.raises(ApiError) as ei:
            handle_exotic({"spot": S, "T": T, "kind": kind,
                           "window": [0.1, 0.4], "num_paths": 5_000,
                           **extra})
        assert ei.value.status == 400


def test_greeks_validates_window_like_price(eng):
    """greeks() used to silently clamp an inverted window to ~1 step."""
    with pytest.raises(ValueError):
        eng.greeks(S, K, T, kind="barrier", barrier=B_UP,
                   monitoring="bridge", window=(0.4, 0.1))
    with pytest.raises(ValueError):
        eng.greeks(S, K, T, kind="barrier", barrier=B_UP,
                   monitoring="bridge", window=(0.1, 2 * T))


def test_dnt_bad_window_raises_regardless_of_spot():
    """window validation used to be skipped by the spot-outside-corridor
    early return — whether a bad window raised depended on the spot."""
    e = ExoticEngine(gbm_params(SIG, r=R_, q=Q_), num_paths=5_000,
                     num_steps=16, seed=3)
    for spot in (100.0, 130.0):          # inside and outside the corridor
        with pytest.raises(ValueError):
            e.price_double_no_touch(spot, T, 85.0, 125.0,
                                    window=(0.0, 99.0))
        with pytest.raises(ValueError):
            e.price_double_no_touch(spot, T, 85.0, 125.0,
                                    window=(0.1, 0.4),
                                    monitoring="discrete")
