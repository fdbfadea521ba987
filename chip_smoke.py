"""On-card smoke run: the pricing service's main path on one NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded comparisons

Phases (one process, which is the only one to use the card):

1. device  — JAX's device list; the card's name and power limit from
   `nvidia-smi` (a child process that does not import JAX). Anything but a
   GPU stops the run with a non-zero exit before any result is printed.
2. server  — the HTTP server (`api/server.py:serve`) on a localhost port in
   a thread: /api/health, /api/price at its defaults (500k paths, Sobol +
   bridge, Euler, antithetic, companion CV) at T=0.04 and T=1.0 against
   Black–Scholes (degenerate SVJ) and the COS oracle (full SVJ),
   /api/greeks at its defaults, and a burst of 8 concurrent requests that
   the coalescer batches, checked against the solo answers.
3. kernel  — the GPU draws kernel (`ops/draws_kernel.py`) against its scan
   twin on the same draws at 500k paths x 252 steps, both antithetic
   branches and the companion leg; then MonteCarloEngine.price warm with
   each simulator at T=1.0 and T=0.04.
4. tests   — the test suite's `gpu`-marked tests, in this process.
5. breadth — `smoke_test.main()`: every model family compiles and runs.

With `--four-cards` only the four-card comparisons run: the auto-mesh
sharded Sobol price at 2^21 paths x 252 steps against the single-card
price of the same global point set, and the sharded portfolio VaR against
the unsharded one.

Every phase prints its numbers; the last line of standard output is one JSON
object, {"ok": true, "device": {...}}, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

SPOT = 22500.0
# Degenerate SVJ for the Black–Scholes oracle (reference verify.py:29-30).
GBM = {"kappa": 1.0, "theta": 0.04, "xi": 1e-4, "rho": 0.0, "v0": 0.04,
       "lambda_j": 0.0, "mu_j": 0.0, "sigma_j": 0.01}
# Euler discretization allowance against the COS oracle at dt ≈ 1/252
# (tests/test_cos_pricer.py:test_mc_matches_cos_full_svj): 0.15% of price.
EULER_BIAS = 0.0015
# In the degenerate limit the control variate collapses std_error below the
# f32 resolution of a price summed over 500k paths; this relative floor
# (about 10 f32 ulps of the price) is added to 3 std_error.
F32_PRICE_FLOOR = 1e-5
# Kernel vs scan: the same f32 inputs, but Triton and XLA may order and
# contract (FMA) the step arithmetic differently, and the difference
# compounds over 252 steps. Bounds: a few ulps of growth per step.
KERNEL_RTOL_S = 2e-5      # S_T and G_T, relative
KERNEL_ATOL_V = 2e-6      # v_T, absolute (v is truncated at 0)
KERNEL_RTOL_PRICE = 1e-5
# Coalesced vs solo: the same per-member program inside a larger jit; f32
# reductions may be ordered differently.
COALESCE_RTOL = 1e-5


class PhaseFailed(Exception):
    pass


def check(label: str, ok: bool, detail: str = "") -> None:
    print(f"    {label}: {'PASS' if ok else 'FAIL'} {detail}".rstrip(),
          flush=True)
    if not ok:
        raise PhaseFailed(label)


def card_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def _median_ms(fn, trials: int) -> float:
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ─────────────────────────────────────────────────────────────────────────────
# Phase 2: the HTTP server
# ─────────────────────────────────────────────────────────────────────────────
class _Client:
    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"

    def get(self, path: str) -> dict:
        with urllib.request.urlopen(self.base + path, timeout=600) as r:
            return json.loads(r.read())

    def post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())


def phase_server(num_paths: int = 500_000, warm_trials: int = 5) -> None:
    import jax

    from mcos_tpu.api import coalesce
    from mcos_tpu.api.server import serve
    from mcos_tpu.models.params import SVJParams
    from mcos_tpu.ops.bs import bs_price
    from mcos_tpu.ops.cos_pricer import cos_price

    print("\n[server]", flush=True)
    httpd = serve("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        client = _Client(httpd.server_address[1])
        health = client.get("/api/health")
        check("GET /api/health", health.get("status") == "healthy")

        svj = SVJParams()
        for T in (0.04, 1.0):
            body = {"spot": SPOT, "strike": SPOT, "T": T, "params": GBM}
            if num_paths != 500_000:
                body["num_paths"] = num_paths
            t0 = time.perf_counter()
            res = client.post("/api/price", body)
            first_ms = (time.perf_counter() - t0) * 1e3
            warm_ms = _median_ms(lambda: client.post("/api/price", body),
                                 warm_trials)
            bs = float(bs_price(SPOT, SPOT, T, 0.065, 0.012, 0.2, True))
            se = res["std_error"]
            print(f"    /api/price T={T} steps={res['num_steps']} "
                  f"paths={res['num_paths_used']}: first {first_ms:.1f} ms "
                  f"(compile included), warm median {warm_ms:.3f} ms",
                  flush=True)
            tol = 3 * se + F32_PRICE_FLOOR * bs
            check(f"degenerate SVJ vs Black-Scholes at T={T}",
                  abs(res["price"] - bs) < tol,
                  f"(MC {res['price']:.4f} BS {bs:.4f} se {se:.4f} "
                  f"tol {tol:.4f})")
            body_svj = dict(body, params=svj.as_dict())
            res = client.post("/api/price", body_svj)
            ref = float(cos_price(svj, SPOT, [SPOT], T, True)[0])
            tol = 3 * res["std_error"] + EULER_BIAS * ref
            check(f"full SVJ vs COS at T={T}", abs(res["price"] - ref) < tol,
                  f"(MC {res['price']:.4f} COS {ref:.4f} tol {tol:.4f})")

        body = {"spot": SPOT, "strike": SPOT, "T": 0.25}
        t0 = time.perf_counter()
        greeks = client.post("/api/greeks", body)
        first_ms = (time.perf_counter() - t0) * 1e3
        warm_ms = _median_ms(lambda: client.post("/api/greeks", body),
                             warm_trials)
        delta = greeks["delta"]
        print(f"    /api/greeks: first {first_ms:.1f} ms, warm median "
              f"{warm_ms:.3f} ms, delta {delta}", flush=True)
        check("/api/greeks: ATM call delta in (0, 1), AD = CRN-FD to 0.02",
              0.0 < delta["pathwise"] < 1.0
              and abs(delta["pathwise"] - delta["finite_diff"]) < 0.02)

        strikes = [SPOT * (0.94 + 0.02 * i) for i in range(8)]
        bodies = [{"spot": SPOT, "strike": k, "T": 0.04} for k in strikes]
        if num_paths != 500_000:
            for b in bodies:
                b["num_paths"] = num_paths
        solo = [client.post("/api/price", b)["price"] for b in bodies]
        batches0 = coalesce.coalescer.batches_run
        burst = None
        for _ in range(3):   # the first burst also compiles the batch sizes
            with ThreadPoolExecutor(len(bodies)) as pool:
                t0 = time.perf_counter()
                burst = list(pool.map(
                    lambda b: client.post("/api/price", b)["price"], bodies))
                burst_ms = (time.perf_counter() - t0) * 1e3
        n_batches = coalesce.coalescer.batches_run - batches0
        print(f"    burst of {len(bodies)} x 3: {n_batches} batches run, "
              f"last burst {burst_ms:.1f} ms", flush=True)
        check("coalescer formed batches (fewer programs than requests)",
              n_batches < 3 * len(bodies))
        worst = max(abs(a - b) / abs(b) for a, b in zip(burst, solo))
        check("coalesced answers match solo answers", worst <= COALESCE_RTOL,
              f"(max rel diff {worst:.2e})")
        stats = jax.devices()[0].memory_stats() or {}
        print(f"    peak_bytes_in_use after the price phase: "
              f"{stats.get('peak_bytes_in_use')}", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)


# ─────────────────────────────────────────────────────────────────────────────
# Phase 3: kernel against the scan reference
# ─────────────────────────────────────────────────────────────────────────────
def phase_kernel(num_paths: int = 500_000, num_steps: int = 252,
                 kernel=None, trials: int = 10) -> None:
    from unittest import mock

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcos_tpu.engine import pricer
    from mcos_tpu.engine.pricer import MonteCarloEngine, mc_price_from_draws
    from mcos_tpu.models.params import SVJParams
    from mcos_tpu.ops import simulate
    from mcos_tpu.ops.draws_kernel import svj_terminal_from_draws_kernel

    kernel = kernel or svj_terminal_from_draws_kernel
    scan = simulate.simulate_terminal_from_draws_pair
    print("\n[kernel]", flush=True)
    p = SVJParams()
    eng = MonteCarloEngine(p, num_paths=num_paths, num_steps=num_steps)
    z1, z2, _, zj = eng._sobol_draws(num_steps)
    u = jax.random.uniform(jax.random.key(eng.seed + 1), z1.shape,
                           jnp.float32)   # the pricer's jump uniforms
    args = (p, SPOT, 1.0, z1, z2, u, zj)
    t0 = time.perf_counter()
    ker = jax.block_until_ready(kernel(*args, companion=True))
    print(f"    kernel first call {time.perf_counter() - t0:.2f} s "
          f"(compile included) at {num_paths} paths x {num_steps} steps",
          flush=True)
    ref = jax.block_until_ready(scan(*args, companion=True))
    for name, k, r in zip(("S_T", "v_T", "G_T"), ker, ref):
        k, r = np.asarray(k, np.float64), np.asarray(r, np.float64)
        d = np.abs(k - r)
        rel = float(np.max(d / np.maximum(np.abs(r), 1e-30)))
        print(f"    {name}: max abs diff {float(d.max()):.3e}, max rel diff "
              f"{rel:.3e}", flush=True)
        if name == "v_T":
            check("v_T within tolerance", float(d.max()) <= KERNEL_ATOL_V)
        else:
            check(f"{name} within tolerance", rel <= KERNEL_RTOL_S)
    strikes = jnp.asarray([0.95 * SPOT, SPOT, 1.05 * SPOT], jnp.float32)
    prices = [np.asarray(mc_price_from_draws(
        p, SPOT, strikes, 1.0, z1, z2, u, zj, steps_major=True,
        simulator=sim)["price"], np.float64) for sim in (kernel, scan)]
    rel = float(np.max(np.abs(prices[0] - prices[1]) / np.abs(prices[1])))
    print(f"    prices kernel {prices[0]} scan {prices[1]} max rel diff "
          f"{rel:.3e}", flush=True)
    check("prices within tolerance", rel <= KERNEL_RTOL_PRICE)

    for name, sim in (("kernel", kernel), ("scan", scan)):
        ms = _median_ms(lambda: jax.block_until_ready(
            sim(*args, companion=True)), trials)
        print(f"    simulator alone, {name}: warm median {ms:.3f} ms",
              flush=True)
    # End to end through the user's entry point, each simulator in turn
    # (kernel, scan, scan, kernel).
    for T in (1.0, 0.04):
        eng.price(SPOT, SPOT, T)
        for name in ("kernel", "scan", "scan", "kernel"):
            sim = kernel if name == "kernel" else scan
            with mock.patch.object(pricer, "simulator_for",
                                   lambda *a, _s=sim, **k: _s):
                eng.price(SPOT, SPOT, T)       # compile outside the timing
                ms = _median_ms(lambda: eng.price(SPOT, SPOT, T), trials)
            print(f"    MonteCarloEngine.price T={T}, {name}: warm median "
                  f"{ms:.3f} ms", flush=True)


# ─────────────────────────────────────────────────────────────────────────────
# Phases 4 and 5: marked tests, every model family
# ─────────────────────────────────────────────────────────────────────────────
def phase_tests() -> None:
    import os

    import pytest

    print("\n[tests]", flush=True)

    class Count:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed:
                self.failed += 1
            elif report.skipped:
                self.skipped += 1

    counter = Count()
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "tests/"], plugins=[counter])
    check("gpu-marked tests", rc == 0 and counter.passed > 0
          and counter.failed == 0 and counter.skipped == 0,
          f"({counter.passed} passed, {counter.failed} failed, "
          f"{counter.skipped} skipped)")


def phase_breadth() -> None:
    import smoke_test

    print("\n[breadth]", flush=True)
    check("smoke_test.main() (every stage)", smoke_test.main() == 0)


# ─────────────────────────────────────────────────────────────────────────────
# Four cards
# ─────────────────────────────────────────────────────────────────────────────
# The sharded Sobol driver partitions ONE global point set of 2^m points, so
# the single-card comparison runs exactly 2^21 paths. Under degenerate SVJ
# (no jumps) both see the same draws and differ only in the order of f32
# sums; with jumps the jump uniforms differ (per-device streams), so the
# full-SVJ comparison is statistical.
FOUR_CARD_PATHS = 1 << 21
SHARDED_RTOL_DEGENERATE = 1e-5


def phase_four_cards(num_paths: int = FOUR_CARD_PATHS,
                     var_paths: int = 8_000_000) -> None:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from mcos_tpu.engine.pricer import MonteCarloEngine
    from mcos_tpu.engine.risk import portfolio_var
    from mcos_tpu.models.params import SVJParams, gbm_params

    print("\n[four cards]", flush=True)
    check("four devices", len(jax.devices()) == 4,
          f"({len(jax.devices())} found)")
    for label, p in (("degenerate SVJ", gbm_params(0.2)),
                     ("full SVJ", SVJParams())):
        out = {}
        for mesh in ("auto", None):
            eng = MonteCarloEngine(p, num_paths=num_paths, mesh=mesh)
            t0 = time.perf_counter()
            res = eng.price(SPOT, SPOT, 1.0)
            first = (time.perf_counter() - t0) * 1e3
            warm = _median_ms(lambda: eng.price(SPOT, SPOT, 1.0), 5)
            out[mesh] = res
            print(f"    {label}, {'4 cards' if mesh else '1 card'}: price "
                  f"{res['price']:.6f} se {res['std_error']:.6f} paths "
                  f"{res['num_paths_used']}; first {first:.1f} ms, warm "
                  f"median {warm:.3f} ms", flush=True)
        a, b = out["auto"], out[None]
        if p.lambda_j == 0.0:
            rel = abs(a["price"] - b["price"]) / abs(b["price"])
            check(f"{label}: sharded = single card to f32 noise",
                  rel <= SHARDED_RTOL_DEGENERATE, f"(rel diff {rel:.2e})")
        else:
            tol = 4 * float(np.hypot(a["std_error"], b["std_error"]))
            check(f"{label}: sharded within 4 joint std_error of single",
                  abs(a["price"] - b["price"]) <= tol,
                  f"(diff {abs(a['price'] - b['price']):.4f} tol {tol:.4f})")

    spots, sigmas = [100.0, 200.0, 50.0, 80.0], [0.2, 0.3, 0.25, 0.15]
    corr = np.eye(4) * 0.7 + 0.3
    w = [0.4, 0.2, 0.2, 0.2]
    kw = dict(num_paths=var_paths, num_steps=32)
    t0 = time.perf_counter()
    sharded = portfolio_var(spots, sigmas, corr, w, 0.1, **kw)
    t_sh = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    single = portfolio_var(spots, sigmas, corr, w, 0.1, **kw,
                           mesh=Mesh(np.asarray(jax.devices()[:1]),
                                     ("paths",)))
    t_one = (time.perf_counter() - t0) * 1e3
    print(f"    portfolio_var {var_paths} paths: sharded VaR {sharded['var']:.6f} "
          f"CVaR {sharded['cvar']:.6f} ({t_sh:.1f} ms, first call); single "
          f"VaR {single['var']:.6f} CVaR {single['cvar']:.6f} "
          f"({t_one:.1f} ms, first call)", flush=True)
    # Different per-device streams: a statistical comparison (the 99% tail
    # of 8M paths holds 80k samples, so quantile noise is well under 1%).
    for k in ("var", "cvar"):
        rel = abs(sharded[k] - single[k]) / abs(single[k])
        check(f"sharded {k} within 2% of unsharded", rel <= 0.02,
              f"(rel diff {rel:.3e})")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card comparisons")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    print(f"[device] {devices} kind={dev.device_kind}", flush=True)
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found platform "
              f"{dev.platform!r}", file=sys.stderr)
        return 2
    print(card_name_and_power_limit(), flush=True)

    from mcos_tpu.utils.checkpoint import enable_compilation_cache

    print(f"    compilation cache: {enable_compilation_cache()}", flush=True)
    phases = ([phase_four_cards] if args.four_cards else
              [phase_server, phase_kernel, phase_tests, phase_breadth])
    t_start = time.perf_counter()
    for phase in phases:
        t0 = time.perf_counter()
        try:
            phase()
        except PhaseFailed as e:
            print(f"FAILED in {phase.__name__}: {e}", file=sys.stderr)
            return 1
        print(f"    {phase.__name__} took {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
