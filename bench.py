"""Headline benchmark: warm `MonteCarloEngine.price` at the served defaults.

The `/api/price` defaults (api/schemas.py:PriceRequest): 500,000 paths,
scrambled Sobol + Brownian bridge, Euler, antithetic, companion control
variate, 252 steps per year; here at T = 1 (252 steps) and T = 0.04
(10 steps).

Prints ONE JSON line naming the device (platform, device_kind, count) with
the median warm latency per maturity and the compile (first-call) time.
Runs only on a GPU: with no GPU it exits non-zero and prints no result.

The run also gates on correctness: in the degenerate-SVJ (GBM) limit the
price must land within 3 std_error (+ an f32 floor of 1e-5 of the price)
of Black-Scholes, or the run fails.

Run: python bench.py
"""

import json
import statistics
import sys
import time


SPOT = STRIKE = 22500.0
SIGMA, R, Q = 0.2, 0.065, 0.012
MATURITIES = (1.0, 0.04)
TRIALS = 20


def main() -> int:
    import jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {device}", file=sys.stderr)
        return 1

    from mcos_tpu.engine.pricer import MonteCarloEngine
    from mcos_tpu.models.params import gbm_params
    from mcos_tpu.ops.bs import bs_price

    eng = MonteCarloEngine(gbm_params(SIGMA, r=R, q=Q))
    out = {"metric": "price_warm_ms", "device": device,
           "num_paths": eng.num_paths, "maturities": {}}
    for T in MATURITIES:
        t0 = time.perf_counter()
        res = eng.price(SPOT, STRIKE, T)   # device_get inside: synced
        first_ms = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(TRIALS):
            t0 = time.perf_counter()
            res = eng.price(SPOT, STRIKE, T)
            times.append((time.perf_counter() - t0) * 1e3)
        ref = float(bs_price(SPOT, STRIKE, T, R, Q, SIGMA, True))
        # The control variate collapses std_error below the f32 resolution
        # of the price; a relative floor of 1e-5 covers that.
        tol = 3.0 * res["std_error"] + 1e-5 * ref
        if not abs(res["price"] - ref) < tol:
            print(f"accuracy gate failed at T={T}: {res['price']} vs BS "
                  f"{ref} (std_error {res['std_error']})", file=sys.stderr)
            return 1
        out["maturities"][str(T)] = {
            "num_steps": res["num_steps"],
            "first_call_ms": first_ms,
            "warm_median_ms": statistics.median(times),
            "warm_min_ms": min(times),
            "price": res["price"], "bs_ref": ref,
            "std_error": res["std_error"],
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
