"""Concurrent serving load test against the resident mcos_tpu API.

Drives N worker threads firing a mixed request stream at a running server
(start it with `python -m mcos_tpu.api.server --port 8000 --warmup` — the
warmup pre-compiles every shape this mix uses, so the measurement is of the
WARM serving path, which is what a desk sees). Reports client-side latency
percentiles per endpoint plus the server's own /api/metrics snapshot, as
one JSON document.

The device work is serialized on one chip (one JAX runtime), so offered
concurrency beyond ~2 mostly measures queueing — the honest serving story
is (throughput at saturation, p50/p95 at a stated concurrency), both of
which this prints.

Usage:
    python benchmarks/loadtest.py --url http://localhost:8000 \
        --concurrency 4 --requests 200
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request
from collections import defaultdict

SPOT, STRIKE, T = 22500.0, 22500.0, 0.1

# The warm request mix: weights roughly follow what the bundled UI fires
# per "Price it" click (price + greeks + convergence + smile) plus an
# occasional stress/exotic. Every shape here is covered by server warmup().
MIX = [
    (5, "/api/price", {"spot": SPOT, "strike": STRIKE, "T": T,
                       "num_paths": 100_000}),
    (2, "/api/price", {"spot": SPOT, "strike": STRIKE, "T": T,
                       "num_paths": 500_000}),
    (2, "/api/price", {"spot": SPOT, "strike": STRIKE, "T": T,
                       "num_paths": 50_000}),
    (3, "/api/greeks", {"spot": SPOT, "strike": STRIKE, "T": T}),
    (2, "/api/smile", {"spot": SPOT, "T": T}),
    (2, "/api/convergence", {"spot": SPOT, "strike": STRIKE, "T": T}),
    (1, "/api/stress", {"spot": SPOT, "strike": STRIKE, "T": T,
                        "num_paths": 50_000}),
    (1, "/api/exotic", {"spot": SPOT, "strike": STRIKE, "T": T,
                        "kind": "asian"}),
]


def _expand_mix():
    seq = []
    for weight, path, body in MIX:
        seq.extend([(path, body)] * weight)
    return seq


def _post(url: str, body: dict, timeout: float = 600.0) -> float:
    data = json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        resp.read()
    return (time.perf_counter() - t0) * 1000.0


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def _pct(xs, q):
    xs = sorted(xs)
    if not xs:
        return None
    idx = min(int(round(q / 100 * (len(xs) - 1))), len(xs) - 1)
    return round(xs[idx], 1)


def run(base_url: str, concurrency: int, total_requests: int) -> dict:
    seq = _expand_mix()
    lat = defaultdict(list)
    errors = []
    lock = threading.Lock()
    counter = {"i": 0}

    def worker():
        while True:
            with lock:
                i = counter["i"]
                if i >= total_requests:
                    return
                counter["i"] = i + 1
            path, body = seq[i % len(seq)]
            try:
                ms = _post(base_url + path, body)
                with lock:
                    lat[path].append(ms)
            except Exception as e:  # noqa: BLE001 — record, keep loading
                with lock:
                    errors.append(f"{path}: {e}")

    # one serial warm pass over every distinct request first, so a cold
    # server doesn't contaminate the measurement with compiles
    for path, body in {(p, json.dumps(b, sort_keys=True)): (p, b)
                       for p, b in seq}.values():
        try:
            _post(base_url + path, body)
        except Exception as e:  # noqa: BLE001
            errors.append(f"warm {path}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0

    done = sum(len(v) for v in lat.values())
    out = {
        "concurrency": concurrency,
        "requests_done": done,
        "errors": errors[:20],
        "error_count": len(errors),
        "wall_seconds": round(wall_s, 2),
        "throughput_rps": round(done / wall_s, 2) if wall_s > 0 else None,
        "endpoints": {
            path: {"n": len(v), "p50_ms": _pct(v, 50), "p95_ms": _pct(v, 95),
                   "max_ms": _pct(v, 100)}
            for path, v in sorted(lat.items())
        },
    }
    allv = [x for v in lat.values() for x in v]
    out["overall"] = {"p50_ms": _pct(allv, 50), "p95_ms": _pct(allv, 95)}
    try:
        out["server_metrics"] = _get(base_url + "/api/metrics")
    except Exception as e:  # noqa: BLE001
        out["server_metrics_error"] = str(e)
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--url", default="http://localhost:8000")
    parser.add_argument("--concurrency", type=int, default=4)
    parser.add_argument("--requests", type=int, default=200)
    args = parser.parse_args()
    print(json.dumps(run(args.url, args.concurrency, args.requests),
                     indent=2))


if __name__ == "__main__":
    main()
