"""Request coalescing (micro-batching) for the serving hot path.

Concurrent `/api/price` requests that share one program *shape* — same
(num_paths, step count, estimator configuration) — are merged into ONE
device program instead of N independent dispatch chains: at concurrency c
the unbatched server pays c × (price + 2 viz) dispatches and host syncs per
window; the coalesced server pays 1 batched program + 1 host sync for the
whole window. The reference has no serving batcher at all — its FastAPI
handler prices one request per call (reference engine/app.py:130-164); this
is the equivalent of a production inference server's dynamic batcher.

Design:
- Leader election per bucket: the first request into an empty bucket
  becomes the leader; it sleeps one batching window (default 3 ms,
  `MCOS_BATCH_WINDOW_MS`), drains whatever arrived, runs the batched
  program, and distributes per-member slices. Followers block on a Future.
- Buckets are keyed on every static of the program: path/step counts, the
  viz recorder's step count, estimator flags, scheme, and is_call. Members
  vary only in traced inputs (params, spot, strike, T), so one executable
  per (bucket, padded batch size) serves every mix of contracts.
- Batch sizes are padded to powers of two (member 0 replicated) to bound
  the number of compiled executables per bucket at log₂(max_batch).
- The member program is the SAME estimator the unbatched path runs
  (`mc_price_from_draws` on the shared Sobol net, with the simulator
  `ops/backend.simulator_for` picks / `mc_price_core` under PRNG, plus the
  two viz recorders), so coalesced and solo responses agree to float32
  noise.
- Failure containment: any batch error is fanned out to every member's
  Future — a request never hangs on a dead leader.

Single-device by construction: the vmapped program runs on the default
device. Under `MCOS_AUTO_MESH` the unbatched route shards each request
over the local mesh instead; coalescing targets the many-small-requests
regime, sharding the few-huge-requests regime.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future
from functools import lru_cache
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import DEFAULT_NUM_STEPS, scaled_steps
from mcos_tpu.engine.pricer import (
    MonteCarloEngine,
    mc_price_core,
    mc_price_from_draws,
)
from mcos_tpu.models.params import SVJParams
from mcos_tpu.ops import simulate

__all__ = ["PriceCoalescer", "coalescer", "bucket_key", "batch_price_viz"]

_VIZ_SAMPLES = 50           # matches handle_price's sample_paths_device call
_TERM_SAMPLES = 1024        # matches terminal_samples_device default
# Largest coalesced program; deeper queues split into several programs.
# Power of two so warmup covers every pad size the batcher can form.
MAX_BATCH = 8


def bucket_key(req) -> Tuple:
    """Static program shape for a PriceRequest (None = not coalescible).

    Importance sampling and RQMC requests run multi-program host logic and
    fall back to the solo path.
    """
    if req.use_importance or req.rqmc_randomizations:
        return None
    num_steps = (req.num_steps if req.num_steps is not None
                 else DEFAULT_NUM_STEPS)
    steps = scaled_steps(num_steps, req.T)
    viz_steps = max(int(num_steps * req.T), 50)
    return (req.num_paths, num_steps, steps, viz_steps, req.use_sobol,
            req.use_antithetic, req.use_control_variate, req.cv_mode,
            req.scheme, req.is_call)


def _pad_size(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return min(b, MAX_BATCH)


@lru_cache(maxsize=256)
def _batched_fn(key: Tuple, batch: int):
    """One jitted (price + viz) program per (bucket, padded size).

    The batch axis is UNROLLED, not vmapped: each member runs the exact
    program the solo serving path runs — including the GPU draws kernel,
    which has no batching rule — so a coalesced response matches a solo
    one and the whole window still costs one dispatch chain + one host
    sync. The win is in dispatches and host syncs, not device parallelism.
    """
    (num_paths, num_steps, steps, viz_steps, use_sobol, use_antithetic,
     use_control_variate, cv_mode, scheme, is_call) = key
    seed = 42  # serving engines are constructed with the default seed

    def member(params, spot, strike, T, draws):
        if use_sobol:
            z1, z2, u_jump, z_js = draws
            res = mc_price_from_draws(
                params, spot, strike, T, z1, z2, u_jump, z_js, seed=seed,
                is_call=is_call, antithetic=use_antithetic,
                control_variate=use_control_variate, cv_mode=cv_mode,
                cv_beta="one", steps_major=True, scheme=scheme)
        else:
            res = mc_price_core(
                params, spot, strike, T, jax.random.key(seed),
                num_paths=num_paths, num_steps=steps, is_call=is_call,
                antithetic=use_antithetic,
                control_variate=use_control_variate, cv_mode=cv_mode,
                cv_beta="one", scheme=scheme)
        paths = simulate.simulate_paths_recorded(
            params, spot, T, jax.random.key(seed + 999),
            num_paths=_VIZ_SAMPLES, num_steps=viz_steps)
        s_final, _, _ = simulate.simulate_terminal(
            params, spot, T, jax.random.key(seed + 1234),
            num_paths=_TERM_SAMPLES, num_steps=steps, antithetic=False)
        return res, paths, s_final[0]

    def run(params_b, spots, strikes, Ts, draws):
        outs = [member(jax.tree.map(lambda x: x[i], params_b),
                       spots[i], strikes[i], Ts[i], draws)
                for i in range(batch)]
        res = jax.tree.map(lambda *xs: jnp.stack(xs), *[o[0] for o in outs])
        paths = jnp.stack([o[1] for o in outs])
        terms = jnp.stack([o[2] for o in outs])
        return res, paths, terms

    return jax.jit(run)


def batch_price_viz(key: Tuple, members: List[Tuple]) -> List[Dict]:
    """Run one coalesced program over `members` = [(params, spot, strike, T)].

    Returns one dict per member: {"res": pytree of np arrays (strike axis),
    "paths": (viz, steps+1) np, "terms": (n,) np}.
    """
    (num_paths, num_steps, steps, _viz_steps, use_sobol, *_rest) = key
    b = len(members)
    pad = _pad_size(b)
    padded = list(members) + [members[0]] * (pad - b)

    params_b = jax.tree.map(
        lambda *xs: jnp.stack([jnp.asarray(x, jnp.float32) for x in xs]),
        *[m[0] for m in padded])
    spots = jnp.asarray([m[1] for m in padded], jnp.float32)
    strikes = jnp.asarray([[m[2]] for m in padded], jnp.float32)
    Ts = jnp.asarray([m[3] for m in padded], jnp.float32)

    if use_sobol:
        # The module-level Sobol LRU in engine/pricer.py — same net the
        # unbatched serving path reads.
        scheme = key[8]
        eng = MonteCarloEngine(padded[0][0], num_paths=num_paths,
                               num_steps=num_steps, scheme=scheme)
        draws = eng._sobol_draws(steps)
    else:
        draws = (None, None, None, None)

    res, paths, terms = jax.device_get(
        _batched_fn(key, pad)(params_b, spots, strikes, Ts, draws))
    out = []
    for i in range(b):
        out.append({
            "res": jax.tree.map(lambda x: np.asarray(x)[i], res),
            "paths": np.asarray(paths[i]),
            "terms": np.asarray(terms[i]),
        })
    return out


class PriceCoalescer:
    """Leader-elected micro-batcher. Thread-safe; one instance per server."""

    def __init__(self, window_s: float = 0.003, max_batch: int = MAX_BATCH):
        self.window_s = window_s
        self.max_batch = max_batch
        self._lock = threading.Lock()
        # A few batches in flight at once: later batches' dispatch and
        # host-side formatting overlap earlier batches' device execution
        # and result transfer, while leaders held at the semaphore let
        # their buckets keep filling — batch size adapts to offered load
        # with no window tuning (continuous batching, the same discipline
        # LLM inference servers use).
        try:
            n_slots = max(int(os.environ.get("MCOS_BATCH_SLOTS", "4")), 1)
        except ValueError:
            n_slots = 4
        self._slots = threading.BoundedSemaphore(n_slots)
        self._buckets: Dict[Tuple, List] = {}
        self.batches_run = 0
        self.requests_coalesced = 0

    def submit(self, key: Tuple, member: Tuple) -> Dict:
        """Block until this member's slice of a batched run is ready."""
        fut: Future = Future()
        with self._lock:
            queue = self._buckets.setdefault(key, [])
            queue.append((member, fut))
            leader = len(queue) == 1
        if not leader:
            return fut.result(timeout=600)

        if self._slots.acquire(blocking=False):
            # Idle server: a brief window lets co-arriving requests join.
            time.sleep(self.window_s)
        else:
            # Busy server: the wait for a free slot IS the batching window
            # — the bucket keeps filling while earlier batches run.
            self._slots.acquire()
        try:
            return self._drain_and_run(key, fut)
        finally:
            self._slots.release()

    def _drain_and_run(self, key: Tuple, fut: Future) -> Dict:
        with self._lock:
            queue = self._buckets.pop(key, [])
        # Oversized windows split into capped chunks — each still ONE program.
        for lo in range(0, len(queue), self.max_batch):
            chunk = queue[lo:lo + self.max_batch]
            try:
                results = batch_price_viz(key, [m for m, _ in chunk])
            except Exception as exc:  # noqa: BLE001 — fan the error out
                for _, f in chunk:
                    f.set_exception(exc)
                continue
            with self._lock:
                self.batches_run += 1
                self.requests_coalesced += len(chunk)
            for (_, f), r in zip(chunk, results):
                f.set_result(r)
        return fut.result(timeout=600)


def _default_window_s() -> float:
    try:
        ms = float(os.environ.get("MCOS_BATCH_WINDOW_MS", "3"))
    except ValueError:
        ms = 3.0
    return max(ms, 0.0) / 1000.0


#: Process-wide coalescer; window 0 disables coalescing at the call site.
coalescer = PriceCoalescer(window_s=_default_window_s())


def enabled() -> bool:
    return coalescer.window_s > 0.0
