"""HTTP serving layer for the pricing engine.

Endpoint surface mirrors the reference's FastAPI app (reference:
engine/app.py:125-236) so its dashboards work unchanged:

    GET  /api/health
    POST /api/price      — pre/post guards, price, 50 sample paths, elapsed_ms
    POST /api/greeks     — all Greeks (one AD pass inside)
    POST /api/stress     — spot/vol/gap ladders
    POST /api/regime     — CALM/EVENT/CRISIS classification
    POST /api/hedge      — delta-hedge backtest
    POST /api/smile      — 21-strike smile, batch-priced + IV-inverted
    POST /api/calibrate  — two-stage SVJ calibration (advertised in the
                           reference's docstring engine/app.py:9 but never
                           implemented there; implemented here)
    GET  /api/quote      — market quote (live proxy or offline fallback,
                           see mcos_tpu.api.quotes)

Transport: Python's stdlib ThreadingHTTPServer — the engine needs no ASGI
machinery (every request is one jit call on device; concurrency comes from
the device, not the web layer), and the served path needs no third-party
web package.

Production note: per-endpoint latency is reported as `elapsed_ms` in every
JSON body (engine/app.py:155-156 convention).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import jax
import numpy as np

from mcos_tpu.api import coalesce, schemas
from mcos_tpu.api.validation import ValidationError
from mcos_tpu.utils import fastjson
from mcos_tpu.engine.calibration import CalibrationEngine
from mcos_tpu.engine.greeks import GreeksEngine
from mcos_tpu.engine.guards import PricingGuard
from mcos_tpu.engine.pricer import MonteCarloEngine
from mcos_tpu.engine.regime import RegimeDetector
from mcos_tpu.engine.risk import HedgingBacktest, StressTestEngine
from mcos_tpu.engine.surface import implied_vol

logging.basicConfig(
    level=logging.INFO,
    format="%(asctime)s [%(name)s] %(levelname)s: %(message)s")
logger = logging.getLogger("mcos_tpu.api")

# Admission control: a JSON body bigger than this is rejected before parsing
# (compute-parameter bounds live in the request schemas).
MAX_BODY_BYTES = 10 * 1024 * 1024


class _Metrics:
    """Per-endpoint serving counters: requests, errors, latency EWMA/max.

    Thread-safe via a plain lock (the stdlib transport serves from a thread
    pool); exposed on GET /api/metrics for scrapers.
    """

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, float]] = {}
        self.started = time.time()

    def observe(self, path: str, ms: float, ok: bool) -> None:
        with self._lock:
            st = self._stats.setdefault(
                path, {"count": 0, "errors": 0, "ewma_ms": 0.0,
                       "max_ms": 0.0})
            st["count"] += 1
            if not ok:
                st["errors"] += 1
            alpha = 0.2
            st["ewma_ms"] = ms if st["count"] == 1 else                 alpha * ms + (1 - alpha) * st["ewma_ms"]
            st["max_ms"] = max(st["max_ms"], ms)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "uptime_s": round(time.time() - self.started, 1),
                "endpoints": {k: {kk: round(vv, 2) for kk, vv in v.items()}
                              for k, v in self._stats.items()},
                "coalescer": {
                    "window_ms": coalesce.coalescer.window_s * 1000,
                    "batches_run": coalesce.coalescer.batches_run,
                    "requests_coalesced":
                        coalesce.coalescer.requests_coalesced,
                },
            }


METRICS = _Metrics()

VERSION = "1.0.0"


class ApiError(Exception):
    def __init__(self, status: int, detail):
        super().__init__(str(detail))
        self.status = status
        self.detail = detail


# ─────────────────────────────────────────────────────────────────────────────
# Endpoint implementations (transport-agnostic: dict in, dict out)
# ─────────────────────────────────────────────────────────────────────────────
def handle_health(_body: dict) -> dict:
    return {"status": "healthy", "engine": "SVJ Monte Carlo",
            "version": VERSION}


def handle_price(body: dict) -> dict:
    """Mirror of engine/app.py:130-164."""
    req = schemas.PriceRequest(**body)
    start = time.time()
    svj = req.params.to_params()

    guard = PricingGuard(svj)
    pre = guard.check_pre_price(req.spot, req.strike, req.T)
    if not pre["pass"]:
        raise ApiError(400, {"failures": pre["failures"],
                             "alerts": pre["alerts"]})

    try:
        divs = schemas.build_dividend_schedule(req.dividends,
                                               req.dividend_kind)
    except ValueError as e:
        raise ApiError(400, str(e))
    try:
        curve = schemas.build_rate_curve(req.rate_curve)
    except ValueError as e:
        raise ApiError(400, str(e))
    engine_kwargs = dict(
        num_paths=req.num_paths, use_sobol=req.use_sobol,
        use_antithetic=req.use_antithetic,
        use_control_variate=req.use_control_variate, cv_mode=req.cv_mode,
        scheme=req.scheme, dividends=divs, rate_curve=curve)
    if req.num_steps is not None:
        engine_kwargs["num_steps"] = req.num_steps
    engine = MonteCarloEngine(svj, **engine_kwargs)
    if divs is not None:
        try:
            engine._spot_eff(req.spot, req.T)  # escrow feasibility → 400
        except ValueError as e:
            raise ApiError(400, str(e))

    # Micro-batching: concurrent same-shape requests coalesce into ONE
    # vmapped device program + ONE host sync for the whole batching window
    # (api/coalesce.py). Solo requests pay only the window (default 3 ms).
    # Dividend requests coalesce too: the adjustment is spot-only, so the
    # member simply enters the batch at its effective spot.
    ck = coalesce.bucket_key(req) if coalesce.enabled() else None
    if ck is not None and engine._resolved_mesh() is None:
        # Members enter the batch with their maturity-effective params (rate
        # curve folds into r) and dividend-effective spot — the adjustments
        # are (params, spot)-only, so batching stays exact.
        sl = coalesce.coalescer.submit(
            ck, (engine._params_T(req.T),
                 engine._spot_eff(req.spot, req.T), req.strike, req.T))
        result = engine.format_price(sl["res"], req.T)
        result["sample_paths"] = fastjson.float_array_json(
            np.asarray(sl["paths"]), decimals=2)
        result["terminal_samples"] = fastjson.float_array_json(
            np.asarray(sl["terms"]), decimals=2)
        return _finish_price(result, guard, pre, req, start)

    # Solo path: enqueue every device program for this request (price + both
    # viz samples) BEFORE the first host sync: JAX dispatch is async, so the
    # host waits for the device once per request instead of once per
    # program.
    paths_dev = engine.sample_paths_device(req.spot, req.T, num_samples=50)
    terms_dev = engine.terminal_samples_device(req.spot, req.T)
    if req.use_importance:
        # Exponential tilt toward the strike + likelihood-ratio reweighting —
        # the deep-OTM configuration (engine/pricer.py:mc_price_importance).
        result = engine.price_importance(req.spot, req.strike, req.T,
                                         req.is_call)
        sample_paths, terms = jax.device_get((paths_dev, terms_dev))
    elif req.rqmc_randomizations:
        # R independent Owen scrambles → spread-based (honest QMC) stderr.
        result = engine.price_rqmc(req.spot, req.strike, req.T, req.is_call,
                                   randomizations=req.rqmc_randomizations)
        sample_paths, terms = jax.device_get((paths_dev, terms_dev))
    else:
        res_dev = engine.price_device(req.spot, req.strike, req.T,
                                      req.is_call)
        res, sample_paths, terms = jax.device_get(
            (res_dev, paths_dev, terms_dev))
        result = engine.format_price(res, req.T)

    result["sample_paths"] = fastjson.float_array_json(
        np.asarray(sample_paths), decimals=2)
    result["terminal_samples"] = fastjson.float_array_json(
        np.asarray(terms), decimals=2)
    return _finish_price(result, guard, pre, req, start)


def _finish_price(result: dict, guard: PricingGuard, pre: dict, req,
                  start: float) -> dict:
    """Shared tail of /api/price: post-guards, timing, request echo."""
    post = guard.check_post_price(result, req.spot, req.strike, req.T,
                                  req.is_call)
    result["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    result["pre_checks"] = pre
    result["post_checks"] = post
    result["params_used"] = req.params.model_dump()
    logger.info("Priced %s K=%.0f T=%.4f → %.4f (%.0fms)",
                "Call" if req.is_call else "Put", req.strike, req.T,
                result["price"], result["elapsed_ms"])
    return result


def handle_greeks(body: dict) -> dict:
    """Mirror of engine/app.py:167-176 (AD engine inside)."""
    req = schemas.GreeksRequest(**body)
    start = time.time()
    engine = GreeksEngine(req.params.to_params(), num_paths=req.num_paths)
    try:
        divs = schemas.build_dividend_schedule(req.dividends,
                                               req.dividend_kind)
    except ValueError as e:
        raise ApiError(400, str(e))
    if req.strikes:
        if req.with_cross or req.with_second_order:
            raise ApiError(400, "with_cross/with_second_order are not "
                                "supported in chain mode (strikes list) — "
                                "request those blocks per contract with a "
                                "single strike")
        if divs is not None:
            raise ApiError(400, "dividends are supported in single-contract "
                                "mode only (omit the strikes list)")
        # Chain mode: one pipelined dispatch per contract, ONE host sync.
        greeks = {"chain": engine.all_greeks_chain(
            req.spot, req.strikes, req.T, req.is_call)}
    else:
        if req.strike <= 0:
            raise ApiError(400, "need strike > 0 (or a strikes list)")
        if divs is not None:
            try:
                greeks = engine.all_greeks_dividends(
                    req.spot, req.strike, req.T, req.is_call, divs)
            except ValueError as e:
                raise ApiError(400, str(e))
        else:
            greeks = engine.all_greeks(req.spot, req.strike, req.T,
                                       req.is_call)
        if req.with_cross:
            if divs is not None:
                # Same effective-process + chain-rule recipe as
                # all_greeks_dividends: vanna = ∂²P/∂S∂σ picks up the
                # ∂S_eff/∂S factor; volga (∂²P/∂σ²) is spot-free.
                from mcos_tpu.ops.dividends import effective_spot

                eff, f = effective_spot(req.spot, divs,
                                        float(engine.params.r), req.T)
                cross = engine.cross_greeks(eff, req.strike, req.T,
                                            req.is_call)
                for key in ("vanna", "vanna_cross_check", "vanna_v0"):
                    cross[key] *= f
                greeks["cross"] = cross
            else:
                greeks["cross"] = engine.cross_greeks(req.spot, req.strike,
                                                      req.T, req.is_call)
        if req.with_second_order:
            if divs is not None:
                # charm/color/veta mix ∂/∂T with the T-dependent dividend
                # adjustment (PV roll-off, ex-date crossings) — the clean
                # chain rule used for first-order blocks doesn't close here.
                raise ApiError(400, "with_second_order is not supported "
                                    "with discrete dividends")
            greeks["second_order"] = engine.second_order_greeks(
                req.spot, req.strike, req.T, req.is_call)
        if req.with_min_variance:
            if divs is not None:
                # Δ_mv = f·Δ_eff + ρξ·P_v/S_raw: the two terms chain-rule
                # differently; keep the raw-process contract clean.
                raise ApiError(400, "with_min_variance is not supported "
                                    "with discrete dividends")
            greeks["min_variance"] = engine.min_variance_delta(
                req.spot, req.strike, req.T, req.is_call)
    greeks["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return greeks


def handle_stress(body: dict) -> dict:
    """Mirror of engine/app.py:179-188."""
    req = schemas.StressRequest(**body)
    start = time.time()
    engine = StressTestEngine(req.params.to_params(), num_paths=req.num_paths)
    if req.mode == "matrix":
        if req.spot_shocks is not None and any(
                s <= -0.95 or s >= 4.0 for s in req.spot_shocks):
            raise ApiError(400, "spot_shocks must lie in (-0.95, 4.0)")
        if req.vol_shocks is not None and any(
                abs(s) > 1.0 for s in req.vol_shocks):
            raise ApiError(400, "vol_shocks must lie in [-1.0, 1.0]"
                                " (decimal vol points)")
        report = engine.scenario_matrix(
            req.spot, req.strike, req.T, req.is_call,
            spot_shocks=req.spot_shocks, vol_shocks=req.vol_shocks)
    else:
        report = engine.full_stress_report(req.spot, req.strike, req.T,
                                           req.is_call)
    report["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return report


def handle_regime(body: dict) -> dict:
    """Mirror of engine/app.py:191-196."""
    req = schemas.RegimeRequest(**body)
    return RegimeDetector().classify(req.realized_vol, req.iv_percentile,
                                     req.skew_slope)


def handle_hedge(body: dict) -> dict:
    """Mirror of engine/app.py:199-212."""
    req = schemas.HedgeRequest(**body)
    start = time.time()
    bt = HedgingBacktest(req.params.to_params())
    try:
        result = bt.run_backtest(
            req.spot, req.strike, req.T, req.is_call,
            txn_cost_bps=req.txn_cost_bps, slippage_bps=req.slippage_bps,
            num_scenarios=req.num_scenarios, dynamics=req.dynamics,
            hedge=req.hedge, risk_aversion=req.risk_aversion)
    except ValueError as e:
        raise ApiError(400, str(e))
    result["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return result


def handle_smile(body: dict) -> dict:
    """Mirror of engine/app.py:215-236: 21 strikes over 0.7-1.3·S, one shared
    path set, IVs inverted on the whole chain at once."""
    req = schemas.SmileRequest(**body)
    svj = req.params.to_params()
    try:
        curve = schemas.build_rate_curve(req.rate_curve)
    except ValueError as e:
        raise ApiError(400, str(e))
    if curve is not None:
        svj = svj.replace(r=curve.r_eff(req.T))
    strikes = np.linspace(req.spot * 0.7, req.spot * 1.3, req.num_strikes)
    if req.method == "cos":
        # Exact semi-analytic Bates smile — no MC noise, host-side, ms-scale
        # (capability beyond the reference, whose smile is always MC).
        from mcos_tpu.ops.cos_pricer import cos_price

        prices = np.asarray(cos_price(svj, req.spot, strikes, req.T, True))
        rows = [{"strike": float(k), "price": float(p)}
                for k, p in zip(strikes, prices)]
    elif req.method == "mc":
        engine = MonteCarloEngine(svj, num_paths=req.num_paths)
        rows = engine.price_batch(req.spot, strikes, req.T, is_call=True)
    else:
        raise ApiError(400, f"unknown smile method {req.method!r}")
    smile = []
    for row in rows:
        iv = implied_vol(row["price"], req.spot, row["strike"], req.T,
                         float(svj.r), float(svj.q), True)
        smile.append({
            "strike": row["strike"],
            "price": row["price"],
            "iv": iv if iv is not None else 0.0,
        })
    out = {"smile": smile, "method": req.method}
    if req.with_density:
        from mcos_tpu.ops.cos_pricer import cos_density

        s_grid, pdf = cos_density(svj, req.spot, req.T)
        out["density"] = {
            "s": [round(float(s), 2) for s in s_grid],
            "pdf": [float(p) for p in pdf],
            "forward": float(req.spot * np.exp((svj.r - svj.q) * req.T)),
        }
    return out


def handle_convergence(body: dict) -> dict:
    """POST /api/convergence — true prefix-mean convergence series (the
    reference UI fakes this chart from one price, js/app.js:415-420)."""
    req = schemas.PriceRequest(**body)
    try:
        divs = schemas.build_dividend_schedule(req.dividends,
                                               req.dividend_kind)
        curve = schemas.build_rate_curve(req.rate_curve)
    except ValueError as e:
        raise ApiError(400, str(e))
    engine = MonteCarloEngine(
        req.params.to_params(), num_paths=min(req.num_paths, 500_000),
        use_sobol=False, use_antithetic=req.use_antithetic,
        dividends=divs, rate_curve=curve)
    try:
        return engine.convergence(req.spot, req.strike, req.T, req.is_call)
    except ValueError as e:  # escrowed spot <= 0
        raise ApiError(400, str(e))


def handle_exotic(body: dict) -> dict:
    """POST /api/exotic — Asian / barrier / lookback (beyond the reference)."""
    from mcos_tpu.engine.exotics import ExoticEngine

    req = schemas.ExoticRequest(**body)
    start = time.time()
    _WINDOW_KINDS = ("barrier", "one_touch", "double_barrier",
                     "double_no_touch", "double_one_touch")
    if req.window is not None and req.kind not in _WINDOW_KINDS:
        raise ApiError(400, f"window is not supported for kind "
                            f"{req.kind!r} (barrier-family kinds only)")
    eng = ExoticEngine(req.params.to_params(), num_paths=req.num_paths)
    if req.kind == "asian":
        if req.strike is None:
            raise ApiError(400, "asian requires strike")
        out = eng.price_asian(req.spot, req.strike, req.T, req.is_call,
                              averaging=req.averaging)
    elif req.kind == "barrier":
        if req.strike is None or req.barrier is None:
            raise ApiError(400, "barrier requires strike and barrier")
        if req.rebate_at_hit and req.knock != "out":
            raise ApiError(400, "rebate_at_hit only applies to knock-outs")
        monitoring = req.monitoring
        if req.window is not None:
            if not 0.0 <= req.window[0] < req.window[1] <= req.T:
                raise ApiError(400, "window needs 0 <= t1 < t2 <= T")
            if req.rebate:
                raise ApiError(400, "rebates on window barriers are not "
                                    "offered")
            # window barriers require the bridge estimator; default to it
            # unless the body explicitly asked for something else
            if "monitoring" not in body:
                monitoring = "bridge"
            elif monitoring != "bridge":
                raise ApiError(400, "window barriers need "
                                    "monitoring='bridge'")
        try:
            out = eng.price_barrier(
                req.spot, req.strike, req.T, req.barrier, req.is_call,
                knock=req.knock, monitoring=monitoring, rebate=req.rebate,
                rebate_at_hit=req.rebate_at_hit,
                window=tuple(req.window) if req.window else None)
        except ValueError as e:
            raise ApiError(400, str(e))
    elif req.kind == "one_touch":
        if req.barrier is None:
            raise ApiError(400, "one_touch requires barrier")
        monitoring = req.monitoring
        if req.window is not None:
            if not 0.0 <= req.window[0] < req.window[1] <= req.T:
                raise ApiError(400, "window needs 0 <= t1 < t2 <= T")
            if "monitoring" not in body:
                monitoring = "bridge"
        try:
            out = eng.price_one_touch(
                req.spot, req.T, req.barrier, monitoring=monitoring,
                pay_at_hit=req.pay_at_hit,
                window=tuple(req.window) if req.window else None)
        except ValueError as e:
            raise ApiError(400, str(e))
    elif req.kind == "double_barrier":
        if req.strike is None or req.barrier is None or req.barrier_lo is None:
            raise ApiError(400, "double_barrier requires strike, barrier "
                                "(upper) and barrier_lo (lower)")
        if not req.barrier_lo < req.barrier:
            raise ApiError(400, "double_barrier needs barrier_lo < barrier")
        # bridge is the natural default for corridors (exact continuous
        # monitoring); an explicit request body still wins
        monitoring = req.monitoring if "monitoring" in body else "bridge"
        if req.rebate_at_hit:
            raise ApiError(400, "rebate_at_hit is not offered on double "
                                "barriers (corridor rebates pay at expiry)")
        if req.window is not None \
                and not 0.0 <= req.window[0] < req.window[1] <= req.T:
            raise ApiError(400, "window needs 0 <= t1 < t2 <= T")
        try:
            out = eng.price_double_barrier(
                req.spot, req.strike, req.T, req.barrier_lo, req.barrier,
                req.is_call, knock=req.knock, monitoring=monitoring,
                rebate=req.rebate,
                window=tuple(req.window) if req.window else None)
        except ValueError as e:
            raise ApiError(400, str(e))
    elif req.kind in ("double_no_touch", "double_one_touch"):
        if req.barrier is None or req.barrier_lo is None:
            raise ApiError(400, f"{req.kind} requires barrier (upper) and "
                                "barrier_lo (lower)")
        if not req.barrier_lo < req.barrier:
            raise ApiError(400, f"{req.kind} needs barrier_lo < barrier")
        monitoring = req.monitoring if "monitoring" in body else "bridge"
        if req.window is not None \
                and not 0.0 <= req.window[0] < req.window[1] <= req.T:
            raise ApiError(400, "window needs 0 <= t1 < t2 <= T")
        try:
            out = eng.price_double_no_touch(
                req.spot, req.T, req.barrier_lo, req.barrier,
                touch=(req.kind == "double_one_touch"),
                monitoring=monitoring,
                window=tuple(req.window) if req.window else None)
        except ValueError as e:
            raise ApiError(400, str(e))
    elif req.kind == "lookback":
        out = eng.price_lookback(req.spot, req.T, req.is_call,
                                 strike=req.strike)
    elif req.kind == "digital":
        if req.strike is None:
            raise ApiError(400, "digital requires strike")
        out = eng.price_digital(req.spot, req.strike, req.T, req.is_call)
    elif req.kind == "variance_swap":
        from mcos_tpu.engine.exotics import variance_swap_fair_strike

        out = variance_swap_fair_strike(req.params.to_params(), req.T)
    else:
        raise ApiError(400, f"unknown kind {req.kind!r}")
    if req.with_greeks:
        if req.kind in ("double_barrier", "double_no_touch",
                        "double_one_touch"):
            # corridor Greeks come from the bridge AD pass
            out["greeks"] = eng.greeks(
                req.spot, req.strike if req.strike is not None else 0.0,
                req.T,
                kind=("double_barrier" if req.kind == "double_barrier"
                      else "double_no_touch"),
                is_call=req.is_call, barrier=req.barrier,
                barrier_lo=req.barrier_lo,
                knock=("in" if req.kind == "double_one_touch"
                       else req.knock),
                monitoring="bridge", rebate=req.rebate,
                window=tuple(req.window) if req.window else None)
        elif req.kind == "one_touch":
            out["greeks"] = eng.greeks(
                req.spot, 0.0, req.T, kind="one_touch",
                barrier=req.barrier, monitoring="bridge",
                window=tuple(req.window) if req.window else None)
        elif req.kind == "barrier" and req.window is not None:
            out["greeks"] = eng.greeks(
                req.spot, req.strike if req.strike is not None else 0.0,
                req.T, kind="barrier", is_call=req.is_call,
                barrier=req.barrier, knock=req.knock,
                monitoring="bridge", window=tuple(req.window))
        elif req.kind == "barrier" and req.rebate:
            # rebated-contract greeks need the smooth bridge weight (the
            # CRN-FD homogeneity identity breaks for cash rebates); the
            # at-expiry rebate is what's differentiated — for at-hit
            # contracts the closed-form discount ratio is held fixed.
            out["greeks"] = eng.greeks(
                req.spot, req.strike if req.strike is not None else 0.0,
                req.T, kind="barrier", is_call=req.is_call,
                barrier=req.barrier, knock=req.knock,
                monitoring="bridge", rebate=req.rebate)
        else:
            out["greeks"] = eng.greeks(
                req.spot,
                req.strike if req.strike is not None else 0.0, req.T,
                kind=req.kind, is_call=req.is_call, barrier=req.barrier,
                knock=req.knock, averaging=req.averaging,
                floating=req.kind == "lookback" and req.strike is None)
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_american(body: dict) -> dict:
    """POST /api/american — LSM American pricing (beyond the reference)."""
    from mcos_tpu.engine.american import AmericanEngine

    req = schemas.AmericanRequest(**body)
    start = time.time()
    try:
        divs = schemas.build_dividend_schedule(req.dividends,
                                               req.dividend_kind)
    except ValueError as e:
        raise ApiError(400, str(e))
    try:
        curve = schemas.build_rate_curve(req.rate_curve)
    except ValueError as e:
        raise ApiError(400, str(e))
    eng = AmericanEngine(req.params.to_params(), num_paths=req.num_paths,
                         dividends=divs, rate_curve=curve)
    out = eng.price(req.spot, req.strike, req.T, req.is_call,
                    exercise_every=req.exercise_every)
    if req.with_bounds:
        if divs is not None or curve is not None:
            raise ApiError(400, "with_bounds does not support discrete "
                                "dividends or rate curves yet — use the "
                                "LSM price/greeks")
        out["bounds"] = eng.price_bounds(
            req.spot, req.strike, req.T, req.is_call,
            n_outer=req.n_outer, n_inner=req.n_inner)
    if req.with_greeks:
        out["greeks"] = eng.greeks(req.spot, req.strike, req.T, req.is_call)
    if req.with_cos_oracle:
        if divs is not None or curve is not None:
            raise ApiError(400, "with_cos_oracle does not support discrete "
                                "dividends or rate curves — the COS "
                                "induction needs iid log-increments")
        from mcos_tpu.engine.american import american_cos_oracle

        out["cos_oracle"] = american_cos_oracle(
            req.params.to_params(), req.spot, req.strike, req.T,
            req.is_call)
    if req.with_boundary:
        from mcos_tpu.engine.pde import PDEEngine

        p = req.params.to_params()
        pde = PDEEngine(sigma=float(p.v0) ** 0.5, r=float(p.r),
                        q=float(p.q), n_t=128)
        prop = None
        if divs is not None:
            if divs.kind != "proportional":
                raise ApiError(400, "with_boundary supports proportional "
                                    "dividends only (the CN grid's jump "
                                    "condition is multiplicative)")
            prop = list(zip(divs.times, divs.amounts))
        bd = pde.exercise_boundary(req.spot, req.strike, req.T,
                                   req.is_call, dividends=prop)
        bd["note"] = ("Crank-Nicolson boundary under the BS proxy "
                      "sigma=sqrt(v0); the full SVJ boundary is a "
                      "surface in (S, v)")
        out["exercise_boundary"] = bd
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_pde(body: dict) -> dict:
    """POST /api/pde — deterministic finite-difference pricing: the 2-D ADI
    Heston solve (Craig-Sneyd/Douglas, engine/pde.py:HestonPDEEngine) or
    the 1-D Crank-Nicolson BS grid. A no-Monte-Carlo cross-check route:
    different discretization, different error structure."""
    req = schemas.PDERequest(**body)
    start = time.time()
    p = req.params.to_params()
    if req.model == "heston":
        from mcos_tpu.engine.pde import HestonPDEEngine

        eng = HestonPDEEngine(p, n_x=req.n_x, n_v=req.n_v, n_t=req.n_t,
                              scheme=req.scheme)
        if req.barrier is not None:
            try:
                out = eng.price_barrier(
                    req.spot, req.strike, req.T, req.barrier, req.is_call,
                    knock=req.knock, direction=req.direction,
                    barrier_lo=req.barrier_lo, rebate=req.rebate,
                    rebate_at_hit=req.rebate_at_hit,
                    american=req.american)
            except ValueError as e:
                raise ApiError(400, str(e))
            out["model"] = req.model
            out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
            return out
        try:
            out = eng.price(req.spot, req.strike, req.T, req.is_call,
                            american=req.american)
            if req.with_boundary and req.american:
                out["exercise_boundary"] = eng.exercise_boundary(
                    req.spot, req.strike, req.T, req.is_call)
        except ValueError as e:
            # e.g. sigma_j == 0 with lambda_j > 0: the Merton cell-mass
            # quadrature has no density to integrate (schemas reject
            # sigma_j < 0; the degenerate 0 case is PIDE-specific).
            raise ApiError(400, str(e))
        if req.with_oracle and not req.american:
            # cos_price is the exact BATES CF — the oracle covers the
            # PIDE route (lambda_j > 0) as well as pure Heston.
            from mcos_tpu.ops.cos_pricer import cos_price

            exact = float(cos_price(p, req.spot, [req.strike], req.T,
                                    req.is_call)[0])
            out["cos_oracle"] = {"price": exact,
                                 "abs_error": abs(out["price"] - exact)}
    else:
        from mcos_tpu.engine.pde import PDEEngine

        sigma = req.sigma if req.sigma is not None else float(p.v0) ** 0.5
        eng = PDEEngine(sigma=sigma, r=float(p.r), q=float(p.q),
                        n_x=req.n_x, n_t=req.n_t)
        out = eng.price(req.spot, req.strike, req.T, req.is_call,
                        american=req.american)
        if req.with_boundary and req.american:
            out["exercise_boundary"] = eng.exercise_boundary(
                req.spot, req.strike, req.T, req.is_call)
    out["model"] = req.model
    out["american"] = req.american
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_margin(body: dict) -> dict:
    """POST /api/margin — SPAN-style portfolio margin (engine/margin.py):
    16-scenario price/vol scan off ONE CRN path set per maturity."""
    from mcos_tpu.engine.margin import MarginEngine

    req = schemas.MarginRequest(**body)
    if not (len(req.strikes) == len(req.Ts) == len(req.is_calls)
            == len(req.quantities)):
        raise ApiError(400,
                       "strikes/Ts/is_calls/quantities must be equal length")
    start = time.time()
    eng = MarginEngine(req.params.to_params(), num_paths=req.num_paths,
                       price_scan_range=req.price_scan_range,
                       vol_scan_range=req.vol_scan_range,
                       extreme_multiplier=req.extreme_multiplier,
                       extreme_coverage=req.extreme_coverage)
    out = eng.margin(req.spot, req.strikes, req.Ts, req.is_calls,
                     req.quantities)
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_replicate(body: dict) -> dict:
    """POST /api/replicate — static replication of a (possibly
    path-dependent) payoff onto a vanilla chain (engine/hedge.py): L²
    projection off one CRN path set, hedge valued with the exact COS
    oracle, residual = the statically-unhedgeable risk."""
    from mcos_tpu.engine.hedge import StaticHedgeEngine

    req = schemas.ReplicateRequest(**body)
    if req.kind in ("digital", "vanilla", "asian") and req.strike <= 0:
        raise ApiError(400, f"kind={req.kind} needs strike > 0")
    if req.kind == "barrier" and req.barrier <= 0:
        raise ApiError(400, "kind=barrier needs barrier > 0")
    if req.kind == "lookback" and not req.floating and req.strike <= 0:
        raise ApiError(400, "fixed-strike lookback needs strike > 0")
    start = time.time()
    eng = StaticHedgeEngine(req.params.to_params(), num_paths=req.num_paths)
    try:
        out = eng.replicate(
            req.spot, req.T, kind=req.kind, strike=req.strike,
            is_call=req.is_call, barrier=req.barrier,
            averaging=req.averaging, knock=req.knock,
            direction=req.direction, floating=req.floating,
            hedge_strikes=req.hedge_strikes, n_hedge=req.n_hedge)
    except ValueError as e:
        raise ApiError(400, str(e))
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_volderivs(body: dict) -> dict:
    """POST /api/volderivs — variance/vol swaps and VIX futures/options
    (engine/volderivs.py). Quadrature-exact where the law is known (VIX
    products via the CIR noncentral-χ² terminal density), MC with stderr
    for realized-vol convexity."""
    from mcos_tpu.engine.volderivs import VolDerivsEngine

    req = schemas.VolDerivsRequest(**body)
    start = time.time()
    eng = VolDerivsEngine(req.params.to_params(), num_paths=req.num_paths)
    if req.kind == "variance_swap":
        out = eng.variance_swap(req.T)
    elif req.kind == "vol_swap":
        out = eng.vol_swap(req.T)
    elif req.kind == "vix_future":
        out = eng.vix_future(req.T, tau=req.tau, convention=req.convention)
        if req.with_mc_check:
            out["mc_check"] = eng.vix_future_mc(req.T, tau=req.tau,
                                                convention=req.convention)
    else:  # vix_option
        if req.strike is None:
            raise ApiError(400, "vix_option requires strike (in vol units)")
        out = eng.vix_option(req.T, req.strike, req.is_call,
                             tau=req.tau, convention=req.convention)
    out["kind"] = req.kind
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_book(body: dict) -> dict:
    """POST /api/book — whole-portfolio pricing + Greeks in one vmapped
    device program (beyond the reference's one-contract-per-call API)."""
    from mcos_tpu.engine.book import BookEngine

    req = schemas.BookRequest(**body)
    if not (len(req.spots) == len(req.strikes) == len(req.Ts)
            == len(req.is_calls)):
        raise ApiError(400, "spots/strikes/Ts/is_calls must be equal length")
    start = time.time()
    eng = BookEngine(req.params.to_params(), num_paths=req.num_paths)
    out = eng.price_book(req.spots, req.strikes, req.Ts, req.is_calls,
                         req.quantities)
    out = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
           for k, v in out.items()}
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_basket(body: dict) -> dict:
    """POST /api/basket — correlated multi-asset SVJ basket pricing (new)."""
    from mcos_tpu.engine.basket import BasketEngine

    req = schemas.BasketRequest(**body)
    n = len(req.spots)
    if len(req.corr) != n:
        raise ApiError(400, "spots/corr dimensions must agree")
    if req.payoff == "basket" and len(req.weights) != n:
        raise ApiError(400, "basket payoff needs one weight per spot")
    if req.payoff == "spread" and n != 2:
        raise ApiError(400, "spread payoff needs exactly 2 assets")
    params = ([p.to_params() for p in req.params] if req.params
              else [schemas.SVJParamsRequest().to_params()] * n)
    if len(params) != n:
        raise ApiError(400, "params list must match spots length")
    start = time.time()
    if req.implied_corr_from_price is not None:
        from mcos_tpu.engine.basket import implied_correlation

        if req.payoff != "basket":
            raise ApiError(400, "implied correlation needs payoff=basket")
        try:
            out = implied_correlation(
                params, req.spots, req.weights, req.strike, req.T,
                req.implied_corr_from_price, is_call=req.is_call,
                num_paths=min(req.num_paths, 200_000))
        except ValueError as e:
            raise ApiError(400, str(e))
        out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
        return out
    eng = BasketEngine(params, np.asarray(req.corr, np.float64),
                       num_paths=req.num_paths)
    if req.american:
        kind = {"basket": "basket", "best_of": "max",
                "worst_of": "min"}.get(req.payoff)
        if kind is None:
            raise ApiError(400, "american supports payoff basket/"
                                "worst_of/best_of (not spread)")
        try:
            out = eng.price_american(
                req.spots, req.strike, req.T, kind=kind,
                is_call=req.is_call,
                weights=req.weights if kind == "basket" else None,
                n_ex=req.n_exercise,
                steps_per_period=req.steps_per_period)
            if req.with_bounds:
                out["bounds"] = eng.price_bounds_american(
                    req.spots, req.strike, req.T, kind=kind,
                    is_call=req.is_call,
                    weights=req.weights if kind == "basket" else None,
                    n_ex=req.n_exercise,
                    steps_per_period=req.steps_per_period,
                    n_outer=req.n_outer, n_inner=req.n_inner)
        except ValueError as e:
            raise ApiError(400, str(e))
        out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
        return out
    if req.payoff == "basket":
        out = eng.price(req.spots, req.weights, req.strike, req.T,
                        req.is_call)
    elif req.payoff in ("worst_of", "best_of"):
        out = eng.price_rainbow(req.spots, req.strike, req.T,
                                kind=req.payoff, is_call=req.is_call)
    elif req.payoff == "spread":
        out = eng.price_spread(req.spots, req.strike, req.T, req.is_call)
    else:
        raise ApiError(400, f"unknown payoff {req.payoff!r}")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_calibrate(body: dict) -> dict:
    """POST /api/calibrate — completes the endpoint the reference only
    documents (engine/app.py:9)."""
    req = schemas.CalibrateRequest(**body)
    start = time.time()
    eng = CalibrationEngine()
    strikes = np.asarray(req.strikes, np.float32)
    market = np.asarray(req.market_prices, np.float32)
    spreads = (np.asarray(req.bid_ask_spreads, np.float32)
               if req.bid_ask_spreads is not None else None)
    atm_vol = req.atm_vol
    deamericanized = None
    if req.exercise == "american":
        from mcos_tpu.engine.surface import deamericanize_quotes

        ivs, eur, keep = deamericanize_quotes(
            req.spot, strikes, req.T, market, req.r, req.q, req.is_call)
        if keep.sum() < 4:
            raise ApiError(400, f"only {int(keep.sum())} quotes "
                                "de-Americanize cleanly (need >= 4)")
        strikes, market = strikes[keep], eur.astype(np.float32)
        if spreads is not None:
            spreads = spreads[keep]
        atm_idx = int(np.argmin(np.abs(
            strikes - req.spot * np.exp((req.r - req.q) * req.T))))
        atm_vol = float(ivs[atm_idx])
        deamericanized = {
            "ivs": [float(x) for x in ivs],
            "strikes_kept": [float(k) for k in strikes],
            "n_dropped": int(len(req.strikes) - keep.sum()),
        }
    elif req.exercise != "european":
        raise ApiError(400, f"unknown exercise {req.exercise!r}")
    result = eng.calibrate(
        req.spot, strikes, req.T, market, is_call=req.is_call,
        r=req.r, q=req.q, bid_ask_spreads=spreads,
        atm_vol=atm_vol, num_paths=req.num_paths)
    if deamericanized is not None:
        result["deamericanized"] = deamericanized
    params = result.pop("params")
    result["params"] = params.as_dict()
    result["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return result


def handle_surface(body: dict) -> dict:
    """POST /api/surface — IV surface extraction, arbitrage screening, and
    SABR slice fits in one call (library-only in the reference)."""
    from mcos_tpu.engine.surface import (
        ArbitrageFreeSpline,
        calibrate_sabr,
        extract_iv_surface,
    )
    from mcos_tpu.models.params import forward_price

    req = schemas.SurfaceRequest(**body)
    start = time.time()
    strikes = np.asarray(req.strikes, np.float64)
    mats = np.asarray(req.maturities, np.float64)
    surface = extract_iv_surface(
        req.spot, req.r, req.q, strikes, mats,
        np.asarray(req.call_prices, np.float64),
        np.asarray(req.put_prices, np.float64),
        bid_ask_spreads=(np.asarray(req.bid_ask_spreads, np.float64)
                         if req.bid_ask_spreads is not None else None),
        exercise=req.exercise)

    spline = ArbitrageFreeSpline()
    report = spline.fit(strikes, mats, surface["iv_call"])

    out = {
        "iv_call": np.where(np.isfinite(surface["iv_call"]),
                            surface["iv_call"], None).tolist(),
        "iv_put": np.where(np.isfinite(surface["iv_put"]),
                           surface["iv_put"], None).tolist(),
        "valid_mask": surface["valid_mask"].tolist(),
        "arbitrage_report": report,
    }
    if req.fit_sabr:
        sabr = {}
        for i, T in enumerate(mats):
            ivs = surface["iv_call"][i]
            ok = np.isfinite(ivs)
            if ok.sum() < 4:
                continue
            F = float(forward_price(req.spot, req.r, req.q, float(T)))
            sabr[str(float(T))] = calibrate_sabr(
                F, strikes[ok], float(T), ivs[ok], beta_fixed=0.8, iters=80)
        out["sabr_fits"] = sabr
    if req.fit_ssvi:
        from mcos_tpu.engine.ssvi import calibrate_ssvi

        rows_ok = [i for i in range(len(mats))
                   if np.isfinite(surface["iv_call"][i]).sum() >= 4]
        if len(rows_ok) >= 2:
            sel = np.asarray(rows_ok)
            fwds = np.array([forward_price(req.spot, req.r, req.q,
                                           float(mats[i])) for i in sel])
            fit = calibrate_ssvi(
                mats[sel], fwds,
                np.tile(strikes, (len(sel), 1)),
                surface["iv_call"][sel], iters=100)
            fit.pop("surface")
            out["ssvi_fit"] = fit
        else:
            out["ssvi_fit"] = {"error": "need >=2 maturities with >=4 "
                                        "valid quotes each"}
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_localvol(body: dict) -> dict:
    """POST /api/localvol — Dupire surface build + surface-consistent MC
    pricing (engine/localvol.py; model family absent from the reference)."""
    from mcos_tpu.engine.localvol import LocalVolEngine, LocalVolSurface

    req = schemas.LocalVolRequest(**body)
    start = time.time()
    try:
        surf = LocalVolSurface.from_iv_points(
            req.spot, req.strikes, req.maturities,
            np.asarray(req.iv, np.float64), r=req.r, q=req.q)
    except ValueError as e:
        raise ApiError(400, str(e))
    eng = LocalVolEngine(surf, num_paths=req.num_paths,
                         num_steps=req.num_steps)
    chain = eng.price_batch(req.spot, req.price_strikes, req.T, req.is_call)
    return {
        "chain": chain,
        "local_vol_grid": {
            "t": surf.t_grid.tolist(),
            "y": surf.y_grid.tolist(),
            "local_vol": np.sqrt(surf.local_var).round(6).tolist(),
        },
        "elapsed_ms": round((time.time() - start) * 1000, 1),
    }


def handle_cliquet(body: dict) -> dict:
    """POST /api/cliquet — cliquet/forward-start (engine/cliquet.py)."""
    from mcos_tpu.engine.cliquet import CliquetEngine

    req = schemas.CliquetRequest(**body)
    start = time.time()
    eng = CliquetEngine(req.params.to_params(), num_paths=req.num_paths,
                        steps_per_period=req.steps_per_period)
    if req.kind == "cliquet":
        out = eng.price_cliquet(
            req.T, n_periods=req.n_periods, local_floor=req.local_floor,
            local_cap=req.local_cap, global_floor=req.global_floor,
            global_cap=req.global_cap, notional=req.notional)
    elif req.kind == "forward_start":
        if not 0.0 < req.t1 < req.T:
            raise ApiError(400, "need 0 < t1 < T")
        out = eng.price_forward_start(req.t1, req.T, k=req.k,
                                      is_call=req.is_call)
    else:
        raise ApiError(400, f"unknown kind {req.kind!r}")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_slv(body: dict) -> dict:
    """POST /api/slv — particle-method SLV chain pricing
    (engine/slv.py)."""
    from mcos_tpu.engine.localvol import LocalVolSurface
    from mcos_tpu.engine.slv import SLVEngine
    from mcos_tpu.models.params import SVJParams

    req = schemas.SLVRequest(**body)
    iv = np.asarray(req.iv, np.float64)
    if iv.shape != (len(req.maturities), len(req.strikes)):
        raise ApiError(400, "iv must be (num_maturities, num_strikes)")
    if req.mode in ("barrier", "chain") and not req.price_strikes:
        raise ApiError(400, f"{req.mode} mode needs non-empty price_strikes")
    start = time.time()
    try:
        surf = LocalVolSurface.from_iv_points(
            req.spot, req.strikes, req.maturities, iv, r=req.r, q=req.q)
    except ValueError as e:
        raise ApiError(400, str(e))
    heston = SVJParams(kappa=req.kappa, theta=req.theta, xi=req.xi,
                       rho=req.rho, v0=req.v0, lambda_j=0.0,
                       r=req.r, q=req.q)
    eng = SLVEngine(surf, heston, num_paths=req.num_paths,
                    num_steps=req.num_steps)
    if req.mode == "barrier":
        if req.barrier <= 0:
            raise ApiError(400, "barrier mode needs barrier > 0")
        out = eng.price_barrier(req.spot, req.price_strikes[0], req.T,
                                req.barrier, is_call=req.is_call,
                                knock=req.knock)
    elif req.mode == "forward_start":
        if not 0.0 < req.t1 < req.T:
            raise ApiError(400, "need 0 < t1 < T")
        out = eng.price_forward_start(req.spot, req.t1, req.T, k=req.k,
                                      is_call=req.is_call)
    elif req.mode == "chain":
        res = eng.price(req.spot, req.price_strikes, req.T,
                        is_call=req.is_call)
        out = {
            "chain": [{"strike": float(k), "price": p, "std_error": s}
                      for k, p, s in zip(req.price_strikes, res["price"],
                                         res["std_error"])],
            "mixing_xi": res["mixing_xi"],
            "num_paths_used": res["num_paths_used"],
        }
    else:
        raise ApiError(400, f"unknown mode {req.mode!r}")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_modelrisk(body: dict) -> dict:
    """POST /api/modelrisk — model-risk band across the model zoo
    (engine/modelrisk.py)."""
    from mcos_tpu.engine.modelrisk import model_risk_report

    req = schemas.ModelRiskRequest(**body)
    start = time.time()
    out = model_risk_report(
        req.spot, req.strike, req.T, is_call=req.is_call,
        atm_vol=req.atm_vol, r=req.r, q=req.q,
        svj=req.params.to_params() if req.params is not None else None,
        num_paths=req.num_paths)
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_pnl(body: dict) -> dict:
    """POST /api/pnl — Greeks-based attribution of a price move between
    two market states (engine/pnl.py)."""
    from mcos_tpu.engine.pnl import pnl_explain

    req = schemas.PnlRequest(**body)
    start = time.time()
    out = pnl_explain(req.params_old.to_params(),
                      req.params_new.to_params(),
                      req.spot_old, req.spot_new, req.T_old, req.T_new,
                      req.strike, is_call=req.is_call,
                      quantity=req.quantity)
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_quanto(body: dict) -> dict:
    """POST /api/quanto — quanto vanilla with the pathwise sqrt(v) tilt
    and exact companion control (engine/quanto.py)."""
    from mcos_tpu.engine.quanto import QuantoEngine

    req = schemas.QuantoRequest(**body)
    start = time.time()
    eng = QuantoEngine(req.params.to_params(), req.r_domestic,
                       req.sigma_fx, req.rho_fx, num_paths=req.num_paths,
                       num_steps=req.num_steps)
    out = eng.price(req.spot, req.strike, req.T, is_call=req.is_call,
                    fx_fixed=req.fx_fixed)
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_autocall(body: dict) -> dict:
    """POST /api/autocall — Express note: price + early-redemption
    accounting (engine/autocallable.py)."""
    from mcos_tpu.engine.autocallable import AutocallableEngine

    req = schemas.AutocallRequest(**body)
    if not (req.protection_barrier <= req.coupon_barrier
            <= req.autocall_barrier):
        raise ApiError(400, "need protection <= coupon <= autocall barrier")
    start = time.time()
    if req.params_list is not None:
        from mcos_tpu.engine.autocallable import WorstOfAutocallableEngine

        if req.corr is None or len(req.corr) != len(req.params_list):
            raise ApiError(400, "worst-of needs corr matching params_list")
        if len(req.params_list) > 16:
            raise ApiError(400, "at most 16 basket assets")
        plist = [schemas.SVJParamsRequest(**p).to_params()
                 for p in req.params_list]
        eng = WorstOfAutocallableEngine(
            plist, np.asarray(req.corr, np.float64),
            num_paths=req.num_paths,
            steps_per_period=req.steps_per_period)
    else:
        eng = AutocallableEngine(req.params.to_params(),
                                 num_paths=req.num_paths,
                                 steps_per_period=req.steps_per_period)
    terms = dict(n_obs=req.n_obs, autocall_barrier=req.autocall_barrier,
                 coupon_barrier=req.coupon_barrier,
                 protection_barrier=req.protection_barrier,
                 notional=req.notional)
    if req.solve_par:
        out = eng.solve_par_coupon(req.T, target=req.par_target, **terms)
    else:
        out = eng.price(req.T, coupon=req.coupon,
                        final_coupon=req.final_coupon, **terms)
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_hhw(body: dict) -> dict:
    """POST /api/hhw — Heston-Hull-White hybrid: price / AD greeks /
    stochastic-rates impact (engine/hhw.py)."""
    from mcos_tpu.engine.hhw import HHWEngine
    from mcos_tpu.ops.hhw import HHWParams

    req = schemas.HHWRequest(**body)
    start = time.time()
    params = HHWParams(kappa=req.kappa, theta=req.theta, xi=req.xi,
                       v0=req.v0, a=req.a, b=req.b, sigma_r=req.sigma_r,
                       r0=req.r0, rho_sv=req.rho_sv, rho_sr=req.rho_sr,
                       rho_vr=req.rho_vr, q=req.q)
    eng = HHWEngine(params, num_paths=req.num_paths,
                    num_steps=req.num_steps)
    if req.mode == "price":
        out = eng.price(req.spot, req.strike, req.T, is_call=req.is_call)
    elif req.mode == "greeks":
        out = eng.greeks(req.spot, req.strike, req.T, is_call=req.is_call)
    elif req.mode == "impact":
        out = eng.rate_vol_impact(req.spot, req.strike, req.T,
                                  is_call=req.is_call)
    else:
        raise ApiError(400, f"unknown mode {req.mode!r}")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_exposure(body: dict) -> dict:
    """POST /api/exposure — EE/ENE/PFE profile + CVA/DVA (+ AD CVA delta)
    for a vanilla netting set (engine/exposure.py; XVA layer beyond the
    reference's same-day risk)."""
    from mcos_tpu.engine.exposure import ExposureEngine

    req = schemas.ExposureRequest(**body)
    positions = [schemas.ExposurePosition(**p).model_dump()
                 for p in req.positions]
    if not positions or len(positions) > schemas.MAX_BOOK_POSITIONS:
        raise ApiError(400, f"need 1..{schemas.MAX_BOOK_POSITIONS} positions")
    n = len(req.spots)
    if len(req.sigmas) != n or len(req.corr) != n:
        raise ApiError(400, "spots/sigmas/corr dimensions must agree")
    start = time.time()
    eng = ExposureEngine(req.spots, req.sigmas,
                         np.asarray(req.corr, np.float64), positions,
                         r=req.r, q=req.q, num_paths=req.num_paths)
    out = eng.profile(num_dates=req.num_dates, quantile=req.quantile,
                      collateral_threshold=req.collateral_threshold,
                      margin_period=req.margin_period)
    if req.hazard_rate > 0.0:
        out["credit"] = eng.cva(hazard_rate=req.hazard_rate, lgd=req.lgd,
                                num_dates=req.num_dates,
                                own_hazard=req.own_hazard)
        if req.wwr_gamma != 0.0:
            out["credit"]["wwr"] = eng.cva_wwr(
                hazard_rate=req.hazard_rate, lgd=req.lgd,
                gamma=req.wwr_gamma, num_dates=req.num_dates)
    if req.with_cva_delta:
        out["cva_delta"] = eng.cva_delta(
            hazard_rate=req.hazard_rate, lgd=req.lgd,
            num_dates=req.num_dates)["cva_delta"]
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_rough(body: dict) -> dict:
    """POST /api/rough — rough Bergomi price/greeks/smile/skew
    (engine/rough.py; rough-volatility family beyond the reference)."""
    from mcos_tpu.engine.rough import RoughBergomiEngine
    from mcos_tpu.ops.rough import RoughBergomiParams

    req = schemas.RoughRequest(**body)
    if req.moneyness is not None and len(req.moneyness) > schemas.MAX_GRID_POINTS:
        raise ApiError(400, f"moneyness grid > {schemas.MAX_GRID_POINTS}")
    start = time.time()
    params = RoughBergomiParams(xi=req.xi, eta=req.eta, rho=req.rho,
                                r=req.r, q=req.q, hurst=req.hurst)
    eng = RoughBergomiEngine(params, num_paths=req.num_paths,
                             num_steps=req.num_steps,
                             use_sobol=req.use_sobol)
    strike = req.strike if req.strike > 0 else req.spot
    if req.mode == "price":
        out = eng.price(req.spot, strike, req.T, is_call=req.is_call)
    elif req.mode == "greeks":
        out = eng.greeks(req.spot, strike, req.T, is_call=req.is_call)
    elif req.mode == "smile":
        out = eng.smile(req.spot, req.T, moneyness=req.moneyness)
    elif req.mode == "skew":
        out = eng.atm_skew(req.spot, req.T)
    elif req.mode == "asian":
        out = eng.price_asian(req.spot, strike, req.T, is_call=req.is_call)
    elif req.mode == "barrier":
        if req.barrier <= 0:
            raise ApiError(400, "barrier mode needs barrier > 0")
        out = eng.price_barrier(req.spot, strike, req.T, req.barrier,
                                is_call=req.is_call, knock=req.knock)
    elif req.mode == "lookback":
        out = eng.price_lookback(
            req.spot, req.T, is_call=req.is_call,
            strike=req.strike if req.strike > 0 else None)
    elif req.mode == "calibrate":
        from mcos_tpu.engine.rough import calibrate_rbergomi

        if not (req.maturities and req.cal_strikes and req.market_prices):
            raise ApiError(400, "calibrate mode needs maturities, "
                                "cal_strikes, market_prices")
        mkt = np.asarray(req.market_prices, np.float64)
        ks = np.asarray(req.cal_strikes, np.float64)
        if ks.shape != mkt.shape or ks.shape[0] != len(req.maturities):
            raise ApiError(400, "cal_strikes/market_prices must be (m, k) "
                                "matching maturities")
        if mkt.size > schemas.MAX_GRID_POINTS * 8:
            raise ApiError(400, "calibration grid too large")
        kw = {}
        if req.hurst_grid:
            kw["hurst_grid"] = tuple(float(h) for h in req.hurst_grid[:8])
        out = calibrate_rbergomi(
            req.spot, req.maturities, ks, mkt, r=req.r, q=req.q,
            num_paths=min(req.num_paths, 65_536), num_steps=req.num_steps,
            **kw)
        p = out.pop("params")
        out["params"] = {"hurst": p.hurst, "eta": float(p.eta),
                         "rho": float(p.rho), "xi": float(p.xi)}
    else:
        raise ApiError(400, f"unknown mode {req.mode!r}")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_var(body: dict) -> dict:
    """POST /api/var — portfolio VaR/CVaR + Euler per-asset contributions
    (engine/risk.py; the reference has portfolio scalars only)."""
    from mcos_tpu.engine.risk import (portfolio_risk_contributions,
                                      portfolio_var)

    req = schemas.VarRequest(**body)
    n = len(req.spots)
    if len(req.sigmas) != n or len(req.weights) != n or len(req.corr) != n:
        raise ApiError(400, "spots/sigmas/weights/corr dimensions must agree")
    start = time.time()
    if req.with_contributions and req.copula == "gaussian":
        out = portfolio_risk_contributions(
            req.spots, req.sigmas, np.asarray(req.corr, np.float64),
            req.weights, req.T, r=req.r, q=req.q,
            num_paths=req.num_paths, confidence=req.confidence)
    else:
        out = portfolio_var(
            req.spots, req.sigmas, np.asarray(req.corr, np.float64),
            req.weights, req.T, r=req.r, q=req.q,
            num_paths=req.num_paths, confidence=req.confidence,
            copula=req.copula, nu=req.nu)
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_svcj(body: dict) -> dict:
    """SVCJ — correlated price/variance jumps (Duffie-Pan-Singleton).

    Modes: price (MC + companion CV), greeks (pathwise AD), smile (exact
    COS-implied vols), compare (MC-vs-oracle rows). Model family beyond
    the reference (engine/svcj.py; oracle in ops/svcj.py)."""
    from mcos_tpu.engine.svcj import SVCJEngine

    req = schemas.SVCJRequest(**body)
    start = time.time()
    p = req.params.to_params()
    kwargs = {"num_paths": req.num_paths}
    if req.num_steps is not None:
        kwargs["num_steps"] = req.num_steps
    eng = SVCJEngine(p, **kwargs)
    strike = req.strike if req.strike > 0 else req.spot
    strikes = req.strikes or [m * req.spot
                              for m in (0.9, 0.95, 1.0, 1.05, 1.1)]
    if req.mode == "price":
        out = eng.price(req.spot, strike, req.T, req.is_call)
    elif req.mode == "greeks":
        out = eng.greeks(req.spot, strike, req.T, req.is_call)
    elif req.mode == "smile":
        out = eng.smile(req.spot, req.T, strikes)
    elif req.mode == "compare":
        out = eng.mc_vs_cos(req.spot, strikes, req.T, req.is_call)
    else:
        raise ApiError(400, f"unknown mode {req.mode!r} "
                            "(price|greeks|smile|compare)")
    warnings = p.validate()
    if warnings:
        out["model_warnings"] = warnings
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_quotegreeks(body: dict) -> dict:
    """POST /api/quotegreeks — dP/d(market quote) through the calibration.

    Implicit-function-theorem map on the weighted-least-squares optimum:
    d theta*/dq = (J^T W J)^+ J^T W with J the exact COS chain Jacobian;
    buckets = (dP/d theta)^T d theta*/dq double as the calibration-
    consistent static hedge in the quoted vanillas. Single expiry (T
    float) or surface (T list + strikes list-of-lists). Capability beyond
    the reference (engine/quotegreeks.py)."""
    from mcos_tpu.engine.quotegreeks import (ALL_PARAMS, CORE4,
                                             quote_bucket_greeks)

    req = schemas.QuoteGreeksRequest(**body)
    start = time.time()
    p = req.params.to_params()
    product = req.product.model_dump()
    if product["kind"] in ("vanilla", "digital") and product["strike"] <= 0:
        product["strike"] = req.spot
    free = tuple(req.free) if req.free else CORE4
    bad = [n for n in free if n not in ALL_PARAMS]
    if bad:
        raise ApiError(400, f"unknown free parameter(s): {bad}")
    try:
        out = quote_bucket_greeks(
            p, req.spot, req.strikes, req.T, product, free=free,
            is_call=req.is_call,
            weights=np.asarray(req.weights, np.float64)
            if req.weights else None)
    except ValueError as e:
        raise ApiError(400, str(e))
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_roughheston(body: dict) -> dict:
    """POST /api/roughheston — rough Heston (El Euch-Rosenbaum).

    CIR mean-reversion driven through the fractional kernel: rBergomi's
    T^(H-1/2) short-dated skew explosion plus a long-run variance anchor.
    Modes: price (lifted-MC + companion CV), greeks (pathwise AD through
    the factor scan), smile (exact COS IVs), compare (MC-vs-oracle rows),
    skew (ATM-skew term structure), calibrate (least-squares on the exact
    COS objective). Model family beyond the reference
    (engine/roughheston.py; fractional-Riccati oracle in
    ops/roughheston.py)."""
    from mcos_tpu.engine.roughheston import (RoughHestonEngine,
                                             calibrate_rough_heston)
    from mcos_tpu.ops.roughheston import RoughHestonParams

    req = schemas.RoughHestonRequest(**body)
    start = time.time()
    p = RoughHestonParams(lam=req.lam, theta=req.theta, nu=req.nu,
                          rho=req.rho, v0=req.v0, r=req.r, q=req.q,
                          hurst=req.hurst)
    kwargs = {"num_paths": req.num_paths, "n_factors": req.n_factors}
    if req.num_steps is not None:
        kwargs["num_steps"] = req.num_steps
    eng = RoughHestonEngine(p, **kwargs)
    strike = req.strike if req.strike > 0 else req.spot
    strikes = req.strikes or [m * req.spot
                              for m in (0.9, 0.95, 1.0, 1.05, 1.1)]
    if req.mode == "price":
        out = eng.price(req.spot, strike, req.T, req.is_call)
    elif req.mode == "greeks":
        out = eng.greeks(req.spot, strike, req.T, req.is_call)
    elif req.mode == "smile":
        out = eng.smile(req.spot, req.T, strikes)
    elif req.mode == "compare":
        out = eng.mc_vs_cos(req.spot, strikes, req.T, req.is_call)
    elif req.mode == "skew":
        mats = req.maturities or [0.02, 0.05, 0.1, 0.25, 0.5, 1.0]
        out = eng.atm_skew_term_structure(req.spot, mats)
    elif req.mode == "calibrate":
        if not req.strikes or req.market_prices is None:
            raise ApiError(400, "calibrate mode needs strikes and "
                                "market_prices")
        if len(req.strikes) != len(req.market_prices):
            raise ApiError(400, "strikes and market_prices length mismatch")
        try:
            fit = calibrate_rough_heston(
                req.spot, req.strikes, req.T, req.market_prices,
                r=req.r, q=req.q, is_call=req.is_call,
                hurst=None if req.fit_hurst else req.hurst)
        except RuntimeError as e:
            raise ApiError(400, str(e))
        out = {k: v for k, v in fit.items() if k != "params"}
    else:
        raise ApiError(400, f"unknown mode {req.mode!r} "
                            "(price|greeks|smile|compare|skew|calibrate)")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_termsvj(body: dict) -> dict:
    """POST /api/termsvj — consistent time-dependent SVJ (ops/tdsvj.py).

    One piecewise-constant (θ(t), ξ(t), λ(t)) process across all expiries —
    the reference's term structure swaps whole parameter sets per maturity
    (engine/models.py:88-144), which is path-inconsistent. Modes: price
    (td MC + exact chained-Riccati COS), compare (per-strike MC-vs-oracle),
    smile (exact COS-implied vols), calibrate (sequential segment
    bootstrap)."""
    from mcos_tpu.engine.termsvj import TDSVJEngine, bootstrap_calibrate_td

    req = schemas.TermSVJRequest(**body)
    start = time.time()
    shared = req.params.to_params()

    if req.mode == "calibrate":
        if not req.maturities or req.market_prices is None:
            raise ApiError(400, "calibrate mode needs maturities and "
                                "market_prices (one chain per maturity)")
        if not req.strikes:
            raise ApiError(400, "calibrate mode needs strikes")
        try:
            fit = bootstrap_calibrate_td(
                req.spot, req.maturities, req.strikes,
                np.asarray(req.market_prices, np.float64), shared,
                is_call=req.is_call)
        except ValueError as e:
            raise ApiError(400, str(e))
        return {
            "segments": [
                {"t_end": float(t), "theta": float(th), "xi": float(x),
                 "lambda_j": float(lm)}
                for t, th, x, lm in zip(fit["seg_ends"], fit["thetas"],
                                        fit["xis"], fit["lams"])
            ],
            "errors": {str(k): v for k, v in fit["errors"].items()},
            "elapsed_ms": round((time.time() - start) * 1000, 1),
        }

    if not req.segments:
        raise ApiError(400, "need at least one segment")
    seg_ends = [s.t_end for s in req.segments]
    thetas = [s.theta for s in req.segments]
    xis = [s.xi for s in req.segments]
    lams = [s.lambda_j for s in req.segments]
    eng = TDSVJEngine(shared, seg_ends, thetas, xis, lams,
                      num_paths=req.num_paths, num_steps=req.num_steps)
    strike = req.strike if req.strike > 0 else req.spot
    strikes = req.strikes or [m * req.spot
                              for m in (0.9, 0.95, 1.0, 1.05, 1.1)]

    if req.mode == "price":
        out = eng.price(req.spot, strike, req.T, req.is_call)
        out["cos_price"] = float(
            eng.cos_chain(req.spot, [strike], req.T, req.is_call)[0])
        out["segments"] = eng.segments_dict()
    elif req.mode == "compare":
        exact = eng.cos_chain(req.spot, strikes, req.T, req.is_call)
        rows = eng.price_batch(req.spot, strikes, req.T, req.is_call)
        out = {"rows": [
            {**row, "cos_price": float(exact[i]),
             "abs_error_sigma": (abs(row["price"] - float(exact[i]))
                                 / max(row["std_error"], 1e-12))}
            for i, row in enumerate(rows)
        ]}
    elif req.mode == "smile":
        prices = eng.cos_chain(req.spot, strikes, req.T, True)
        smile = []
        for k, p in zip(strikes, prices):
            iv = implied_vol(float(p), req.spot, float(k), req.T,
                             float(shared.r), float(shared.q), True)
            smile.append({"strike": float(k), "price": float(p),
                          "iv": iv if iv is not None else 0.0})
        out = {"smile": smile}
    elif req.mode == "forward_start":
        if not (req.t1 and 0.0 < req.t1 < req.T):
            raise ApiError(400, "forward_start mode needs 0 < t1 < T")
        k_perf = req.strike if req.strike > 0 else 1.0
        try:
            out = eng.price_forward_start(req.spot, req.t1, req.T,
                                          k=k_perf, is_call=req.is_call)
        except ValueError as e:
            raise ApiError(400, str(e))
        out["segments"] = eng.segments_dict()
    elif req.mode == "cliquet":
        out = eng.price_cliquet(
            req.T, n_periods=req.n_periods, local_floor=req.local_floor,
            local_cap=req.local_cap, global_floor=req.global_floor,
            global_cap=req.global_cap, notional=req.notional)
        out["segments"] = eng.segments_dict()
    elif req.mode == "greeks":
        out = eng.greeks(req.spot, strike, req.T, req.is_call)
    elif req.mode == "american":
        out = eng.price_american(req.spot, strike, req.T, req.is_call)
        out["segments"] = eng.segments_dict()
    elif req.mode == "varswap":
        out = eng.variance_swap(req.T)
    else:
        raise ApiError(400, f"unknown mode {req.mode!r} "
                            "(price|compare|smile|forward_start|cliquet|"
                            "greeks|american|varswap|calibrate)")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_quote(query: dict) -> dict:
    from mcos_tpu.api.quotes import fetch_quote

    symbol = (query.get("symbol") or [""])[0]
    if not symbol:
        raise ApiError(400, "missing ?symbol=")
    quote = fetch_quote(symbol)
    if quote is None:
        raise ApiError(503, f"no quote available for {symbol}")
    return quote


def handle_symbols(query: dict) -> dict:
    """GET /api/symbols — the full tradeable universe (50 NIFTY
    constituents + index) for the UI's searchable picker. Server-side
    source of truth replacing the reference's client-bundled
    js/stocks.js:2-53. `?q=` filters on symbol/name/sector (the same
    fields the UI dropdown matches, case-insensitive substring)."""
    from mcos_tpu.api.quotes import list_symbols

    rows = list_symbols()
    q = (query.get("q", [""])[0] or "").strip().lower()
    if q:
        rows = [row for row in rows
                if q in row["symbol"].lower() or q in row["name"].lower()
                or q in row["sector"].lower()]
    return {"symbols": rows}


POST_ROUTES: Dict[str, Callable[[dict], dict]] = {
    "/api/price": handle_price,
    "/api/greeks": handle_greeks,
    "/api/stress": handle_stress,
    "/api/regime": handle_regime,
    "/api/hedge": handle_hedge,
    "/api/smile": handle_smile,
    "/api/calibrate": handle_calibrate,
    "/api/exotic": handle_exotic,
    "/api/american": handle_american,
    "/api/book": handle_book,
    "/api/basket": handle_basket,
    "/api/convergence": handle_convergence,
    "/api/surface": handle_surface,
    "/api/localvol": handle_localvol,
    "/api/var": handle_var,
    "/api/cliquet": handle_cliquet,
    "/api/rough": handle_rough,
    "/api/exposure": handle_exposure,
    "/api/hhw": handle_hhw,
    "/api/autocall": handle_autocall,
    "/api/quanto": handle_quanto,
    "/api/pnl": handle_pnl,
    "/api/modelrisk": handle_modelrisk,
    "/api/slv": handle_slv,
    "/api/svcj": handle_svcj,
    "/api/quotegreeks": handle_quotegreeks,
    "/api/roughheston": handle_roughheston,
    "/api/termsvj": handle_termsvj,
    "/api/volderivs": handle_volderivs,
    "/api/replicate": handle_replicate,
    "/api/margin": handle_margin,
    "/api/pde": handle_pde,
}


# ─────────────────────────────────────────────────────────────────────────────
# Static UI serving (role of engine/app.py:239-252 + traversal guard per
# server.js:103-124)
# ─────────────────────────────────────────────────────────────────────────────
WEB_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "web"))
_MIME = {".html": "text/html", ".js": "application/javascript",
         ".css": "text/css", ".svg": "image/svg+xml", ".png": "image/png"}


def _static_file(name: str) -> Optional[Tuple[bytes, str]]:
    path = os.path.normpath(os.path.join(WEB_DIR, name))
    # Trailing separator: bare startswith(WEB_DIR) would admit sibling
    # directories like /root/repo/webapp (review finding).
    if not path.startswith(WEB_DIR + os.sep) or not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    return data, _MIME.get(os.path.splitext(path)[1], "application/octet-stream")


# ─────────────────────────────────────────────────────────────────────────────
# stdlib transport
# ─────────────────────────────────────────────────────────────────────────────
class _Handler(BaseHTTPRequestHandler):
    server_version = f"mcos-tpu/{VERSION}"
    # Socket read timeout: a client that opens a connection and trickles
    # (or never sends) the body can otherwise pin a thread forever
    # (slowloris). 30 s comfortably covers a slow mobile POST.
    timeout = 30

    def _security_headers(self, cache: str) -> None:
        # The reference ships these via its deployment config
        # (vercel.json:3-24); an internet-facing stdlib server must set
        # them itself.
        self.send_header("X-Content-Type-Options", "nosniff")
        self.send_header("X-Frame-Options", "DENY")
        self.send_header("Referrer-Policy", "strict-origin-when-cross-origin")
        self.send_header("Cache-Control", cache)

    def _send_json(self, status: int, payload) -> None:
        # fastjson.dumps == json.dumps except that JsonChunk values (the
        # natively pre-serialized float arrays on the price path) are
        # spliced raw — ~26x cheaper than round()+json.dumps per request.
        data = fastjson.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        # CORS-any, as the reference configures (engine/app.py:42-47).
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "*")
        self.send_header("Access-Control-Allow-Headers", "*")
        self._security_headers("no-store")   # API responses are per-request
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug(fmt, *args)

    def do_OPTIONS(self):  # CORS preflight
        self._send_json(204, {})

    def _send_file(self, data: bytes, mime: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", mime)
        self.send_header("Content-Length", str(len(data)))
        # Static assets: long-lived immutable cache for subresources,
        # must-revalidate for the HTML shell (vercel.json:20-41 values).
        cache = ("public, max-age=0, must-revalidate"
                 if mime == "text/html"
                 else "public, max-age=31536000, immutable")
        self._security_headers(cache)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        parsed = urlparse(self.path)
        try:
            if parsed.path == "/api/health":
                self._send_json(200, handle_health({}))
            elif parsed.path == "/api/metrics":
                self._send_json(200, METRICS.snapshot())
            elif parsed.path == "/api/quote":
                self._send_json(200, handle_quote(parse_qs(parsed.query)))
            elif parsed.path == "/api/symbols":
                self._send_json(200, handle_symbols(parse_qs(parsed.query)))
            elif parsed.path in ("/", "/index.html", "/advanced"):
                hit = _static_file("index.html")
                if hit:
                    self._send_file(*hit)
                else:
                    self._send_json(404, {"detail": "UI not bundled"})
            elif parsed.path.startswith("/static/"):
                hit = _static_file(parsed.path[len("/static/"):])
                if hit:
                    self._send_file(*hit)
                else:
                    self._send_json(404, {"detail": "not found"})
            else:
                self._send_json(404, {"detail": "not found"})
        except ApiError as e:
            self._send_json(e.status, {"detail": e.detail})
        except Exception as e:  # noqa: BLE001 — server must not die
            logger.exception("GET %s failed", parsed.path)
            self._send_json(500, {"detail": str(e)})

    def do_POST(self):
        parsed = urlparse(self.path)
        handler = POST_ROUTES.get(parsed.path)
        if handler is None:
            self._send_json(404, {"detail": "not found"})
            return
        t0 = time.time()
        ok = False
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length > MAX_BODY_BYTES:
                self._send_json(413, {"detail": "request body too large"})
                return
            body = json.loads(self.rfile.read(max(length, 0)) or b"{}")
            out = handler(body)
            ok = True
            self._send_json(200, out)
        except ApiError as e:
            self._send_json(e.status, {"detail": e.detail})
        except (ValidationError, json.JSONDecodeError) as e:
            self._send_json(422, {"detail": str(e)})
        except Exception as e:  # noqa: BLE001
            logger.exception("POST %s failed", parsed.path)
            self._send_json(500, {"detail": str(e)})
        finally:
            METRICS.observe(parsed.path, (time.time() - t0) * 1000, ok)


def serve(host: str = "0.0.0.0", port: int = 8000) -> ThreadingHTTPServer:
    httpd = ThreadingHTTPServer((host, port), _Handler)
    logger.info("mcos_tpu API listening on %s:%d", host, port)
    return httpd


def warmup() -> None:
    """Pre-compile the hot endpoint programs at default request shapes.

    First-request jit compiles cost seconds to tens of seconds; a resident
    server should eat that at startup, not on the first client request. Covers /api/price (Sobol default), /api/greeks,
    and /api/smile at their schema-default shapes; combined with the
    persistent compilation cache (utils/checkpoint.py) later restarts warm
    from disk.
    """
    t0 = time.time()
    logger.info("warmup: compiling default-shape endpoint programs…")
    spot, strike, T = 22500.0, 22500.0, 0.1
    try:
        # /api/price at the top path-count buckets (num_paths is a static
        # jit arg — every distinct value is its own compiled program; the
        # UI offers 50k/100k/500k/1M and the schema default is 500k).
        for n in (50_000, 100_000, 500_000):
            handle_price({"spot": spot, "strike": strike, "T": T,
                          "num_paths": n})
        handle_greeks({"spot": spot, "strike": strike, "T": T})
        handle_smile({"spot": spot, "T": T})
        handle_convergence({"spot": spot, "strike": strike, "T": T})
        handle_stress({"spot": spot, "strike": strike, "T": T,
                       "num_paths": 50_000})
        handle_exotic({"spot": spot, "strike": strike, "T": T,
                       "kind": "asian"})
        # Newer model families at their schema-default shapes.
        handle_rough({"spot": spot, "T": T, "mode": "price"})
        handle_hhw({"spot": spot, "strike": strike, "T": 1.0})
        handle_exposure({"spots": [spot], "sigmas": [0.2], "corr": [[1.0]],
                         "positions": [{"kind": "call", "strike": strike,
                                        "T": 1.0}]})
        # Coalesced-batch executables: one per (bucket, padded size). The
        # handle_price calls above warmed pad=1; under load the batcher
        # forms pads 2/4/8, each its own program — compile them now so the
        # first concurrent burst is warm (the persistent compilation cache
        # makes this near-free on restart).
        if coalesce.enabled():
            for n in (50_000, 100_000, 500_000):
                req = schemas.PriceRequest(spot=spot, strike=strike, T=T,
                                           num_paths=n)
                key = coalesce.bucket_key(req)
                member = (req.params.to_params(), spot, strike, T)
                for pad in (2, 4, 8):
                    coalesce.batch_price_viz(key, [member] * pad)
                logger.info("warmup: coalesced pads ready for %dk paths",
                            n // 1000)
    except Exception:  # noqa: BLE001 — warmup must never kill the server
        logger.exception("warmup failed (server continues cold)")
    logger.info("warmup done in %.1fs", time.time() - t0)


def main():
    parser = argparse.ArgumentParser(description="mcos_tpu pricing API")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--warmup", action="store_true",
                        help="pre-compile hot endpoints before serving")
    args = parser.parse_args()
    # Persistent XLA compilation cache: restarts warm from disk
    # (JAX_COMPILATION_CACHE_DIR, else the fixed in-checkout directory).
    from mcos_tpu.utils.checkpoint import enable_compilation_cache

    enable_compilation_cache()
    # Multi-chip serving: when >1 local device is attached, every engine
    # the handlers build auto-routes its pricing through the path-sharded
    # drivers (engine/pricer.py:_resolved_mesh → parallel/mesh.py). On a
    # single chip this is a no-op. Opt out with MCOS_AUTO_MESH=0.
    os.environ.setdefault("MCOS_AUTO_MESH", "1")
    if args.warmup:
        warmup()
    serve(args.host, args.port).serve_forever()


if __name__ == "__main__":
    main()
