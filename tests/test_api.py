"""HTTP API: endpoint surface parity with the reference (engine/app.py),
driven over a real socket against the stdlib server."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from mcos_tpu.api import server as api_server


@pytest.fixture(scope="module")
def base_url():
    httpd = api_server.serve(host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()


def post(url, body, timeout=300):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


PRICE_BODY = {
    "spot": 22500, "strike": 22500, "T": 0.04,
    "num_paths": 20_000, "use_sobol": False,
}


def test_health(base_url):
    out = get(f"{base_url}/api/health")
    assert out["status"] == "healthy"
    assert "version" in out


def test_price_endpoint(base_url):
    out = post(f"{base_url}/api/price", PRICE_BODY)
    assert out["price"] > 0
    assert out["std_error"] >= 0
    assert out["pre_checks"]["pass"] and out["post_checks"]["pass"]
    assert "elapsed_ms" in out and "params_used" in out
    # 50 sample paths for the dashboard's path chart (engine/app.py:149-150).
    paths = np.asarray(out["sample_paths"])
    assert paths.shape[0] == 50 and paths.shape[1] > 10


def test_price_endpoint_guard_rejection(base_url):
    bad = dict(PRICE_BODY)
    bad["params"] = {"v0": 99.0}
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(f"{base_url}/api/price", bad)
    assert exc.value.code == 400
    detail = json.loads(exc.value.read())["detail"]
    assert detail["failures"]


def test_greeks_endpoint(base_url):
    out = post(f"{base_url}/api/greeks", {
        "spot": 22500, "strike": 22500, "T": 0.04, "num_paths": 20_000})
    assert 0 < out["delta"]["pathwise"] < 1
    assert "vega_per_vol_point" in out["vega"]
    assert "gamma" in out["gamma"]
    assert "theta_daily" in out["theta"]
    assert "rho" in out["rho"]


def test_greeks_chain_endpoint(base_url):
    out = post(f"{base_url}/api/greeks", {
        "spot": 22500, "strikes": [22000, 22500, 23000], "T": 0.04,
        "num_paths": 20_000})
    chain = out["chain"]
    assert [c["strike"] for c in chain] == [22000, 22500, 23000]
    deltas = [c["delta"]["pathwise"] for c in chain]
    assert deltas[0] > deltas[1] > deltas[2]  # calls: delta falls in strike
    # strike omitted AND no strikes → clean 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(f"{base_url}/api/greeks", {"spot": 22500, "T": 0.04})
    assert exc.value.code == 400


def test_stress_endpoint(base_url):
    out = post(f"{base_url}/api/stress", {
        "spot": 22500, "strike": 22500, "T": 0.04, "num_paths": 10_000})
    assert len(out["spot_shocks"]) == 6
    assert len(out["vol_shocks"]) == 2
    assert "jump_scenario" in out


def test_stress_matrix_endpoint(base_url):
    out = post(f"{base_url}/api/stress", {
        "spot": 22500, "strike": 22500, "T": 0.04, "num_paths": 10_000,
        "mode": "matrix", "spot_shocks": [-0.05, 0.05],
        "vol_shocks": [-0.02, 0.02]})
    assert out["spot_shocks_pct"] == [-5.0, 0.0, 5.0]
    assert out["vol_shocks_pts"] == [-2.0, 0.0, 2.0]
    assert len(out["pnl"]) == 3 and len(out["pnl"][0]) == 3
    assert out["pnl"][1][1] == pytest.approx(0.0, abs=1e-9)
    # invalid axes → 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(f"{base_url}/api/stress", {
            "spot": 22500, "strike": 22500, "T": 0.04, "mode": "matrix",
            "spot_shocks": [-0.99]})
    assert exc.value.code == 400


def test_greeks_second_order_endpoint(base_url):
    out = post(f"{base_url}/api/greeks", {
        "spot": 22500, "strike": 22500, "T": 0.1, "num_paths": 20_000,
        "with_second_order": True})
    so = out["second_order"]
    for k in ("charm", "speed", "zomma", "color", "veta"):
        assert k in so and so[k] == so[k]  # present and not NaN
    # chain mode rejects the flag
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(f"{base_url}/api/greeks", {
            "spot": 22500, "strikes": [22500.0], "T": 0.1,
            "with_second_order": True})
    assert exc.value.code == 400


def test_greeks_min_variance_endpoint(base_url):
    out = post(f"{base_url}/api/greeks", {
        "spot": 22500, "strike": 22500, "T": 0.1, "num_paths": 20_000,
        "with_min_variance": True,
        "params": {"rho": -0.7, "xi": 0.5}})
    mv = out["min_variance"]
    assert mv["adjustment"] < 0          # rho<0 tilts the hedge down
    assert mv["mv_delta"] == pytest.approx(
        mv["delta"] + mv["adjustment"], abs=1e-12)


def test_regime_endpoint(base_url):
    out = post(f"{base_url}/api/regime", {
        "realized_vol": 0.35, "iv_percentile": 85, "skew_slope": 0.12})
    assert out["regime"] == "crisis"


def test_hedge_endpoint(base_url):
    out = post(f"{base_url}/api/hedge", {
        "spot": 22500, "strike": 22500, "T": 0.04, "num_scenarios": 100})
    assert "mean_pnl" in out and "pnl_percentiles" in out
    assert out["hedge"] == "bs_delta"


def test_hedge_mv_endpoint(base_url):
    out = post(f"{base_url}/api/hedge", {
        "spot": 22500, "strike": 22500, "T": 0.04, "num_scenarios": 100,
        "dynamics": "svj", "hedge": "mv_delta"})
    assert out["hedge"] == "mv_delta"
    # mv_delta + rough is a clean 400, not a 500
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(f"{base_url}/api/hedge", {
            "spot": 22500, "strike": 22500, "T": 0.04,
            "num_scenarios": 100, "dynamics": "rough",
            "hedge": "mv_delta"})
    assert exc.value.code == 400


def test_smile_endpoint(base_url):
    out = post(f"{base_url}/api/smile", {"spot": 22500, "T": 0.1})
    assert len(out["smile"]) == 21
    strikes = [p["strike"] for p in out["smile"]]
    assert strikes[0] == pytest.approx(22500 * 0.7)
    assert strikes[-1] == pytest.approx(22500 * 1.3)
    prices = [p["price"] for p in out["smile"]]
    assert all(a > b for a, b in zip(prices, prices[1:]))  # calls ↓ in K


def test_calibrate_endpoint(base_url):
    from mcos_tpu.ops.bs import bs_price
    strikes = list(np.linspace(0.95, 1.05, 5) * 22500)
    market = [float(bs_price(22500, k, 0.25, 0.065, 0.012, 0.18, True))
              for k in strikes]
    out = post(f"{base_url}/api/calibrate", {
        "spot": 22500, "strikes": strikes, "T": 0.25,
        "market_prices": market, "atm_vol": 0.18, "num_paths": 8192})
    assert "params" in out and "stage1_result" in out
    assert out["params"]["v0"] > 0
    # Gauss-Newton error bars ride along (5 strikes < 8 params → the
    # Jacobian is rank-deficient; pinv covariance must still be finite).
    unc = out["uncertainty"]
    assert unc["param_names"][0] == "kappa"
    assert all(s >= 0 for s in unc["std_errors"])


def test_calibrate_american_endpoint(base_url):
    """American quotes de-Americanize server-side before the fit; the
    reported IVs recover the generating flat vol (CRR round trip)."""
    from mcos_tpu.engine.american import binomial_american_bs

    strikes = list(np.linspace(0.90, 1.10, 5) * 100)
    market = [binomial_american_bs(100.0, k, 0.5, 0.065, 0.012, 0.2,
                                   steps=256, is_call=False)
              for k in strikes]
    out = post(f"{base_url}/api/calibrate", {
        "spot": 100, "strikes": strikes, "T": 0.5, "is_call": False,
        "market_prices": market, "num_paths": 8192,
        "exercise": "american"})
    dm = out["deamericanized"]
    assert dm["n_dropped"] == 0
    np.testing.assert_allclose(dm["ivs"], 0.2, atol=2e-3)
    # unknown exercise → 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(f"{base_url}/api/calibrate", {
            "spot": 100, "strikes": strikes, "T": 0.5,
            "market_prices": market, "exercise": "bermudan"})
    assert exc.value.code == 400


def test_exotic_endpoint(base_url):
    out = post(f"{base_url}/api/exotic", {
        "spot": 100, "strike": 100, "T": 0.5, "kind": "asian",
        "num_paths": 10_000})
    assert out["price"] > 0 and "cv_beta" in out
    out2 = post(f"{base_url}/api/exotic", {
        "spot": 100, "strike": 100, "T": 0.5, "kind": "barrier",
        "barrier": 130, "num_paths": 10_000})
    assert out2["price"] >= 0
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(f"{base_url}/api/exotic", {
            "spot": 100, "T": 0.5, "kind": "barrier", "num_paths": 1000})
    assert exc.value.code == 400


def test_quote_endpoint_fallback(base_url):
    # Zero-egress environment: the live fetch fails, fallback serves the
    # static universe with source=CACHED (js/app.js:126-142 contract).
    out = get(f"{base_url}/api/quote?symbol=RELIANCE")
    assert out["source"] in ("CACHED", "LIVE")
    assert out["price"] > 0 and 0 < out["volatility"] < 1


def test_symbols_endpoint_full_universe(base_url):
    """GET /api/symbols serves the full 50-constituent NIFTY universe
    (+ the index itself) with the metadata the searchable picker needs
    (reference universe: js/stocks.js:2-53)."""
    out = get(f"{base_url}/api/symbols")
    rows = out["symbols"]
    assert len(rows) == 51  # 50 constituents + NIFTY index
    syms = {r["symbol"] for r in rows}
    for must in ("NIFTY", "RELIANCE", "UPL", "LTIM", "BAJAJ-AUTO",
                 "SHRIRAMFIN", "JSWSTEEL", "APOLLOHOSP"):
        assert must in syms
    for r in rows:
        assert r["price"] > 0 and 0 < r["vol"] < 1
        assert r["name"] and r["sector"]
    # server-side search: ?q= filters on symbol/name/sector, the same
    # fields the UI dropdown matches (client.symbols(q=...) contract)
    it_rows = get(f"{base_url}/api/symbols?q=IT")["symbols"]
    assert 0 < len(it_rows) < len(rows)
    assert all("it" in (r["symbol"] + r["name"] + r["sector"]).lower()
               for r in it_rows)
    assert get(f"{base_url}/api/symbols?q=reliance")["symbols"][0][
        "symbol"] == "RELIANCE"
    assert get(f"{base_url}/api/symbols?q=zzzz")["symbols"] == []
    # every universe symbol must be quotable through /api/quote
    q = get(f"{base_url}/api/quote?symbol=UPL")
    assert q["price"] > 0


def test_quote_endpoint_unknown_symbol(base_url):
    with pytest.raises(urllib.error.HTTPError) as exc:
        get(f"{base_url}/api/quote?symbol=NOSUCHSTOCK")
    assert exc.value.code == 503


def test_unknown_route_404(base_url):
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(f"{base_url}/api/nope", {})
    assert exc.value.code == 404


def test_malformed_body_422(base_url):
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(f"{base_url}/api/price", {"spot": "not-a-number"})
    assert exc.value.code == 422


def test_convergence_endpoint(base_url):
    out = post(f"{base_url}/api/convergence", {
        "spot": 22500, "strike": 22500, "T": 0.04, "num_paths": 20_000})
    assert len(out["num_paths"]) == len(out["price"]) == len(out["std_error"])
    assert out["num_paths"][-1] == 20_000


def test_american_endpoint(base_url):
    out = post(f"{base_url}/api/american", {
        "spot": 100, "strike": 110, "T": 0.5, "is_call": False,
        "num_paths": 20_000,
        "params": {"kappa": 0.0, "theta": 0.0625, "xi": 0.0, "rho": 0.0,
                    "v0": 0.0625, "lambda_j": 0.0, "mu_j": 0.0,
                    "sigma_j": 0.0, "r": 0.06, "q": 0.0}})
    assert out["price"] >= out["intrinsic"] - 1e-6
    assert out["price"] >= 10.0  # ITM put ≥ intrinsic


def test_book_endpoint(base_url):
    out = post(f"{base_url}/api/book", {
        "spots": [22500, 22500], "strikes": [22500, 23000],
        "Ts": [0.1, 0.25], "is_calls": [True, False],
        "quantities": [2.0, -1.0], "num_paths": 10_000})
    assert len(out["price"]) == 2
    assert "book_delta" in out and "book_value" in out
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(f"{base_url}/api/book", {
            "spots": [1.0], "strikes": [1, 2], "Ts": [0.1],
            "is_calls": [True]})
    assert exc.value.code == 400


def test_static_traversal_guard(base_url):
    # Sibling-directory escape (web vs webapp) must 404 (review finding).
    req = urllib.request.Request(f"{base_url}/static/../web/../README.md")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=30)
    assert exc.value.code == 404


def test_surface_endpoint(base_url):
    from mcos_tpu.ops.bs import bs_price as _bsp
    strikes = list(np.linspace(0.9, 1.1, 7) * 22500)
    mats = [0.1, 0.3]
    sigma = 0.2
    calls = [[float(_bsp(22500, k, t, 0.065, 0.012, sigma, True))
              for k in strikes] for t in mats]
    puts = [[float(_bsp(22500, k, t, 0.065, 0.012, sigma, False))
             for k in strikes] for t in mats]
    out = post(f"{base_url}/api/surface", {
        "spot": 22500, "strikes": strikes, "maturities": mats,
        "call_prices": calls, "put_prices": puts})
    assert len(out["iv_call"]) == 2 and len(out["iv_call"][0]) == 7
    ivs = [v for row in out["iv_call"] for v in row if v is not None]
    assert all(abs(v - sigma) < 0.01 for v in ivs)
    assert "arbitrage_report" in out
    assert out["sabr_fits"]  # one fit per maturity


def test_price_endpoint_qe_scheme():
    """POST /api/price with scheme='qe' prices with the Andersen scheme
    (matches the COS oracle at a step count where Euler would be biased)."""
    from mcos_tpu.api.server import handle_price
    from mcos_tpu.models.params import SVJParams
    from mcos_tpu.ops.cos_pricer import cos_price

    body = {"spot": 22500.0, "strike": 22500.0, "T": 0.25,
            "num_paths": 65536, "scheme": "qe", "num_steps": 64,
            "use_sobol": False,
            "params": {"kappa": 3.0, "theta": 0.05, "xi": 0.4, "rho": -0.6,
                       "v0": 0.04, "lambda_j": 1.0, "mu_j": -0.05,
                       "sigma_j": 0.1}}
    out = handle_price(body)
    p = SVJParams(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
                  lambda_j=1.0, mu_j=-0.05, sigma_j=0.1)
    exact = float(cos_price(p, 22500.0, [22500.0], 0.25, True)[0])
    assert abs(out["price"] - exact) < max(4 * out["std_error"], 3.0)


def test_price_endpoint_importance_sampling():
    """POST /api/price with use_importance=true prices a deep-OTM strike the
    plain estimator can't see (tilted measure + likelihood-ratio weights)."""
    from mcos_tpu.api.server import handle_price
    from mcos_tpu.ops.bs import bs_price as _bsp

    body = {"spot": 22500.0, "strike": 22500.0 * 1.30, "T": 1.0 / 12.0,
            "num_paths": 100_000, "use_importance": True,
            "params": {"kappa": 3.0, "theta": 0.04, "xi": 1e-4, "rho": 0.0,
                       "v0": 0.04, "lambda_j": 0.0, "mu_j": 0.0,
                       "sigma_j": 1e-4}}
    out = handle_price(body)
    ref = float(_bsp(22500.0, 22500.0 * 1.30, 1.0 / 12.0, 0.065, 0.012,
                     0.2, True))
    assert out["std_error"] > 0
    assert abs(out["price"] - ref) < max(4 * out["std_error"], 0.01 * ref)
    assert out["ess"] > 0


def test_localvol_endpoint():
    """POST /api/localvol prices a chain under a Dupire surface built from a
    flat IV grid — must match Black-Scholes."""
    from mcos_tpu.api.server import handle_localvol
    from mcos_tpu.ops.bs import bs_price as _bsp

    strikes = [np.round(22500.0 * m, 2) for m in np.linspace(0.8, 1.2, 9)]
    body = {"spot": 22500.0, "strikes": strikes,
            "maturities": [0.25, 0.5, 1.0],
            "iv": [[0.2] * 9] * 3,
            "price_strikes": [21000.0, 22500.0, 24000.0], "T": 0.5,
            "num_paths": 100_000, "num_steps": 64,
            "r": 0.065, "q": 0.012}
    out = handle_localvol(body)
    assert len(out["chain"]) == 3
    for row in out["chain"]:
        ref = float(_bsp(22500.0, row["strike"], 0.5, 0.065, 0.012, 0.2,
                         True))
        assert abs(row["price"] - ref) < max(4 * row["std_error"],
                                             0.005 * ref)
    lv = np.asarray(out["local_vol_grid"]["local_vol"])
    assert lv.shape == (len(out["local_vol_grid"]["t"]),
                        len(out["local_vol_grid"]["y"]))


def test_slv_empty_price_strikes_is_400():
    """Barrier/chain modes with an empty price_strikes list must be a clean
    400 (ApiError), not an IndexError-driven 500."""
    from mcos_tpu.api.server import ApiError, handle_slv

    strikes = [np.round(22500.0 * m, 2) for m in np.linspace(0.9, 1.1, 5)]
    body = {"spot": 22500.0, "strikes": strikes,
            "maturities": [0.25, 0.5, 1.0], "iv": [[0.2] * 5] * 3,
            "price_strikes": [], "T": 0.5, "mode": "barrier",
            "barrier": 21000.0, "num_paths": 1_000, "num_steps": 16}
    with pytest.raises(ApiError) as exc:
        handle_slv(body)
    assert exc.value.status == 400


def test_rough_endpoint_modes():
    """POST /api/rough: price mode hits BS in the degenerate limit; smile
    mode returns a skewed vol curve at full rough parameters."""
    from mcos_tpu.api.server import handle_rough
    from mcos_tpu.ops.bs import bs_price as _bsp

    deg = {"spot": 100.0, "T": 0.5, "strike": 105.0, "mode": "price",
           "eta": 1e-8, "rho": 0.0, "xi": 0.04, "hurst": 0.07,
           "num_paths": 4_096, "num_steps": 32}
    out = handle_rough(deg)
    ref = float(_bsp(100.0, 105.0, 0.5, out.get("r", 0.065), 0.012, 0.2,
                     True))
    assert out["price"] == pytest.approx(ref, abs=max(
        4 * out["std_error"], 2e-3))

    sm = handle_rough({"spot": 100.0, "T": 0.25, "mode": "smile",
                       "num_paths": 32_768, "num_steps": 32,
                       "moneyness": [0.9, 1.0, 1.1]})
    ivs = sm["implied_vols"]
    assert ivs[0] > ivs[1] > ivs[2]
    assert "elapsed_ms" in sm


def test_exposure_endpoint():
    """POST /api/exposure on a single long call: discounted EE must be flat
    at C0 (martingale) and the credit block must carry CVA ≈ LGD·C0·PD."""
    from mcos_tpu.api.server import handle_exposure
    from mcos_tpu.ops.bs import bs_price as _bsp

    out = handle_exposure({
        "spots": [100.0], "sigmas": [0.25], "corr": [[1.0]],
        "positions": [{"kind": "call", "strike": 100.0, "T": 1.0}],
        "r": 0.05, "q": [0.0], "num_paths": 100_000, "num_dates": 8,
        "hazard_rate": 0.03, "lgd": 0.6, "with_cva_delta": True})
    c0 = float(_bsp(100.0, 100.0, 1.0, 0.05, 0.0, 0.25, True))
    t = np.asarray(out["dates"])
    live = t < 1.0 - 1e-6
    disc_ee = np.exp(-0.05 * t[live]) * np.asarray(out["ee"])[live]
    np.testing.assert_allclose(disc_ee, c0, rtol=0.02)
    assert out["credit"]["cva"] == pytest.approx(
        0.6 * c0 * out["credit"]["pd_horizon"], rel=0.05)
    assert len(out["cva_delta"]) == 1 and out["cva_delta"][0] > 0


def test_serverless_entry_importable():
    """The managed-platform entry imports cleanly and exposes the stdlib
    transport."""
    import mcos_tpu.api.serverless as sl

    assert callable(sl.serve_wsgi)


def test_metrics_endpoint_counts_requests():
    from mcos_tpu.api import server as srv

    before = srv.METRICS.snapshot()["endpoints"].get(
        "/api/regime", {"count": 0})["count"]
    srv.handle_regime({"realized_vol": 0.12, "iv_percentile": 30.0,
                       "skew_slope": 0.01})
    # handle_* is transport-agnostic; observe() rides the HTTP layer — call
    # it directly the way do_POST does.
    srv.METRICS.observe("/api/regime", 1.0, True)
    snap = srv.METRICS.snapshot()
    assert snap["endpoints"]["/api/regime"]["count"] == before + 1
    assert "uptime_s" in snap


def test_security_and_cache_headers(base_url):
    """The reference ships these via vercel.json:3-41; the stdlib server
    must set them itself."""
    req = urllib.request.Request(f"{base_url}/api/health")
    with urllib.request.urlopen(req, timeout=60) as resp:
        h = resp.headers
        assert h["X-Content-Type-Options"] == "nosniff"
        assert h["X-Frame-Options"] == "DENY"
        assert h["Referrer-Policy"] == "strict-origin-when-cross-origin"
        assert h["Cache-Control"] == "no-store"
    # Static HTML shell revalidates; the server may run without the UI
    # bundled, in which case the 404 JSON still carries the headers.
    try:
        with urllib.request.urlopen(f"{base_url}/", timeout=60) as resp:
            assert resp.headers["X-Content-Type-Options"] == "nosniff"
            assert "must-revalidate" in resp.headers["Cache-Control"]
    except urllib.error.HTTPError as e:
        assert e.headers["X-Content-Type-Options"] == "nosniff"


def test_oversized_body_rejected_413(base_url):
    big = json.dumps({"spot": 22500, "pad": "x" * (11 * 1024 * 1024)})
    req = urllib.request.Request(
        f"{base_url}/api/price", data=big.encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    # The server answers 413 without draining the oversized body, so the
    # client may instead observe a reset while still writing — both are
    # the refusal we are testing for.
    with pytest.raises(urllib.error.URLError) as ei:
        urllib.request.urlopen(req, timeout=60)
    if isinstance(ei.value, urllib.error.HTTPError):
        assert ei.value.code == 413
