"""SVCJ (correlated price/variance jumps): CF limits, COS oracle, and the
MC-vs-oracle cross-check — the same validation ladder the SVJ stack gets
in tests/test_cos_pricer.py."""

import numpy as np
import pytest

from mcos_tpu.api import server as api
from mcos_tpu.engine.svcj import SVCJEngine
from mcos_tpu.models.params import SVCJParams
from mcos_tpu.ops.cos_pricer import bates_cf, cos_price
from mcos_tpu.ops.svcj import svcj_cf, svcj_cos_price

S, T = 22500.0, 0.25

P = SVCJParams(kappa=3.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04,
               lambda_j=1.5, mu_j=-0.07, sigma_j=0.12,
               mu_v=0.08, rho_j=-0.6)


def test_cf_is_martingale():
    """φ(−i) = E[S_T] = S·e^{(r−q)T} — the compensator is exactly right."""
    phi = svcj_cf(np.array([-1j]), P, T, S)[0]
    fwd = S * np.exp((float(P.r) - float(P.q)) * T)
    assert abs(phi.real - fwd) < 1e-6 * fwd and abs(phi.imag) < 1e-6


def test_cf_reduces_to_bates():
    """μ_v → 0 kills the variance jump: SVCJ CF = Bates CF exactly."""
    u = np.linspace(0.1, 60.0, 13)
    lhs = svcj_cf(u, P.replace(mu_v=1e-14), T, S)
    rhs = bates_cf(u, P.svj_part(), T, S)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-9)


def test_cos_reduces_to_bates_price():
    strikes = np.array([0.9, 1.0, 1.1]) * S
    lhs = svcj_cos_price(P.replace(mu_v=1e-14), S, strikes, T, True)
    rhs = cos_price(P.svj_part(), S, strikes, T, True)
    np.testing.assert_allclose(lhs, rhs, rtol=5e-5)


def test_cos_put_call_parity():
    strikes = np.array([0.85, 1.0, 1.15]) * S
    calls = svcj_cos_price(P, S, strikes, T, True)
    puts = svcj_cos_price(P, S, strikes, T, False)
    parity = S * np.exp(-float(P.q) * T) - strikes * np.exp(-float(P.r) * T)
    np.testing.assert_allclose(calls - puts, parity, atol=1e-6 * S)


def test_variance_jumps_raise_otm_put_value():
    """Crash jumps (Z_v up, Z_s tilted down via ρ_J<0) must fatten the left
    tail: deep-OTM puts are strictly more valuable than the Bates fit with
    identical diffusion + price-jump marginal-free parameters."""
    k = 0.85 * S
    with_vj = float(svcj_cos_price(P, S, [k], T, False)[0])
    without = float(cos_price(P.svj_part(), S, [k], T, False)[0])
    assert with_vj > without * 1.02


def test_mc_matches_cos_full_svcj():
    """THE oracle test for the family: the scan MC must reproduce the
    semi-analytic SVCJ price within MC + discretization bands (the SVJ
    analogue is tests/test_cos_pricer.py::test_mc_matches_cos_full_svj)."""
    strikes = np.array([0.9, 0.95, 1.0, 1.05, 1.1]) * S
    exact = svcj_cos_price(P, S, strikes, T, True)
    eng = SVCJEngine(P, num_paths=300_000, num_steps=2048, seed=5)
    res = eng.mc_vs_cos(S, strikes, T, True)
    for row, ex in zip(res["rows"], exact):
        tol = 4 * row["std_error"] + 0.0015 * ex
        assert abs(row["mc_price"] - ex) < tol, row


def test_engine_price_and_greeks():
    eng = SVCJEngine(P, num_paths=60_000, num_steps=64, seed=2)
    out = eng.price(S, S, T)
    assert out["price"] > 0 and out["frac_nonfinite"] == 0.0
    g = eng.greeks(S, S, T)
    assert 0.3 < g["delta"] < 0.8
    assert g["vega"] > 0


def test_smile_has_put_skew():
    """ρ<0, ρ_J<0 crash dynamics ⇒ downside IV above upside IV."""
    eng = SVCJEngine(P)
    sm = eng.smile(S, T, [0.9 * S, S, 1.1 * S])
    ivs = sm["iv"]
    assert all(v is not None for v in ivs)
    assert ivs[0] > ivs[2]


def test_api_svcj_modes():
    base = {"spot": S, "T": T, "num_paths": 2_000, "num_steps": 16}
    out = api.handle_svcj(dict(base))
    assert out["price"] > 0
    g = api.handle_svcj({**base, "mode": "greeks"})
    assert "delta" in g
    sm = api.handle_svcj({**base, "mode": "smile",
                          "strikes": [0.95 * S, S, 1.05 * S]})
    assert len(sm["iv"]) == 3
    cmp_ = api.handle_svcj({**base, "mode": "compare"})
    assert len(cmp_["rows"]) == 5
    with pytest.raises(api.ApiError):
        api.handle_svcj({**base, "mode": "nope"})


def test_schema_rejects_divergent_compensator():
    from mcos_tpu.api.validation import ValidationError

    with pytest.raises(ValidationError):
        api.schemas.SVCJRequest(spot=S, T=T,
                                params={"mu_v": 0.9, "rho_j": 2.0})
