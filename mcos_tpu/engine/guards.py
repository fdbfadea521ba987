"""Production stability guards: pre-price and post-price validation.

Re-design of the reference's guard layer (reference:
engine/guards.py). Same contract: `check_pre_price` rejects unreliable
parameterizations before any compute, `check_post_price` sanity-checks the MC
result, `validate_simulation_output` screens terminal arrays.

Host-side by design — these are request-admission checks on a handful of
scalars; the expensive parts (NaN/Inf scans over terminal arrays) are already
computed *on device* inside the pricer as fused reductions
(`frac_nonfinite`, `v_max` in mc_price_core) so the guard only inspects
scalars and never pulls path arrays to the host.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

from mcos_tpu.config import (
    JUMP_COMPENSATION_TOL,
    MAX_CORRELATION,
    MAX_VARIANCE,
    SAFE_STRIKE_RANGE,
    VOL_OF_VOL_ALERT_THRESHOLD,
)
from mcos_tpu.models.params import SVJParams

logger = logging.getLogger("mcos_tpu.guards")


class PricingGuard:
    """Pre/post pricing validation (guards.py:28-170 API).

    check_pre_price → {'pass': bool, 'failures': [...], 'alerts': [...]}
    check_post_price → same shape, applied to the pricer's result dict.

    Implementation: each check is one entry in a declarative rule table —
    (severity, predicate → message-or-None) — evaluated in order. Adding a
    rule is adding a row, and the tables double as a readable policy spec.
    """

    def __init__(self, params: SVJParams):
        self.params = params
        self.alerts: list = []

    # ── pre-price rule table ──────────────────────────────────────────────
    # Each rule maps the request context to a message (triggered) or None.
    @staticmethod
    def _pre_rules():
        def variance_domain(c):
            for label, val in (("v0", c["v0"]), ("θ", c["theta"])):
                if val > MAX_VARIANCE:
                    return (f"{label}={val:.4f} exceeds "
                            f"MAX_VARIANCE={MAX_VARIANCE}")
                if val <= 0:
                    return f"{label}={val:.6f} is non-positive"
            return None

        def correlation_domain(c):
            if abs(c["rho"]) > MAX_CORRELATION:
                return f"|ρ|={abs(c['rho']):.4f} exceeds {MAX_CORRELATION}"
            return None

        def jump_consistency(c):
            # The engine's compensator k must equal exp(μ+σ²/2)−1; a
            # mismatch means corrupted params (guards.py:67-73). Both sides
            # in f64 on host: comparing a device-f32 exp against host np.exp
            # can falsely fail the 1e-6 tolerance (f32 exp error ~1e-6).
            mu, sig = c["mu_j"], c["sigma_j"]
            if not (np.isfinite(mu) and np.isfinite(sig)):
                return f"Jump parameters non-finite: μ_J={mu}, σ_J={sig}"
            k = float(np.exp(mu + 0.5 * sig**2) - 1.0)
            if abs(k - c["device_k"]) > max(JUMP_COMPENSATION_TOL,
                                            5e-6 * max(abs(k), 1.0)):
                return (f"Jump compensation misaligned: k={c['device_k']:.6f}"
                        f" vs expected={k:.6f}")
            return None

        def maturity_positive(c):
            return f"T={c['T']} is non-positive" if c["T"] <= 0 else None

        def moneyness_band(c):
            if c["spot"] <= 0:
                return None
            m = c["strike"] / c["spot"]
            lo, hi = SAFE_STRIKE_RANGE
            if m < lo or m > hi:
                return (f"Moneyness K/S={m:.3f} lies beyond the calibrated "
                        f"band [{lo}, {hi}] — treat the quote as "
                        "extrapolated.")
            return None

        def vol_of_vol_spike(c):
            if c["xi"] > VOL_OF_VOL_ALERT_THRESHOLD:
                return (f"Vol-of-vol ξ={c['xi']:.3f} above the "
                        f"{VOL_OF_VOL_ALERT_THRESHOLD} alert line — expect "
                        "noisy variance paths and wide stderr.")
            return None

        def feller_soft(c):
            if not c["feller_ok"]:
                return (f"Feller check fails (2κθ={c['two_kt']:.4f} "
                        f"< ξ²={c['xi']**2:.4f}): the variance process can "
                        "touch zero, full truncation will clip it.")
            return None

        def long_maturity(c):
            if c["T"] > 5:
                return (f"T={c['T']:.2f}y maturity sits outside the weekly-"
                        "options regime this model is tuned for")
            return None

        return (
            ("fail", variance_domain),
            ("fail", correlation_domain),
            ("fail", jump_consistency),
            ("fail", maturity_positive),
            ("alert", moneyness_band),
            ("alert", vol_of_vol_spike),
            ("alert", feller_soft),
            ("alert", long_maturity),
        )

    def check_pre_price(self, spot: float, strike: float, T: float) -> Dict:
        """Parameter/domain admission checks (guards.py:41-115 rule set)."""
        p = self.params
        ctx = {
            "spot": spot, "strike": strike, "T": T,
            "v0": float(p.v0), "theta": float(p.theta), "xi": float(p.xi),
            "rho": float(p.rho), "mu_j": float(p.mu_j),
            "sigma_j": float(p.sigma_j),
            "device_k": float(p.jump_compensation),
            "feller_ok": bool(p.feller_satisfied),
            "two_kt": 2 * float(p.kappa) * float(p.theta),
        }
        return self._evaluate(self._pre_rules(), ctx, log_prefix="PRE-PRICE")

    # ── post-price rule table ─────────────────────────────────────────────
    @staticmethod
    def _post_rules():
        def negative_price(c):
            if c["price"] < -1e-6:
                return f"Negative price={c['price']:.6f}"
            return None

        def arbitrage_ceiling(c):
            # Call ≤ spot; put ≤ discounted strike (guards.py:145-151).
            if c["is_call"] and c["price"] > c["spot"] * 1.01:
                return (f"Call at {c['price']:.2f} breaches its no-arbitrage"
                        f" ceiling (spot {c['spot']:.2f})")
            if not c["is_call"] and c["price"] > c["disc_strike"] * 1.01:
                return (f"Put at {c['price']:.2f} breaches its no-arbitrage "
                        "ceiling (discounted strike)")
            return None

        def intrinsic_floor(c):
            if c["price"] < c["intrinsic"] - 3 * c["std_error"]:
                return (f"Price {c['price']:.4f} undershoots the intrinsic "
                        f"floor {c['intrinsic']:.4f} beyond 3σ of MC noise")
            return None

        def nonfinite_paths(c):
            if c["frac_nonfinite"] > 0:
                return (f"{c['frac_nonfinite']:.2e} fraction of non-finite "
                        "terminal spots")
            return None

        def stderr_budget(c):
            # 0.1%-of-premium tolerance (config.py:25 / guards.py:139-142).
            if c["price"] > 0 and c["std_error"] / c["price"] > 0.001:
                return (f"MC noise at {c['std_error'] / c['price']:.4%} of "
                        "premium — above the 0.1% production tolerance; "
                        "raise num_paths")
            return None

        def variance_explosion(c):
            if c["v_max"] > MAX_VARIANCE:
                return (f"Max terminal variance={c['v_max']:.4f} exceeds "
                        f"limit={MAX_VARIANCE}")
            return None

        return (
            ("fail", negative_price),
            ("fail", arbitrage_ceiling),
            ("fail", intrinsic_floor),
            ("fail", nonfinite_paths),
            ("alert", stderr_budget),
            ("alert", variance_explosion),
        )

    def check_post_price(self, result: Dict, spot: float, strike: float,
                         T: float, is_call: bool = True) -> Dict:
        """Result sanity checks (guards.py:117-170 rule set)."""
        r, q = float(self.params.r), float(self.params.q)
        fwd_spot = spot * np.exp(-q * T)
        disc_strike = strike * np.exp(-r * T)
        intrinsic = max(fwd_spot - disc_strike, 0.0) if is_call \
            else max(disc_strike - fwd_spot, 0.0)
        ctx = {
            "price": result.get("price", 0.0),
            "std_error": result.get("std_error", 0.0),
            "frac_nonfinite": result.get("frac_nonfinite", 0.0),
            "v_max": result.get("v_max", 0.0),
            "spot": spot, "is_call": is_call,
            "disc_strike": disc_strike, "intrinsic": intrinsic,
        }
        return self._evaluate(self._post_rules(), ctx,
                              log_prefix="POST-PRICE")

    # ── shared evaluator ──────────────────────────────────────────────────
    def _evaluate(self, rules, ctx, log_prefix: str) -> Dict:
        failures, alerts = [], []
        for severity, rule in rules:
            msg = rule(ctx)
            if msg is None:
                continue
            (failures if severity == "fail" else alerts).append(msg)
        if log_prefix == "PRE-PRICE":
            self.alerts.extend(alerts)
        for msg in failures:
            logger.error("%s FAILURE: %s", log_prefix, msg)
        for msg in alerts:
            logger.warning("%s ALERT: %s", log_prefix, msg)
        return {"pass": not failures, "failures": failures, "alerts": alerts}


def validate_simulation_output(s_final, v_final) -> Dict:
    """Terminal-array screening (guards.py:173-218 contract).

    Accepts numpy or JAX arrays; reductions run wherever the arrays live
    (on device for JAX inputs — only scalars cross to the host).
    """
    import jax.numpy as jnp

    s = jnp.asarray(s_final)
    v = jnp.asarray(v_final)
    issues = []

    nan_s = int(jnp.isnan(s).sum())
    nan_v = int(jnp.isnan(v).sum())
    inf_s = int(jnp.isinf(s).sum())
    inf_v = int(jnp.isinf(v).sum())
    if nan_s:
        issues.append(f"{nan_s} NaN values in S_final")
    if nan_v:
        issues.append(f"{nan_v} NaN values in v_final")
    if inf_s:
        issues.append(f"{inf_s} Inf values in S_final")
    if inf_v:
        issues.append(f"{inf_v} Inf values in v_final")

    neg_s = int((s < 0).sum())
    if neg_s:
        issues.append(f"{neg_s} negative S values")

    max_v = float(jnp.max(v)) if v.size else 0.0
    if max_v > MAX_VARIANCE:
        issues.append(f"Max variance={max_v:.4f} exceeds limit={MAX_VARIANCE}")

    neg_v = int((v < -1e-10).sum())
    if neg_v:
        issues.append(f"{neg_v} negative variance values (truncation failed)")

    return {
        "valid": not issues,
        "issues": issues,
        "stats": {
            "S_mean": float(jnp.nanmean(s)),
            "S_std": float(jnp.nanstd(s)),
            "v_mean": float(jnp.nanmean(v)),
            "v_max": max_v,
        },
    }
