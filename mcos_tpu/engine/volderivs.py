"""Volatility derivatives under SVJ: variance swaps, vol swaps, and
VIX-style futures/options on model-implied forward volatility.

Capability family beyond the reference (its engine prices spot options only;
a vol desk also quotes realized- and implied-variance products — NSE lists
India VIX futures on this exact underlying class).

Three exact structures make the whole module oracle-testable:

1. **Variance swap**: fair strike is closed-form under SVJ
   (engine/exotics.py:variance_swap_fair_strike). Here we add the MC
   round-trip — realized variance Σ(Δlog S)² accumulated in-scan — pinned
   to the closed form in tests.

2. **Vol swap**: K_vol = E[√(RV/T)] has no closed form; we report the MC
   estimator plus the Brockhaus-Long convexity approximation
   √E[X] − Var(X)/(8·E[X]^{3/2}), with Jensen's bound K_vol ≤ K_var^{1/2}
   as a structural test.

3. **VIX-style index**: with τ the index window (30/365), the model VIX² at
   time T is affine in the instantaneous variance,

       VIX²_T = a(τ) + b(τ)·v_T,
       b = (1 − e^{−κτ})/(κτ),   a = θ(1 − b) + j,

   where j is the jump add-on: 2λ(k̄ − μ_J) with k̄ = E[e^J−1] under the
   market *log-contract* definition (the CBOE/India-VIX replication measures
   2·E[dS/S − d log S] = v dt + 2(e^J−1−J)dN), or λ(μ_J² + σ_J²) under the
   *quadratic-variation* convention — both exposed. v_T follows the exact
   CIR transition: v_T = c·X with X ~ noncentral-χ²(df, nc),

       c = ξ²(1−e^{−κT})/(4κ),  df = 4κθ/ξ²,  nc = 4κe^{−κT} v₀/(ξ²(1−e^{−κT})),

   so VIX futures E[√(a+b·v_T)] and VIX options E[(VIX_T − K)±] are
   one-dimensional integrals against a known density — evaluated here by
   Gauss-Legendre in probability space (host f64: precision-critical and
   tiny work). The QE Monte Carlo variance terminal
   (ops/simulate.py:simulate_terminal_qe) cross-checks the quadrature: the
   engine's simulated v_T must reproduce the analytic noncentral-χ² law.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import scaled_steps
from mcos_tpu.engine.exotics import variance_swap_fair_strike
from mcos_tpu.models.params import SVJParams
from mcos_tpu.ops.simulate import _svj_step_core, simulate_terminal_qe

Array = jax.Array

VIX_WINDOW = 30.0 / 365.0


# ─────────────────────────────────────────────────────────────────────────────
# Realized-variance Monte Carlo (in-scan accumulation)
# ─────────────────────────────────────────────────────────────────────────────
@partial(jax.jit, static_argnames=("num_paths", "num_steps", "antithetic"))
def realized_variance_paths(params: SVJParams, T, key, *,
                            num_paths: int, num_steps: int,
                            antithetic: bool = True) -> Array:
    """(n_branch, num_paths) annualized realized variance Σ(Δlog S)²/T.

    Reuses `_svj_step_core` (the pinned scan/Pallas recursion — any dynamics
    change lands there first) and accumulates squared log increments in the
    carry; no path sheet is materialized. Spot cancels (increments only), so
    there is no spot argument.
    """
    dtype = jnp.float32
    n_branch = 2 if antithetic else 1
    dt = jnp.asarray(T, dtype) / num_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None]

    log_s0 = jnp.zeros((n_branch, num_paths), dtype)
    v0 = jnp.broadcast_to(jnp.asarray(params.v0, dtype),
                          (n_branch, num_paths))
    rv0 = jnp.zeros_like(log_s0)

    def step(carry, step_idx):
        log_s, v, rv = carry
        k_step = jax.random.fold_in(key, step_idx)
        k_norm, k_unif = jax.random.split(k_step)
        z = jax.random.normal(k_norm, (3, num_paths), dtype)
        u = jax.random.uniform(k_unif, (num_paths,), dtype)
        # Antithetic branch: normals negated, jump uniforms shared
        # (monte_carlo.py:318-324 pairing).
        log_s2, v2 = _svj_step_core(params, dt, sqrt_dt, log_s, v,
                                    sign * z[0], sign * z[1], u[None],
                                    sign * z[2])
        rv = rv + (log_s2 - log_s) ** 2
        return (log_s2, v2, rv), None

    (_, _, rv), _ = jax.lax.scan(step, (log_s0, v0, rv0),
                                 jnp.arange(num_steps))
    return rv / jnp.asarray(T, dtype)


# ─────────────────────────────────────────────────────────────────────────────
# VIX affine map and the exact CIR terminal law
# ─────────────────────────────────────────────────────────────────────────────
def vix_squared_coefficients(params: SVJParams, tau: float = VIX_WINDOW,
                             convention: str = "log_contract"
                             ) -> Dict[str, float]:
    """(a, b) of VIX²_T = a + b·v_T (host f64).

    convention: "log_contract" (market VIX replication; jump add-on
    2λ(E[e^J−1] − μ_J)) or "quadratic_variation" (realized-variance units;
    add-on λ(μ_J²+σ_J²), matching variance_swap_fair_strike's jump leg).
    """
    kappa, theta = float(params.kappa), float(params.theta)
    lam = float(params.lambda_j)
    mu_j, sig_j = float(params.mu_j), float(params.sigma_j)
    kt = max(kappa * tau, 1e-12)
    b = (1.0 - np.exp(-kt)) / kt
    if convention == "log_contract":
        k_bar = np.exp(mu_j + 0.5 * sig_j**2) - 1.0
        jump = 2.0 * lam * (k_bar - mu_j)
    elif convention == "quadratic_variation":
        jump = lam * (mu_j**2 + sig_j**2)
    else:
        raise ValueError(f"unknown convention: {convention!r}")
    return {"a": theta * (1.0 - b) + jump, "b": b, "jump_addon": jump}


def cir_terminal_law(params: SVJParams, T: float) -> Dict[str, float]:
    """Exact CIR v_T = scale·X, X ~ ncx2(df, nc) (host f64)."""
    kappa, theta, xi = (float(params.kappa), float(params.theta),
                        float(params.xi))
    v0 = float(params.v0)
    if xi <= 1e-8:  # deterministic variance (the GBM degenerate oracle)
        ekt = np.exp(-kappa * T)
        return {"scale": 0.0, "df": 0.0, "nc": 0.0,
                "deterministic_v": theta + (v0 - theta) * ekt}
    ekt = np.exp(-kappa * T)
    scale = xi**2 * (1.0 - ekt) / (4.0 * kappa)
    df = 4.0 * kappa * theta / xi**2
    nc = v0 * ekt / scale
    return {"scale": scale, "df": df, "nc": nc, "deterministic_v": None}


def _expect_vix_payoff(params: SVJParams, T: float, tau: float,
                       convention: str, payoff, n_nodes: int = 512) -> float:
    """E[payoff(VIX_T)] by Gauss-Legendre in probability space (host f64).

    u-space nodes avoid tail truncation: E[g(F⁻¹(U))] with U uniform; the
    ncx2 ppf handles both tails exactly.
    """
    from scipy.stats import ncx2

    co = vix_squared_coefficients(params, tau, convention)
    law = cir_terminal_law(params, T)
    if law["deterministic_v"] is not None:
        vix = np.sqrt(max(co["a"] + co["b"] * law["deterministic_v"], 0.0))
        return float(payoff(np.asarray([vix]))[0])
    u, w = np.polynomial.legendre.leggauss(n_nodes)
    u = 0.5 * (u + 1.0)          # → (0, 1)
    w = 0.5 * w
    v_t = law["scale"] * ncx2.ppf(u, law["df"], law["nc"])
    vix = np.sqrt(np.maximum(co["a"] + co["b"] * v_t, 0.0))
    return float(np.sum(w * payoff(vix)))


# ─────────────────────────────────────────────────────────────────────────────
# Engine
# ─────────────────────────────────────────────────────────────────────────────
class VolDerivsEngine:
    """Variance/vol swaps and VIX futures/options with the framework's
    engine conventions (quadrature exact where a law is known, MC with
    stderr where it is not)."""

    def __init__(self, params: SVJParams, num_paths: int = 200_000,
                 num_steps: int = 252, seed: int = 42, mesh=None):
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        # None honors MCOS_AUTO_MESH=1; "auto"/Mesh routes variance_swap()
        # through parallel/families.py:sharded_variance_swap.
        self.mesh = mesh

    # -- realized-variance products -------------------------------------------
    def _rv(self, T: float) -> np.ndarray:
        """(2, num_paths) realized-variance array — branch axis kept so the
        stderr can be taken over iid antithetic PAIRS. The branches share
        jump uniforms and z² magnitudes (the dominant v·z²·dt term is
        identical within a pair), so flattening to 2n values and dividing
        by √(2n) would understate the error by up to ~√2 — the same defect
        greeks.py's LR estimator fixes by collapsing pairs first."""
        steps = scaled_steps(self.num_steps, T)
        rv = realized_variance_paths(
            self.params, T, jax.random.key(self.seed),
            num_paths=self.num_paths, num_steps=steps)
        return np.asarray(jax.device_get(rv), np.float64)

    def variance_swap(self, T: float) -> Dict[str, float]:
        """Closed-form fair strike + the MC round-trip (discrete daily
        sampling at the engine's step grid)."""
        from mcos_tpu.engine.pricer import resolve_mesh

        mesh = resolve_mesh(self.mesh)
        if mesh is not None:
            from mcos_tpu.parallel.families import sharded_variance_swap

            out = sharded_variance_swap(
                self.params, T, jax.random.key(self.seed), mesh=mesh,
                num_paths=self.num_paths,
                num_steps=scaled_steps(self.num_steps, T))
            out["num_paths"] = int(out.pop("num_paths_used"))
            return out
        closed = variance_swap_fair_strike(self.params, T)
        pairs = self._rv(T).mean(axis=0)   # iid pair means
        mc = pairs.mean()
        se = pairs.std() / np.sqrt(pairs.size)
        return {
            **closed,
            "mc_fair_variance": float(mc),
            "mc_std_error": float(se),
            "mc_vs_closed_sigmas": float(
                abs(mc - closed["fair_variance"]) / max(se, 1e-12)),
            "num_paths": self.num_paths,
        }

    def vol_swap(self, T: float) -> Dict[str, float]:
        """Fair volatility strike E[√(RV/T)] (MC) + Brockhaus-Long
        approximation and the Jensen gap vs the variance-swap strike."""
        rv = self._rv(T)
        vol_pairs = np.sqrt(np.maximum(rv, 0.0)).mean(axis=0)
        k_vol = vol_pairs.mean()
        se = vol_pairs.std() / np.sqrt(vol_pairs.size)
        m, var = rv.mean(), rv.var()
        bl = np.sqrt(m) - var / (8.0 * max(m, 1e-12) ** 1.5)
        k_var_sqrt = np.sqrt(
            variance_swap_fair_strike(self.params, T)["fair_variance"])
        return {
            "fair_vol_strike": float(k_vol),
            "std_error": float(se),
            "brockhaus_long": float(bl),
            "variance_strike_sqrt": float(k_var_sqrt),
            "convexity_discount": float(k_var_sqrt - k_vol),
            "num_paths": self.num_paths,
        }

    # -- VIX-style products -----------------------------------------------------
    def vix_spot(self, convention: str = "log_contract",
                 tau: float = VIX_WINDOW) -> float:
        """Model VIX at t=0: √(a + b·v₀)."""
        co = vix_squared_coefficients(self.params, tau, convention)
        return float(np.sqrt(max(co["a"] + co["b"] * float(self.params.v0),
                                 0.0)))

    def vix_future(self, T: float, tau: float = VIX_WINDOW,
                   convention: str = "log_contract") -> Dict[str, float]:
        """VIX future F = E[VIX_T] by exact quadrature, with Jensen's upper
        bound √E[VIX²_T] (closed form via E[v_T])."""
        fut = _expect_vix_payoff(self.params, T, tau, convention,
                                 lambda vix: vix)
        co = vix_squared_coefficients(self.params, tau, convention)
        kappa, theta = float(self.params.kappa), float(self.params.theta)
        ev_t = theta + (float(self.params.v0) - theta) * np.exp(-kappa * T)
        upper = np.sqrt(max(co["a"] + co["b"] * ev_t, 0.0))
        return {
            "future": float(fut),
            "jensen_upper_bound": float(upper),
            "vix_spot": self.vix_spot(convention, tau),
            "convention": convention,
        }

    def vix_option(self, T: float, strike: float,
                   is_call: bool = True, tau: float = VIX_WINDOW,
                   convention: str = "log_contract") -> Dict[str, float]:
        """European VIX option (discounted, on the index level in vol
        units — quote ×100 for index points)."""
        k = float(strike)
        if is_call:
            payoff = lambda vix: np.maximum(vix - k, 0.0)  # noqa: E731
        else:
            payoff = lambda vix: np.maximum(k - vix, 0.0)  # noqa: E731
        undisc = _expect_vix_payoff(self.params, T, tau, convention, payoff)
        df = np.exp(-float(self.params.r) * T)
        fut = _expect_vix_payoff(self.params, T, tau, convention,
                                 lambda vix: vix)
        return {
            "price": float(df * undisc),
            "future": float(fut),
            "discount_factor": float(df),
            "convention": convention,
        }

    def vix_future_mc(self, T: float, tau: float = VIX_WINDOW,
                      convention: str = "log_contract",
                      num_steps: int = 32) -> Dict[str, float]:
        """MC cross-check: v_T from the engine's QE variance dynamics
        (near-exact noncentral-χ² transitions) → E[√(a + b·v_T)]. Pins the
        quadrature against the simulator the spot engines actually use."""
        co = vix_squared_coefficients(self.params, tau, convention)
        _, v_final, _ = simulate_terminal_qe(
            self.params, 100.0, T, jax.random.key(self.seed),
            num_paths=self.num_paths, num_steps=num_steps, antithetic=False)
        v_t = np.asarray(jax.device_get(v_final), np.float64).reshape(-1)
        vix = np.sqrt(np.maximum(co["a"] + co["b"] * v_t, 0.0))
        return {
            "future_mc": float(vix.mean()),
            "std_error": float(vix.std() / np.sqrt(vix.size)),
            "num_paths": self.num_paths,
        }
