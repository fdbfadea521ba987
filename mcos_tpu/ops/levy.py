r"""Variance Gamma: pure-jump Levy model with an EXACT terminal sampler.

Capability beyond the reference (diffusion + compound-Poisson only): the
Madan-Carr-Chang Variance Gamma process, Brownian motion with drift run
on a gamma clock,

    ln S_T = ln S0 + (r - q + omega) T + theta*G + sigma*sqrt(G)*Z,
    G ~ Gamma(T/nu, nu),   omega = ln(1 - theta*nu - sigma^2 nu/2)/nu,

an infinite-activity process whose small jumps generate steep short-dated
smiles without any diffusion component at all.

Design: the terminal law is sampled EXACTLY in two primitives
(`jax.random.gamma` + one normal) — no path loop, no discretization bias
of any kind; pricing is one elementwise expression over the path batch.
The COS machinery (ops/cos_pricer.py) prices the same model
semi-analytically from the closed-form characteristic function

    phi(u) = e^{iu(ln S0 + (r-q+omega)T)} (1 - iu theta nu
             + sigma^2 nu u^2 / 2)^{-T/nu},

giving the usual exact-oracle pin: MC and COS are independent routes to
the same law (tests), and nu -> 0 recovers Black-Scholes.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import DIVIDEND_YIELD, RISK_FREE_RATE
from mcos_tpu.ops.cos_pricer import _chi_psi

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VGParams:
    """Variance Gamma parameters (risk-neutral).

    theta < 0 tilts the gamma-time Brownian motion down (negative skew);
    nu is the variance of the gamma clock per unit time (kurtosis);
    sigma the diffusion scale on the business clock.
    """

    sigma: float = 0.2
    nu: float = 0.2
    theta: float = -0.14
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD

    @property
    def omega(self):
        """Martingale compensator: E[e^{omega T + theta G + ...}] = 1."""
        arg = 1.0 - self.theta * self.nu - 0.5 * self.sigma**2 * self.nu
        return jnp.log(arg) / self.nu


def vg_cf(u: np.ndarray, p: VGParams, T: float, spot: float) -> np.ndarray:
    """Characteristic function E[e^{iu ln S_T}] (host complex128)."""
    sigma, nu, theta = float(p.sigma), float(p.nu), float(p.theta)
    r, q = float(p.r), float(p.q)
    omega = np.log(1.0 - theta * nu - 0.5 * sigma**2 * nu) / nu
    u = np.asarray(u, np.complex128)
    iu = 1j * u
    drift = iu * (np.log(spot) + (r - q + omega) * T)
    base = 1.0 - iu * theta * nu + 0.5 * sigma**2 * nu * u**2
    return np.exp(drift) * base ** (-T / nu)


def vg_cos_price(p: VGParams, spot: float, strikes, T: float,
                 is_call: bool = True, n_terms: int = 512,
                 L: float = 14.0) -> np.ndarray:
    """Semi-analytic VG prices (COS; the MC engine's exact oracle).

    Truncation from the VG cumulants of ln S_T:
        c1 = ln S0 + (r-q+omega)T + theta T
        c2 = (sigma^2 + nu theta^2) T
        c4 = 3 (sigma^4 nu + 2 theta^4 nu^3 + 4 sigma^2 theta^2 nu^2) T.
    """
    sigma, nu, theta = float(p.sigma), float(p.nu), float(p.theta)
    r, q = float(p.r), float(p.q)
    omega = np.log(1.0 - theta * nu - 0.5 * sigma**2 * nu) / nu
    strikes = np.atleast_1d(np.asarray(strikes, np.float64))

    c1 = np.log(spot) + (r - q + omega) * T + theta * T
    c2 = (sigma**2 + nu * theta**2) * T
    c4 = 3.0 * (sigma**4 * nu + 2.0 * theta**4 * nu**3
                + 4.0 * sigma**2 * theta**2 * nu**2) * T
    half = L * np.sqrt(c2 + np.sqrt(max(c4, 0.0)))
    a, b = c1 - half, c1 + half

    k = np.arange(n_terms)
    u = k * np.pi / (b - a)
    phi = vg_cf(u, p, T, spot)
    weights = np.ones(n_terms)
    weights[0] = 0.5
    x_shift = np.exp(-1j * u * a)

    prices = np.empty(strikes.shape, np.float64)
    for i, K in enumerate(strikes):
        lnK = np.log(K)
        c_lo, c_hi = a, min(lnK, b)
        if c_hi <= c_lo:
            put = 0.0
        else:
            chi, psi = _chi_psi(a, b, c_lo, c_hi, k)
            v_k = 2.0 / (b - a) * (K * psi - chi)
            put = np.exp(-r * T) * np.sum(
                weights * np.real(phi * x_shift) * v_k)
        prices[i] = (put + spot * np.exp(-q * T) - K * np.exp(-r * T)
                     if is_call else put)
    return np.maximum(prices, 0.0)


@partial(jax.jit, static_argnames=("num_paths", "antithetic"))
def vg_terminal(p: VGParams, spot, T, key, *, num_paths: int,
                antithetic: bool = True) -> Array:
    """(branches, paths) EXACT terminal spots — one gamma + one normal.

    Antithetic negates Z on the shared gamma clock (the clock itself has
    no useful antithetic pairing; sharing it keeps the pair's business
    time identical, which is what makes the variance reduction work).
    """
    dtype = jnp.float32
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    k_g, k_z = jax.random.split(key)
    shape = T / p.nu
    g = p.nu * jax.random.gamma(k_g, shape, (num_paths,), dtype)
    z = jax.random.normal(k_z, (num_paths,), dtype)
    n_branch = 2 if antithetic else 1
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None]
    growth = ((p.r - p.q + p.omega) * T + p.theta * g[None, :]
              + p.sigma * jnp.sqrt(g)[None, :] * (sign * z[None, :]))
    return spot * jnp.exp(growth)


@partial(jax.jit, static_argnames=("num_paths", "is_call", "antithetic"))
def vg_price_mc(p: VGParams, spot, strikes, T, key, *, num_paths: int,
                is_call: bool, antithetic: bool = True
                ) -> Tuple[Array, Array]:
    """(prices, std_errors) per strike from the exact terminal sampler."""
    strikes = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))
    s = vg_terminal(p, spot, T, key, num_paths=num_paths,
                    antithetic=antithetic)
    phi = 1.0 if is_call else -1.0
    pay = jnp.maximum(phi * (s[..., None] - strikes[None, None, :]), 0.0)
    comb = jnp.mean(pay, axis=0)
    disc = jnp.exp(-jnp.asarray(p.r, jnp.float32) * jnp.asarray(T,
                                                                jnp.float32))
    mean = disc * jnp.mean(comb, axis=0)
    se = disc * jnp.std(comb, axis=0) / jnp.sqrt(jnp.float32(comb.shape[0]))
    return mean, se


@partial(jax.jit, static_argnames=("num_paths", "is_call", "antithetic"))
def nig_price_mc(p: "NIGParams", spot, strikes, T, key, *, num_paths: int,
                 is_call: bool, antithetic: bool = True
                 ) -> Tuple[Array, Array]:
    """(prices, std_errors) per strike from the exact NIG terminal
    sampler — the vg_price_mc estimator verbatim on the IG clock."""
    strikes = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))
    s = nig_terminal(p, spot, T, key, num_paths=num_paths,
                     antithetic=antithetic)
    phi = 1.0 if is_call else -1.0
    pay = jnp.maximum(phi * (s[..., None] - strikes[None, None, :]), 0.0)
    comb = jnp.mean(pay, axis=0)
    disc = jnp.exp(-jnp.asarray(p.r, jnp.float32) * jnp.asarray(T,
                                                                jnp.float32))
    mean = disc * jnp.mean(comb, axis=0)
    se = disc * jnp.std(comb, axis=0) / jnp.sqrt(jnp.float32(comb.shape[0]))
    return mean, se


def levy_price_mc(p, spot, strikes, T, key, *, num_paths: int,
                  is_call: bool = True, mesh=None) -> Tuple[Array, Array]:
    """Model-dispatched Lévy MC pricing (VGParams | NIGParams).

    mesh=None honors MCOS_AUTO_MESH=1; "auto"/Mesh routes through the
    psum-pooled driver (parallel/families.py:sharded_levy_price), which
    reproduces the single-device estimator on the pooled union sample.
    """
    from mcos_tpu.engine.pricer import resolve_mesh

    mesh = resolve_mesh(mesh)
    if mesh is not None:
        from mcos_tpu.parallel.families import sharded_levy_price

        res = sharded_levy_price(p, spot, strikes, T, key, mesh=mesh,
                                 num_paths=num_paths, is_call=is_call)
        return res["price"], res["std_error"]
    fn = vg_price_mc if isinstance(p, VGParams) else nig_price_mc
    return fn(p, spot, strikes, T, key, num_paths=num_paths,
              is_call=is_call)


def calibrate_vg(spot: float, strikes, T: float, market_prices,
                 r: float = None, q: float = None, is_call: bool = True,
                 n_starts: int = 4, seed: int = 0) -> dict:
    """Fit (sigma, nu, theta) to a single-maturity price smile.

    The COS objective is host f64 and ~microseconds per evaluation, so a
    multi-start trust-region least squares (scipy) is the right tool —
    no MC noise, no device round-trips inside the optimizer. Round-trip
    recovery of generating parameters is test-pinned.
    """
    from scipy.optimize import least_squares

    r = RISK_FREE_RATE if r is None else float(r)
    q = DIVIDEND_YIELD if q is None else float(q)
    strikes = np.asarray(strikes, np.float64)
    market = np.asarray(market_prices, np.float64)
    lo = np.array([0.02, 0.01, -1.5])
    hi = np.array([2.00, 2.00, 0.5])

    def resid(x):
        sigma, nu, theta = x
        # Keep the omega log argument positive (hard model constraint).
        if 1.0 - theta * nu - 0.5 * sigma**2 * nu <= 1e-6:
            return np.full(market.shape, 1e3)
        p = VGParams(sigma=sigma, nu=nu, theta=theta, r=r, q=q)
        return vg_cos_price(p, spot, strikes, T, is_call) - market

    rng = np.random.default_rng(seed)
    best = None
    starts = [np.array([0.2, 0.2, -0.1])] + [
        lo + rng.random(3) * (hi - lo) for _ in range(n_starts - 1)]
    for x0 in starts:
        if 1.0 - x0[2] * x0[1] - 0.5 * x0[0]**2 * x0[1] <= 1e-3:
            continue
        try:
            res = least_squares(resid, x0, bounds=(lo, hi), xtol=1e-12)
        except Exception:  # noqa: BLE001 — a bad start must not kill the fit
            continue
        if best is None or res.cost < best.cost:
            best = res
    if best is None:
        raise RuntimeError("VG calibration failed from every start")
    sigma, nu, theta = (float(v) for v in best.x)
    rmse = float(np.sqrt(2.0 * best.cost / max(market.size, 1)))
    return {
        "params": VGParams(sigma=sigma, nu=nu, theta=theta, r=r, q=q),
        "sigma": sigma, "nu": nu, "theta": theta,
        "rmse_price": rmse, "n_quotes": int(market.size),
    }


# ─────────────────────────────────────────────────────────────────────────────
# Normal Inverse Gaussian: BM on an inverse-Gaussian clock
# ─────────────────────────────────────────────────────────────────────────────
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NIGParams:
    """NIG in the time-change parametrization: X_T = theta*I + sigma*
    sqrt(I)*Z with I ~ InverseGaussian(mean=T, Var=nu*T) — the same
    (sigma, nu, theta) reading as VGParams but with semi-heavy
    (exponential-ish) tails instead of VG's heavier ones."""

    sigma: float = 0.2
    nu: float = 0.2
    theta: float = -0.14
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD

    @property
    def omega(self):
        """Martingale compensator from the IG Laplace transform:
        E[e^{(theta + sigma^2/2) I}] = exp(T/nu (1 - sqrt(1 - 2 nu s)))."""
        s = self.theta + 0.5 * self.sigma**2
        return (jnp.sqrt(1.0 - 2.0 * self.nu * s) - 1.0) / self.nu


def nig_cf(u: np.ndarray, p: "NIGParams", T: float,
           spot: float) -> np.ndarray:
    """Characteristic function E[e^{iu ln S_T}] (host complex128)."""
    sigma, nu, theta = float(p.sigma), float(p.nu), float(p.theta)
    r, q = float(p.r), float(p.q)
    omega = (np.sqrt(1.0 - 2.0 * nu * (theta + 0.5 * sigma**2))
             - 1.0) / nu
    u = np.asarray(u, np.complex128)
    iu = 1j * u
    drift = iu * (np.log(spot) + (r - q + omega) * T)
    s = 0.5 * sigma**2 * u**2 - 1j * theta * u
    return np.exp(drift + (T / nu) * (1.0 - np.sqrt(1.0 + 2.0 * nu * s)))


def nig_cos_price(p: "NIGParams", spot: float, strikes, T: float,
                  is_call: bool = True, n_terms: int = 512,
                  L: float = 14.0) -> np.ndarray:
    """Semi-analytic NIG prices (COS; the exact-sampler's oracle)."""
    sigma, nu, theta = float(p.sigma), float(p.nu), float(p.theta)
    r, q = float(p.r), float(p.q)
    omega = (np.sqrt(1.0 - 2.0 * nu * (theta + 0.5 * sigma**2))
             - 1.0) / nu
    strikes = np.atleast_1d(np.asarray(strikes, np.float64))
    c1 = np.log(spot) + (r - q + omega) * T + theta * T
    c2 = (sigma**2 + nu * theta**2) * T
    c4 = 3.0 * (sigma**4 * nu + 2.0 * theta**4 * nu**3
                + 4.0 * sigma**2 * theta**2 * nu**2) * T
    half = L * np.sqrt(c2 + np.sqrt(max(c4, 0.0)))
    a, b = c1 - half, c1 + half
    k = np.arange(n_terms)
    u = k * np.pi / (b - a)
    phi = nig_cf(u, p, T, spot)
    weights = np.ones(n_terms)
    weights[0] = 0.5
    x_shift = np.exp(-1j * u * a)
    prices = np.empty(strikes.shape, np.float64)
    for i, K in enumerate(strikes):
        c_lo, c_hi = a, min(np.log(K), b)
        if c_hi <= c_lo:
            put = 0.0
        else:
            chi, psi = _chi_psi(a, b, c_lo, c_hi, k)
            v_k = 2.0 / (b - a) * (K * psi - chi)
            put = np.exp(-r * T) * np.sum(
                weights * np.real(phi * x_shift) * v_k)
        prices[i] = (put + spot * np.exp(-q * T) - K * np.exp(-r * T)
                     if is_call else put)
    return np.maximum(prices, 0.0)


def _sample_inverse_gaussian(key, mu, lam, shape, dtype=jnp.float32):
    """Michael-Schucany-Haas IG(mean=mu, shape=lam) sampler — branchless
    (one normal + one uniform + a select), so it vectorizes on the VPU."""
    k_n, k_u = jax.random.split(key)
    z = jax.random.normal(k_n, shape, dtype)
    u = jax.random.uniform(k_u, shape, dtype)
    y = z * z
    x = (mu + 0.5 * mu * mu * y / lam
         - 0.5 * mu / lam * jnp.sqrt(4.0 * mu * lam * y
                                     + (mu * y) ** 2))
    x = jnp.maximum(x, 1e-12)
    return jnp.where(u <= mu / (mu + x), x, mu * mu / x)


@partial(jax.jit, static_argnames=("num_paths", "antithetic"))
def nig_terminal(p: "NIGParams", spot, T, key, *, num_paths: int,
                 antithetic: bool = True) -> Array:
    """(branches, paths) EXACT terminal spots — one IG draw + one normal
    (antithetic negates Z on the shared clock, as in VG)."""
    dtype = jnp.float32
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    k_i, k_z = jax.random.split(key)
    # I ~ IG(mean=T, Var=nu*T): Var = mu^3/lam ⇒ lam = T^2/nu... with
    # mu = T: Var = T^3/lam = nu T ⇒ lam = T^2/nu.
    ig = _sample_inverse_gaussian(k_i, T, T * T / p.nu, (num_paths,),
                                  dtype)
    z = jax.random.normal(k_z, (num_paths,), dtype)
    n_branch = 2 if antithetic else 1
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None]
    growth = ((p.r - p.q + p.omega) * T + p.theta * ig[None, :]
              + p.sigma * jnp.sqrt(ig)[None, :] * (sign * z[None, :]))
    return spot * jnp.exp(growth)


def calibrate_nig(spot: float, strikes, T: float, market_prices,
                  r: float = None, q: float = None, is_call: bool = True,
                  n_starts: int = 4, seed: int = 0) -> dict:
    """Fit NIG (sigma, nu, theta) to a single-maturity price smile —
    same multi-start trust-region recipe as `calibrate_vg` (the COS
    objective is host f64 microseconds). Round-trip recovery pinned."""
    from scipy.optimize import least_squares

    r = RISK_FREE_RATE if r is None else float(r)
    q = DIVIDEND_YIELD if q is None else float(q)
    strikes = np.asarray(strikes, np.float64)
    market = np.asarray(market_prices, np.float64)
    lo = np.array([0.02, 0.01, -1.5])
    hi = np.array([2.00, 2.00, 0.5])

    def resid(x):
        sigma, nu, theta = x
        # The IG Laplace sqrt argument must stay positive.
        if 1.0 - 2.0 * nu * (theta + 0.5 * sigma**2) <= 1e-6:
            return np.full(market.shape, 1e3)
        p = NIGParams(sigma=sigma, nu=nu, theta=theta, r=r, q=q)
        return nig_cos_price(p, spot, strikes, T, is_call) - market

    rng = np.random.default_rng(seed)
    best = None
    starts = [np.array([0.2, 0.2, -0.1])] + [
        lo + rng.random(3) * (hi - lo) for _ in range(n_starts - 1)]
    for x0 in starts:
        if 1.0 - 2.0 * x0[1] * (x0[2] + 0.5 * x0[0]**2) <= 1e-3:
            continue
        try:
            res = least_squares(resid, x0, bounds=(lo, hi), xtol=1e-12)
        except Exception:  # noqa: BLE001
            continue
        if best is None or res.cost < best.cost:
            best = res
    if best is None:
        raise RuntimeError("NIG calibration failed from every start")
    sigma, nu, theta = (float(v) for v in best.x)
    return {
        "params": NIGParams(sigma=sigma, nu=nu, theta=theta, r=r, q=q),
        "sigma": sigma, "nu": nu, "theta": theta,
        "rmse_price": float(np.sqrt(2.0 * best.cost
                                    / max(market.size, 1))),
        "n_quotes": int(market.size),
    }
