r"""Rough Bergomi (rBergomi) simulation — exact-covariance, matmul-only.

Capability beyond the reference (which stops at Markovian SVJ,
/root/reference/engine/monte_carlo.py:189-243): the rough-volatility model
of Bayer-Friz-Gatheral (2016),

    v_t = xi(t) * exp(eta * W~_t - eta^2/2 * t^{2H}),
    dS/S = (r - q) dt + sqrt(v_t) (rho dW_t + sqrt(1-rho^2) dW'_t),

where W~ is a Riemann-Liouville fractional Brownian motion
W~_t = sqrt(2H) \int_0^t (t-u)^{H-1/2} dW_u with Hurst H in (0, 1/2].
Small H produces the steep short-dated skew and the t^{H-1/2} ATM-skew
explosion that Markovian models cannot match.

Device-first design — NO sequential step loop at all:

  * W~ is non-Markovian, so instead of a scan we sample the *exact* joint
    Gaussian of (W~ at the grid times, the dW increments): the covariance
    has a closed form (Gauss hypergeometric, computed on host in f64), its
    Cholesky factor L is a static (2n, 2n) input, and sampling is ONE MXU
    matmul  Z @ L^T  over the whole path batch. The usual CPU designs
    (per-step hybrid-scheme convolution) are replaced by dense linear
    algebra at tensor-core speed — this is the idiomatic mapping, and it is
    *exact* in the law of (W~, W) (no Volterra discretization bias; the
    only bias left is the Riemann price integral).
  * The price leg never simulates S: the Romano-Touzi conditional
    ("mixed") estimator integrates the orthogonal noise W' out in closed
    form — conditional on the W path, S_T is lognormal, so each path
    contributes a Black formula on

        F_eff = S0 e^{(r-q)T} exp(rho*I1 - rho^2/2 * I2),
        s^2   = (1 - rho^2) * I2,
        I1 = sum_i sqrt(v_i) dW_i,   I2 = sum_i v_i dt.

    This removes the orthogonal-noise variance entirely (at rho = 0 that
    is all of the spot noise), needs half the random numbers, and —
    because the Black formula is smooth — makes *pathwise AD deliver
    smooth delta and even gamma* where kinked-payoff MC cannot.

All device work is f32; the covariance and its Cholesky are prepared once
per (H, T, n) on host in f64 (an n<=512 Cholesky is microseconds).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import hyp2f1

from mcos_tpu.config import DIVIDEND_YIELD, RISK_FREE_RATE

Array = jax.Array


# ─────────────────────────────────────────────────────────────────────────────
# Parameters
# ─────────────────────────────────────────────────────────────────────────────
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RoughBergomiParams:
    """rBergomi parameters. `hurst` is static (it shapes the host-side
    covariance); the rest are traced leaves, so eta/rho/xi sensitivities
    come out of the same `jax.grad` pass as delta."""

    xi: float = 0.04        # flat forward-variance level xi(t) = xi
    eta: float = 1.9        # vol-of-vol of the Wick exponential
    rho: float = -0.9       # spot/vol correlation
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD
    hurst: float = dataclasses.field(default=0.07,
                                     metadata={"static": True})


# ─────────────────────────────────────────────────────────────────────────────
# Exact joint covariance of (W~ grid values, dW increments) — host, f64
# ─────────────────────────────────────────────────────────────────────────────
def volterra_cov(s: np.ndarray, t: np.ndarray, hurst: float) -> np.ndarray:
    """E[W~_s W~_t] for the Riemann-Liouville fBM, elementwise.

    For s <= t:  C = 2H/(H+1/2) * s^{H+1/2} t^{H-1/2}
                     * 2F1(1, 1/2-H; H+3/2; s/t),
    which reduces to min(s,t) at H = 1/2 and to s^{2H} on the diagonal.
    The hypergeometric argument s/t lies in [0, 1] — well-conditioned
    everywhere (tests pin this form against brute-force quadrature).
    """
    s = np.asarray(s, np.float64)
    t = np.asarray(t, np.float64)
    lo, hi = np.minimum(s, t), np.maximum(s, t)
    ratio = np.where(hi > 0.0, lo / np.where(hi > 0.0, hi, 1.0), 0.0)
    h = float(hurst)
    pref = 2.0 * h / (h + 0.5) * lo ** (h + 0.5) * hi ** (h - 0.5)
    return pref * hyp2f1(1.0, 0.5 - h, h + 1.5, ratio)


def volterra_increment_cov(t_grid: np.ndarray, hurst: float,
                           dt: float) -> np.ndarray:
    """E[W~_{t_i} dW_j] for grid-aligned increments dW_j over
    (t_{j-1}, t_j]:  sqrt(2H)/(H+1/2) * [(t_i-t_{j-1})^{H+1/2}
    - (t_i-t_j)^{H+1/2}]  for j <= i, zero for j > i."""
    h = float(hurst)
    n = len(t_grid)
    ti = np.asarray(t_grid, np.float64)[:, None]          # (n, 1)
    tj = np.asarray(t_grid, np.float64)[None, :]          # (1, n) right ends
    tjm1 = tj - dt
    a = np.maximum(ti - tjm1, 0.0) ** (h + 0.5)
    b = np.maximum(ti - tj, 0.0) ** (h + 0.5)
    out = np.sqrt(2.0 * h) / (h + 0.5) * (a - b)
    out[np.broadcast_to(tj, (n, n)) > ti + 1e-14] = 0.0
    return out


@lru_cache(maxsize=32)
def _factor_cached(hurst: float, T: float, num_steps: int,
                   transform: str, rank: int = 0) -> np.ndarray:
    """Factor A (f32, A Aᵀ ≈ cov) of the joint (2n, 2n) covariance of
    [W~_{t_1..t_n}, dW_{1..n}] on the uniform grid t_i = i*T/n.

    transform="cholesky": triangular factor (any sampling order works for
    iid normals). transform="pca": U diag(sqrt(lambda)) with eigenvalues
    descending — the classic QMC construction, so the FIRST input
    dimensions carry the largest variance directions; paired with
    low-discrepancy draws this is where Sobol's low-dim uniformity pays.

    See `rbergomi_conditional_factor` for the truncated long-dated
    factorization (transform="conditional" is routed there).
    """
    n = int(num_steps)
    dt = float(T) / n
    t = dt * np.arange(1, n + 1)
    cov_w = volterra_cov(t[:, None], t[None, :], hurst)
    cross = volterra_increment_cov(t, hurst, dt)
    cov = np.empty((2 * n, 2 * n), np.float64)
    cov[:n, :n] = cov_w
    cov[:n, n:] = cross
    cov[n:, :n] = cross.T
    cov[n:, n:] = dt * np.eye(n)
    # Tiny diagonal lift: the W~ block is ill-conditioned for small H at
    # fine grids; 1e-12 relative is far below the f32 sampling noise.
    cov[np.diag_indices(2 * n)] += 1e-12 * cov.diagonal().max()
    if transform == "pca":
        lam, u = np.linalg.eigh(cov)          # ascending
        lam = np.maximum(lam[::-1], 0.0)
        return (u[:, ::-1] * np.sqrt(lam)[None, :]).astype(np.float32)
    if rank:
        raise ValueError(
            "rank truncation: use rbergomi_conditional_factor (or "
            "rbergomi_chol(transform='conditional', rank=k))")
    return np.linalg.cholesky(cov).astype(np.float32)


@lru_cache(maxsize=32)
def _conditional_factor_cached(hurst: float, T: float, num_steps: int,
                               rank: int):
    """(factor (2n, n+k), diag_tail (n,)) — the long-dated escape hatch
    past the exact sampler's O((2n)²) matmul.

    Naive joint-covariance PCA fails twice here: the W~ block carries
    ~400× the dW block's total variance, so global PCA discards the
    *white-noise increments* first (flat dt-spectrum, incompressible);
    and the W~|dW regression residual — the intra-step mass of the
    singular (t−u)^{H−1/2} kernel — is ~30% of Var[W~] at H=0.07 and
    NEARLY DIAGONAL, so low-rank PCA cannot represent it either. The
    structured factorization samples all three parts at their natural
    cost:

        dW  = √dt · z                     exact     (n iid columns)
        W~  = (cross/dt)·dW               exact     (dense n×n block)
            + B_k · ε                     rank-k PCA of the residual's
                                          smooth off-diagonal part
            + √diag_tail ⊙ ζ              exact diagonal tail, O(n) —
                                          handled by rbergomi_core's
                                          diag_tail argument, NOT a dense
                                          column block

    dW marginals, the W~/dW cross-covariance, AND every Var[W~_t] are
    exact; only rank-truncated off-diagonal residual correlations are
    approximate. Device cost drops from O(paths·4n²) to
    O(paths·(2n·(n+k) + n)) ≈ 2× at k ≪ n, and the Wick compensator
    reads delivered variance off the factor (+tail) so E[v_t] = ξ(t)
    holds exactly under any (k) (benchmarks config10 publishes the
    ladder; accuracy pinned in tests/test_rough.py).
    """
    n = int(num_steps)
    k = int(rank)
    dt = float(T) / n
    t = dt * np.arange(1, n + 1)
    cov_w = volterra_cov(t[:, None], t[None, :], hurst)
    cross = volterra_increment_cov(t, hurst, dt)
    a = cross / dt                         # regression W~ on dW
    res = cov_w - cross @ cross.T / dt     # conditional covariance W~|dW
    res[np.diag_indices(n)] += 1e-12 * max(res.diagonal().max(), 1e-30)
    lam, u = np.linalg.eigh(res)           # ascending
    lam = np.maximum(lam[::-1][:k], 0.0)
    b = u[:, ::-1][:, :k] * np.sqrt(lam)[None, :]
    diag_tail = np.maximum(res.diagonal() - np.sum(b * b, axis=1), 0.0)
    fac = np.zeros((2 * n, n + k))
    fac[:n, :n] = a * np.sqrt(dt)
    fac[n:, :n] = np.sqrt(dt) * np.eye(n)
    fac[:n, n:] = b
    return fac.astype(np.float32), diag_tail.astype(np.float32)


def rbergomi_conditional_factor(hurst: float, T: float, num_steps: int,
                                rank: int = 32):
    """Public cached accessor for the truncated factorization:
    (factor, diag_tail) — pass BOTH to rbergomi_core /
    rbergomi_conditional_payoffs."""
    if rank <= 0:
        raise ValueError("conditional factorization needs rank > 0")
    return _conditional_factor_cached(
        round(float(hurst), 10), round(float(T), 10), int(num_steps),
        int(rank))


def rbergomi_chol(hurst: float, T: float, num_steps: int,
                  transform: str = "cholesky",
                  rank: int = 0) -> np.ndarray:
    """Public cached accessor (host). Keyed on rounded floats so jitter in
    float(T) does not defeat the cache. transform="conditional" returns
    only the dense factor — prefer `rbergomi_conditional_factor`, which
    also returns the diagonal tail the sampler needs for exact Var[W~]."""
    if transform == "conditional":
        if not rank:
            raise ValueError("transform='conditional' needs rank > 0")
        return rbergomi_conditional_factor(hurst, T, num_steps, rank)[0]
    return _factor_cached(round(float(hurst), 10), round(float(T), 10),
                          int(num_steps), transform, int(rank))


def xi_curve_from_variance_swaps(maturities, var_strikes):
    """Bootstrap the piecewise-constant forward-variance curve from
    variance-swap quotes: K_var(T)^2 T = \\int_0^T xi(u) du, so between
    quote maturities  xi_i = (W_{i+1} - W_i) / (T_{i+1} - T_i)  with
    W_i = K_i^2 T_i. Returns (edges (m+1,), values (m,)) with edges[0]=0.
    The curve is exact-by-construction: repricing every quoted variance
    swap from the curve returns the input strikes (test-pinned).
    """
    mats = np.asarray(maturities, np.float64)
    ks = np.asarray(var_strikes, np.float64)
    if np.any(np.diff(mats) <= 0):
        raise ValueError("maturities must be strictly increasing")
    w = ks**2 * mats
    w = np.concatenate([[0.0], w])
    edges = np.concatenate([[0.0], mats])
    vals = np.diff(w) / np.diff(edges)
    if np.any(vals <= 0):
        raise ValueError("variance-swap quotes imply a negative forward "
                         "variance (calendar arbitrage)")
    return edges, vals


def sample_xi_curve(edges, vals, T: float, num_steps: int) -> np.ndarray:
    """(num_steps,) forward variance at the left grid endpoints of [0, T];
    flat extrapolation beyond the last quote."""
    t_left = float(T) / num_steps * np.arange(num_steps)
    idx = np.clip(np.searchsorted(edges, t_left, side="right") - 1, 0,
                  len(vals) - 1)
    return np.asarray(vals)[idx].astype(np.float32)


# ─────────────────────────────────────────────────────────────────────────────
# Device simulation — one matmul + elementwise
# ─────────────────────────────────────────────────────────────────────────────

def _wick_var_left(chol, n: int, dtype=jnp.float32, diag_tail=None):
    """Left-point Var[W~_t] read off the factor ITSELF: row i of the W~
    block has variance Σ_k A[i,k]² (+ the diagonal tail when the
    conditional factorization supplies one). For the exact factor this
    equals t_i^{2H}; for a truncated factor it is the variance the
    sampler actually delivers — using it in the Wick compensator keeps
    E[v_t] = ξ(t) EXACTLY under any truncation (a martingale correction;
    without it the lost tail variance biases prices down ~η²·Δvar/2).
    """
    row_var = jnp.sum(chol[:n].astype(dtype) ** 2, axis=1)
    if diag_tail is not None:
        row_var = row_var + jnp.asarray(diag_tail, dtype)
    return jnp.concatenate([jnp.zeros((1,), dtype), row_var[:-1]])


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "antithetic"))
def rbergomi_core(params: RoughBergomiParams, T, chol, key, *,
                  num_paths: int, num_steps: int,
                  antithetic: bool = True,
                  z: Optional[Array] = None,
                  xi_t: Optional[Array] = None,
                  diag_tail: Optional[Array] = None
                  ) -> Tuple[Array, Array, Array]:
    """Simulate the W-conditional sufficient statistics of rBergomi.

    Returns (v_mean_t, I1, I2):
      v_grid : (n,) grid-mean of v (diagnostic / E[v]=xi tests),
      I1     : (branches, paths) = sum_i sqrt(v_{i-1}) dW_i,
      I2     : (branches, paths) = sum_i v_{i-1} dt,
    with antithetic branches on axis 0 (Z and -Z share one draw set).

    `z` optionally supplies the (num_paths, 2n) standard normals — e.g.
    Owen-scrambled Sobol points through the PCA factor (QMC driving);
    None draws PRNG normals from `key`.

    `xi_t` optionally supplies the forward-variance curve sampled at the
    left grid endpoints, (n,) — the curve the Wick exponential rides
    (E[v_{t_i}] = xi_t[i] exactly); None uses the flat params.xi.
    """
    dtype = jnp.float32
    n = num_steps
    T = jnp.asarray(T, dtype)
    dt = T / n
    wick_var = _wick_var_left(chol, n, dtype, diag_tail)

    if z is None:
        # chol may be a truncated factor (2n, m<2n): draw m normals.
        z = jax.random.normal(key, (num_paths, chol.shape[1]), dtype)
    zd = None
    if diag_tail is not None:
        # Diagonal residual tail (conditional factorization): n extra iid
        # normals per path at O(n) cost — see rbergomi_conditional_factor.
        zd = jax.random.normal(jax.random.fold_in(key, 77),
                               (num_paths, n), dtype)
        sqrt_tail = jnp.sqrt(jnp.asarray(diag_tail, dtype))
    branches = (1.0, -1.0) if antithetic else (1.0,)

    xi_vec = (params.xi * jnp.ones((n,), dtype) if xi_t is None
              else jnp.asarray(xi_t, dtype))
    i1s, i2s, v_means = [], [], []
    for sign in branches:
        g = (sign * z) @ chol.T                           # MXU: (paths, 2n)
        w_tilde = g[:, :n]
        dw = g[:, n:]
        if zd is not None:
            w_tilde = w_tilde + (sign * zd) * sqrt_tail[None, :]
        # Left-point W~: W~_{t_0}=0, then the first n-1 grid values.
        w_left = jnp.concatenate(
            [jnp.zeros((num_paths, 1), dtype), w_tilde[:, :-1]], axis=1)
        v = xi_vec[None, :] * jnp.exp(
            params.eta * w_left
            - 0.5 * params.eta ** 2 * wick_var[None, :])
        i1s.append(jnp.sum(jnp.sqrt(v) * dw, axis=1))
        i2s.append(jnp.sum(v, axis=1) * dt)
        v_means.append(jnp.mean(v, axis=0))
    return (jnp.mean(jnp.stack(v_means), axis=0),
            jnp.stack(i1s), jnp.stack(i2s))


def _black_on_forward(F, K, s, is_call):
    """Undiscounted Black price with total volatility s = sigma*sqrt(T),
    smooth in all inputs (the s -> 0 limit is handled by a floor that is
    far below any realistic conditional vol)."""
    s = jnp.maximum(s, 1e-6)
    d1 = jnp.log(F / K) / s + 0.5 * s
    d2 = d1 - s
    phi = jax.scipy.stats.norm.cdf
    call = F * phi(d1) - K * phi(d2)
    return jnp.where(is_call, call, call - (F - K))       # Black parity


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "antithetic"))
def rbergomi_conditional_payoffs(params: RoughBergomiParams, spot, strikes,
                                 T, chol, key, *, num_paths: int,
                                 num_steps: int, is_call,
                                 antithetic: bool = True,
                                 z: Optional[Array] = None,
                                 xi_t: Optional[Array] = None,
                                 diag_tail: Optional[Array] = None) -> Array:
    """(branches, paths, strikes) per-path *conditional Black* payoffs
    (undiscounted). Averaging over paths and discounting gives the price;
    the estimator is exact in the orthogonal noise, so its variance is
    (1-rho^2)-suppressed and every payoff is smooth for AD. `z` and
    `xi_t` as in `rbergomi_core` (QMC driving / forward-variance curve).
    """
    dtype = jnp.float32
    spot = jnp.asarray(spot, dtype)
    strikes = jnp.atleast_1d(jnp.asarray(strikes, dtype))
    T = jnp.asarray(T, dtype)
    _, i1, i2 = rbergomi_core(params, T, chol, key, num_paths=num_paths,
                              num_steps=num_steps, antithetic=antithetic,
                              z=z, xi_t=xi_t, diag_tail=diag_tail)
    return _conditional_black(params, spot, strikes, T, i1, i2, is_call)


def _conditional_black(params: RoughBergomiParams, spot, strikes, T,
                       i1, i2, is_call) -> Array:
    """Romano-Touzi payoff assembly shared by the exact-covariance and
    lifted samplers (one algebra, never forked): per-path Black on
    F_eff = S0 e^{(r-q)T + rho I1 - rho^2/2 I2}, s^2 = (1-rho^2) I2."""
    f_eff = spot * jnp.exp((params.r - params.q) * T
                           + params.rho * i1
                           - 0.5 * params.rho ** 2 * i2)  # (branches, paths)
    s_eff = jnp.sqrt(jnp.maximum((1.0 - params.rho ** 2) * i2, 0.0))
    return _black_on_forward(f_eff[..., None], strikes[None, None, :],
                             s_eff[..., None], is_call)


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "antithetic",
                                   "remat_chunk"))
def rbergomi_lifted_payoffs(params: RoughBergomiParams, spot, strikes,
                            T, key, c, d, g, tail, *, num_paths: int,
                            num_steps: int, is_call,
                            antithetic: bool = True,
                            xi_t: Optional[Array] = None,
                            remat_chunk: int = 0) -> Array:
    """`rbergomi_conditional_payoffs` through the Markovian-lift sampler
    (`rbergomi_core_lifted`): same (branches, paths, strikes) conditional
    Black payoffs, same smooth-AD property, O(n·m) instead of O(n²)."""
    dtype = jnp.float32
    spot = jnp.asarray(spot, dtype)
    strikes = jnp.atleast_1d(jnp.asarray(strikes, dtype))
    T = jnp.asarray(T, dtype)
    _, i1, i2 = rbergomi_core_lifted(
        params, T, key, c, d, g, tail, num_paths=num_paths,
        num_steps=num_steps, antithetic=antithetic, xi_t=xi_t,
        remat_chunk=remat_chunk)
    return _conditional_black(params, spot, strikes, T, i1, i2, is_call)


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "antithetic"))
def rbergomi_terminal(params: RoughBergomiParams, spot, T, chol, key, *,
                      num_paths: int, num_steps: int,
                      antithetic: bool = True) -> Array:
    """(branches, paths) terminal spots S_T via the *plain* estimator
    (explicit orthogonal noise). Used to validate the conditional
    estimator and for payoffs that need the full terminal law."""
    dtype = jnp.float32
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    k_w, k_perp = jax.random.split(key)
    _, i1, i2 = rbergomi_core(params, T, chol, k_w, num_paths=num_paths,
                              num_steps=num_steps, antithetic=antithetic)
    # Orthogonal leg: conditional on v, int sqrt(v) dW' ~ N(0, I2) exactly —
    # one normal per path per branch (antithetic in the orthogonal draw too).
    zp = jax.random.normal(k_perp, (num_paths,), dtype)
    zp = jnp.stack([zp, -zp])[: i1.shape[0]]
    growth = ((params.r - params.q) * T - 0.5 * i2 + params.rho * i1
              + jnp.sqrt(jnp.maximum((1.0 - params.rho ** 2) * i2, 0.0)) * zp)
    return spot * jnp.exp(growth)


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "antithetic"))
def rbergomi_log_paths(params: RoughBergomiParams, T, chol, key, *,
                       num_paths: int, num_steps: int,
                       antithetic: bool = True,
                       xi_t: Optional[Array] = None) -> Array:
    """(branches, paths, n) log(S_t/S_0) sheet on the grid t_1..t_n.

    The full-path variant of the exact-covariance sampler (one cumsum
    over the step axis); feeds consumers that need day-by-day spots —
    e.g. the delta-hedging backtest under rough dynamics. `xi_t` as in
    `rbergomi_core` (forward-variance curve at left endpoints)."""
    dtype = jnp.float32
    T = jnp.asarray(T, dtype)
    n = num_steps
    dt = T / n
    wick_var = _wick_var_left(chol, n, dtype)
    k_w, k_perp = jax.random.split(key)
    z = jax.random.normal(k_w, (num_paths, chol.shape[1]), dtype)
    zp = jax.random.normal(k_perp, (num_paths, n), dtype)
    branches = (1.0, -1.0) if antithetic else (1.0,)
    rho = params.rho
    orth = jnp.sqrt(jnp.maximum(1.0 - rho ** 2, 0.0))
    xi_vec = (params.xi * jnp.ones((n,), dtype) if xi_t is None
              else jnp.asarray(xi_t, dtype))
    outs = []
    for sign in branches:
        g = (sign * z) @ chol.T
        w_tilde, dw = g[:, :n], g[:, n:]
        w_left = jnp.concatenate(
            [jnp.zeros((num_paths, 1), dtype), w_tilde[:, :-1]], axis=1)
        v = xi_vec[None, :] * jnp.exp(
            params.eta * w_left
            - 0.5 * params.eta ** 2 * wick_var[None, :])
        dz = rho * dw + orth * (sign * zp) * jnp.sqrt(dt)
        dlog = (params.r - params.q - 0.5 * v) * dt + jnp.sqrt(v) * dz
        outs.append(jnp.cumsum(dlog, axis=1))
    return jnp.stack(outs)


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "antithetic"))
def rbergomi_path_stats(params: RoughBergomiParams, spot, T, chol, key, *,
                        num_paths: int, num_steps: int,
                        antithetic: bool = True) -> dict:
    """Path statistics for path-dependent payoffs under rough volatility.

    The exact-covariance sampler already yields the whole (W~, dW) path
    law, so the full spot sheet is one cumsum over the step axis — still
    no sequential scan. The orthogonal leg needs explicit per-step W'
    increments here (the path, not just S_T, depends on them). Returns
    per-branch (branches, paths) arrays: terminal, arithmetic mean, max,
    min of S over the observation grid t_1..t_n — t_0 excluded, matching
    ops/exotics.py's trackers (tests pin the engines to each other in the
    degenerate GBM limit on matched grids).
    """
    dtype = jnp.float32
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    n = num_steps
    dt = T / n
    wick_var = _wick_var_left(chol, n, dtype)
    k_w, k_perp = jax.random.split(key)
    z = jax.random.normal(k_w, (num_paths, chol.shape[1]), dtype)
    zp = jax.random.normal(k_perp, (num_paths, n), dtype)
    branches = (1.0, -1.0) if antithetic else (1.0,)

    outs = {"s_terminal": [], "s_mean": [], "s_max": [], "s_min": []}
    rho = params.rho
    orth = jnp.sqrt(jnp.maximum(1.0 - rho ** 2, 0.0))
    for sign in branches:
        g = (sign * z) @ chol.T
        w_tilde, dw = g[:, :n], g[:, n:]
        w_left = jnp.concatenate(
            [jnp.zeros((num_paths, 1), dtype), w_tilde[:, :-1]], axis=1)
        v = params.xi * jnp.exp(
            params.eta * w_left
            - 0.5 * params.eta ** 2 * wick_var[None, :])
        dz = rho * dw + orth * (sign * zp) * jnp.sqrt(dt)
        dlog = (params.r - params.q - 0.5 * v) * dt + jnp.sqrt(v) * dz
        log_s = jnp.cumsum(dlog, axis=1)
        s = spot * jnp.exp(log_s)                     # (paths, n)
        outs["s_terminal"].append(s[:, -1])
        outs["s_mean"].append(jnp.mean(s, axis=1))
        outs["s_max"].append(jnp.max(s, axis=1))
        outs["s_min"].append(jnp.min(s, axis=1))
    return {k2: jnp.stack(v2) for k2, v2 in outs.items()}


# ─────────────────────────────────────────────────────────────────────────────
# Markovian lift — O(n·m) scan sampler that breaks the O(n²) matmul wall
# ─────────────────────────────────────────────────────────────────────────────
@lru_cache(maxsize=32)
def _lift_cached(hurst: float, T: float, num_steps: int, n_factors: int):
    """Host-side lift tables for `rbergomi_core_lifted`.

    The Volterra kernel sqrt(2H)·τ^{H-1/2} is a Laplace mixture; reuse the
    moment-matched exponential-sum nodes built for rough Heston
    (`ops/roughheston.py:lifted_kernel_nodes`, <1% sup error on [dt, T]),
    rescaled by κ = sqrt(2H)·Γ(H+1/2) to this kernel's normalization. Then

        W~_t ≈ Σ_j c_j Y_j(t),   Y_j(t_{i+1}) = e^{-x_j dt} Y_j(t_i)
                                              + e^{-x_j dt/2} ΔW_{i+1},

    an O(n·m) scan instead of the exact sampler's O(n²)-per-path matmul
    (m = n_factors = 24 default). The midpoint loading e^{-x_j dt/2} is
    the exact stochastic-convolution weight for mid-step mass; stiff
    nodes decay correctly instead of overshooting.

    What the truncation loses is the kernel's *intra-step singular mass*
    (~30% of Var[W~] at H = 0.07 — see `rbergomi_conditional_factor`,
    which measured the same residual to be nearly diagonal). The lift
    tops it up the same way: `tail[i] = t_{i+1}^{2H} − Var[W~^lift]`,
    added as an independent per-grid-point normal, so **every marginal
    Var[W~_t] — and with it E[v_t] = ξ(t) — is exact**; only sub-dt
    autocorrelation detail is approximated (pinned against the exact
    sampler in tests/test_rough.py).

    Returns f32 (c (m,), d (m,), g (m,), tail (n,)).
    """
    import math

    from mcos_tpu.ops.roughheston import lifted_kernel_nodes

    h = float(hurst)
    n = int(num_steps)
    dt = float(T) / n
    c, x = lifted_kernel_nodes(round(h, 10), round(float(T), 10), dt,
                               int(n_factors))
    c = np.asarray(c, np.float64)
    x = np.asarray(x, np.float64)
    kappa = math.sqrt(2.0 * h) * math.gamma(h + 0.5)
    c = kappa * c
    d = np.exp(-x * dt)
    g = np.exp(-0.5 * x * dt)
    # Memoryless top-up node (d = 0): the kernel fit lives on [dt, T], so
    # the lift underweights the SAME-STEP cross-covariance E[W~_t ΔW_t] —
    # the sub-dt singular mass is ~25% of it at H = 0.07, and that cross
    # term IS the finest-scale leverage (measured: without it, OTM wings
    # under rho = -0.9 price ~8% high). One extra factor that forgets
    # everything each step carries exactly the missing mass:
    # E[W~ ΔW]_exact = sqrt(2H)/(H+1/2)·dt^{H+1/2}.
    cross_exact = math.sqrt(2.0 * h) / (h + 0.5) * dt ** (h + 0.5)
    c0 = cross_exact / dt - float(np.sum(c * g))
    if c0 > 1e-12:
        c = np.append(c, c0)
        d = np.append(d, 0.0)
        g = np.append(g, 1.0)
    # Delivered Var[W~_{t_i}] under the recursion: Cov_Y(i) = D∘Cov_Y(i-1)
    # + G with D = d dᵀ, G = dt·g gᵀ (common ΔW across factors).
    D = np.outer(d, d)
    G = np.outer(g, g) * dt
    S = np.zeros_like(D)
    var_deliv = np.empty(n)
    for i in range(n):
        S = D * S + G
        var_deliv[i] = float(c @ S @ c)
    t = dt * np.arange(1, n + 1)
    tail = np.maximum(t ** (2.0 * h) - var_deliv, 0.0)
    return (c.astype(np.float32), d.astype(np.float32),
            g.astype(np.float32), tail.astype(np.float32))


def rbergomi_lift(hurst: float, T: float, num_steps: int,
                  n_factors: int = 24):
    """Public cached accessor: (c, d, g, tail) for rbergomi_core_lifted."""
    return _lift_cached(round(float(hurst), 10), round(float(T), 10),
                        int(num_steps), int(n_factors))


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "antithetic",
                                   "remat_chunk"))
def rbergomi_core_lifted(params: RoughBergomiParams, T, key, c, d, g, tail,
                         *, num_paths: int, num_steps: int,
                         antithetic: bool = True,
                         xi_t: Optional[Array] = None,
                         remat_chunk: int = 0
                         ) -> Tuple[Array, Array, Array]:
    """`rbergomi_core` contract — (v_mean_t, I1, I2) — via the Markovian
    lift: a `lax.scan` carrying the (m, branches, paths) factor state
    instead of the (paths, 2n) covariance matmul. Wall-clock is O(n·m)
    per path, so steps = 1024+ (the exact sampler's O(n²) knee —
    benchmarks config10) runs at scan speed; PRNG-only (QMC callers keep
    the exact PCA factor, where Sobol's low-dim structure pays).

    Same left-point v convention, same ΔW drives v and I1 (the spot leg),
    same antithetic convention (Z and −Z share one draw set — the tail
    normals flip sign too, like every other draw). The Wick compensator
    uses t^{2H} exactly — legitimate because the tail top-up makes the
    delivered Var[W~_t] exact (see `_lift_cached`).

    `remat_chunk`: as in roughheston.lifted_terminal — AD callers must
    set it (backward pass otherwise stores the factor block per step).
    """
    dtype = jnp.float32
    n = num_steps
    h = float(params.hurst)
    T = jnp.asarray(T, dtype)
    dt = T / n
    sqrt_dt = jnp.sqrt(dt)
    nb = 2 if antithetic else 1
    sign = jnp.array([1.0, -1.0], dtype)[:nb, None]

    c_ = jnp.asarray(c, dtype)[:, None, None]
    d_ = jnp.asarray(d, dtype)[:, None, None]
    g_ = jnp.asarray(g, dtype)[:, None, None]
    # Left-point tables: index i holds the t_i value (t_0 = 0 row first).
    sqrt_tail_left = jnp.concatenate(
        [jnp.zeros((1,), dtype), jnp.sqrt(jnp.asarray(tail, dtype))[:-1]])
    t_left = dt * jnp.arange(n, dtype=dtype)
    wick_left = jnp.where(t_left > 0.0, t_left, 1.0) ** jnp.float32(2 * h)
    wick_left = jnp.where(t_left > 0.0, wick_left, 0.0)
    xi_vec = (params.xi * jnp.ones((n,), dtype) if xi_t is None
              else jnp.asarray(xi_t, dtype))
    eta = jnp.asarray(params.eta, dtype)

    def step(carry, i):
        y, i1, i2 = carry
        z = jax.random.normal(jax.random.fold_in(key, i),
                              (2, num_paths), dtype)
        dw = (z[0] * sign) * sqrt_dt                   # (nb, paths)
        zeta = z[1] * sign
        w_left = jnp.sum(c_ * y, axis=0) + sqrt_tail_left[i] * zeta
        v = xi_vec[i] * jnp.exp(eta * w_left
                                - 0.5 * eta * eta * wick_left[i])
        i1 = i1 + jnp.sqrt(v) * dw
        i2 = i2 + v * dt
        y = d_ * y + g_ * dw[None]
        return (y, i1, i2), jnp.mean(v)

    zeros = jnp.zeros((nb, num_paths), dtype)
    init = (jnp.zeros((c_.shape[0], nb, num_paths), dtype), zeros, zeros)
    if remat_chunk:
        if num_steps % remat_chunk:
            raise ValueError(f"num_steps={num_steps} not a multiple of "
                             f"remat_chunk={remat_chunk}")

        @partial(jax.checkpoint, prevent_cse=False)
        def chunk(carry, chunk_idx):
            return jax.lax.scan(
                step, carry,
                chunk_idx * remat_chunk + jnp.arange(remat_chunk))

        (y, i1, i2), v_means = jax.lax.scan(
            chunk, init, jnp.arange(num_steps // remat_chunk))
        v_means = v_means.reshape(-1)
    else:
        (y, i1, i2), v_means = jax.lax.scan(step, init, jnp.arange(n))
    return v_means, i1, i2


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "antithetic"))
def rbergomi_path_stats_lifted(params: RoughBergomiParams, spot, T, key,
                               c, d, g, tail, *, num_paths: int,
                               num_steps: int, antithetic: bool = True,
                               xi_t: Optional[Array] = None) -> dict:
    """`rbergomi_path_stats` through the Markovian lift — O(n·m) per path
    instead of the exact sampler's O(n²) covariance matmul, so 1024-step
    path-dependent payoffs (asian/barrier/lookback) run at scan speed.

    Same carry recursion as `rbergomi_core_lifted` (left-point v, tail
    top-up, antithetic = all three normals flip), extended with the spot
    leg the exact sheet carried: dz = ρ dW + √(1−ρ²) dW' needs an explicit
    per-step orthogonal normal here (the PATH depends on it, unlike the
    Romano-Touzi terminal estimator), and the carry tracks
    (log S, Σ S, max log S, min log S) — max/min commute with the
    monotone spot·exp(·), so only the running mean pays the extra exp.
    Returns the same dict of (branches, paths) arrays over the grid
    t_1..t_n, statistically pinned to the exact sampler in
    tests/test_rough.py."""
    dtype = jnp.float32
    n = num_steps
    h = float(params.hurst)
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt = T / n
    sqrt_dt = jnp.sqrt(dt)
    nb = 2 if antithetic else 1
    sign = jnp.array([1.0, -1.0], dtype)[:nb, None]

    c_ = jnp.asarray(c, dtype)[:, None, None]
    d_ = jnp.asarray(d, dtype)[:, None, None]
    g_ = jnp.asarray(g, dtype)[:, None, None]
    sqrt_tail_left = jnp.concatenate(
        [jnp.zeros((1,), dtype), jnp.sqrt(jnp.asarray(tail, dtype))[:-1]])
    t_left = dt * jnp.arange(n, dtype=dtype)
    wick_left = jnp.where(t_left > 0.0, t_left, 1.0) ** jnp.float32(2 * h)
    wick_left = jnp.where(t_left > 0.0, wick_left, 0.0)
    xi_vec = (params.xi * jnp.ones((n,), dtype) if xi_t is None
              else jnp.asarray(xi_t, dtype))
    eta = jnp.asarray(params.eta, dtype)
    rho = jnp.asarray(params.rho, dtype)
    orth = jnp.sqrt(jnp.maximum(1.0 - rho * rho, 0.0))
    mu_dt = (jnp.asarray(params.r, dtype) - jnp.asarray(params.q, dtype)) * dt

    def step(carry, i):
        y, log_s, sum_s, max_ls, min_ls = carry
        z = jax.random.normal(jax.random.fold_in(key, i),
                              (3, num_paths), dtype)
        dw = (z[0] * sign) * sqrt_dt                       # (nb, paths)
        zeta = z[1] * sign
        w_left = jnp.sum(c_ * y, axis=0) + sqrt_tail_left[i] * zeta
        v = xi_vec[i] * jnp.exp(eta * w_left
                                - 0.5 * eta * eta * wick_left[i])
        dz = rho * dw + orth * (z[2] * sign) * sqrt_dt
        log_s = log_s + (mu_dt - 0.5 * v * dt) + jnp.sqrt(v) * dz
        sum_s = sum_s + jnp.exp(log_s)
        max_ls = jnp.maximum(max_ls, log_s)
        min_ls = jnp.minimum(min_ls, log_s)
        y = d_ * y + g_ * dw[None]
        return (y, log_s, sum_s, max_ls, min_ls), None

    zeros = jnp.zeros((nb, num_paths), dtype)
    init = (jnp.zeros((c_.shape[0], nb, num_paths), dtype), zeros, zeros,
            jnp.full((nb, num_paths), -jnp.inf, dtype),
            jnp.full((nb, num_paths), jnp.inf, dtype))
    (_, log_s, sum_s, max_ls, min_ls), _ = jax.lax.scan(
        step, init, jnp.arange(n))
    return {
        "s_terminal": spot * jnp.exp(log_s),
        "s_mean": spot * sum_s / jnp.float32(n),
        "s_max": spot * jnp.exp(max_ls),
        "s_min": spot * jnp.exp(min_ls),
    }
