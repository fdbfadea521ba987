"""American option pricing: Longstaff-Schwartz Monte Carlo on device.

Capability extension beyond the reference (European-only — NIFTY index
options are European, but single-stock NSE options are American, and a desk
framework needs both).

Design:
- Paths are recorded once ((steps, paths) log-spot matrix in HBM — 100MB at
  200k × 128, trivial), then the backward induction runs as a *reverse*
  `lax.scan`.
- The continuation regression at each exercise date is a masked (ITM-only,
  the classic Longstaff-Schwartz restriction) polynomial least squares in
  normalized moneyness, solved via ridge-stabilized normal equations — a
  (paths × d)ᵀ(paths × d) matmul pair per step, MXU-friendly.
- The regression basis and decision are fully vectorized; there is no
  per-path Python anywhere.

Validation oracle: `binomial_american_bs` (CRR tree, host numpy f64) — the
standard American-BS reference; LSM carries a small low bias (suboptimal
exercise) and MC noise, both bounded in tests.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import DEFAULT_NUM_PATHS, scaled_steps
from mcos_tpu.models.params import SVJParams
from mcos_tpu.ops.dividends import DividendSchedule
from mcos_tpu.ops.simulate import _svj_step_core

Array = jax.Array


def _dividend_sheets(s_paths: Array, div_grid: Array, div_kind: str,
                     floor) -> tuple:
    """(dates, paths) no-dividend spots → (s_ex, s_cum) adjusted sheets.

    ``s_ex`` is the tradable ex-dividend spot at each date (drives regression
    state, continuation dynamics and the terminal payoff); ``s_cum`` is the
    cum-dividend spot the holder captures by exercising *just before* the
    drop (s_cum = s_ex + D at ex-dates, = s_ex elsewhere) — the spot the
    early-exercise payoff must use, or the classic exercise-before-ex-date
    premium of an American call vanishes.

    cash: the exact compounded model (ops/dividends.py module docstring):
        s_ex(t_k) = S(t_k)·(1 − Σ_{j<=k} D_j/S(t_j)),  drop of exactly D_j.
    proportional: deterministic cumulative factors Π(1−d).
    Both are floored at a tiny positive level (huge dividends on a crashed
    path can exhaust the spot; the floor keeps payoffs/bases finite).
    """
    if div_kind == "proportional":
        cum_ex = jnp.exp(jnp.cumsum(jnp.log1p(-div_grid)))
        cum_cum = cum_ex / (1.0 - div_grid)  # excludes the date's own drop
        s_ex = s_paths * cum_ex[:, None]
        s_cum = s_paths * cum_cum[:, None]
    else:
        a_ex = jnp.cumsum(div_grid[:, None] / s_paths, axis=0)
        s_ex = s_paths * (1.0 - a_ex)
        s_cum = s_ex + div_grid[:, None]
    return jnp.maximum(s_ex, floor), jnp.maximum(s_cum, floor)


@partial(jax.jit, static_argnames=("num_paths", "num_steps"))
def _record_log_paths(params: SVJParams, spot, T, key, *,
                      num_paths: int, num_steps: int,
                      td_table: Optional[Array] = None) -> Array:
    """(num_steps, num_paths) log-spots at t_1..t_n (t_0 = log spot known).

    `td_table` (optional, (3, num_steps): per-step θ/ξ/λ rows from
    ops/tdsvj.step_param_arrays) records the sheet under time-dependent
    dynamics. The key/fold layout is identical either way, so a constant
    table reproduces the constant-param sheet bit-for-bit (test-pinned).
    """
    dtype = jnp.float32
    spot = jnp.asarray(spot, dtype)
    dt = jnp.asarray(T, dtype) / num_steps
    sqrt_dt = jnp.sqrt(dt)
    # log(S/S0) carry (see ops/simulate.py on f32 drift quantization);
    # log(spot) is added back to the recorded sheet at the end.
    log_s0 = jnp.zeros((num_paths,), dtype)
    v0 = jnp.broadcast_to(jnp.asarray(params.v0, dtype), (num_paths,))

    if td_table is None:
        xs = (jnp.arange(num_steps), None)
    else:
        xs = (jnp.arange(num_steps), jnp.asarray(td_table, dtype).T)

    def step(carry, x):
        log_s, v = carry
        step_idx, td_row = x
        p = (params if td_row is None else params.replace(
            theta=td_row[0], xi=td_row[1], lambda_j=td_row[2]))
        k_step = jax.random.fold_in(key, step_idx)
        k_norm, k_unif = jax.random.split(k_step)
        z = jax.random.normal(k_norm, (3, num_paths), dtype)
        u = jax.random.uniform(k_unif, (num_paths,), dtype)
        log_s, v = _svj_step_core(p, dt, sqrt_dt, log_s, v,
                                  z[0], z[1], u, z[2])
        return (log_s, v), log_s

    (_, _), log_paths = jax.lax.scan(step, (log_s0, v0), xs)
    return log_paths + jnp.log(spot)


def _exercise_mask(num_steps: int, exercise_every: int) -> np.ndarray:
    """(num_steps-1,) bool: is exercise allowed at date t_k, k = 1..n-1?

    `exercise_every = 1` is the American schedule (every step);
    `exercise_every = m` keeps only dates t_m, t_2m, ... (a Bermudan
    schedule on the simulation grid); `exercise_every = num_steps` leaves
    no early date at all — the European degenerate case, a test oracle.
    Maturity t_n is always an exercise date (handled by the terminal
    payoff), and t_0 is never one (a just-written Bermudan cannot be
    struck same-day; the American engine keeps its intrinsic floor).
    """
    k = np.arange(1, num_steps)
    return (k % int(exercise_every)) == 0


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "is_call",
                                   "basis_degree", "exercise_every",
                                   "div_kind"))
def lsm_price(params: SVJParams, spot, strike, T, key, *,
              num_paths: int, num_steps: int, is_call: bool,
              basis_degree: int = 3,
              exercise_every: int = 1,
              div_grid: Optional[Array] = None,
              div_kind: str = "cash",
              rate_offsets: Optional[Array] = None,
              rate_step_dfs: Optional[Array] = None,
              td_table: Optional[Array] = None) -> Dict[str, Array]:
    """Longstaff-Schwartz American/Bermudan price under SVJ dynamics.

    `td_table` ((3, num_steps) per-step θ/ξ/λ) prices the American under
    time-dependent dynamics (ops/tdsvj.py) — early exercise against a vol
    term structure, e.g. a put across a known calm→stressed transition.

    `rate_offsets`/`rate_step_dfs` ((num_steps,) host-precomputed, see
    ops/curves.py) price off a deterministic rate curve exactly: the sheet
    simulated at the flat rate params.r is shifted by the cumulative drift
    correction, and the backward induction discounts with per-step factors.

    `div_grid` ((num_steps,) per-date discrete dividends snapped onto the
    simulation grid, see DividendSchedule.grid_amounts) prices American
    options on dividend-paying stocks: exercise payoffs read the
    cum-dividend spot, continuation state the ex-dividend spot
    (_dividend_sheets) — the configuration where early exercise of a call
    is actually optimal (just before a large ex-date)."""
    dtype = jnp.float32
    strike = jnp.asarray(strike, dtype)
    dt = jnp.asarray(T, dtype) / num_steps
    df = jnp.exp(-params.r * dt)

    log_paths = _record_log_paths(params, spot, T, key,
                                  num_paths=num_paths, num_steps=num_steps,
                                  td_table=td_table)
    if rate_offsets is not None:
        log_paths = log_paths + rate_offsets[:, None]
    s_paths = jnp.exp(log_paths)  # (steps, paths), t_1..t_n
    if div_grid is not None:
        s_ex, s_cum = _dividend_sheets(s_paths, div_grid, div_kind,
                                       floor=1e-6 * strike)
    else:
        s_ex = s_cum = s_paths

    def payoff(s):
        return jnp.maximum(s - strike, 0.0) if is_call \
            else jnp.maximum(strike - s, 0.0)

    def basis(s):
        # Centered moneyness powers + the normalized payoff itself.
        # Raw x^k powers make the f32 Gram matrix ill-conditioned enough to
        # trigger spurious exercise (measured: up to 15% price destruction on
        # a q=0 call); centering at ATM and adding payoff/K as a regressor
        # keeps the deep-ITM fit tight where exercise mistakes are costliest.
        u = s / strike - 1.0
        cols = [jnp.ones_like(u)]
        for d in range(1, basis_degree + 1):
            cols.append(u**d)
        cols.append(payoff(s) / strike)
        return jnp.stack(cols, axis=1)  # (paths, deg+2)

    cf_terminal = payoff(s_ex[-1])
    allowed = jnp.asarray(_exercise_mask(num_steps, exercise_every))
    # Per-step discounts: sdf[m] covers [t_m, t_{m+1}] (constant when flat).
    sdf = (rate_step_dfs if rate_step_dfs is not None
           else jnp.full((num_steps,), df))

    cf = lsm_backward_cashflows(cf_terminal, s_cum, s_ex, allowed, sdf,
                                payoff, basis)
    price = jnp.mean(cf)
    se = jnp.std(cf) / jnp.sqrt(jnp.float32(num_paths))
    intrinsic = payoff(jnp.asarray(spot, dtype))
    # The t_0 intrinsic floor applies only when t_0-style exercise exists
    # (the American schedule); a Bermudan's first right is t_m.
    floored = jnp.maximum(price, intrinsic) if exercise_every == 1 else price
    return {
        "price": floored,
        "std_error": se,
        "mc_continuation": price,
        "intrinsic": intrinsic,
    }


def solve_normal_equations(gram, rhs, *, ridge: float = 1e-5):
    """Equilibrated ridge solve of G·coef = rhs (G = XᵀWX, rhs = XᵀW y).

    G' = DGD with D = diag(G)^{-1/2} plus a RELATIVE ridge on the unit
    diagonal: raw polynomial Grams reach condition ~1e9 on wide-dispersion
    path sheets, and f32 normal equations square that — measured −0.7 on
    the 13.90 Broadie-Glasserman max-call before equilibration, ±0.002
    after (the f64 value). Shared by every LSM regression in the framework
    (single-asset, multi-asset, distributed, and the dual's value fits).
    """
    d_eq = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(gram), 1e-12))
    gram_eq = gram * d_eq[:, None] * d_eq[None, :] \
        + ridge * jnp.eye(gram.shape[0], dtype=gram.dtype)
    return d_eq * jnp.linalg.solve(gram_eq, d_eq * rhs)


def lsm_backward_cashflows(cf_terminal, s_cum, s_ex, allowed, sdf,
                           payoff, basis, *, ridge: float = 1e-5,
                           pool=None):
    """Backward LSM induction → per-path cashflows discounted to t₀.

    ONE implementation of the continuation-regression algebra, shared by
    the single-device `lsm_price` (pool=None), the mesh-sharded driver
    (`parallel/mesh.py:sharded_american_price`, pool=psum), and the
    multi-asset LSM (engine/basket_american.py) — the same twin-sharing
    discipline as `corridor_surv_increment`. The pooling hook receives the
    stacked ``[gram | rhs]`` moment block: normal equations are linear in
    the per-path outer products, so psum-pooling them across devices
    reproduces EXACTLY the regression a single device would fit on the
    union path set — every device then solves the identical (d×d) system
    and applies the identical stopping rule to its local paths.

    The solve equilibrates the pooled Gram (G' = DGD with
    D = diag(G)^{-1/2}) and adds a RELATIVE ridge on the unit diagonal:
    raw polynomial Grams reach condition ~1e9 on wide-dispersion sheets
    (f32 normal equations square that), which silently destroys the
    stopping rule — measured −0.7 on the 13.90 Broadie-Glasserman
    2-asset max-call before equilibration, ±0.002 after (the f64 value).
    Equilibration is applied AFTER pooling, so it is distribution-safe.

    `s_cum`/`s_ex` are the (steps, paths) cum-/ex-dividend sheets for dates
    t_1..t_n (equal when no dividends); `sdf[m]` discounts [t_m, t_{m+1}].
    """
    dtype = cf_terminal.dtype

    def backstep(cf, inputs):
        s_pay, s_state, allow, df_t = inputs
        cf = cf * df_t  # continuation value discounted to time t
        pay = payoff(s_pay)          # cum-dividend: what exercise captures
        itm = pay > 0.0
        w = itm.astype(dtype)
        b = basis(s_state)           # ex-dividend: what drives the future
        bw = b * w[:, None]
        block = jnp.concatenate([b.T @ bw, (bw.T @ cf)[:, None]], axis=1)
        if pool is not None:
            block = pool(block)
        coef = solve_normal_equations(block[:, :-1], block[:, -1],
                                      ridge=ridge)
        cont = b @ coef
        exercise = itm & (pay > cont) & allow
        return jnp.where(exercise, pay, cf), None

    # Reverse induction over t_{n-1}..t_1 (terminal step handled by caller).
    cf, _ = jax.lax.scan(backstep, cf_terminal,
                         (s_cum[:-1], s_ex[:-1], allowed, sdf[1:]),
                         reverse=True)
    return cf * sdf[0]  # discount t_1 → t_0


def _payoff_fn(strike, is_call: bool):
    def payoff(s):
        return jnp.maximum(s - strike, 0.0) if is_call \
            else jnp.maximum(strike - s, 0.0)
    return payoff


def _basis_fn(strike, is_call: bool, basis_degree: int):
    payoff = _payoff_fn(strike, is_call)

    def basis(s):
        # Stacked on the LAST axis so it broadcasts over any leading batch
        # shape (1-D training paths, 2-D (inner × outer) nested states).
        u = s / strike - 1.0
        cols = [jnp.ones_like(u)]
        for d in range(1, basis_degree + 1):
            cols.append(u**d)
        cols.append(payoff(s) / strike)
        return jnp.stack(cols, axis=-1)
    return basis


def _value_basis(strike):
    """Well-conditioned basis for the dual's value regression: centered
    moneyness powers only. The policy basis's payoff/K regressor is exactly
    collinear with u on an all-ITM put sample (payoff/K = −u there), which
    leaves the coefficient split arbitrary — harmless for the in-manifold
    policy decision, fatal for the dual, which evaluates the fit everywhere.
    """
    def basis(s):
        u = s / strike - 1.0
        return jnp.stack([jnp.ones_like(u), u, u**2, u**3], axis=-1)
    return basis


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "is_call",
                                   "basis_degree", "exercise_every",
                                   "div_kind"))
def lsm_train(params: SVJParams, spot, strike, T, key, *,
              num_paths: int, num_steps: int, is_call: bool,
              basis_degree: int = 3,
              exercise_every: int = 1,
              div_grid: Optional[Array] = None,
              div_kind: str = "cash",
              rate_offsets: Optional[Array] = None,
              rate_step_dfs: Optional[Array] = None) -> Dict[str, Array]:
    """Fit the per-date continuation regressions on a training path set.

    Returns {"policy": (num_steps−1, n_basis), "value": (num_steps−1, 4)} —
    row k is the regression for exercise date t_{k+1} (dates t_1..t_{n−1};
    at t_n the value is the payoff). "policy" is the classic ITM-masked
    LSM fit driving the stopping rule; "value" is an *unmasked* fit of the
    continuation value on the powers-only basis, used by the dual bound
    (which needs a sane V̂ on every state the outer paths visit, not just
    ITM ones). Training is separated from evaluation so the stopping rule
    can be applied out of sample — in-sample LSM peeks at the future
    through the fit and is biased high (Longstaff-Schwartz 2001 recommend
    the split).
    """
    dtype = jnp.float32
    strike = jnp.asarray(strike, dtype)
    dt = jnp.asarray(T, dtype) / num_steps
    df = jnp.exp(-params.r * dt)
    payoff = _payoff_fn(strike, is_call)
    basis = _basis_fn(strike, is_call, basis_degree)
    vbasis = _value_basis(strike)

    log_paths = _record_log_paths(params, spot, T, key,
                                  num_paths=num_paths, num_steps=num_steps)
    if rate_offsets is not None:
        log_paths = log_paths + rate_offsets[:, None]
    s_paths = jnp.exp(log_paths)
    if div_grid is not None:
        s_ex, s_cum = _dividend_sheets(s_paths, div_grid, div_kind,
                                       floor=1e-6 * strike)
    else:
        s_ex = s_cum = s_paths
    cf_terminal = payoff(s_ex[-1])

    allowed = jnp.asarray(_exercise_mask(num_steps, exercise_every))
    sdf = (rate_step_dfs if rate_step_dfs is not None
           else jnp.full((num_steps,), df))

    def backstep(cf, inputs):
        s_pay, s_state, allow, df_t = inputs
        cf = cf * df_t
        pay = payoff(s_pay)
        itm = pay > 0.0
        w = itm.astype(dtype)
        b = basis(s_state)
        bw = b * w[:, None]
        coef = solve_normal_equations(b.T @ bw, bw.T @ cf)
        cont = b @ coef
        bv = vbasis(s_state)
        coef_v = solve_normal_equations(bv.T @ bv, bv.T @ cf)
        exercise = itm & (pay > cont) & allow
        return jnp.where(exercise, pay, cf), (coef, coef_v)

    _, (coefs, coefs_v) = jax.lax.scan(backstep, cf_terminal,
                                       (s_cum[:-1], s_ex[:-1], allowed,
                                        sdf[1:]),
                                       reverse=True)
    return {"policy": coefs, "value": coefs_v}


def _lower_bound_values(params: SVJParams, spot, strike, T, key, coefs, *,
                        num_paths: int, num_steps: int, is_call: bool,
                        basis_degree: int = 3,
                        exercise_every: int = 1,
                        div_grid=None,
                        div_kind: str = "cash",
                        rate_offsets=None,
                        rate_cum=None) -> Array:
    """Per-path discounted payoffs at the FIXED stopping rule (traceable).

    Differentiable in (spot, params, T): the stop decision rides through
    boolean `jnp.where` selects, so AD differentiates the *realized* branch
    with the stopping time held fixed — exactly the policy-fixed pathwise
    estimator American Greeks need (the envelope theorem makes the ignored
    ∂policy term second-order at a near-optimal policy).
    """
    dtype = jnp.float32
    strike = jnp.asarray(strike, dtype)
    dt = jnp.asarray(T, dtype) / num_steps
    payoff = _payoff_fn(strike, is_call)
    basis = _basis_fn(strike, is_call, basis_degree)

    log_paths = _record_log_paths(params, spot, T, key,
                                  num_paths=num_paths, num_steps=num_steps)
    if rate_offsets is not None:
        log_paths = log_paths + rate_offsets[:, None]
    s_paths = jnp.exp(log_paths)
    if div_grid is not None:
        s_ex, s_cum = _dividend_sheets(s_paths, div_grid, div_kind,
                                       floor=1e-6 * strike)
    else:
        s_ex = s_cum = s_paths

    # Discount to t_{k+1}: flat exp(−r·t) normally; with a curve, the
    # host-precomputed R(t) grid PLUS the traced parallel component
    # (params.r − R(T)/T)·t — zero at evaluation (the engine sets
    # params.r = r_eff), but it keeps ∂/∂r = −t·P alive so the policy-fixed
    # AD rho is the parallel-shift sensitivity under the curve too.
    t_grid = dt * jnp.arange(1, num_steps + 1, dtype=dtype)
    if rate_cum is not None:
        r_flat = rate_cum[-1] / jnp.asarray(T, dtype)
        cum_disc = jnp.exp(-(rate_cum + (params.r - r_flat) * t_grid))
    else:
        cum_disc = jnp.exp(-params.r * t_grid)

    def fwd(carry, inputs):
        stopped, value = carry
        s_pay, s_state, coef, allow, disc = inputs
        pay = payoff(s_pay)
        cont = basis(s_state) @ coef
        exercise = (~stopped) & (pay > 0.0) & (pay > cont) & allow
        value = jnp.where(exercise, disc * pay, value)
        return (stopped | exercise, value), None

    n_paths = s_paths.shape[1]
    allowed = jnp.asarray(_exercise_mask(num_steps, exercise_every))
    init = (jnp.zeros((n_paths,), bool), jnp.zeros((n_paths,), dtype))
    (stopped, value), _ = jax.lax.scan(
        fwd, init, (s_cum[:-1], s_ex[:-1], coefs, allowed,
                    cum_disc[:-1]))
    # Unstopped paths exercise (or expire) at maturity.
    return jnp.where(stopped, value, cum_disc[-1] * payoff(s_ex[-1]))


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "is_call",
                                   "basis_degree", "exercise_every",
                                   "div_kind"))
def lsm_lower_bound(params: SVJParams, spot, strike, T, key, coefs, *,
                    num_paths: int, num_steps: int, is_call: bool,
                    basis_degree: int = 3,
                    exercise_every: int = 1,
                    div_grid=None,
                    div_kind: str = "cash",
                    rate_offsets=None,
                    rate_cum=None) -> Dict[str, Array]:
    """Evaluate the FIXED stopping rule on fresh paths → a true lower bound.

    Any measurable stopping rule gives E[discounted payoff at stop] ≤ the
    American value; the LSM rule trained on an independent set qualifies.
    Forward pass: stop at the first date where payoff > fitted continuation
    (and ITM); collect the discounted payoff.
    """
    value = _lower_bound_values(params, spot, strike, T, key, coefs,
                                num_paths=num_paths, num_steps=num_steps,
                                is_call=is_call, basis_degree=basis_degree,
                                exercise_every=exercise_every,
                                div_grid=div_grid, div_kind=div_kind,
                                rate_offsets=rate_offsets,
                                rate_cum=rate_cum)
    price = jnp.mean(value)
    se = jnp.std(value) / jnp.sqrt(jnp.float32(num_paths))
    return {"price": price, "std_error": se}


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "is_call",
                                   "basis_degree", "div_kind"))
def american_greeks_ad(params: SVJParams, spot, strike, T, key, coefs, *,
                       num_paths: int, num_steps: int, is_call: bool,
                       basis_degree: int = 3,
                       div_grid=None, div_kind: str = "cash",
                       rate_offsets=None, rate_cum=None):
    """(price, ∂P/∂spot, ∂P/∂v₀, ∂P/∂T, ∂P/∂r) of the policy-fixed American
    lower-bound estimator — ONE forward+backward pass.

    The regression coefficients are constants here (trained on an
    independent path set), so the gradient is the fixed-stopping-time
    pathwise derivative; at a near-optimal policy the neglected policy
    sensitivity is second-order (envelope theorem). The same argument the
    reference cannot make at all — it has no American pricer (greeks.py is
    European-only).
    """
    def f(spot_, v0_, T_, r_):
        p = params.replace(v0=v0_, r=r_)
        value = _lower_bound_values(p, spot_, strike, T_, key, coefs,
                                    num_paths=num_paths, num_steps=num_steps,
                                    is_call=is_call,
                                    basis_degree=basis_degree,
                                    div_grid=div_grid, div_kind=div_kind,
                                    rate_offsets=rate_offsets,
                                    rate_cum=rate_cum)
        return jnp.mean(value)

    price, grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3))(
        jnp.float32(spot), jnp.asarray(params.v0, jnp.float32),
        jnp.float32(T), jnp.asarray(params.r, jnp.float32))
    return price, grads


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "is_call",
                                   "basis_degree", "div_kind"))
def _american_delta_batch(params: SVJParams, spots, strike, T, key, coefs, *,
                          num_paths: int, num_steps: int, is_call: bool,
                          basis_degree: int = 3,
                          div_grid=None, div_kind: str = "cash",
                          rate_offsets=None, rate_cum=None):
    """Policy-fixed AD delta at a batch of spots (CRN: same key/coefs) —
    gamma's central difference rides one vmapped backward pass."""
    def one(s):
        def f(s_):
            return jnp.mean(_lower_bound_values(
                params, s_, strike, T, key, coefs, num_paths=num_paths,
                num_steps=num_steps, is_call=is_call,
                basis_degree=basis_degree,
                div_grid=div_grid, div_kind=div_kind,
                rate_offsets=rate_offsets, rate_cum=rate_cum))
        return jax.grad(f)(s)

    return jax.vmap(one)(jnp.asarray(spots, jnp.float32))


@partial(jax.jit, static_argnames=("n_outer", "n_inner", "num_steps",
                                   "is_call", "basis_degree"))
def dual_upper_bound(params: SVJParams, spot, strike, T, key, coefs, *,
                     n_outer: int, n_inner: int, num_steps: int,
                     is_call: bool, basis_degree: int = 3
                     ) -> Dict[str, Array]:
    """Haugh-Kogan / Andersen-Broadie dual upper bound.

    For ANY martingale M with M₀ = 0,
        American price ≤ E[ max_k ( disc_k·h(S_k) − M_k ) ],
    with equality at the Doob martingale of the value process. M is built
    from the LSM value function V̂_k(s) = max(h(s), ĉ_k(s)):
        M_{k+1} = M_k + Ṽ_{k+1}(S_{k+1}) − Ê_k[Ṽ_{k+1}],
    where Ṽ is discounted to t₀ and the conditional expectation is a
    one-step nested simulation (n_inner fresh transitions from the outer
    state — the (outer × inner) batch is a single vectorized kernel, the
    shape of nested MC a vector device runs well). Zero-mean inner noise keeps
    M a martingale, so the bound stays valid (just looser) at small
    n_inner; the LSM lower bound + this upper bound bracket the true price
    with a reported duality gap. Capability absent from the reference.
    """
    dtype = jnp.float32
    # Antithetic inner draws are built as concat((n_inner//2), -(n_inner//2));
    # an odd n_inner would broadcast-mismatch against the outer state at
    # trace time, so round down to even (schemas allow any 16..2048).
    n_inner -= n_inner % 2
    strike = jnp.asarray(strike, dtype)
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    df_powk = lambda k: jnp.exp(-params.r * dt * k)  # noqa: E731
    payoff = _payoff_fn(strike, is_call)
    vbasis = _value_basis(strike)

    k_outer, k_inner = jax.random.split(key)

    # Outer paths: record (log S, v) at every date (v is needed to branch
    # the inner transitions off the true state).
    log_s0 = jnp.zeros((n_outer,), dtype)
    v0 = jnp.broadcast_to(jnp.asarray(params.v0, dtype), (n_outer,))

    def outer_step(carry, step_idx):
        log_s, v = carry
        ks = jax.random.fold_in(k_outer, step_idx)
        kn, ku = jax.random.split(ks)
        z = jax.random.normal(kn, (3, n_outer), dtype)
        u = jax.random.uniform(ku, (n_outer,), dtype)
        log_s, v = _svj_step_core(params, dt, sqrt_dt, log_s, v,
                                  z[0], z[1], u, z[2])
        return (log_s, v), (log_s, v)

    (_, _), (log_path, v_path) = jax.lax.scan(
        outer_step, (log_s0, v0), jnp.arange(num_steps))
    # Prepend t_0 state; shapes (num_steps+1, n_outer).
    log_path = jnp.concatenate([log_s0[None], log_path]) + jnp.log(spot)
    v_path = jnp.concatenate([v0[None], v_path])

    n_basis = coefs.shape[1]

    def vhat(s, k, coef_k):
        """Time-t_k value estimate in t_k money (k = 1..num_steps).

        Continuation fit clamped to the no-arbitrage window [0, K] (put) /
        [0, S] (call) — the cubic extrapolates wildly outside the training
        cloud, and the dual evaluates it wherever the paths wander.
        """
        pay = payoff(s)
        cap = jnp.broadcast_to(strike, s.shape) if not is_call else s
        cont = jnp.clip(vbasis(s) @ coef_k, 0.0, cap)
        # Terminal date: value IS the payoff (no continuation).
        is_terminal = k >= num_steps
        return jnp.where(is_terminal, pay, jnp.maximum(pay, cont))

    # Walk k = 0..num_steps-1, accumulating M and the running max of
    # (disc_k·h_k − M_k). M_0 = 0; date-0 candidate is the intrinsic.
    def dual_step(carry, inputs):
        m, best = carry
        k, coef_next, log_s_k, v_k, log_s_next = inputs
        s_next = jnp.exp(log_s_next)

        # Ê_k[Ṽ_{k+1}]: n_inner fresh one-step transitions from (s_k, v_k),
        # antithetic-paired (±z halves the estimator noise that directly
        # loosens the bound).
        ki = jax.random.fold_in(k_inner, k.astype(jnp.int32))
        kn, ku = jax.random.split(ki)
        zh = jax.random.normal(kn, (3, n_inner // 2, n_outer), dtype)
        z = jnp.concatenate([zh, -zh], axis=1)
        uh = jax.random.uniform(ku, (n_inner // 2, n_outer), dtype)
        u = jnp.concatenate([uh, uh], axis=0)
        log_si, _ = _svj_step_core(
            params, dt, sqrt_dt,
            jnp.broadcast_to(log_s_k, (n_inner, n_outer)),
            jnp.broadcast_to(v_k, (n_inner, n_outer)),
            z[0], z[1], u, z[2])
        v_inner = vhat(jnp.exp(log_si), k + 1, coef_next)   # (inner, outer)
        e_k = jnp.mean(v_inner, axis=0)

        disc_next = df_powk(k + 1.0)
        m = m + disc_next * (vhat(s_next, k + 1, coef_next) - e_k)
        best = jnp.maximum(best, disc_next * payoff(s_next) - m)
        return (m, best), None

    m0 = jnp.zeros((n_outer,), dtype)
    best0 = payoff(jnp.broadcast_to(spot, (n_outer,)))  # k = 0 candidate
    # Date k+1 regression rows; the terminal date gets a zero row (vhat
    # switches to pure payoff there, the row is unused).
    coef_rows = jnp.concatenate([coefs, jnp.zeros((1, n_basis), dtype)])
    (m, best), _ = jax.lax.scan(
        dual_step, (m0, best0),
        (jnp.arange(num_steps, dtype=dtype), coef_rows,
         log_path[:-1], v_path[:-1], log_path[1:]))
    price = jnp.mean(best)
    se = jnp.std(best) / jnp.sqrt(jnp.float32(n_outer))
    return {"price": price, "std_error": se}


class AmericanEngine:
    """LSM American pricer with the framework's engine conventions."""

    def __init__(self, params: SVJParams, num_paths: int = DEFAULT_NUM_PATHS,
                 num_steps: int = 64, seed: int = 42, basis_degree: int = 3,
                 dividends: "DividendSchedule" = None,
                 rate_curve=None, mesh=None):
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.basis_degree = int(basis_degree)
        # None | "auto" | Mesh — price() routes through the distributed-LSM
        # driver (parallel/mesh.py:sharded_american_price, psum-pooled
        # normal equations) when a multi-device mesh resolves and neither
        # dividends nor a rate curve is set; greeks()/price_bounds() stay
        # single-device. None honors MCOS_AUTO_MESH=1 (the serving toggle).
        self.mesh = mesh
        # Discrete dividends (ops/dividends.py): cash uses the exact
        # compounded-cash path model, proportional the exact factor model.
        # The continuous yield q should then hold only the non-discrete
        # remainder (double counting is the caller's to avoid).
        self.dividends = dividends
        # Deterministic rate term structure (ops/curves.RateCurve): paths
        # simulate at the flat-equivalent rate and the sheets/discounts are
        # corrected exactly (see lsm_price docstring). params.r is ignored
        # when a curve is set.
        self.rate_curve = rate_curve

    def _params_T(self, T: float) -> SVJParams:
        if self.rate_curve is None:
            return self.params
        return self.params.replace(r=self.rate_curve.r_eff(float(T)))

    def _rate_args(self, T: float, steps: int, for_lb: bool = False) -> Dict:
        """lsm kwargs for the curve vectors (empty when flat)."""
        if self.rate_curve is None:
            return {}
        r_flat = self.rate_curve.r_eff(float(T))
        off = jnp.asarray(
            self.rate_curve.grid_log_offsets(float(T), steps, r_flat))
        if for_lb:
            return {"rate_offsets": off,
                    "rate_cum": jnp.asarray(
                        self.rate_curve.grid_integrals(float(T), steps),
                        jnp.float32)}
        return {"rate_offsets": off,
                "rate_step_dfs": jnp.asarray(
                    self.rate_curve.grid_step_dfs(float(T), steps))}

    def _div_args(self, T: float, steps: int) -> Dict:
        """jit kwargs for the dividend-adjusted path sheets (or empty)."""
        if self.dividends is None:
            return {}
        grid = self.dividends.grid_amounts(T, steps)
        if grid is None:
            return {}
        return {"div_grid": jnp.asarray(grid),
                "div_kind": self.dividends.kind}

    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True,
              exercise_every: int = 1) -> Dict[str, float]:
        """American price; `exercise_every = m > 1` restricts exercise to
        every m-th simulation date — a Bermudan schedule (e.g. with the
        default 64 steps/yr, `exercise_every=16` ≈ quarterly rights).
        `exercise_every >= num_steps` degenerates to European (the test
        oracle)."""
        steps = scaled_steps(self.num_steps, T, floor=16)
        if self.dividends is None and self.rate_curve is None:
            from mcos_tpu.engine.pricer import resolve_mesh

            mesh = resolve_mesh(self.mesh)
            if mesh is not None:
                from mcos_tpu.parallel.mesh import sharded_american_price

                out = sharded_american_price(
                    self.params, spot, strike, T, jax.random.key(self.seed),
                    mesh=mesh, num_paths=self.num_paths, num_steps=steps,
                    is_call=is_call, basis_degree=self.basis_degree,
                    exercise_every=min(int(exercise_every), steps))
                out["num_steps"] = steps
                if exercise_every != 1:
                    out["exercise_every"] = min(int(exercise_every), steps)
                return out
        res = jax.device_get(lsm_price(
            self._params_T(T), spot, strike, T, jax.random.key(self.seed),
            num_paths=self.num_paths, num_steps=steps,
            is_call=is_call, basis_degree=self.basis_degree,
            exercise_every=min(int(exercise_every), steps),
            **self._div_args(T, steps), **self._rate_args(T, steps)))
        out = {k: float(v) for k, v in res.items()}
        out["num_paths_used"] = self.num_paths
        out["num_steps"] = steps
        if exercise_every != 1:
            out["exercise_every"] = min(int(exercise_every), steps)
        return out

    def greeks(self, spot: float, strike: float, T: float,
               is_call: bool = True, spot_bump: float = 0.01
               ) -> Dict[str, float]:
        """American Greeks: policy-fixed pathwise AD (see american_greeks_ad).

        delta/vega/theta/rho from ONE backward pass through the stopped-
        payoff scan; gamma = central CRN-FD of the AD delta (the same
        kinked-payoff recipe as the European GreeksEngine). Early exercise
        shows up where it must: a deep-ITM American put's delta → −1 and
        theta → −rK side, which no European estimator reproduces.

        Key conventions mirror GreeksEngine.all_greeks (vega_per_vol_point
        = 2σ·∂P/∂v₀; the reference's theta_daily label holds the annualized
        rate — engine/greeks.py:425-436).
        """
        steps = scaled_steps(self.num_steps, T, floor=16)
        key = jax.random.key(self.seed)
        k_train, k_eval = jax.random.split(key)
        params_T = self._params_T(T)
        base = dict(num_steps=steps, is_call=is_call,
                    basis_degree=self.basis_degree,
                    **self._div_args(T, steps))
        coefs = lsm_train(params_T, spot, strike, T, k_train,
                          num_paths=self.num_paths, **base,
                          **self._rate_args(T, steps))["policy"]
        kwargs = {**base, **self._rate_args(T, steps, for_lb=True)}
        price, (d_s, d_v, d_T, d_r) = jax.device_get(american_greeks_ad(
            params_T, spot, strike, T, k_eval, coefs,
            num_paths=self.num_paths, **kwargs))
        s_up, s_dn = spot * (1 + spot_bump), spot * (1 - spot_bump)
        deltas = jax.device_get(_american_delta_batch(
            params_T, [s_up, s_dn], strike, T, k_eval, coefs,
            num_paths=self.num_paths, **kwargs))
        sigma = float(np.sqrt(float(self.params.v0)))
        theta_val = -float(d_T)
        return {
            "price": float(price),
            "delta": float(d_s),
            "gamma": float((deltas[0] - deltas[1]) / (s_up - s_dn)),
            "ad_vega_v0": float(d_v),
            "vega_per_vol_point": float(d_v) * 2 * sigma,
            "theta_daily": theta_val,
            "theta_annual": theta_val * 252,
            "rho": float(d_r),
            "num_steps": steps,
        }

    def price_bounds(self, spot: float, strike: float, T: float,
                     is_call: bool = True, n_outer: int = 2048,
                     n_inner: int = 128) -> Dict[str, float]:
        """Bracket the American price: out-of-sample LSM lower bound +
        Haugh-Kogan/Andersen-Broadie dual upper bound, with the duality gap.

        Three independent path sets: policy training, lower-bound
        evaluation, and the dual's outer/inner simulation — so the lower
        bound is free of foresight bias and the bracket is honest.
        """
        steps = scaled_steps(self.num_steps, T, floor=16)
        if self.rate_curve is not None:
            raise ValueError(
                "price_bounds does not support rate curves; use price()/"
                "greeks() (exact curve-corrected LSM) instead")
        div_args = self._div_args(T, steps)
        if div_args:
            # The dual bound's nested one-step inner simulations would need
            # dividend-aware restarts at every (date, state); not wired yet.
            # Fail loudly instead of returning a silently-wrong bracket.
            raise ValueError(
                "price_bounds does not support discrete dividends; use "
                "price()/greeks() (exact compounded-cash LSM) instead")
        key = jax.random.key(self.seed)
        k_train, k_eval, k_dual = jax.random.split(key, 3)
        kwargs = dict(num_steps=steps, is_call=is_call,
                      basis_degree=self.basis_degree)
        coefs = lsm_train(self.params, spot, strike, T, k_train,
                          num_paths=self.num_paths, **kwargs)
        lo = jax.device_get(lsm_lower_bound(
            self.params, spot, strike, T, k_eval, coefs["policy"],
            num_paths=self.num_paths, **kwargs))
        hi = jax.device_get(dual_upper_bound(
            self.params, spot, strike, T, k_dual, coefs["value"],
            n_outer=n_outer, n_inner=n_inner, **kwargs))
        intrinsic = max(spot - strike, 0.0) if is_call \
            else max(strike - spot, 0.0)
        lower = max(float(lo["price"]), intrinsic)
        upper = float(hi["price"])
        return {
            "lower_bound": lower,
            "lower_se": float(lo["std_error"]),
            "upper_bound": upper,
            "upper_se": float(hi["std_error"]),
            "duality_gap": upper - lower,
            "price": 0.5 * (lower + upper),
            "num_steps": steps,
            "n_outer": n_outer,
            "n_inner": n_inner,
        }


def binomial_american_bs(S: float, K: float, T: float, r: float, q: float,
                         sigma: float, steps: int = 1000,
                         is_call: bool = True) -> float:
    """CRR binomial American price under Black-Scholes (host f64 oracle)."""
    dt = T / steps
    u = np.exp(sigma * np.sqrt(dt))
    d = 1.0 / u
    disc = np.exp(-r * dt)
    p = (np.exp((r - q) * dt) - d) / (u - d)
    if not (0.0 < p < 1.0):
        raise ValueError("unstable tree: reduce dt or vol")

    j = np.arange(steps + 1)
    prices = S * u ** (steps - j) * d ** j
    values = np.maximum(prices - K, 0.0) if is_call \
        else np.maximum(K - prices, 0.0)
    for n in range(steps - 1, -1, -1):
        j = np.arange(n + 1)
        prices = S * u ** (n - j) * d ** j
        values = disc * (p * values[:-1] + (1 - p) * values[1:])
        intrinsic = np.maximum(prices - K, 0.0) if is_call \
            else np.maximum(K - prices, 0.0)
        values = np.maximum(values, intrinsic)
    return float(values[0])


def american_cos_oracle(params: SVJParams, spot: float, strike: float,
                        T: float, is_call: bool = True) -> Dict:
    """Exact COS American under the Levy projection of `params`.

    Projection = Merton jump-diffusion with sigma = sqrt(v0) plus the SVJ
    jump leg — EXACT when xi = 0 and theta = v0 (frozen variance), the
    same desk convention as the CN exercise boundary's BS proxy
    (api/server.py handle_american with_boundary). Fourier-cosine backward
    induction + Richardson over the date ladder (ops/cos_bermudan.py):
    no paths, no regression — the oracle the LSM bounds are pinned to
    under jump dynamics."""
    from mcos_tpu.ops.cos_bermudan import american_cos, merton_model

    m = merton_model(float(params.v0) ** 0.5, float(params.lambda_j),
                     float(params.mu_j), float(params.sigma_j),
                     float(params.r), float(params.q))
    out = american_cos(m, spot, strike, T, is_call=is_call)
    out["note"] = ("exact COS American under the Merton projection "
                   "sigma=sqrt(v0) + the SVJ jump leg; exact when xi=0 "
                   "and theta=v0, a proxy otherwise (like with_boundary)")
    return out
