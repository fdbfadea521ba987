"""Device-mesh parallelism: path-sharded Monte Carlo with psum reductions.

The reference's only parallelism is shared-memory threading over MC paths
(`prange(num_paths)`, engine/monte_carlo.py:221-222) — single process, no
distributed backend (SURVEY.md §5.8). The equivalent built here:

- a `jax.sharding.Mesh` with a `"paths"` axis (optionally × `"batch"` for
  strike/contract data-parallelism),
- `shard_map` runs the per-device path simulation with a device-folded
  threefry key (no cross-device random reuse),
- the (count, Σpay, Σpay², ...) moment triple is reduced with `psum`,
  reproducing the single-chip price/stderr estimator bit-for-bit in
  expectation (monte_carlo.py:342-343 semantics),
- antithetic pairs and CRN stay device-local, so no resharding precedes the
  reduction.

Multi-host scaling uses standard JAX multi-process initialization (the
`"paths"` axis spans hosts); nothing here changes.

This module holds the INFRASTRUCTURE (`make_mesh`, `sharded_moments` /
`pool_moments` — the one moment-pooling combinator) plus the programs
whose pooling is genuinely different (gradient-sharing greeks, exact-tail
gathers, regression normal equations, batch partitioning). Every
moment-pooled model family driver lives in `parallel/families.py` as a
thin payoff function over the combinator.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from mcos_tpu.models.params import SVJParams
from mcos_tpu.ops import simulate
from mcos_tpu.ops.backend import SVJ_EULER_DRAWS, simulator_for
from mcos_tpu.ops.bs import bs_price

Array = jax.Array


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "paths") -> Mesh:
    """1-D mesh over all (or given) devices for path-parallel MC."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis_name,))


def make_mesh_2d(batch: int, devices: Optional[Sequence] = None,
                 axis_names=("batch", "paths")) -> Mesh:
    """2-D mesh: contract/strike batch axis × path axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(batch, -1), axis_names)


def _local_price_stats(params, spot, strikes, T, key, *,
                       paths_per_device, num_steps, is_call, antithetic,
                       control_variate, cv_mode, axis_name, scheme="euler"):
    """Per-device path simulation + local moment sums (runs inside shard_map)."""
    idx = jax.lax.axis_index(axis_name)
    dev_key = jax.random.fold_in(key, idx)
    want_g = control_variate and cv_mode == "companion"
    sim = (simulate.simulate_terminal_qe if scheme == "qe"
           else simulate.simulate_terminal)
    s_final, v_final, g_final = sim(
        params, spot, T, dev_key,
        num_paths=paths_per_device, num_steps=num_steps,
        antithetic=antithetic, companion=want_g,
    )
    pay = simulate.combine_antithetic(
        simulate.vanilla_payoff(
            s_final[None], strikes[:, None, None], is_call).swapaxes(0, 1))

    if control_variate:
        discount = jnp.exp(-params.r * jnp.asarray(T, jnp.float32))
        sigma_bs = jnp.sqrt(params.v0)
        bs_ref = bs_price(spot, strikes, T, params.r, params.q, sigma_bs,
                          is_call)
        if cv_mode == "companion":
            ctrl = simulate.combine_antithetic(
                simulate.vanilla_payoff(
                    g_final[None], strikes[:, None, None], is_call
                ).swapaxes(0, 1))
        else:  # reference arithmetic (biased; parity only)
            ctrl = simulate.vanilla_payoff(
                s_final[0][None], strikes[:, None], is_call)
        eff = pay - (ctrl - bs_ref[:, None] / discount)
    else:
        eff = pay

    n_local = jnp.float32(eff.shape[-1])
    stats = {
        "n": n_local,
        "sum": jnp.sum(eff, axis=-1),
        "sumsq": jnp.sum(eff * eff, axis=-1),
        "nonfinite": jnp.sum(~jnp.isfinite(s_final)).astype(jnp.float32),
    }
    stats = jax.tree.map(lambda x: jax.lax.psum(x, axis_name), stats)
    # Max pools as max, NOT psum (a summed per-device max would report
    # ~n_dev× the true value and fire spurious variance-explosion guards).
    # all_gather + max rather than pmax: sharded_all_greeks differentiates
    # through this function and pmax has no JVP rule; the gather is tiny
    # (one scalar per device) and v_max is a diagnostic, so cut the tape.
    stats["v_max"] = jnp.max(jax.lax.all_gather(
        jax.lax.stop_gradient(jnp.max(v_final)), axis_name))
    return stats


# ─────────────────────────────────────────────────────────────────────────────
# THE sharding combinator. Every moment-pooled driver in this module is the
# same shape — per-device payoffs on a device-folded key, psum'd moment
# sums, replicated pooling — so that shape lives HERE exactly once and a
# family driver supplies only its payoff function (one
# combinator, not the 19th hand-written wrapper). The reference has nothing
# on this axis (its one parallelism is prange threads, SURVEY.md §5.8).
# ─────────────────────────────────────────────────────────────────────────────
@lru_cache(maxsize=128)
def _sharded_moments_fn(payoff_fn, statics, mesh, n_args, axis_name):
    """Build-once jitted shard_map for `sharded_moments` (cached on the
    payoff function's identity + static config, the repo-wide discipline
    — a fresh closure per call would re-trace on every serving request)."""
    fn = partial(payoff_fn, **dict(statics)) if statics else payoff_fn

    def local(key_, *args_):
        idx = jax.lax.axis_index(axis_name)
        dev_key = jax.random.fold_in(key_, idx)
        out = fn(dev_key, *args_)
        eff, ctrl, aux = out if isinstance(out, tuple) else (out, None, {})
        n = jnp.float32(eff.shape[-1])
        if ctrl is None:
            sums = {"n": n,
                    "sum": jnp.sum(eff, axis=-1),
                    "sumsq": jnp.sum(eff * eff, axis=-1)}
        else:  # optimal-β CV cross-moments (pooled _cv_adjust estimator)
            sums = {"n": n,
                    "sum_p": jnp.sum(eff, axis=-1),
                    "sumsq_p": jnp.sum(eff * eff, axis=-1),
                    "sum_c": jnp.sum(ctrl, axis=-1),
                    "sumsq_c": jnp.sum(ctrl * ctrl, axis=-1),
                    "sum_pc": jnp.sum(eff * ctrl, axis=-1)}
        sums.update({k: v for k, v in aux.items() if k != "v_max"})
        sums = jax.tree.map(lambda x: jax.lax.psum(x, axis_name), sums)
        if "v_max" in aux:
            sums["v_max"] = jax.lax.pmax(aux["v_max"], axis_name)
        return sums

    spec = P()
    return jax.jit(jax.shard_map(local, mesh=mesh,
                                 in_specs=(spec,) * (n_args + 1),
                                 out_specs=spec, check_vma=False))


def sharded_moments(payoff_fn, key, args, *, mesh, statics=(),
                    axis_name: str = "paths") -> Dict[str, Array]:
    """Pool `payoff_fn`'s per-device payoffs into psum'd global moments.

    `payoff_fn(dev_key, *args, **dict(statics))` runs inside shard_map on
    a key folded by device index and returns one of:

    - ``eff``                 — effective payoffs, LAST axis = the
      per-device path axis (leading axes, e.g. a strike vector, ride
      along); pooled as (n, Σ, Σ²),
    - ``(eff, ctrl, aux)``    — ``ctrl`` (or None) adds the optimal-β
      control-variate cross-moments (pool with
      ``pool_moments(..., ctrl_exact=...)``); ``aux`` is a dict of extra
      per-device scalars — key ``"v_max"`` pools by pmax, everything
      else by psum.

    payoff_fn MUST be a module-level function and `statics` a hashable
    tuple of (name, value) kwargs: the jitted shard_map is cached on
    (payoff_fn, statics, mesh) — the DE-objective discipline (CLAUDE.md),
    or every call would re-trace. `args` are traced pytrees, replicated
    into the shard_map (per-path data never crosses hosts; only the
    O(strikes) moment sums ride the interconnect).
    """
    return _sharded_moments_fn(payoff_fn, tuple(statics), mesh,
                               len(args), axis_name)(key, *args)


def pool_moments(stats: Dict[str, Array], discount=1.0,
                 ctrl_exact=None) -> Dict[str, Array]:
    """Replicated psum'd sums → price/std_error — the single-chip
    estimator (monte_carlo.py:342-343 semantics) reassembled exactly.

    With CV cross-moments present, ``ctrl_exact`` is the control's exact
    expectation in UNdiscounted payoff units (`_pooled_cv_price`)."""
    out = {"num_paths_used": stats["n"]}
    if "sum_c" in stats:
        mean, se, beta = _pooled_cv_price(stats, ctrl_exact)
        out["cv_beta"] = beta
    else:
        n = stats["n"]
        mean = stats["sum"] / n
        se = jnp.sqrt(
            jnp.maximum(stats["sumsq"] / n - mean * mean, 0.0) / n)
    out["price"] = discount * mean
    out["std_error"] = discount * se
    if "v_max" in stats:
        out["v_max"] = stats["v_max"]
    return out


def sharded_portfolio_returns(
    spots,
    sigmas,
    corr,
    weights,
    T,
    key: Array,
    *,
    mesh: Mesh,
    num_paths: int,
    num_steps: int,
    r: float,
    q: float,
    tail_quota: int,
    axis_name: str = "paths",
) -> Dict[str, Array]:
    """Correlated-GBM portfolio returns, path-sharded, with a distributed
    exact-tail reduction.

    Per device: simulate `num_paths / n_dev` paths (device-folded key), form
    portfolio returns, psum the raw moment sums, and contribute its local
    worst `tail_quota` returns via all_gather. The global worst-k order
    statistics (k ≤ tail_quota) are a subset of the union of per-device
    worst-`tail_quota` sets whenever no single device holds more than
    `tail_quota` of them — guaranteed when tail_quota ≥ k, and true with
    overwhelming probability for tail_quota ≳ 1.5·k/n_dev + O(√k) under iid
    sampling (the caller sizes the quota; see risk.portfolio_var).

    Returns replicated arrays: n, sum1..sum4 (raw moment sums) and
    `tail` — the (n_dev · tail_quota,) gathered worst returns.
    """
    from mcos_tpu.engine.risk import multi_asset_gbm_terminal

    n_dev = mesh.shape[axis_name]
    paths_per_device = -(-num_paths // n_dev)
    quota = min(tail_quota, paths_per_device)

    def local(spots_, sigmas_, corr_, weights_, T_, key_):
        idx = jax.lax.axis_index(axis_name)
        dev_key = jax.random.fold_in(key_, idx)
        s_t = multi_asset_gbm_terminal(
            spots_, sigmas_, corr_, r, q, T_, dev_key,
            num_paths=paths_per_device, num_steps=num_steps)
        rel = s_t / spots_[None, :] - 1.0
        returns = rel @ weights_

        n = jnp.float32(returns.shape[0])
        sums = {
            "n": n,
            "sum1": jnp.mean(returns) * n,       # pairwise-accurate means
            "sum2": jnp.mean(returns**2) * n,
            "sum3": jnp.mean(returns**3) * n,
            "sum4": jnp.mean(returns**4) * n,
        }
        sums = jax.tree.map(lambda x: jax.lax.psum(x, axis_name), sums)
        # Local worst `quota` returns (most negative first), then gather.
        worst = -jax.lax.top_k(-returns, quota)[0]
        sums["tail"] = jax.lax.all_gather(
            worst, axis_name, tiled=True)
        return sums

    spec = P()
    shmapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec,) * 6,
        out_specs=spec,
        check_vma=False,
    )
    return jax.jit(shmapped)(
        jnp.asarray(spots, jnp.float32), jnp.asarray(sigmas, jnp.float32),
        jnp.asarray(corr, jnp.float32), jnp.asarray(weights, jnp.float32),
        jnp.float32(T), key)


@lru_cache(maxsize=64)
def _sharded_price_fn(mesh, paths_per_device, num_steps, is_call, antithetic,
                      control_variate, cv_mode, scheme, axis_name):
    """Build-once jitted shard_map for `sharded_price` (Mesh is hashable)."""
    local = partial(
        _local_price_stats,
        paths_per_device=paths_per_device, num_steps=num_steps,
        is_call=is_call, antithetic=antithetic,
        control_variate=control_variate, cv_mode=cv_mode, scheme=scheme,
        axis_name=axis_name,
    )
    # Everything is replicated in; reductions produce replicated outputs.
    spec = P()
    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    ))


def sharded_price(
    params: SVJParams,
    spot,
    strikes,
    T,
    key: Array,
    *,
    mesh: Mesh,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    antithetic: bool = True,
    control_variate: bool = True,
    cv_mode: str = "companion",
    scheme: str = "euler",
    axis_name: str = "paths",
) -> Dict[str, Array]:
    """Mesh-sharded European pricing; same estimator as `mc_price_core`.

    `num_paths` is the *global* path count; it is split evenly over the
    `axis_name` mesh axis (rounded up to a device multiple).
    """
    n_dev = mesh.shape[axis_name]
    paths_per_device = -(-num_paths // n_dev)
    strikes = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))

    # The jitted shard_map is cached on (mesh, static config) — a fresh
    # closure + jax.jit per call would defeat the executable cache (keyed
    # on function identity) and re-trace on EVERY serving request.
    stats = _sharded_price_fn(
        mesh, paths_per_device, num_steps, is_call, antithetic,
        control_variate, cv_mode, scheme, axis_name)(
        params, jnp.float32(spot), strikes, jnp.float32(T), key)

    discount = jnp.exp(-jnp.asarray(params.r, jnp.float32)
                       * jnp.asarray(T, jnp.float32))
    n = stats["n"]
    mean = stats["sum"] / n
    var = jnp.maximum(stats["sumsq"] / n - mean * mean, 0.0)
    out = {
        "price": discount * mean,
        "std_error": discount * jnp.sqrt(var / n),
        "num_paths_used": n,
        "v_max": stats["v_max"],
        # nonfinite counts every simulated terminal spot (both antithetic
        # branches); normalize to a fraction of spots, matching
        # mc_price_core's jnp.mean(~isfinite(s_final)) convention.
        "frac_nonfinite": stats["nonfinite"] / ((2.0 if antithetic else 1.0)
                                                * n),
    }
    if control_variate:
        # eff already includes +bs_ref/discount, so `price` is the CV price.
        out["bs_ref"] = bs_price(spot, strikes, T, params.r, params.q,
                                 jnp.sqrt(params.v0), is_call)
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Engine-wide sharding: greeks / exotics / HHW / SLV / Sobol-QMC
# (the reference's one parallelism axis — paths — made first-class across
# the whole engine surface, SURVEY.md §5.8)
# ─────────────────────────────────────────────────────────────────────────────
def sharded_all_greeks(
    params: SVJParams,
    spot,
    strike,
    T,
    key: Array,
    *,
    mesh: Mesh,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    bump: float = 0.01,
    lambda_bump: float = 0.1,
    axis_name: str = "paths",
) -> Dict[str, float]:
    """All Greeks with the path simulation sharded over the mesh.

    `jax.grad` THROUGH `shard_map`: the backward pass of the psum'd moment
    pooling is itself a psum, so one value_and_grad over the sharded
    CV-adjusted price yields price + delta + theta + rho + the full
    ∂P/∂params pytree with every path-simulation flop distributed. Gamma is
    the central CRN difference of the sharded AD delta (same estimator as
    GreeksEngine.gamma — second-order pathwise AD of a kinked payoff is
    biased); ∂P/∂λ is a CRN forward difference (the jump indicator has zero
    pathwise derivative). Key conventions match engine/greeks.py exactly so
    the two paths are interchangeable.
    """
    n_dev = mesh.shape[axis_name]
    ppd = -(-num_paths // n_dev)
    strikes = jnp.atleast_1d(jnp.asarray(strike, jnp.float32))

    local = partial(
        _local_price_stats,
        paths_per_device=ppd, num_steps=num_steps, is_call=is_call,
        antithetic=True, control_variate=True, cv_mode="companion",
        axis_name=axis_name)
    spec = P()
    shmapped = jax.shard_map(local, mesh=mesh, in_specs=(spec,) * 5,
                             out_specs=spec, check_vma=False)

    def scalar_price(params_, spot_, T_):
        stats = shmapped(params_, spot_, strikes, T_, key)
        discount = jnp.exp(-params_.r * T_)
        return (discount * stats["sum"] / stats["n"])[0]

    def everything(params_, spot_, T_):
        price, (d_params, d_spot, d_T) = jax.value_and_grad(
            scalar_price, argnums=(0, 1, 2))(params_, spot_, T_)
        d_up = jax.grad(scalar_price, argnums=1)(
            params_, spot_ * (1.0 + bump), T_)
        d_dn = jax.grad(scalar_price, argnums=1)(
            params_, spot_ * (1.0 - bump), T_)
        gamma = (d_up - d_dn) / (2.0 * spot_ * bump)
        lam = params_.lambda_j
        lam_up = lam + lambda_bump
        lam_dn = jnp.maximum(lam - lambda_bump, 0.0)
        p_up = scalar_price(params_.replace(lambda_j=lam_up), spot_, T_)
        p_dn = scalar_price(params_.replace(lambda_j=lam_dn), spot_, T_)
        lam_fd = (p_up - p_dn) / jnp.maximum(lam_up - lam_dn, 1e-12)
        return {"price": price, "delta": d_spot, "d_T": d_T,
                "d_params": d_params, "gamma": gamma, "lambda_j": lam_fd}

    out = jax.device_get(jax.jit(everything)(
        params, jnp.float32(spot), jnp.float32(T)))
    d_params = out["d_params"]
    sigma = float(np.sqrt(float(params.v0)))
    return {
        "price": float(out["price"]),
        "delta": float(out["delta"]),
        "gamma": float(out["gamma"]),
        "vega_per_vol_point": float(d_params.v0) * 2.0 * sigma,
        "ad_vega_v0": float(d_params.v0),
        "theta_daily": -float(out["d_T"]),   # reference key convention
        "rho": float(d_params.r),
        "lambda_j": float(out["lambda_j"]),
        "mu_j": float(d_params.mu_j),
        "sigma_j": float(d_params.sigma_j),
        "kappa": float(d_params.kappa),
        "theta": float(d_params.theta),
        "xi": float(d_params.xi),
        "rho_corr": float(d_params.rho),
        "num_devices": int(n_dev),
    }


def _pooled_cv_price(stats: Dict[str, Array], ctrl_exact):
    """(mean, stderr, β|None) from psum'd (n, Σp, Σp², [Σc, Σc², Σpc])
    moments with the optimal-β control variate computed on the POOLED
    sample — exactly the single-device `_cv_adjust` estimator
    (engine/exotics.py:43-55), reassembled from sums."""
    n = stats["n"]
    mean_p = stats["sum_p"] / n
    var_p = jnp.maximum(stats["sumsq_p"] / n - mean_p**2, 0.0)
    if ctrl_exact is None:
        return mean_p, jnp.sqrt(var_p / n), None
    mean_c = stats["sum_c"] / n
    var_c = jnp.maximum(stats["sumsq_c"] / n - mean_c**2, 0.0)
    cov = stats["sum_pc"] / n - mean_p * mean_c
    beta = jnp.where(var_c > 1e-12, cov / jnp.maximum(var_c, 1e-12), 0.0)
    mean_adj = mean_p - beta * (mean_c - ctrl_exact)
    # var(p−βc) at β* = var_p − cov²/var_c = var_p − β·cov
    var_adj = jnp.maximum(var_p - beta * cov, 0.0)
    return mean_adj, jnp.sqrt(var_adj / n), beta


def sharded_exotic_price(
    params: SVJParams,
    spot,
    strike,
    T,
    key: Array,
    barrier=0.0,
    *,
    mesh: Mesh,
    kind: str,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    averaging: str = "arithmetic",
    knock: str = "out",
    direction: str = "up",
    floating: bool = False,
    one_touch: bool = False,
    control_variate: bool = True,
    axis_name: str = "paths",
    monitoring: str = "discrete",
    bridge_ctrl_exact: float = 0.0,
    barrier_lo=0.0,
    rebate=0.0,
    window=None,
) -> Dict[str, Array]:
    """Mesh-sharded exotic pricing (Asian/barrier/lookback/double-barrier).

    Each device runs the fused path-functional scan
    (ops/exotics.py:simulate_path_stats) on its slice with a device-folded
    key; the payoff/control algebra is the SAME code as the single-device
    engine (engine/exotics.py:exotic_payoff_and_control), and the
    optimal-β control variate is computed from the psum-pooled
    (n, Σp, Σp², Σc, Σc², Σpc) moments — identical to the single-device
    estimator evaluated on the union sample.
    """
    from mcos_tpu.engine.exotics import exotic_payoff_and_control
    from mcos_tpu.ops import exotics as ops_exotics

    n_dev = mesh.shape[axis_name]
    ppd = -(-num_paths // n_dev)

    def local(params_, spot_, strike_, T_, barrier_, barrier_lo_, rebate_,
              key_):
        idx = jax.lax.axis_index(axis_name)
        dev_key = jax.random.fold_in(key_, idx)
        stats = ops_exotics.simulate_path_stats(
            params_, spot_, T_, dev_key, num_paths=ppd,
            num_steps=num_steps, antithetic=True,
            companion=control_variate,
            bridge=(monitoring == "bridge"), bridge_up=(direction == "up"),
            bridge_log_b=jnp.log(jnp.maximum(barrier_, 1e-30)
                                 / jnp.asarray(spot_, jnp.float32)),
            corridor=(kind == "double_barrier" and monitoring == "bridge"),
            bridge_log_l=jnp.log(jnp.maximum(barrier_lo_, 1e-30)
                                 / jnp.asarray(spot_, jnp.float32)),
            window=window)
        pay_b, ctrl_b, ctrl_exact = exotic_payoff_and_control(
            stats, params_, spot_, strike_, T_, barrier_, kind=kind,
            num_steps=num_steps, is_call=is_call, averaging=averaging,
            knock=knock, direction=direction, floating=floating,
            one_touch=one_touch, control_variate=control_variate,
            monitoring=monitoring, bridge_ctrl_exact=bridge_ctrl_exact,
            barrier_lo=barrier_lo_, rebate=rebate_)
        pay = simulate.combine_antithetic(pay_b)
        sums = {"n": jnp.float32(pay.shape[0]),
                "sum_p": jnp.sum(pay), "sumsq_p": jnp.sum(pay * pay)}
        if ctrl_b is not None:
            ctrl = simulate.combine_antithetic(ctrl_b)
            sums.update(sum_c=jnp.sum(ctrl), sumsq_c=jnp.sum(ctrl * ctrl),
                        sum_pc=jnp.sum(pay * ctrl))
        sums = jax.tree.map(lambda x: jax.lax.psum(x, axis_name), sums)
        sums["ctrl_exact"] = (ctrl_exact if ctrl_exact is not None
                              else jnp.float32(jnp.nan))
        return sums

    spec = P()
    shmapped = jax.shard_map(local, mesh=mesh, in_specs=(spec,) * 8,
                             out_specs=spec, check_vma=False)
    stats = jax.jit(shmapped)(
        params, jnp.float32(spot), jnp.float32(strike), jnp.float32(T),
        jnp.float32(barrier), jnp.float32(barrier_lo), jnp.float32(rebate),
        key)
    discount = jnp.exp(-jnp.asarray(params.r, jnp.float32)
                       * jnp.asarray(T, jnp.float32))
    has_cv = "sum_c" in stats
    mean, se, beta = _pooled_cv_price(
        stats, stats["ctrl_exact"] if has_cv else None)
    out = {"price": discount * mean, "std_error": discount * se,
           "num_paths_used": stats["n"]}
    if beta is not None:
        out["cv_beta"] = beta
    return out


def sharded_sobol_price(
    params: SVJParams,
    spot,
    strikes,
    T,
    *,
    mesh: Mesh,
    num_paths: int,
    num_steps: int,
    seed: int = 42,
    is_call: bool = True,
    control_variate: bool = True,
    scramble: str = "owen",
    axis_name: str = "paths",
) -> Dict[str, Array]:
    """Mesh-sharded scrambled-Sobol QMC pricing (the serving default
    driver, scaled past one chip).

    ONE global Owen-scrambled Sobol sequence of 2^m ≥ num_paths points is
    partitioned by index: device i generates points
    [i·ppd, (i+1)·ppd) via the offset XOR expansion
    (ops/sobol.py:sobol_svj_draws_slice) — the device union IS the
    single-host point set, so the estimator keeps full QMC convergence
    instead of degrading to pooled short streams. The Brownian-bridge
    matrix is replicated (a few KB of static data); jump-occurrence
    uniforms come from a device-folded threefry stream (they carry no QMC
    structure — monte_carlo.py:306-308 uses a plain PRNG too). Fixes the
    single-host limitation documented at engine/pricer.py:32-35.
    """
    n_dev = mesh.shape[axis_name]
    m = int(np.ceil(np.log2(max(num_paths, 2))))
    n_global = 2 ** m
    if n_global % n_dev:
        raise ValueError(f"2^{m} Sobol points do not split over {n_dev} "
                         "devices — use a power-of-two device count")
    ppd = n_global // n_dev
    strikes = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))

    stats = _sharded_sobol_fn(
        mesh, ppd, n_global, num_steps, seed, is_call, control_variate,
        scramble, axis_name)(
        params, jnp.float32(spot), strikes, jnp.float32(T))
    discount = jnp.exp(-jnp.asarray(params.r, jnp.float32)
                       * jnp.asarray(T, jnp.float32))
    n = stats["n"]
    mean = stats["sum"] / n
    var = jnp.maximum(stats["sumsq"] / n - mean * mean, 0.0)
    out = {"price": discount * mean,
           "std_error": discount * jnp.sqrt(var / n),
           "num_paths_used": n,
           "v_max": stats["v_max"],
           "frac_nonfinite": stats["nonfinite"] / (2.0 * n)}
    if control_variate:
        out["bs_ref"] = bs_price(spot, strikes, T, params.r, params.q,
                                 jnp.sqrt(params.v0), is_call)
    return out


@lru_cache(maxsize=64)
def _sharded_sobol_fn(mesh, ppd, n_global, num_steps, seed, is_call,
                      control_variate, scramble, axis_name):
    """Build-once jitted shard_map for `sharded_sobol_price` — a fresh
    closure per call would re-trace on every multi-chip serving request.
    seed stays in the cache key (serving reuses one seed; rqmc's handful
    of replicate seeds each cache their own trace)."""
    from mcos_tpu.ops.sobol import sobol_svj_draws_slice

    want_g = control_variate

    def local(params_, spot_, ks_, T_):
        idx = jax.lax.axis_index(axis_name)
        offset = idx.astype(jnp.uint32) * jnp.uint32(ppd)
        z1, z2, _, z_js = sobol_svj_draws_slice(
            ppd, n_global, offset, num_steps, seed=seed, scramble=scramble)
        u_jump = jax.random.uniform(
            jax.random.fold_in(jax.random.key(seed + 1), idx),
            (num_steps, ppd), jnp.float32)
        s_final, v_final, g_final = simulator_for(SVJ_EULER_DRAWS)(
            params_, spot_, T_, z1, z2, u_jump, z_js, antithetic=True,
            companion=want_g)
        pay = simulate.combine_antithetic(
            simulate.vanilla_payoff(
                s_final[None], ks_[:, None, None], is_call).swapaxes(0, 1))
        if control_variate:
            discount = jnp.exp(-params_.r * T_)
            bs_ref = bs_price(spot_, ks_, T_, params_.r, params_.q,
                              jnp.sqrt(params_.v0), is_call)
            ctrl = simulate.combine_antithetic(
                simulate.vanilla_payoff(
                    g_final[None], ks_[:, None, None],
                    is_call).swapaxes(0, 1))
            eff = pay - (ctrl - bs_ref[:, None] / discount)
        else:
            eff = pay
        sums = {"n": jnp.float32(eff.shape[-1]),
                "sum": jnp.sum(eff, axis=-1),
                "sumsq": jnp.sum(eff * eff, axis=-1),
                "nonfinite": jnp.sum(~jnp.isfinite(s_final))
                .astype(jnp.float32)}
        sums = jax.tree.map(lambda x: jax.lax.psum(x, axis_name), sums)
        # pmax, not psum: see _local_price_stats. These diagnostics feed the
        # post-price guards (nonfinite_paths is a FAIL rule) — the sharded
        # route must not silently disable them.
        sums["v_max"] = jax.lax.pmax(jnp.max(v_final), axis_name)
        return sums

    spec = P()
    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,) * 4,
                                 out_specs=spec, check_vma=False))


# ─────────────────────────────────────────────────────────────────────────────
# Time-dependent SVJ (piecewise-constant θ/ξ/λ — ops/tdsvj.py)
# ─────────────────────────────────────────────────────────────────────────────
@lru_cache(maxsize=64)
def _sharded_american_fn(mesh, ppd, num_steps, is_call, basis_degree,
                         exercise_every, axis_name):
    """Build-once jitted shard_map for `sharded_american_price`."""
    from mcos_tpu.engine.american import (_basis_fn, _exercise_mask,
                                          _payoff_fn, _record_log_paths,
                                          lsm_backward_cashflows)

    allowed = jnp.asarray(_exercise_mask(num_steps, exercise_every))

    def local(params_, spot_, strike_, T_, key_):
        idx = jax.lax.axis_index(axis_name)
        dev_key = jax.random.fold_in(key_, idx)
        dtype = jnp.float32
        strike_ = jnp.asarray(strike_, dtype)
        dt = jnp.asarray(T_, dtype) / num_steps
        payoff = _payoff_fn(strike_, is_call)
        basis = _basis_fn(strike_, is_call, basis_degree)
        s = jnp.exp(_record_log_paths(params_, spot_, T_, dev_key,
                                      num_paths=ppd, num_steps=num_steps))
        sdf = jnp.full((num_steps,), jnp.exp(-params_.r * dt))
        cf = lsm_backward_cashflows(
            payoff(s[-1]), s, s, allowed, sdf, payoff, basis,
            pool=lambda blk: jax.lax.psum(blk, axis_name))
        sums = {"n": jnp.float32(cf.shape[0]),
                "sum": jnp.sum(cf), "sumsq": jnp.sum(cf * cf)}
        return jax.tree.map(lambda x: jax.lax.psum(x, axis_name), sums)

    spec = P()
    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,) * 5,
                                 out_specs=spec, check_vma=False))


def sharded_american_price(
    params: SVJParams,
    spot,
    strike,
    T,
    key: Array,
    *,
    mesh: Mesh,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    basis_degree: int = 3,
    exercise_every: int = 1,
    axis_name: str = "paths",
) -> Dict[str, float]:
    """Mesh-sharded Longstaff-Schwartz American pricing.

    Distributed LSM: each device records its own key-folded slice of the
    path sheet, and the per-date continuation regression pools the normal
    equations — psum of the stacked ``[gram | rhs]`` (d×(d+1)) moment block,
    ~150 bytes per exercise date — so every device fits the IDENTICAL
    regression a single device would fit on the union path set (normal
    equations are linear in per-path outer products; the algebra is
    `engine/american.py:lsm_backward_cashflows` itself, not a twin).
    Exercise decisions and cashflows stay device-local; the final
    (n, Σcf, Σcf²) pools like every other driver. The one cross-device
    coupling an American option genuinely needs — the regression — rides
    the interconnect at O(basis²) bytes per date, independent of path count.
    """
    n_dev = mesh.shape[axis_name]
    ppd = -(-num_paths // n_dev)
    stats = _sharded_american_fn(
        mesh, ppd, num_steps, is_call, basis_degree,
        min(int(exercise_every), num_steps), axis_name)(
        params, jnp.float32(spot), jnp.float32(strike), jnp.float32(T), key)
    stats = jax.device_get(stats)
    n = float(stats["n"])
    mean = float(stats["sum"]) / n
    var = max(float(stats["sumsq"]) / n - mean * mean, 0.0)
    intrinsic = max(spot - strike, 0.0) if is_call \
        else max(strike - spot, 0.0)
    # t_0 intrinsic floor only when t_0-style exercise exists (American
    # schedule) — same convention as lsm_price.
    price = max(mean, intrinsic) if exercise_every == 1 else mean
    return {
        "price": price,
        "std_error": float(np.sqrt(var / n)),
        "mc_continuation": mean,
        "intrinsic": intrinsic,
        "num_paths_used": n,
        "num_devices": int(n_dev),
    }


# ─────────────────────────────────────────────────────────────────────────────
# Sharded MLMC (levels and paths are embarrassingly parallel)
# ─────────────────────────────────────────────────────────────────────────────
@lru_cache(maxsize=64)
def _sharded_mlmc_level_fn(mesh, ppd, level, base_steps, is_call, axis_name):
    """Build-once jitted shard_map for one MLMC level at ppd paths/device."""
    from mcos_tpu.engine.mlmc import _coupled_level, _level_zero

    def local(params_, spot_, strike_, T_, key_):
        idx = jax.lax.axis_index(axis_name)
        dev_key = jax.random.fold_in(key_, idx)
        if level == 0:
            m, m2 = _level_zero(params_, spot_, strike_, T_, dev_key,
                                num_paths=ppd, num_steps=base_steps,
                                is_call=is_call)
        else:
            m, m2 = _coupled_level(
                params_, spot_, strike_, T_, dev_key, num_paths=ppd,
                num_coarse_steps=base_steps * 2 ** (level - 1),
                is_call=is_call)
        n = jnp.float32(ppd)
        sums = {"n": n, "sum": m * n, "sumsq": m2 * n}
        return jax.tree.map(lambda x: jax.lax.psum(x, axis_name), sums)

    spec = P()
    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,) * 5,
                                 out_specs=spec, check_vma=False))


def sharded_mlmc_price(
    params: SVJParams,
    spot,
    strike,
    T,
    *,
    mesh: Mesh,
    is_call: bool = True,
    eps: float = 0.05,
    base_steps: int = 4,
    max_levels: int = 8,
    pilot_paths: int = 8_192,
    max_paths_per_level: int = 4_000_000,
    seed: int = 0,
    axis_name: str = "paths",
) -> Dict[str, object]:
    """Mesh-sharded multilevel Monte Carlo (engine/mlmc.py over a mesh).

    Each Giles level's correction estimator is an iid mean — the textbook
    path-sharded workload: every device runs `n/n_dev` coupled fine/coarse
    pairs with a device-folded key and the (n, Σ, Σ²) triple pools by
    psum (the exact-moment-pooling discipline of every driver here). The
    Giles allocation loop itself (`engine/mlmc.py:giles_driver`) is shared
    VERBATIM with the single-device entry — only run_level differs. Path
    counts round to power-of-two × n_dev so jit shapes stay bounded.
    """
    n_dev = mesh.shape[axis_name]
    rng_root = jax.random.key(seed)
    from mcos_tpu.engine.mlmc import giles_driver

    def run_level(level: int, n: int):
        n = int(min(max(n, 256 * n_dev), max_paths_per_level))
        n = 1 << int(np.ceil(np.log2(n)))
        ppd = max(n // n_dev, 1)
        key = jax.random.fold_in(rng_root, level * 1000 + n % 997)
        stats = _sharded_mlmc_level_fn(
            mesh, ppd, level, base_steps, is_call, axis_name)(
            params, jnp.float32(spot), jnp.float32(strike),
            jnp.float32(T), key)
        stats = jax.device_get(stats)
        n_used = float(stats["n"])
        return int(n_used), float(stats["sum"]) / n_used, \
            float(stats["sumsq"]) / n_used

    out = giles_driver(run_level, eps=eps, base_steps=base_steps,
                       max_levels=max_levels, pilot_paths=pilot_paths)
    out["num_devices"] = int(n_dev)
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Sharded XVA exposure profile (THE 1e6-path × long-horizon
# workload multi-chip exists for)
# ─────────────────────────────────────────────────────────────────────────────
@lru_cache(maxsize=64)
def _sharded_exposure_fn(mesh, ppd, quota, axis_name):
    """Build-once jitted shard_map for `sharded_exposure_profile`."""
    from mcos_tpu.engine.exposure import _exposure_values

    def local(spots_, sigmas_, chol_, r_, q_, dates_, key_, kind_, strike_,
              mat_, qty_, asset_):
        idx = jax.lax.axis_index(axis_name)
        dev_key = jax.random.fold_in(key_, idx)
        net, gross, _ = _exposure_values(
            spots_, sigmas_, chol_, r_, q_, dates_, dev_key, kind_,
            strike_, mat_, qty_, asset_, num_paths=ppd)
        pos = jnp.maximum(net, 0.0)                       # (dates, ppd)
        n = jnp.float32(ppd)
        sums = {
            "n": n,
            "ee_sum": jnp.mean(pos, axis=1) * n,          # pairwise means
            "ene_sum": jnp.mean(jnp.maximum(-net, 0.0), axis=1) * n,
            "gross_sum": jnp.mean(jnp.maximum(gross, 0.0), axis=1) * n,
        }
        sums = jax.tree.map(lambda x: jax.lax.psum(x, axis_name), sums)
        # Per-date local top-`quota` exposures; the global top-k (k ≤
        # quota) is a subset of the union — same exact-tail discipline as
        # sharded_portfolio_returns.
        sums["tail"] = jax.lax.all_gather(
            jax.lax.top_k(pos, quota)[0], axis_name, axis=1, tiled=True)
        return sums

    spec = P()
    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,) * 12,
                                 out_specs=spec, check_vma=False))


def sharded_exposure_profile(
    engine,
    *,
    mesh: Mesh,
    num_dates: int = 32,
    horizon: Optional[float] = None,
    quantile: float = 0.975,
    num_paths: Optional[int] = None,
    axis_name: str = "paths",
) -> Dict[str, object]:
    """Mesh-sharded EE/ENE/PFE/EPE profile for an `ExposureEngine` book.

    The date-grid scan is O(dates) and identical on every device; the path
    axis — the expensive one (a CVA desk wants 1e6+ paths over multi-year
    horizons) — shards across the mesh with device-folded keys. EE/ENE/
    gross pool as exact moment sums; the PFE quantile pools by the
    exact-tail union: each device contributes its local worst
    `quota ≥ 1.6·k/n_dev + 64` exposures per date, and the global k-th
    order statistic is read off the gathered union (guaranteed exact when
    no device holds more than `quota` of the global top-k; quota is sized
    so that holds with overwhelming probability, and deterministically
    whenever quota ≥ k).

    Output matches `ExposureEngine.profile` (uncollateralized; CSA paths
    stay on the single-device engine).
    """
    mat = engine.pos_arrays[2]
    horizon = float(horizon or mat.max())
    n_dev = mesh.shape[axis_name]
    total = int(num_paths or engine.num_paths)
    ppd = -(-total // n_dev)
    k = max(int(np.ceil((1.0 - quantile) * ppd * n_dev)), 1)
    quota = int(min(ppd, max(np.ceil(1.6 * k / n_dev) + 64, 64)))
    dates = np.linspace(horizon / num_dates, horizon,
                        num_dates).astype(np.float32)
    kind, strike, mat_a, qty, asset = engine.pos_arrays
    stats = _sharded_exposure_fn(mesh, ppd, quota, axis_name)(
        jnp.asarray(engine.spots), jnp.asarray(engine.sigmas),
        jnp.asarray(engine.chol), jnp.float32(engine.r),
        jnp.asarray(engine.q), jnp.asarray(dates),
        jax.random.key(engine.seed), jnp.asarray(kind),
        jnp.asarray(strike), jnp.asarray(mat_a), jnp.asarray(qty),
        jnp.asarray(asset))
    stats = jax.device_get(stats)
    n = float(stats["n"])
    ee = np.asarray(stats["ee_sum"]) / n
    ene = np.asarray(stats["ene_sum"]) / n
    gross_ee = np.asarray(stats["gross_sum"]) / n
    tail = np.sort(np.asarray(stats["tail"]), axis=1)[:, ::-1]
    k_eff = min(max(int(np.ceil((1.0 - quantile) * n)), 1), tail.shape[1])
    pfe = tail[:, k_eff - 1]
    disc = np.exp(-engine.r * dates)
    return {
        "dates": dates.tolist(),
        "ee": ee.tolist(),
        "ene": ene.tolist(),
        "pfe": pfe.tolist(),
        "pfe_quantile": quantile,
        "gross_ee": gross_ee.tolist(),
        "epe": float(np.mean(disc * ee)),
        "ene_avg": float(np.mean(disc * ene)),
        "netting_benefit": float(np.mean(disc * (gross_ee - ee))),
        "num_paths_used": int(n),
        "num_devices": int(n_dev),
    }


# ─────────────────────────────────────────────────────────────────────────────
# Sharded basket-American duality bracket (the dual's nested
# inner simulations are the n_outer × n_inner × n_ex × sub-steps workload)
# ─────────────────────────────────────────────────────────────────────────────
@lru_cache(maxsize=64)
def _sharded_bounds_fn(mesh, ppd_lo, ppd_hi, n_inner, n_ex,
                       steps_per_period, kind, is_call, has_weights,
                       axis_name):
    """Build-once jitted shard_map for `sharded_basket_bounds`."""
    from mcos_tpu.engine.basket_american import (_dual_pairs,
                                                 _lower_bound_pairs)

    def local(params_, spots_, chol_, strike_, T_, r_num_, key_lo, key_hi,
              coefs_p, coefs_v, weights_):
        idx = jax.lax.axis_index(axis_name)
        w = weights_ if has_weights else None
        lo_pair = _lower_bound_pairs(
            params_, spots_, chol_, strike_, T_, r_num_,
            jax.random.fold_in(key_lo, idx), coefs_p, num_paths=ppd_lo,
            n_ex=n_ex, steps_per_period=steps_per_period, kind=kind,
            is_call=is_call, weights=w)
        hi_pair = _dual_pairs(
            params_, spots_, chol_, strike_, T_, r_num_,
            jax.random.fold_in(key_hi, idx), coefs_v, n_outer=ppd_hi,
            n_inner=n_inner, n_ex=n_ex,
            steps_per_period=steps_per_period, kind=kind,
            is_call=is_call, weights=w)
        sums = {}
        for tag, pair, n in (("lo", lo_pair, ppd_lo),
                             ("hi", hi_pair, ppd_hi)):
            sums[tag] = {"n": jnp.float32(n),
                         "sum": jnp.mean(pair) * n,
                         "sumsq": jnp.mean(pair * pair) * n}
        return jax.tree.map(lambda x: jax.lax.psum(x, axis_name), sums)

    spec = P()
    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,) * 11,
                                 out_specs=spec, check_vma=False))


def sharded_basket_bounds(
    engine,
    spots,
    strike,
    T,
    *,
    mesh: Mesh,
    kind: str = "max",
    is_call: bool = True,
    weights=None,
    n_ex: int = 9,
    steps_per_period: int = 1,
    n_outer: int = 2048,
    n_inner: int = 64,
    axis_name: str = "paths",
) -> Dict[str, float]:
    """Mesh-sharded Bermudan duality bracket (engine/basket_american.py:
    price_bounds_basket over a mesh).

    The regressions train ONCE on the engine's training sheet (host-level,
    replicated into the mesh as coefficients — the policy is a ~(n_ex, 13)
    table, bytes); what shards is the expensive part: the out-of-sample
    lower-bound evaluation and the Andersen-Broadie dual's antithetic
    nested inner simulations (n_outer × n_inner one-period restarts), each
    device running its key-folded slice of the outer paths and pooling
    exact (n, Σ, Σ²) pair moments. The algebra is `_lower_bound_pairs` /
    `_dual_pairs` itself — shared with the single-device wrappers, never
    forked.
    """
    from mcos_tpu.engine.basket_american import (_ma_payoff_fn,
                                                 lsm_basket_train)

    if kind not in ("max", "min", "basket"):
        raise ValueError("kind must be 'max', 'min', or 'basket'")
    if kind == "basket" and weights is None:
        raise ValueError("kind='basket' needs weights")
    n_dev = mesh.shape[axis_name]
    n_assets = len(engine.params_list)
    w = (jnp.asarray(weights, jnp.float32) if weights is not None
         else None)
    spots_a = jnp.asarray(spots, jnp.float32)
    r_num = float(engine.params_list[0].r)
    k_train, k_eval, k_dual = jax.random.split(
        jax.random.key(engine.seed), 3)
    static = dict(n_ex=int(n_ex), steps_per_period=int(steps_per_period),
                  kind=kind, is_call=is_call)
    coefs = lsm_basket_train(
        engine._batch, spots_a, engine._chol, strike, T, r_num, k_train,
        num_paths=engine.num_paths, weights=w, **static)
    ppd_lo = -(-engine.num_paths // n_dev)
    ppd_hi = max(-(-int(n_outer) // n_dev), 2)
    n_inner = int(n_inner) - int(n_inner) % 2
    w_arg = w if w is not None else jnp.full((n_assets,),
                                             1.0 / n_assets, jnp.float32)
    stats = _sharded_bounds_fn(
        mesh, ppd_lo, ppd_hi, n_inner, int(n_ex), int(steps_per_period),
        kind, is_call, w is not None, axis_name)(
        engine._batch, spots_a, engine._chol, jnp.float32(strike),
        jnp.float32(T), jnp.float32(r_num), k_eval, k_dual,
        coefs["policy"], coefs["value"], w_arg)
    stats = jax.device_get(stats)

    def reduce(tag):
        n = float(stats[tag]["n"])
        mean = float(stats[tag]["sum"]) / n
        var = max(float(stats[tag]["sumsq"]) / n - mean * mean, 0.0)
        return mean, float(np.sqrt(var / n)), n

    lo, lo_se, n_lo = reduce("lo")
    hi, hi_se, n_hi = reduce("hi")
    payoff = _ma_payoff_fn(jnp.float32(strike), kind, is_call, w_arg)
    intrinsic = float(payoff(spots_a[:, None])[0])
    lower = max(lo, intrinsic)
    return {
        "lower_bound": lower,
        "lower_se": lo_se,
        "upper_bound": hi,
        "upper_se": hi_se,
        "duality_gap": hi - lower,
        "price": 0.5 * (lower + hi),
        "n_exercise": int(n_ex),
        "n_outer": int(n_hi),
        "n_inner": n_inner,
        "num_devices": int(n_dev),
    }


# ─────────────────────────────────────────────────────────────────────────────
# Sharded ADI PDE chain (the ADI batch axis was the
# one engine surface still single-device)
# ─────────────────────────────────────────────────────────────────────────────
@lru_cache(maxsize=32)
def _sharded_pde_fn(mesh, per_dev, n_x, n_v, n_t, is_call, american,
                    scheme, jumps, axis_name):
    """Build-once jitted shard_map for `sharded_pde_chain`: each device
    vmaps the ADI solve over its chunk of the contract batch (pure data
    parallelism — the tridiagonal stages batch natively, no collectives)."""
    from mcos_tpu.engine.pde import _adi_heston_solve

    kw = dict(n_x=n_x, n_v=n_v, n_t=n_t, is_call=is_call,
              american=american, scheme=scheme)

    def local(strikes_, Ts_, xs_, vs_, jump_, r_, q_, kap_, th_, xi_, rho_):
        def one(strike, T, x, v, jump_tables):
            u, _ = _adi_heston_solve(
                strike, T, r_, q_, kap_, th_, xi_, rho_, x, v,
                jump=(jump_tables if jumps else None), **kw)
            return u
        return jax.vmap(one)(strikes_, Ts_, xs_, vs_, jump_)

    b, rep = P(axis_name), P()
    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(b, b, b, b, b if jumps else rep) + (rep,) * 6,
        out_specs=b, check_vma=False))


def sharded_pde_chain(
    engine,
    spot,
    contracts,
    *,
    mesh: Mesh,
    is_call: bool = True,
    american: bool = False,
    axis_name: str = "batch",
):
    """Mesh-sharded ADI solve of a whole option chain (engine/pde.py:
    HestonPDEEngine.price over a contract batch).

    Each (strike, T) contract's 2-D Heston/Bates solve is independent —
    the textbook batch-parallel workload: the chain pads to a multiple of
    the mesh size, every device runs a vmapped `_adi_heston_solve` over
    its chunk (the ADI tridiagonal stages batch natively on the leading
    axis), and the solved (n_v, n_x) grids gather back for the engine's
    own host-side extraction (`HestonPDEEngine._extract` — price + grid
    delta/gamma/vega per contract). All solves share ONE static
    resolution — the batch max of the engine's per-contract jump-regime
    guards (`_resolution`) — so the jit cache holds a single program.

    The reference has no PDE at all (SURVEY §2); this parallelizes the
    rebuild's third numerical route (MC / COS / PDE) the same way the MC
    engines shard, completing the mesh story across every engine family.

    Returns a list of per-contract dicts (same schema as `engine.price`).
    """
    from mcos_tpu.engine.pde import _merton_jump_tables

    contracts = [(float(k), float(t)) for k, t in contracts]
    if not contracts:
        return []
    n_dev = mesh.shape[axis_name]
    p = engine.params

    # Batch-max resolution: every contract's jump-stability/resolution
    # guard satisfied by one static shape.
    grids = [engine._grids(float(spot), k, t) for k, t in contracts]
    n_x = max(g[2] for g in grids)
    n_t = max(g[3] for g in grids)
    n_v = engine.n_v
    if n_x != grids[0][2]:  # widen any coarser grids to the batch n_x
        grids = []
        for k, t in contracts:
            save = engine.n_x
            try:
                engine.n_x = n_x
                grids.append(engine._grids(float(spot), k, t))
            finally:
                engine.n_x = save
        n_t = max(n_t, max(g[3] for g in grids))

    pad = (-len(contracts)) % n_dev
    idx = list(range(len(contracts))) + [len(contracts) - 1] * pad
    xs = jnp.stack([grids[i][0] for i in idx])
    vs = jnp.stack([grids[i][1] for i in idx])
    strikes = jnp.asarray([contracts[i][0] for i in idx], jnp.float32)
    Ts = jnp.asarray([contracts[i][1] for i in idx], jnp.float32)

    if engine.jumps:
        tables = [_merton_jump_tables(
            np.asarray(grids[i][0], np.float64), float(p.lambda_j),
            float(p.mu_j), float(p.sigma_j)) for i in idx]
        jump_arg = jax.tree.map(lambda *a: jnp.stack(a), *tables)
    else:
        jump_arg = jnp.zeros((), jnp.float32)  # replicated placeholder

    per_dev = len(idx) // n_dev
    u_all = _sharded_pde_fn(
        mesh, per_dev, n_x, n_v, n_t, is_call, american,
        engine.scheme, engine.jumps, axis_name)(
        strikes, Ts, xs, vs, jump_arg,
        jnp.float32(p.r), jnp.float32(p.q), jnp.float32(p.kappa),
        jnp.float32(p.theta), jnp.float32(p.xi), jnp.float32(p.rho))
    u_all = jax.device_get(u_all)

    out = []
    for i in range(len(contracts)):
        row = engine._extract(u_all[i], grids[i][0], grids[i][1],
                              float(spot), american, n_t)
        row["strike"], row["T"] = contracts[i]
        row["num_devices"] = int(n_dev)
        out.append(row)
    return out
