"""Exotic option pricing engine: Asian, barrier, lookback.

Capability extension beyond the reference (Europeans only). Variance
reduction per payoff family:

- **Arithmetic Asian**: control = discrete *geometric* Asian on the GBM
  companion leg (closed form `geometric_asian_bs`; Kemna-Vorst). Correlation
  is typically >0.99 ⇒ 10-100× variance reduction.
- **Geometric Asian**: same control (exact in the BS limit).
- **Barrier / lookback**: control = European payoff on the companion leg
  (expectation = `bs_price`, exact for the discrete leg too since only the
  terminal value enters). Correlation is payoff-dependent, so the CV
  coefficient matters:

All controls use the *estimated optimal β* = Cov(pay, ctrl)/Var(ctrl)
(computed on-device from the same sample; the O(1/n) estimation bias is
standard and negligible at these path counts) — unlike the β=1 convention the
European pricer inherits from the reference. β=1 with a weak control can
*increase* variance; optimal-β never does (in expectation).

All prices carry `std_error` with the same estimator conventions as the
European engine (antithetic-combined per-path values, population std / √n).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import DEFAULT_NUM_PATHS, scaled_steps
from mcos_tpu.models.params import SVJParams
from mcos_tpu.ops import exotics as ops_exotics
from mcos_tpu.ops.bs import bs_price
from mcos_tpu.ops.simulate import combine_antithetic, mc_mean_stderr

Array = jax.Array


def _cv_adjust(pay: Array, ctrl: Array, ctrl_mean_exact: Array):
    """Optimal-β control-variate estimate: mean, stderr, β.

    pay, ctrl: antithetic-combined per-path values, shape (paths,).
    ctrl_mean_exact: the control's known (undiscounted) expectation.
    """
    ctrl_centered = ctrl - jnp.mean(ctrl)
    var_c = jnp.mean(ctrl_centered**2)
    cov = jnp.mean((pay - jnp.mean(pay)) * ctrl_centered)
    beta = jnp.where(var_c > 1e-12, cov / jnp.maximum(var_c, 1e-12), 0.0)
    adjusted = pay - beta * (ctrl - ctrl_mean_exact)
    mean, se = mc_mean_stderr(adjusted)
    return mean, se, beta


def _snap_window(T, steps: int, window):
    """Validate a (t1, t2) monitoring window and snap it to the step grid.

    Returns (w0, w1, (t1_eff, t2_eff)) with 0 <= w0 < w1 <= steps. ONE
    implementation shared by every windowed product method AND greeks, so
    price and greeks can never monitor different windows (review finding:
    five hand-rolled copies had already drifted on validation).
    """
    t1, t2 = float(window[0]), float(window[1])
    if not 0.0 <= t1 < t2 <= float(T):
        raise ValueError("window needs 0 <= t1 < t2 <= T")
    dt = float(T) / steps
    w0 = max(0, min(steps - 1, int(round(t1 / dt))))
    w1 = max(w0 + 1, min(steps, int(round(t2 / dt))))
    return w0, w1, (w0 * dt, w1 * dt)


def exotic_payoff_and_control(
    stats: Dict[str, Array], params: SVJParams, spot, strike, T, barrier,
    *, kind: str, num_steps: int, is_call: bool,
    averaging: str = "arithmetic", knock: str = "out", direction: str = "up",
    floating: bool = False, one_touch: bool = False,
    control_variate: bool = True,
    monitoring: str = "discrete", bridge_ctrl_exact=0.0,
    barrier_lo=0.0, rebate=0.0,
):
    """(pay_b, ctrl_b, ctrl_exact) from a path-stats dict.

    `rebate` (cash, paid AT EXPIRY — at-hit contracts pre-scale it into an
    effective at-expiry amount, see price_barrier) pays on the dead branch
    of barrier / double_barrier kinds: on knock for KO, on no-knock for
    KI. Under bridge monitoring the companion control leg carries the same
    rebate and `bridge_ctrl_exact` must include the rebate leg's exact
    undiscounted mean.

    Shared by the single-device core below and the mesh-sharded pricer
    (parallel/mesh.py:sharded_exotic_price) so the payoff/control algebra
    cannot drift between them. ctrl_b/ctrl_exact are None when the payoff
    takes no companion control (one-touch cash digitals, or
    control_variate=False).

    kind="double_barrier": `barrier` is the UPPER barrier, `barrier_lo`
    the lower. one_touch=True prices the corridor digitals — knock="out"
    is the double-NO-touch (pays iff neither barrier trades), knock="in"
    the double-one-touch (pays on any touch, at expiry); both take the
    companion-leg digital as control under bridge monitoring
    (`bridge_ctrl_exact` = the undiscounted `double_no_touch_bs`-style
    stay/touch probability).
    """
    discount = jnp.exp(-params.r * jnp.asarray(T, jnp.float32))
    if kind == "asian":
        pay_b = ops_exotics.asian_payoff(stats, strike, is_call, averaging)
    elif kind == "double_barrier":
        if one_touch:
            if monitoring == "bridge":
                surv = jnp.exp(stats["log_surv"])
                pay_b = surv if knock == "out" else 1.0 - surv
                if control_variate:
                    g_surv = jnp.exp(stats["g_log_surv"])
                    ctrl_b = g_surv if knock == "out" else 1.0 - g_surv
                    return pay_b, ctrl_b, jnp.asarray(bridge_ctrl_exact,
                                                      jnp.float32)
            else:
                touched = ((stats["max_s"] >= barrier)
                           | (stats["min_s"] <= barrier_lo))
                alive = ~touched if knock == "out" else touched
                pay_b = alive.astype(jnp.float32)
            return pay_b, None, None
        if monitoring == "bridge":
            # log_surv already means "survived the corridor": the single-
            # barrier bridge payoff applies unchanged, companion leg as CV
            # with its exact continuous mean (double_barrier_bs quadrature,
            # host f64, passed undiscounted via bridge_ctrl_exact).
            pay_b = ops_exotics.barrier_bridge_payoff(
                stats, strike, is_call, knock=knock, rebate=rebate)
            if control_variate:
                ctrl_b = ops_exotics.barrier_bridge_payoff(
                    stats, strike, is_call, knock=knock, leg="g",
                    rebate=rebate)
                return pay_b, ctrl_b, jnp.asarray(bridge_ctrl_exact,
                                                  jnp.float32)
            return pay_b, None, None
        pay_b = ops_exotics.double_barrier_payoff(
            stats, strike, barrier_lo, barrier, is_call, knock=knock,
            rebate=rebate)
        # falls through to the European companion control below
    elif kind == "barrier":
        if one_touch:
            if monitoring == "bridge":
                pay_b = ops_exotics.one_touch_bridge_payoff(stats)
            else:
                touched = (stats["max_s"] >= barrier if direction == "up"
                           else stats["min_s"] <= barrier)
                pay_b = touched.astype(jnp.float32)
            control_variate = False      # no companion control for cash
        elif monitoring == "bridge":
            # Bridge-weighted payoff + the bridge-weighted COMPANION as
            # control: its continuous-barrier expectation is the exact
            # Reiner-Rubinstein price (host f64, passed in undiscounted
            # via bridge_ctrl_exact) — correlation with the SVJ leg is
            # near the companion-CV ceiling.
            pay_b = ops_exotics.barrier_bridge_payoff(
                stats, strike, is_call, knock=knock, rebate=rebate)
            if control_variate:
                ctrl_b = ops_exotics.barrier_bridge_payoff(
                    stats, strike, is_call, knock=knock, leg="g",
                    rebate=rebate)
                return pay_b, ctrl_b, jnp.asarray(bridge_ctrl_exact,
                                                  jnp.float32)
            return pay_b, None, None
        else:
            pay_b = ops_exotics.barrier_payoff(
                stats, strike, barrier, is_call, knock=knock,
                direction=direction, rebate=rebate)
    elif kind == "lookback":
        pay_b = ops_exotics.lookback_payoff(
            stats, is_call, None if floating else strike)
    else:
        raise ValueError(f"unknown exotic kind: {kind!r}")

    if not control_variate:
        return pay_b, None, None

    sigma_bs = jnp.sqrt(params.v0)
    if kind == "asian":
        # Kemna-Vorst: geometric Asian on the companion leg.
        g_geo = jnp.exp(stats["g_log_avg"])
        ctrl_b = jnp.where(g_geo - strike > 0, g_geo - strike, 0.0) \
            if is_call else jnp.maximum(strike - g_geo, 0.0)
        ctrl_exact = ops_exotics.geometric_asian_bs(
            spot, strike, T, params.r, params.q, sigma_bs, num_steps,
            is_call) / discount
    else:
        # European payoff on the companion leg (terminal value only ⇒
        # its expectation is the exact BS price, discrete or not).
        eff_strike = jnp.where(jnp.asarray(floating), spot, strike)
        g_t = stats["g_final"]
        ctrl_b = jnp.maximum(g_t - eff_strike, 0.0) if is_call \
            else jnp.maximum(eff_strike - g_t, 0.0)
        ctrl_exact = bs_price(spot, eff_strike, T, params.r, params.q,
                              sigma_bs, is_call) / discount
    return pay_b, ctrl_b, ctrl_exact


@partial(jax.jit, static_argnames=(
    "num_paths", "num_steps", "is_call", "kind", "averaging", "knock",
    "direction", "antithetic", "control_variate", "floating", "one_touch",
    "monitoring", "window"))
def _price_exotic_core(
    params: SVJParams,
    spot,
    strike,
    T,
    key,
    barrier=0.0,
    bridge_ctrl_exact=0.0,
    barrier_lo=0.0,
    rebate=0.0,
    *,
    kind: str,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    averaging: str = "arithmetic",
    knock: str = "out",
    direction: str = "up",
    floating: bool = False,
    one_touch: bool = False,
    antithetic: bool = True,
    control_variate: bool = True,
    monitoring: str = "discrete",
    window=None,
) -> Dict[str, Array]:
    bridge = monitoring == "bridge"
    corridor = kind == "double_barrier" and bridge
    bridge_log_b = jnp.log(jnp.maximum(barrier, 1e-30)
                           / jnp.asarray(spot, jnp.float32))
    bridge_log_l = jnp.log(jnp.maximum(barrier_lo, 1e-30)
                           / jnp.asarray(spot, jnp.float32))
    stats = ops_exotics.simulate_path_stats(
        params, spot, T, key, num_paths=num_paths, num_steps=num_steps,
        antithetic=antithetic, companion=control_variate,
        bridge=bridge, bridge_up=(direction == "up"),
        bridge_log_b=bridge_log_b, corridor=corridor,
        bridge_log_l=bridge_log_l, window=window)
    discount = jnp.exp(-params.r * jnp.asarray(T, jnp.float32))

    pay_b, ctrl_b, ctrl_exact = exotic_payoff_and_control(
        stats, params, spot, strike, T, barrier, kind=kind,
        num_steps=num_steps, is_call=is_call, averaging=averaging,
        knock=knock, direction=direction, floating=floating,
        one_touch=one_touch, control_variate=control_variate,
        monitoring=monitoring, bridge_ctrl_exact=bridge_ctrl_exact,
        barrier_lo=barrier_lo, rebate=rebate)

    pay = combine_antithetic(pay_b)
    raw_mean, raw_se = mc_mean_stderr(pay)
    out: Dict[str, Array] = {
        "raw_mc_price": discount * raw_mean,
        "price": discount * raw_mean,
        "std_error": discount * raw_se,
    }

    if ctrl_b is not None:
        ctrl = combine_antithetic(ctrl_b)
        mean, se, beta = _cv_adjust(pay, ctrl, ctrl_exact)
        out["price"] = discount * mean
        out["std_error"] = discount * se
        out["cv_beta"] = beta
    return out


@partial(jax.jit, static_argnames=(
    "kind", "num_paths", "num_steps", "is_call", "averaging", "knock",
    "direction", "floating", "antithetic", "control_variate", "monitoring",
    "one_touch", "window"))
def _exotic_value_and_greeks(
    params: SVJParams, spot, strike, T, key, barrier, barrier_lo=0.0,
    rebate=0.0, *,
    kind: str, num_paths: int, num_steps: int, is_call: bool,
    averaging: str = "arithmetic", knock: str = "out", direction: str = "up",
    floating: bool = False, antithetic: bool = True,
    control_variate: bool = True, monitoring: str = "discrete",
    one_touch: bool = False, window=None,
):
    """(price, ∂P/∂spot, ∂P/∂params) through the differentiable stat scan.

    Valid for Lipschitz path functionals (Asian averages, lookback extrema
    — max/min carry a.e.-correct subgradients). NOT for discretely-
    monitored barriers: the knock indicator has zero pathwise derivative
    (the engine uses CRN-FD there instead, see ExoticEngine.greeks).
    Bridge-monitored barriers and one-touches ARE in scope: the survival
    weight exp(Σ log(1−p_cross)) is continuous in (spot, params) — it
    decays smoothly to 0 as an endpoint approaches the barrier — so its
    pathwise derivative is unbiased (Glasserman §7.2 smoothing; this is
    the bridge estimator's second payoff, after the bias removal). The
    bridge AD pass runs the RAW estimator (control_variate off): the
    companion CV's exact mean is a host-f64 constant whose own spot/vol
    sensitivity would otherwise be dropped from the gradient."""
    cv = control_variate and monitoring != "bridge"

    def f(s, p_):
        return _price_exotic_core(
            p_, s, strike, T, key, barrier, 0.0, barrier_lo, rebate,
            kind=kind,
            num_paths=num_paths, num_steps=num_steps, is_call=is_call,
            averaging=averaging, knock=knock, direction=direction,
            floating=floating, one_touch=one_touch, antithetic=antithetic,
            control_variate=cv,
            monitoring=monitoring, window=window)["price"]

    price, (d_spot, d_params) = jax.value_and_grad(
        f, argnums=(0, 1))(jnp.float32(spot), params)
    return price, d_spot, d_params


def variance_swap_fair_strike(params: SVJParams, T: float) -> Dict[str, float]:
    """Fair strike of a variance swap (annualized quadratic variation).

    Closed form under SVJ/Bates — capability beyond the reference:
        QV/T = θ + (v0 − θ)·(1 − e^{−κT})/(κT)   (CIR mean integral)
             + λ·(μ_J² + σ_J²)                    (E[J²] per unit time)
    The jump leg is the second moment of the log jump size times intensity
    (each jump adds J² to realized variance). Discrete daily sampling adds
    only an O(dt²) drift² term — negligible and ignored, as is market
    convention. Returns both legs and the total, in variance units
    (vol strike = √total).
    """
    kappa = float(params.kappa)
    theta = float(params.theta)
    v0 = float(params.v0)
    kt = max(kappa * T, 1e-12)
    diffusion = theta + (v0 - theta) * (1.0 - np.exp(-kt)) / kt
    jumps = float(params.lambda_j) * (float(params.mu_j) ** 2
                                      + float(params.sigma_j) ** 2)
    total = diffusion + jumps
    return {
        "fair_variance": total,
        "fair_vol_strike": float(np.sqrt(max(total, 0.0))),
        "diffusion_leg": diffusion,
        "jump_leg": jumps,
    }


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "is_call"))
def _digital_core(params: SVJParams, spot, strikes, T, key, *,
                  num_paths: int, num_steps: int, is_call: bool):
    """Cash-or-nothing digital prices at a strike vector off one path set."""
    from mcos_tpu.ops import simulate

    s_final, _, _ = simulate.simulate_terminal(
        params, spot, T, key, num_paths=num_paths, num_steps=num_steps,
        antithetic=True, companion=False)
    strikes = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))
    hit = (s_final[None] > strikes[:, None, None]) if is_call \
        else (s_final[None] < strikes[:, None, None])
    pay = combine_antithetic(jnp.swapaxes(hit.astype(jnp.float32), 0, 1))
    mean, se = mc_mean_stderr(pay)
    discount = jnp.exp(-params.r * jnp.asarray(T, jnp.float32))
    return discount * mean, discount * se


class ExoticEngine:
    """Asian / barrier / lookback pricer sharing the framework's estimator
    conventions (antithetic, CRN keys, maturity-scaled steps)."""

    def __init__(self, params: SVJParams, num_paths: int = DEFAULT_NUM_PATHS,
                 num_steps: int = 252, seed: int = 42,
                 use_antithetic: bool = True, use_control_variate: bool = True):
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.use_antithetic = bool(use_antithetic)
        self.use_control_variate = bool(use_control_variate)

    def _run(self, spot, strike, T, *, kind, barrier=0.0, **kw) -> Dict:
        steps = scaled_steps(self.num_steps, T)
        res = _price_exotic_core(
            self.params, spot, strike, T, jax.random.key(self.seed),
            barrier, kind=kind, num_paths=self.num_paths,
            num_steps=steps, antithetic=self.use_antithetic,
            control_variate=self.use_control_variate, **kw)
        res = jax.device_get(res)  # one transfer, not one per scalar
        out = {k: float(v) for k, v in res.items()}
        out["num_paths_used"] = self.num_paths
        out["num_steps"] = steps
        return out

    def price_asian(self, spot: float, strike: float, T: float,
                    is_call: bool = True,
                    averaging: str = "arithmetic") -> Dict[str, float]:
        """Discretely-averaged Asian (observations at the simulation grid)."""
        return self._run(spot, strike, T, kind="asian", is_call=is_call,
                         averaging=averaging)

    def price_barrier(self, spot: float, strike: float, T: float,
                      barrier: float, is_call: bool = True,
                      knock: str = "out",
                      direction: Optional[str] = None,
                      monitoring: str = "discrete",
                      rebate: float = 0.0,
                      rebate_at_hit: bool = False,
                      window=None) -> Dict[str, float]:
        """Barrier option; `direction` defaults from the barrier position
        (above spot ⇒ 'up').

        monitoring="discrete" (default) knocks on the simulation grid —
        the contract most listed barriers actually specify.
        monitoring="continuous" applies the Broadie-Glasserman-Kou
        continuity correction: the monitored level shifts by
        exp(∓β·σ·√dt) (β = 0.5826; up barriers shift down, down barriers
        up), with σ = √v₀ — exact in the GBM limit, where the MC is
        test-pinned to the Reiner-Rubinstein closed form
        (`ops/exotics.py:barrier_bs`).

        `rebate` is cash paid on the dead branch (on knock for KO; at
        expiry if never knocked for KI — the market convention).
        rebate_at_hit=True (KO only) pays the KO rebate when the barrier
        trades instead of at expiry: the simulation prices the at-expiry
        contract and the rebate is pre-scaled by the closed-form
        at-hit/at-expiry one-touch ratio (`one_touch_bs`) — exact in the
        GBM limit, a documented approximation under SVJ (same device as
        `price_one_touch(pay_at_hit=True)`).

        window=(t1, t2) restricts monitoring to [t1, t2] ⊆ [0, T]
        (partial/window barrier). Requires monitoring="bridge" — the
        survival increments are simply gated to the window's steps, so
        the estimator stays exact-continuous under GBM *within* the
        window and smooth for AD. The window snaps to the simulation
        grid (effective times returned as `window_effective`); the CV's
        exact mean is the `window_barrier_bs` image-series quadrature at
        the snapped times. Rebates on window barriers are not offered
        (no closed-form window-touch discount to borrow).
        """
        if window is not None:
            if monitoring != "bridge":
                raise ValueError("window barriers need monitoring='bridge'")
            if rebate:
                raise ValueError("rebates on window barriers are not "
                                 "offered")
            t1, t2 = float(window[0]), float(window[1])
        if direction is None:
            direction = "up" if barrier >= spot else "down"
        if rebate_at_hit and knock != "out":
            raise ValueError("rebate_at_hit only applies to knock-outs "
                             "(KI rebates pay at expiry by convention)")
        rebate_eff = float(rebate)
        if rebate and rebate_at_hit:
            p = self.params
            sig_ot = float(np.sqrt(float(p.v0)))
            at_hit = ops_exotics.one_touch_bs(
                spot, T, float(p.r), float(p.q), sig_ot, barrier,
                direction, pay_at_hit=True)
            at_exp = max(ops_exotics.one_touch_bs(
                spot, T, float(p.r), float(p.q), sig_ot, barrier,
                direction, pay_at_hit=False), 1e-12)
            rebate_eff = float(rebate) * at_hit / at_exp
        barrier_eff = barrier
        extra: Dict = {}
        if rebate:
            extra["rebate"] = rebate_eff
        if monitoring == "continuous":
            from mcos_tpu.ops.exotics import BGK_BETA

            steps = scaled_steps(self.num_steps, T)
            sig = float(np.sqrt(float(self.params.v0)))
            shift = BGK_BETA * sig * np.sqrt(T / steps)
            barrier_eff = barrier * float(np.exp(
                -shift if direction == "up" else shift))
        elif monitoring == "bridge":
            # Brownian-bridge survival weights: exact continuous
            # monitoring under GBM at any step count, smooth estimator
            # (ops/exotics.py:simulate_path_stats bridge docstring). The
            # companion CV's exact mean is the Reiner-Rubinstein closed
            # form at sigma = sqrt(v0), host f64, passed undiscounted.
            if window is not None:
                w0, w1, win_eff = _snap_window(
                    T, scaled_steps(self.num_steps, T), window)
                win_steps = (w0, w1)
            else:
                win_steps = win_eff = None
            if self.use_control_variate:
                p = self.params
                sig = float(np.sqrt(float(p.v0)))
                if window is not None:
                    rr = ops_exotics.window_barrier_bs(
                        spot, strike, T, float(p.r), float(p.q), sig,
                        barrier, win_eff[0], win_eff[1], is_call=is_call,
                        knock=knock, direction=direction)
                else:
                    rr = ops_exotics.barrier_bs(
                        spot, strike, T, float(p.r), float(p.q), sig,
                        barrier, is_call=is_call, knock=knock,
                        direction=direction)
                ctrl = rr * np.exp(float(p.r) * T)
                if rebate:
                    # companion rebate leg, undiscounted: rebate_eff times
                    # the touch (KO) / no-touch (KI) probability.
                    touch = ops_exotics.one_touch_bs(
                        spot, T, float(p.r), float(p.q), sig, barrier,
                        direction) * np.exp(float(p.r) * T)
                    ctrl += rebate_eff * (touch if knock == "out"
                                          else 1.0 - touch)
                extra["bridge_ctrl_exact"] = float(ctrl)
            extra["monitoring"] = "bridge"
        elif monitoring != "discrete":
            raise ValueError(f"unknown monitoring {monitoring!r}")
        if window is not None:
            extra["window"] = win_steps
        out = self._run(spot, strike, T, kind="barrier",
                        barrier=barrier_eff, is_call=is_call, knock=knock,
                        direction=direction, **extra)
        out["monitoring"] = monitoring
        out["barrier"] = barrier
        if window is not None:
            out["window"] = [t1, t2]
            out["window_effective"] = list(win_eff)
        if rebate:
            out["rebate"] = rebate
            out["rebate_at_hit"] = bool(rebate_at_hit)
        return out

    def price_one_touch(self, spot: float, T: float, barrier: float,
                        direction: Optional[str] = None,
                        monitoring: str = "continuous",
                        pay_at_hit: bool = False,
                        window=None) -> Dict[str, float]:
        """One-touch digital: pays 1 when the barrier trades.

        MC prices the pay-at-expiry contract (the touch indicator rides
        the existing max/min trackers; BGK shift under
        monitoring="continuous"); pay-at-hit discounting uses the closed
        form's at-hit/at-expiry ratio on top of the MC touch probability
        (exact in the GBM limit, a documented approximation under SVJ).
        The GBM closed form (`one_touch_bs`, reflection principle) rides
        along as `closed_form_gbm` for reference.
        """
        from mcos_tpu.ops.exotics import BGK_BETA, one_touch_bs

        if direction is None:
            direction = "up" if barrier >= spot else "down"
        sig = float(np.sqrt(float(self.params.v0)))
        barrier_eff = barrier
        extra: Dict = {}
        win_eff = None
        if window is not None:
            # windowed one-touch: pays at expiry on any in-window touch.
            # Bridge only (the gated survival weight IS the estimator);
            # pay-at-hit has no closed-form window discount to borrow.
            if monitoring != "bridge":
                raise ValueError("window one-touch needs "
                                 "monitoring='bridge'")
            if pay_at_hit:
                raise ValueError("pay_at_hit is not offered on window "
                                 "one-touches")
            w0, w1, win_eff = _snap_window(
                T, scaled_steps(self.num_steps, T), window)
            extra["window"] = (w0, w1)
        if monitoring == "continuous":
            steps = scaled_steps(self.num_steps, T)
            shift = BGK_BETA * sig * np.sqrt(T / steps)
            barrier_eff = barrier * float(np.exp(
                -shift if direction == "up" else shift))
        elif monitoring == "bridge":
            # Smooth touch probability 1 - P(survive) off the bridge
            # weights — exact continuous monitoring under GBM, no BGK
            # shift, no indicator variance.
            extra["monitoring"] = "bridge"
        res = self._run(spot, 0.0, T, kind="barrier", barrier=barrier_eff,
                        is_call=True, knock="in", direction=direction,
                        one_touch=True, **extra)
        if win_eff is not None:
            cf = float(np.exp(-float(self.params.r) * T)
                       ) - ops_exotics.window_no_touch_bs(
                spot, T, float(self.params.r), float(self.params.q), sig,
                barrier, win_eff[0], win_eff[1], direction=direction)
        else:
            cf = one_touch_bs(
                spot, T, float(self.params.r), float(self.params.q), sig,
                barrier, direction, pay_at_hit=pay_at_hit)
        out = {
            "price": res["price"],
            "std_error": res["std_error"],
            "touch_probability": res["price"]
            / float(np.exp(-float(self.params.r) * T)),
            "monitoring": monitoring,
            "closed_form_gbm": cf,
            "num_paths_used": self.num_paths,
        }
        if win_eff is not None:
            out["window"] = [float(window[0]), float(window[1])]
            out["window_effective"] = list(win_eff)
        if pay_at_hit:
            ratio_num = one_touch_bs(spot, T, float(self.params.r),
                                     float(self.params.q), sig, barrier,
                                     direction, pay_at_hit=True)
            ratio_den = max(one_touch_bs(spot, T, float(self.params.r),
                                         float(self.params.q), sig,
                                         barrier, direction,
                                         pay_at_hit=False), 1e-12)
            out["price"] = out["price"] * ratio_num / ratio_den
            out["std_error"] = out["std_error"] * ratio_num / ratio_den
            out["pay_at_hit"] = True
        return out

    def price_double_barrier(self, spot: float, strike: float, T: float,
                             lower: float, upper: float,
                             is_call: bool = True, knock: str = "out",
                             monitoring: str = "bridge",
                             rebate: float = 0.0,
                             window=None) -> Dict[str, float]:
        """Double-barrier option: knocks when EITHER barrier trades.

        monitoring="bridge" (default — it is the whole point here) uses the
        image-series corridor survival weight
        (`ops/exotics.py:corridor_surv_increment`): exact continuous
        monitoring under GBM at any step count, smooth [0,1] weight, and
        per-path in-out parity by construction. CV = the bridge-weighted
        companion leg, whose exact continuous mean is the
        `double_barrier_bs` corridor-density quadrature (host f64).
        monitoring="discrete" knocks on the simulation grid;
        "continuous" applies the BGK shift to BOTH barriers (upper down,
        lower up) — exact in the GBM limit.
        """
        if not lower < upper:
            raise ValueError("double barrier needs lower < upper")
        lo_eff, hi_eff = lower, upper
        extra: Dict = {}
        sig = float(np.sqrt(float(self.params.v0)))
        win_eff = None
        if window is not None:
            if monitoring != "bridge":
                raise ValueError("window double barriers need "
                                 "monitoring='bridge'")
            if rebate:
                raise ValueError("rebates on window barriers are not "
                                 "offered")
            w0, w1, win_eff = _snap_window(
                T, scaled_steps(self.num_steps, T), window)
            extra["window"] = (w0, w1)
        cf_cached = None
        if monitoring == "continuous":
            steps = scaled_steps(self.num_steps, T)
            from mcos_tpu.ops.exotics import BGK_BETA

            shift = BGK_BETA * sig * np.sqrt(T / steps)
            hi_eff = upper * float(np.exp(-shift))
            lo_eff = lower * float(np.exp(shift))
        elif monitoring == "bridge":
            if self.use_control_variate:
                p = self.params
                if win_eff is not None:
                    # computed once; reused below for closed_form_gbm
                    cf_cached = ops_exotics.window_barrier_bs(
                        spot, strike, T, float(p.r), float(p.q), sig,
                        upper, win_eff[0], win_eff[1], is_call=is_call,
                        knock=knock, barrier_lo=lower)
                    db = cf_cached
                else:
                    db = ops_exotics.double_barrier_bs(
                        spot, strike, T, float(p.r), float(p.q), sig,
                        lower, upper, is_call=is_call, knock=knock)
                ctrl = db * np.exp(float(p.r) * T)
                if rebate:
                    stay = ops_exotics.double_no_touch_bs(
                        spot, T, float(p.r), float(p.q), sig, lower, upper
                    ) * np.exp(float(p.r) * T)    # undiscounted stay prob
                    ctrl += rebate * ((1.0 - stay) if knock == "out"
                                      else stay)
                extra["bridge_ctrl_exact"] = float(ctrl)
            extra["monitoring"] = "bridge"
        elif monitoring != "discrete":
            raise ValueError(f"unknown monitoring {monitoring!r}")
        if rebate:
            # cash at expiry on the dead branch (on knock for KO, on
            # no-knock for KI — at-hit corridor rebates are not offered:
            # there is no closed-form hit-time discount to borrow).
            extra["rebate"] = float(rebate)
        out = self._run(spot, strike, T, kind="double_barrier",
                        barrier=hi_eff, barrier_lo=lo_eff, is_call=is_call,
                        knock=knock, **extra)
        out["monitoring"] = monitoring
        out["lower_barrier"] = lower
        out["upper_barrier"] = upper
        p = self.params
        if win_eff is not None:
            cf = cf_cached              # CV path already evaluated it
            if cf is None:
                cf = ops_exotics.window_barrier_bs(
                    spot, strike, T, float(p.r), float(p.q), sig, upper,
                    win_eff[0], win_eff[1], is_call=is_call, knock=knock,
                    barrier_lo=lower)
            out["window"] = [float(window[0]), float(window[1])]
            out["window_effective"] = list(win_eff)
        else:
            cf = ops_exotics.double_barrier_bs(
                spot, strike, T, float(p.r), float(p.q),
                sig, lower, upper, is_call=is_call, knock=knock)
        if rebate:
            df = float(np.exp(-float(p.r) * T))
            dnt = ops_exotics.double_no_touch_bs(
                spot, T, float(p.r), float(p.q), sig, lower, upper)
            cf += rebate * ((df - dnt) if knock == "out" else dnt)
            out["rebate"] = float(rebate)
        out["closed_form_gbm"] = cf
        return out

    def price_double_no_touch(self, spot: float, T: float, lower: float,
                              upper: float, touch: bool = False,
                              monitoring: str = "bridge",
                              window=None) -> Dict[str, float]:
        """Corridor digital: double-no-touch pays 1 at expiry iff the spot
        never leaves (lower, upper); touch=True prices the double-ONE-touch
        (pays on any touch, at expiry — their undiscounted probabilities
        sum to 1). Bridge monitoring gives the smooth exp(log_surv) weight
        (exact continuous under GBM); the companion-leg digital rides as
        control with exact mean from `double_no_touch_bs`."""
        win_eff = None
        win_steps = None
        if window is not None:
            # validate BEFORE any early return — otherwise whether a bad
            # window raises would depend on the spot level (review find)
            if monitoring != "bridge":
                raise ValueError("window corridor digitals need "
                                 "monitoring='bridge'")
            w0, w1, win_eff = _snap_window(
                T, scaled_steps(self.num_steps, T), window)
            win_steps = (w0, w1)
        if not lower < spot < upper and (
                window is None or float(window[0]) <= 0.0):
            # already through a barrier at the first monitored instant:
            # the digital is decided at t=0 (a window starting later is
            # NOT decided — the spot may re-enter the corridor by t1)
            df = float(np.exp(-float(self.params.r) * T))
            return {"price": df if touch else 0.0, "std_error": 0.0,
                    "stay_probability": 0.0, "monitoring": monitoring,
                    "num_paths_used": 0, "num_steps": 0}
        knock = "in" if touch else "out"
        sig = float(np.sqrt(float(self.params.v0)))
        lo_eff, hi_eff = lower, upper
        extra: Dict = {}
        dnt_cached = None
        if win_steps is not None:
            extra["window"] = win_steps
        if monitoring == "continuous":
            steps = scaled_steps(self.num_steps, T)
            from mcos_tpu.ops.exotics import BGK_BETA

            shift = BGK_BETA * sig * np.sqrt(T / steps)
            hi_eff = upper * float(np.exp(-shift))
            lo_eff = lower * float(np.exp(shift))
        elif monitoring == "bridge":
            if self.use_control_variate:
                p = self.params
                if win_eff is not None:
                    # computed once; reused below for closed_form_gbm
                    dnt_cached = ops_exotics.window_no_touch_bs(
                        spot, T, float(p.r), float(p.q), sig, upper,
                        win_eff[0], win_eff[1], barrier_lo=lower)
                    stay = dnt_cached * np.exp(float(p.r) * T)
                else:
                    stay = ops_exotics.double_no_touch_bs(
                        spot, T, float(p.r), float(p.q), sig, lower, upper
                    ) * np.exp(float(p.r) * T)  # undiscounted stay prob
                extra["bridge_ctrl_exact"] = float(
                    stay if not touch else 1.0 - stay)
            extra["monitoring"] = "bridge"
        elif monitoring != "discrete":
            raise ValueError(f"unknown monitoring {monitoring!r}")
        out = self._run(spot, 0.0, T, kind="double_barrier",
                        barrier=hi_eff, barrier_lo=lo_eff, is_call=True,
                        knock=knock, one_touch=True, **extra)
        df = float(np.exp(-float(self.params.r) * T))
        out["stay_probability"] = (out["price"] / df if not touch
                                   else 1.0 - out["price"] / df)
        out["monitoring"] = monitoring
        out["lower_barrier"] = lower
        out["upper_barrier"] = upper
        if win_eff is not None:
            dnt = dnt_cached
            if dnt is None:
                dnt = ops_exotics.window_no_touch_bs(
                    spot, T, float(self.params.r), float(self.params.q),
                    sig, upper, win_eff[0], win_eff[1], barrier_lo=lower)
            out["window"] = [float(window[0]), float(window[1])]
            out["window_effective"] = list(win_eff)
        else:
            dnt = ops_exotics.double_no_touch_bs(
                spot, T, float(self.params.r), float(self.params.q), sig,
                lower, upper)
        out["closed_form_gbm"] = dnt if not touch else df - dnt
        return out

    def price_lookback(self, spot: float, T: float, is_call: bool = True,
                       strike: Optional[float] = None) -> Dict[str, float]:
        """Lookback: floating strike when `strike` is None, else fixed."""
        return self._run(spot, strike if strike is not None else 0.0, T,
                         kind="lookback", is_call=is_call,
                         floating=strike is None)

    def price_digital(self, spot: float, strike: float, T: float,
                      is_call: bool = True,
                      bump: float = 0.01) -> Dict[str, float]:
        """Cash-or-nothing digital (payout 1) with delta — beyond the
        reference.

        The indicator has zero pathwise derivative, so delta is a CRN
        central difference using 0-homogeneity: 1{(1±h)S_T > K} =
        1{S_T > K/(1±h)} — the three strike rows ride ONE path set, so the
        FD noise comes only from paths inside the flip band.
        """
        steps = scaled_steps(self.num_steps, T)
        rel = np.array([1.0, 1.0 + bump, 1.0 - bump])
        prices, ses = _digital_core(
            self.params, spot, jnp.asarray(strike / rel, jnp.float32), T,
            jax.random.key(self.seed), num_paths=self.num_paths,
            num_steps=steps, is_call=is_call)
        prices = np.asarray(jax.device_get(prices), np.float64)
        return {
            "price": float(prices[0]),
            "std_error": float(np.asarray(ses)[0]),
            "delta": float((prices[1] - prices[2]) / (2 * spot * bump)),
            "num_paths_used": self.num_paths,
            "num_steps": steps,
        }

    def greeks(self, spot: float, strike: float, T: float,
               kind: str = "asian", is_call: bool = True,
               barrier: Optional[float] = None, knock: str = "out",
               averaging: str = "arithmetic", floating: bool = False,
               bump: float = 0.01,
               monitoring: str = "discrete",
               barrier_lo: Optional[float] = None,
               rebate: float = 0.0,
               window=None) -> Dict[str, float]:
        """Delta and vega for path-dependent payoffs (beyond the reference,
        which has no exotics at all).

        Asian / lookback: exact pathwise AD through the differentiable stat
        scan (the payoffs are Lipschitz in the path functionals), vega
        converted per vol point (2√v0 · ∂P/∂v0). Barrier with
        monitoring="discrete"/"continuous": the knock indicator has zero
        pathwise derivative, so delta comes from a CRN central difference
        using payoff homogeneity — SVJ paths scale with S₀, so
        P((1±h)S, K, B) = (1±h)·P(S, K/(1±h), B/(1±h)) off the same paths
        — and vega from a CRN v0 bump (shared draws keep indicator flips
        to the near-barrier band). Barrier / one_touch with
        monitoring="bridge": the smooth survival weight restores a valid
        pathwise derivative, so delta/vega/rho come from ONE AD pass like
        the Asians (test-pinned to f64 FD of the Reiner-Rubinstein forms
        in the GBM limit).

        `rebate` (cash at expiry on the dead branch) is supported on the
        bridge AD branches only — the smooth weight keeps the rebate leg
        differentiable; the CRN-FD homogeneity trick does NOT extend to a
        cash rebate (cash doesn't scale with S0), so rebated contracts
        must use monitoring="bridge" for greeks.
        """
        if rebate and monitoring != "bridge":
            raise ValueError("rebated barrier greeks need "
                             "monitoring='bridge' (the CRN-FD homogeneity "
                             "identity does not hold for cash rebates)")
        if window is not None and monitoring != "bridge":
            raise ValueError("window-barrier greeks need "
                             "monitoring='bridge'")
        steps = scaled_steps(self.num_steps, T)
        key = jax.random.key(self.seed)
        if window is not None:
            w0, w1, _ = _snap_window(T, steps, window)
            window = (w0, w1)
        if (kind in ("double_barrier", "double_no_touch")
                and monitoring == "bridge"):
            # Corridor bridge weight is smooth in (spot, params) exactly
            # like the single-barrier one: ONE pathwise AD pass.
            if barrier is None or barrier_lo is None:
                raise ValueError("double-barrier greeks need barrier= "
                                 "(upper) and barrier_lo=")
            one_touch = kind == "double_no_touch"
            price, d_spot, d_params = jax.device_get(
                _exotic_value_and_greeks(
                    self.params, spot, 0.0 if one_touch else strike, T,
                    key, barrier, barrier_lo, rebate,
                    kind="double_barrier",
                    num_paths=self.num_paths, num_steps=steps,
                    is_call=True if one_touch else is_call,
                    knock=knock, one_touch=one_touch,
                    antithetic=self.use_antithetic,
                    control_variate=False, monitoring="bridge",
                    window=window))
            v0 = float(self.params.v0)
            return {
                "price": float(price),
                "delta": float(d_spot),
                "vega_v0": float(d_params.v0),
                "vega": float(d_params.v0) * 2.0 * v0 ** 0.5,
                "rho": float(d_params.r),
                "method": "pathwise_ad_bridge",
            }
        if (kind in ("barrier", "one_touch")) and monitoring == "bridge":
            if barrier is None:
                raise ValueError("barrier greeks need barrier=")
            direction = "up" if barrier >= spot else "down"
            one_touch = kind == "one_touch"
            price, d_spot, d_params = jax.device_get(
                _exotic_value_and_greeks(
                    self.params, spot,
                    0.0 if one_touch else strike, T, key, barrier, 0.0,
                    rebate,
                    kind="barrier", num_paths=self.num_paths,
                    num_steps=steps, is_call=True if one_touch else is_call,
                    knock="in" if one_touch else knock, direction=direction,
                    one_touch=one_touch, antithetic=self.use_antithetic,
                    control_variate=False, monitoring="bridge",
                    window=window))
            v0 = float(self.params.v0)
            return {
                "price": float(price),
                "delta": float(d_spot),
                "vega_v0": float(d_params.v0),
                "vega": float(d_params.v0) * 2.0 * v0 ** 0.5,
                "rho": float(d_params.r),
                "method": "pathwise_ad_bridge",
            }
        if kind in ("asian", "lookback"):
            price, d_spot, d_params = jax.device_get(_exotic_value_and_greeks(
                self.params, spot, strike, T, key, barrier or 0.0,
                kind=kind, num_paths=self.num_paths, num_steps=steps,
                is_call=is_call, averaging=averaging, floating=floating,
                antithetic=self.use_antithetic,
                control_variate=self.use_control_variate))
            v0 = float(self.params.v0)
            return {
                "price": float(price),
                "delta": float(d_spot),
                "vega_v0": float(d_params.v0),
                "vega": float(d_params.v0) * 2.0 * v0 ** 0.5,
                "rho": float(d_params.r),
                "method": "pathwise_ad",
            }
        if kind != "barrier":
            raise ValueError(f"unknown exotic kind: {kind!r}")
        if barrier is None:
            raise ValueError("barrier greeks need barrier=")
        direction = "up" if barrier >= spot else "down"
        base = self.price_barrier(spot, strike, T, barrier, is_call, knock,
                                  direction)
        rel = (1.0 + bump, 1.0 - bump)
        shocked = [
            r * self.price_barrier(spot, strike / r, T, barrier / r,
                                   is_call, knock, direction)["price"]
            for r in rel
        ]
        delta = (shocked[0] - shocked[1]) / (2 * spot * bump)
        v0 = float(self.params.v0)
        dv = 0.25 * v0  # relative v0 bump keeps CRN indicator flips local
        prices_v = []
        for v0b in (v0 + dv, max(v0 - dv, 1e-4)):
            eng = ExoticEngine(self.params.replace(v0=v0b),
                               num_paths=self.num_paths,
                               num_steps=self.num_steps, seed=self.seed,
                               use_antithetic=self.use_antithetic,
                               use_control_variate=self.use_control_variate)
            prices_v.append(eng.price_barrier(spot, strike, T, barrier,
                                              is_call, knock,
                                              direction)["price"])
        vega_v0 = (prices_v[0] - prices_v[1]) / (2 * dv)
        return {
            "price": base["price"],
            "delta": float(delta),
            "vega_v0": float(vega_v0),
            "vega": float(vega_v0) * 2.0 * v0 ** 0.5,
            "method": "crn_fd_homogeneity",
        }
