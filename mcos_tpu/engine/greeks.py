"""Greeks engine: exact pathwise AD + CRN finite-difference cross-checks.

Re-design of the reference's bump-and-revalue Greeks
(reference: engine/greeks.py:20-263). The reference needs ≈13 kernel passes
per `all_greeks` call (SURVEY.md §3.2); here **every first-order Greek comes
out of ONE backward pass** — `jax.grad` of the CV-adjusted MC price wrt
(spot, T, and every SVJParams field simultaneously) — because the scan
simulator is differentiable end-to-end:

- delta   = ∂P/∂S₀      (pathwise; equals e^{−rT}E[1_ITM · S_T/S₀] for calls,
                         the estimator at greeks.py:70-76)
- vega    = ∂P/∂v₀      (the reference's v₀-bump FD, greeks.py:121-156, exact)
- rho     = ∂P/∂r       (greeks.py:224-252 bump, exact)
- theta   = −∂P/∂T      (greeks.py:205-222 re-price, exact — T flows through
                         dt, the discount, and the BS control-variate leg)
- plus ∂P/∂{κ, θ, ξ, ρ, μ_J, σ_J} for free (model-risk sensitivities the
  reference cannot produce at all).

Caveats handled explicitly:
- **Gamma**: the second pathwise derivative of a kinked payoff is biased
  (the ∂1_ITM δ-mass is lost), so gamma = central CRN finite difference *of
  the AD delta* — smooth, low-noise, and unbiased up to O(h²).
- **λ (jump intensity)**: the jump indicator 1{U < λdt} has zero pathwise
  derivative, so ∂P/∂λ via AD only sees the drift compensator. `all_greeks`
  reports a CRN finite difference for λ (shared jump uniforms make the FD
  variance tiny); the AD value is exposed as `lambda_j_drift_only`.

Common Random Numbers are free under JAX: "same key" ⇒ bit-identical paths
(replaces the reference's pre-drawn shared Z arrays, greeks.py:33-41).

Result dict keys mirror the reference's (`pathwise`, `finite_diff`,
`diff_pct`, `fd_vega_v0`, `vega_per_vol_point`, `gamma`, `theta_daily`,
`theta_annual`, `rho`, `rho_per_rate_point`) so the HTTP layer is 1:1.
Note the reference labels the *annualized* decay rate `theta_daily`
(greeks.py:217-221); we keep its numeric convention for API parity.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import math

import jax
import jax.numpy as jnp

import numpy as np

from mcos_tpu.config import DEFAULT_NUM_PATHS, scaled_steps
from mcos_tpu.engine.pricer import mc_price_core
from mcos_tpu.models.params import SVJParams
from mcos_tpu.ops import simulate
from mcos_tpu.ops.bs import bs_price

# Shared FD bump defaults: vega() and jump_sensitivities() ride ONE vmapped
# params-batch device call per contract when called with their defaults (the
# all_greeks path), so the bump pair is part of that batch's memo key.
DEFAULT_VEGA_BUMP = 0.01
DEFAULT_LAMBDA_BUMP = 0.1

Array = jax.Array


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_steps", "is_call", "control_variate"),
)
def _price_scalar(params: SVJParams, spot, strike, T, key, *,
                  num_paths: int, num_steps: int, is_call: bool,
                  control_variate: bool = True) -> Array:
    res = mc_price_core(
        params, spot, jnp.atleast_1d(jnp.asarray(strike, jnp.float32)), T, key,
        num_paths=num_paths, num_steps=num_steps, is_call=is_call,
        antithetic=True, control_variate=control_variate,
        cv_mode="companion",
    )
    return res["price"][0]


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_steps", "is_call", "control_variate"),
)
def price_and_greeks(params: SVJParams, spot, strike, T, key, *,
                     num_paths: int, num_steps: int, is_call: bool,
                     control_variate: bool = True):
    """(price, ∂P/∂spot, ∂P/∂T, ∂P/∂params-pytree) in one fwd+bwd pass."""
    def f(spot_, T_, params_):
        return _price_scalar(params_, spot_, strike, T_, key,
                             num_paths=num_paths, num_steps=num_steps,
                             is_call=is_call, control_variate=control_variate)

    price, (d_spot, d_T, d_params) = jax.value_and_grad(
        f, argnums=(0, 1, 2))(jnp.float32(spot), jnp.float32(T), params)
    return price, d_spot, d_T, d_params


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_steps", "is_call"),
)
def _ad_delta_batch(params, spots, strike, T, key, *, num_paths, num_steps,
                    is_call):
    """Pathwise AD delta at several spots in ONE vmapped backward pass
    (gamma's central difference needs two — they ride together)."""
    def one(s):
        return jax.grad(
            lambda ss: _price_scalar(params, ss, strike, T, key,
                                     num_paths=num_paths,
                                     num_steps=num_steps, is_call=is_call))(s)

    return jax.vmap(one)(jnp.asarray(spots, jnp.float32))


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_steps", "is_call"),
)
def _params_batch_price(params_batch, spot, strike, T, key, *, num_paths,
                        num_steps, is_call):
    """CRN prices under a batch of parameterizations (leaves carry a leading
    batch axis) — the vega/lambda FD bumps in ONE vmapped simulation."""
    def one(pp):
        return _price_scalar(pp, spot, strike, T, key, num_paths=num_paths,
                             num_steps=num_steps, is_call=is_call)

    return jax.vmap(one)(params_batch)


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_steps", "is_call"),
)
def _ad_delta_vega_batch(params, spots, v0s, strike, T, key, *, num_paths,
                         num_steps, is_call):
    """(∂P/∂spot, ∂P/∂v₀) at a batch of (spot, v₀) points, CRN, one vmapped
    backward pass. Feeds the second-order Greeks: central differences of
    these exact first derivatives give gamma / vanna / volga without the
    biased second-order pathwise AD of a kinked payoff (the ∂1_ITM δ-mass
    is invisible to AD in every bump direction, not just spot)."""
    def one(s, v):
        def f(s_, v_):
            return _price_scalar(params.replace(v0=v_), s_, strike, T, key,
                                 num_paths=num_paths, num_steps=num_steps,
                                 is_call=is_call)
        return jax.grad(f, argnums=(0, 1))(s, v)

    return jax.vmap(one)(jnp.asarray(spots, jnp.float32),
                         jnp.asarray(v0s, jnp.float32))


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_steps", "is_call"),
)
def _ad_dsdv_T_batch(params, spots, v0s, Ts, strike, key, *, num_paths,
                     num_steps, is_call):
    """(∂P/∂spot, ∂P/∂v₀) at a batch of (spot, v₀, T) points — the
    `_ad_delta_vega_batch` recipe with the maturity axis batched too, so
    the time-decay second-order Greeks (charm, color, veta) ride the same
    one-vmapped-backward-pass device program as gamma/vanna/volga. CRN:
    every point uses the SAME key and the SAME static step count (the base
    contract's), so T-bumped lanes difference against draw-identical paths.
    """
    def one(s, v, t):
        def f(s_, v_, t_):
            return _price_scalar(params.replace(v0=v_), s_, strike, t_, key,
                                 num_paths=num_paths, num_steps=num_steps,
                                 is_call=is_call)
        return jax.grad(f, argnums=(0, 1))(s, v, t)

    return jax.vmap(one)(jnp.asarray(spots, jnp.float32),
                         jnp.asarray(v0s, jnp.float32),
                         jnp.asarray(Ts, jnp.float32))


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "is_call"))
def lambda_lr_estimate(params: SVJParams, spot, strike, T, key, *,
                       num_paths: int, num_steps: int, is_call: bool):
    """Likelihood-ratio (score-function) estimator of ∂P/∂λ.

    The jump indicator 1{U < λdt} is a per-step Bernoulli(p), p = λ·dt, so
        ∂/∂λ E[f] = E[ f · Σ_t (J_t − p) / (p(1−p)) · dt ]  +  pathwise drift
    where the second term is the differentiable −λk·dt drift compensator that
    plain AD already captures. The score has zero mean, so the payoff is
    centered before multiplying (a free baseline that removes most of the LR
    variance). The reference's docstring advertises an LR vega it never
    implements (greeks.py:97-123); this is the genuine LR machinery, applied
    where it is actually *needed* — the parameter AD cannot see.

    Requires λ > 0 (the Bernoulli family is degenerate at the boundary).
    """
    from mcos_tpu.ops.simulate import _svj_step_core

    dtype = jnp.float32
    p = params
    spot = jnp.asarray(spot, dtype)
    dt = jnp.asarray(T, dtype) / num_steps
    sqrt_dt = jnp.sqrt(dt)
    prob = jnp.clip(p.lambda_j * dt, 1e-7, 1.0 - 1e-7)

    log_s0 = jnp.zeros((num_paths,), dtype)  # log(S/S0), see ops/simulate.py
    v0 = jnp.broadcast_to(jnp.asarray(p.v0, dtype), (num_paths,))
    score0 = jnp.zeros((num_paths,), dtype)

    def step(carry, step_idx):
        log_s, v, score = carry
        k_step = jax.random.fold_in(key, step_idx)
        k_norm, k_unif = jax.random.split(k_step)
        z = jax.random.normal(k_norm, (3, num_paths), dtype)
        u = jax.random.uniform(k_unif, (num_paths,), dtype)
        log_s, v = _svj_step_core(p, dt, sqrt_dt, log_s, v,
                                  z[0], z[1], u, z[2])
        jumped = (u < prob).astype(dtype)
        score = score + (jumped - prob) / (prob * (1.0 - prob)) * dt
        return (log_s, v, score), None

    (log_s, _, score), _ = jax.lax.scan(
        step, (log_s0, v0, score0), jnp.arange(num_steps))
    s_final = spot * jnp.exp(log_s)
    pay = jnp.maximum(s_final - strike, 0.0) if is_call \
        else jnp.maximum(strike - s_final, 0.0)
    discount = jnp.exp(-p.r * jnp.asarray(T, dtype))
    centered = pay - jnp.mean(pay)
    lr_term = discount * jnp.mean(centered * score)
    se = discount * jnp.std(centered * score) / jnp.sqrt(num_paths)

    # Pathwise drift-compensator term: ∂/∂λ of the −λk·T drift on log S.
    k_comp = jnp.exp(p.mu_j + 0.5 * p.sigma_j**2) - 1.0
    drift_term = discount * jnp.mean(
        jnp.where(pay > 0, 1.0, 0.0) * s_final * (-k_comp)
        * jnp.asarray(T, dtype)) * jnp.where(is_call, 1.0, -1.0)
    return lr_term + drift_term, se


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_steps", "is_call", "with_lr"),
)
def _all_greeks_device(params, spot, strike, T, key, *, num_paths,
                       num_steps, is_call, with_lr,
                       bump=0.01, v_bump=DEFAULT_VEGA_BUMP,
                       l_bump=DEFAULT_LAMBDA_BUMP):
    """Every all_greeks ingredient off ONE simulation pass (fwd + bwd).

    v1 fused five independently-scanned blocks into one dispatch; the
    remaining cost was *sequential scan-step latency* — ~175 steps across
    the blocks dominated the ms/contract figure (measured 103 ms at
    200k×25 where the backward-pass core alone is ~10 ms; each step is
    launch-latency, not FLOPs). v2 collapses the simulation work to ONE
    5-member vmapped scan (+ its backward), ~50 sequential steps total:

    - members: [base, v0±bump, λ±bump] with stop_gradient on the bumped
      four, all on the SAME key (CRN) — one vmapped fwd gives the base
      terminals AND the four FD cross-check prices; value_and_grad of the
      member-0 price gives delta/theta/rho/∂params exactly as before.
    - spot-bump CRN prices: SVJ log-dynamics are spot-independent, so
      P((1±b)S, K) = (1±b)·P(S, K/(1±b)) on the SAME terminals — pure
      payoff algebra, zero extra simulation (the identity
      _spot_bump_prices documents).
    - AD delta pair for gamma: ∂P/∂spot at spot(1±b) differentiates only
      the payoff/CV materialization (spot never enters the scan carry),
      again on frozen terminals — replaces a second fwd+bwd scan pair.
    - LR λ-score: accumulated inside the same base scan
      (ops/simulate.py:simulate_terminal_members), zero extra passes.
    """
    from mcos_tpu.ops.simulate import simulate_terminal_members

    strike_arr = jnp.atleast_1d(jnp.asarray(strike, jnp.float32))
    rel = jnp.asarray([1.0 + bump, 1.0 - bump], jnp.float32)
    sg = jax.lax.stop_gradient

    def price_from_terminals(pp, s_final, g_final, spot_, strikes_, T_):
        """CV-companion β=1 price vector — the exact mc_price_core
        arithmetic (engine/pricer.py:_finalize_price) on given terminals."""
        pay = simulate.vanilla_payoff(
            s_final[None], strikes_[:, None, None], is_call)
        pay = simulate.combine_antithetic(jnp.swapaxes(pay, 0, 1))
        ctrl = simulate.vanilla_payoff(
            g_final[None], strikes_[:, None, None], is_call)
        ctrl = simulate.combine_antithetic(jnp.swapaxes(ctrl, 0, 1))
        discount = jnp.exp(-pp.r * T_)
        bs_ref = bs_price(spot_, strikes_, T_, pp.r, pp.q,
                          jnp.sqrt(pp.v0), is_call)
        eff = pay - (ctrl - bs_ref[:, None] / discount)
        return discount * jnp.mean(eff, axis=-1)

    def fused(params_, spot_, T_):
        """Base member only: differentiable fwd; its backward is the ONE
        scan the whole Greeks block pays for. The four FD members run in
        a separate fwd-only scan below — putting them in this batch would
        widen the backward 5× for zero cotangents (dead scan lanes are not
        eliminated from the backward pass)."""
        from mcos_tpu.ops.simulate import simulate_terminal_with_score

        s0, _, g0, score = simulate_terminal_with_score(
            params_, spot_, T_, key, num_paths=num_paths,
            num_steps=num_steps, antithetic=True, companion=True)
        price0 = price_from_terminals(params_, s0, g0, spot_, strike_arr,
                                      T_)[0]
        return price0, (s0, g0, score)

    spot_f = jnp.float32(spot)
    T_f = jnp.float32(T)
    (price, aux), (d_params, d_spot, d_T) = jax.value_and_grad(
        fused, argnums=(0, 1, 2), has_aux=True)(params, spot_f, T_f)
    s0, g0, score = sg(aux[0]), sg(aux[1]), aux[2]

    # The four CRN FD members (v0±, λ±) in one fwd-only member scan on the
    # SAME key folding (simulate_terminal_members is draw-identical to the
    # base sim), entirely outside the backward.
    members4 = [
        sg(params.replace(v0=params.v0 + v_bump)),
        sg(params.replace(v0=jnp.maximum(params.v0 - v_bump, 0.001))),
        sg(params.replace(lambda_j=params.lambda_j + l_bump)),
        sg(params.replace(lambda_j=jnp.maximum(params.lambda_j - l_bump,
                                               0.0))),
    ]
    batch4 = jax.tree.map(
        lambda *xs: jnp.stack([jnp.asarray(x, jnp.float32) for x in xs]),
        *members4)
    s4, g4, _ = simulate_terminal_members(
        batch4, spot_f, T_f, key, num_paths=num_paths, num_steps=num_steps)
    prices4 = jax.vmap(
        lambda pp, s, g: price_from_terminals(pp, s, g, spot_f, strike_arr,
                                              T_f)[0])(batch4, s4, g4)

    # Spot-bump CRN prices by strike homogeneity (zero extra simulation).
    spot_bumped = price_from_terminals(
        params, s0, g0, spot_f, strike_arr[0] / rel, T_f)

    # AD delta at spot(1±b): terminals scale linearly in spot, so only the
    # materialization differentiates — same value the full AD gives.
    def p_at_spot(sp):
        scale = sp / spot_f
        return price_from_terminals(params, s0 * scale, g0 * scale, sp,
                                    strike_arr, T_f)[0]

    d_up = jax.grad(p_at_spot)(spot_f * (1.0 + bump))
    d_dn = jax.grad(p_at_spot)(spot_f * (1.0 - bump))

    out = {
        "price": price, "d_spot": d_spot, "d_T": d_T, "d_params": d_params,
        "spot_bumped": spot_bumped, "pbatch": prices4,
        "d_pair": jnp.stack([d_up, d_dn]),
    }
    if with_lr:
        # LR λ-estimator off the SAME base sample (2n antithetic values,
        # score shared across the branch pair — lambda_lr_estimate
        # arithmetic on the fused terminals).
        discount = jnp.exp(-params.r * T_f)
        pay_b = simulate.vanilla_payoff(s0, strike_arr[0], is_call)
        # The score is SHARED across the antithetic branch pair, so the 2n
        # (payoff·score) values are pairwise correlated — std/√(2n) would
        # understate the stderr by ~√2. Collapse each pair to its mean
        # first: same point estimate, honest stderr over n iid pairs
        # (matches lambda_lr_estimate's single-branch arithmetic).
        pair_pay = jnp.mean(pay_b, axis=0)                       # (n,)
        centered = pair_pay - jnp.mean(pair_pay)
        vals = centered * score
        out["lr_raw"] = discount * jnp.mean(vals)
        out["lr_se"] = (discount * jnp.std(vals)
                        / jnp.sqrt(jnp.float32(vals.shape[0])))
        k_comp = jnp.exp(params.mu_j + 0.5 * params.sigma_j**2) - 1.0
        pay_flat = pay_b.reshape(-1)
        out["lr_drift"] = discount * jnp.mean(
            jnp.where(pay_flat > 0, 1.0, 0.0)
            * s0.reshape(-1) * (-k_comp) * T_f) \
            * jnp.where(jnp.asarray(is_call), 1.0, -1.0)
    return out


class GreeksEngine:
    """Reference-API-compatible Greeks engine (engine/greeks.py:20-31 ctor)."""

    def __init__(self, params: SVJParams, num_paths: int = DEFAULT_NUM_PATHS,
                 num_steps: int = 252, seed: int = 42):
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        # Result memos (JAX caches compilations, not executions): within one
        # `all_greeks` call every first-order block reads the same backward
        # pass, and the delta/gamma FD cross-checks share their CRN bump
        # prices. Keys carry the full engine state, so mutating params/seed
        # between calls invalidates naturally. Bounded: cleared per contract.
        self._memo: Dict[tuple, object] = {}

    # -- internals -------------------------------------------------------------
    def _key(self) -> Array:
        return jax.random.key(self.seed)

    def _steps(self, T: float) -> int:
        return scaled_steps(self.num_steps, T)

    def _state_key(self, params) -> tuple:
        return (self.num_paths, self.num_steps, self.seed,
                tuple(sorted(params.as_dict().items())))

    def _price(self, params, spot, strike, T, is_call,
               control_variate=True) -> float:
        k = ("price", float(spot), float(strike), float(T), bool(is_call),
             bool(control_variate), self._state_key(params))
        if k not in self._memo:
            if len(self._memo) > 256:
                self._memo.clear()
            self._memo[k] = float(_price_scalar(
                params, spot, strike, T, self._key(),
                num_paths=self.num_paths, num_steps=self._steps(T),
                is_call=is_call, control_variate=control_variate))
        return self._memo[k]

    def _grads(self, spot, strike, T, is_call):
        k = ("grads", float(spot), float(strike), float(T), bool(is_call),
             self._state_key(self.params))
        if k not in self._memo:
            if len(self._memo) > 256:
                self._memo.clear()
            out = price_and_greeks(
                self.params, spot, strike, T, self._key(),
                num_paths=self.num_paths, num_steps=self._steps(T),
                is_call=is_call)
            price, d_spot, d_T, d_params = jax.device_get(out)  # ONE transfer
            self._memo[k] = (float(price), float(d_spot), float(d_T),
                             jax.tree.map(float, d_params))
        return self._memo[k]

    def _spot_bump_prices(self, spot, strike, T, is_call, bump):
        """(P(spot(1+b), K), P(spot(1−b), K)) in ONE device call.

        SVJ log-dynamics are independent of S₀, so a spot bump is a payoff
        transform on the shared path set: P((1±b)S, K) = (1±b)·P(S, K/(1±b))
        — both bumps are rows of one strike-vectorized pricing (the same
        identity the stress ladder uses, engine/risk.py).
        """
        k = ("spot2", float(spot), float(strike), float(T), bool(is_call),
             float(bump), self._state_key(self.params))
        if k not in self._memo:
            if len(self._memo) > 256:
                self._memo.clear()
            rel = np.array([1.0 + bump, 1.0 - bump])
            res = mc_price_core(
                self.params, spot, jnp.asarray(strike / rel, jnp.float32), T,
                self._key(), num_paths=self.num_paths,
                num_steps=self._steps(T), is_call=is_call,
                antithetic=True, control_variate=True, cv_mode="companion")
            pr = np.asarray(jax.device_get(res["price"]), np.float64) * rel
            self._memo[k] = (float(pr[0]), float(pr[1]))
        return self._memo[k]

    def _param_bump_prices(self, spot, strike, T, is_call,
                           v_bump, l_bump):
        """CRN prices at (v0±b_v, λ±b_λ) — one vmapped params batch."""
        k = ("pbatch", float(spot), float(strike), float(T), bool(is_call),
             float(v_bump), float(l_bump), self._state_key(self.params))
        if k not in self._memo:
            if len(self._memo) > 256:
                self._memo.clear()
            p = self.params
            v0, lam = float(p.v0), float(p.lambda_j)
            v0_up, v0_dn = v0 + v_bump, max(v0 - v_bump, 0.001)
            lam_up, lam_dn = lam + l_bump, max(lam - l_bump, 0.0)
            members = [p.replace(v0=v0_up), p.replace(v0=v0_dn),
                       p.replace(lambda_j=lam_up), p.replace(lambda_j=lam_dn)]
            batch = jax.tree.map(
                lambda *xs: jnp.stack([jnp.asarray(x, jnp.float32)
                                       for x in xs]), *members)
            arr = np.asarray(jax.device_get(_params_batch_price(
                batch, spot, strike, T, self._key(),
                num_paths=self.num_paths, num_steps=self._steps(T),
                is_call=is_call)), np.float64)
            self._memo[k] = {
                "v0_up": (v0_up, float(arr[0])),
                "v0_dn": (v0_dn, float(arr[1])),
                "lam_up": (lam_up, float(arr[2])),
                "lam_dn": (lam_dn, float(arr[3])),
            }
        return self._memo[k]

    def _ad_delta_pair(self, spot, strike, T, is_call, bump):
        """AD deltas at spot(1±b) — one vmapped backward pass."""
        k = ("adpair", float(spot), float(strike), float(T), bool(is_call),
             float(bump), self._state_key(self.params))
        if k not in self._memo:
            if len(self._memo) > 256:
                self._memo.clear()
            d = np.asarray(jax.device_get(_ad_delta_batch(
                self.params, [spot * (1 + bump), spot * (1 - bump)], strike,
                T, self._key(), num_paths=self.num_paths,
                num_steps=self._steps(T), is_call=is_call)), np.float64)
            self._memo[k] = (float(d[0]), float(d[1]))
        return self._memo[k]

    # -- reference API -----------------------------------------------------------
    def delta(self, spot: float, strike: float, T: float,
              is_call: bool = True, bump: float = 0.01) -> Dict[str, float]:
        """AD pathwise delta + CRN-FD cross-check (greeks.py:53-95 contract)."""
        _, d_spot, _, _ = self._grads(spot, strike, T, is_call)
        pathwise = float(d_spot)

        p_up, p_dn = self._spot_bump_prices(spot, strike, T, is_call, bump)
        fd = (p_up - p_dn) / (2 * spot * bump)
        return {
            "pathwise": pathwise,
            "finite_diff": float(fd),
            "diff_pct": float(abs(pathwise - fd) / max(abs(fd), 1e-10) * 100),
        }

    def vega(self, spot: float, strike: float, T: float,
             is_call: bool = True,
             bump: float = DEFAULT_VEGA_BUMP) -> Dict[str, float]:
        """Exact ∂P/∂v₀ via AD; ×2σ per-vol-point conversion
        (greeks.py:156-160 convention); CRN-FD cross-check."""
        _, _, _, d_params = self._grads(spot, strike, T, is_call)
        ad_vega = float(d_params.v0)

        v0 = float(self.params.v0)
        pb = self._param_bump_prices(spot, strike, T, is_call,
                                     v_bump=bump, l_bump=DEFAULT_LAMBDA_BUMP)
        (v0_up, p_up), (v0_dn, p_dn) = pb["v0_up"], pb["v0_dn"]
        fd = (p_up - p_dn) / (v0_up - v0_dn)
        sigma = v0 ** 0.5
        return {
            "fd_vega_v0": float(fd),
            "ad_vega_v0": ad_vega,
            "vega_per_vol_point": ad_vega * 2 * sigma,
            "diff_pct": float(abs(ad_vega - fd) / max(abs(fd), 1e-10) * 100),
        }

    def gamma(self, spot: float, strike: float, T: float,
              is_call: bool = True, bump: float = 0.01) -> Dict[str, float]:
        """Central CRN-FD of the AD delta (see module docstring on why not
        second-order AD). Returns the reference's key set
        (greeks.py:196-203) with prices from the same CRN stream."""
        h = spot * bump
        s_up, s_dn = spot * (1 + bump), spot * (1 - bump)
        d_up, d_dn = self._ad_delta_pair(spot, strike, T, is_call, bump)
        gamma = (d_up - d_dn) / (s_up - s_dn)

        p_base = self._grads(spot, strike, T, is_call)[0]
        # Same bump as delta()'s FD, so the batched CRN prices are shared.
        p_up, p_dn = self._spot_bump_prices(spot, strike, T, is_call, bump)
        return {
            "gamma": float(gamma),
            "gamma_fd2": float((p_up - 2 * p_base + p_dn) / (h * h)),
            "price_up": p_up,
            "price_base": p_base,
            "price_down": p_dn,
        }

    def theta(self, spot: float, strike: float, T: float,
              is_call: bool = True, dt: float = 1 / 252) -> Dict[str, float]:
        """Exact −∂P/∂T via AD. The reference computes
        −(P(T)−P(T−dt))/dt and calls it `theta_daily` (greeks.py:205-222);
        we keep its numeric convention (annualized decay under that key)."""
        del dt  # AD needs no step size
        _, _, d_T, _ = self._grads(spot, strike, T, is_call)
        theta_val = -float(d_T)
        return {
            "theta_daily": theta_val,
            "theta_annual": theta_val * 252,
        }

    def rho(self, spot: float, strike: float, T: float,
            is_call: bool = True, bump: float = 0.0001) -> Dict[str, float]:
        """Exact ∂P/∂r via AD (replaces the ±1bp bump at greeks.py:224-252)."""
        del bump
        _, _, _, d_params = self._grads(spot, strike, T, is_call)
        rho_val = float(d_params.r)
        return {
            "rho": rho_val,
            "rho_per_rate_point": rho_val / 100,
        }

    def jump_sensitivities(self, spot: float, strike: float, T: float,
                           is_call: bool = True,
                           bump: float = DEFAULT_LAMBDA_BUMP
                           ) -> Dict[str, float]:
        """Jump-parameter sensitivities.

        μ_J, σ_J: exact pathwise AD. λ: CRN central FD (shared jump uniforms
        ⇒ only paths whose uniforms fall in the bumped band flip, so the FD
        noise is tiny); the pathwise-AD λ value (drift-compensator term only)
        is exposed for comparison. Capability absent from the reference.
        """
        _, _, _, d_params = self._grads(spot, strike, T, is_call)
        pb = self._param_bump_prices(spot, strike, T, is_call,
                                     v_bump=DEFAULT_VEGA_BUMP, l_bump=bump)
        (lam_up, p_up), (lam_dn, p_dn) = pb["lam_up"], pb["lam_dn"]
        denom = max(lam_up - lam_dn, 1e-12)
        out = {
            "lambda_j": float((p_up - p_dn) / denom),
            "lambda_j_drift_only": float(d_params.lambda_j),
            "mu_j": float(d_params.mu_j),
            "sigma_j": float(d_params.sigma_j),
        }
        if float(self.params.lambda_j) > 1e-6:
            klr = ("lr", float(spot), float(strike), float(T), bool(is_call),
                   self._state_key(self.params))
            if klr not in self._memo:
                lr, lr_se = jax.device_get(lambda_lr_estimate(
                    self.params, spot, strike, T, self._key(),
                    num_paths=self.num_paths, num_steps=self._steps(T),
                    is_call=is_call))
                self._memo[klr] = (float(lr), float(lr_se))
            out["lambda_j_lr"], out["lambda_j_lr_se"] = self._memo[klr]
        return out

    def min_variance_delta(self, spot: float, strike: float, T: float,
                           is_call: bool = True) -> Dict[str, float]:
        """Minimum-variance hedge ratio under stochastic vol (Hull & White
        2017, "Optimal Delta Hedging for Options").

        Spot and vol moves are correlated (ρ<0 on equity desks), so the
        hedge that minimizes the local P&L variance is NOT the pathwise
        delta. Between jumps, with dS = S√v dW₁ + O(dt) and
        dv = ξ√v dW₂ + O(dt), corr(dW₁,dW₂) = ρ:

            h* = argmin_h Var(dP − h·dS) = Cov(dP, dS)/Var(dS)
               = ∂P/∂S + (∂P/∂v)·Cov(dv,dS)/Var(dS)
               = Δ + (∂P/∂v₀)·ρξ/S.

        Both partials come from the SAME one-backward-pass AD grads that
        feed delta() and vega() — no extra device work. With ρ<0 and
        ∂P/∂v>0 the MV ratio sits below Δ: down-moves arrive with vol
        up-moves, and the vega gain hedges part of the delta loss. Jump
        co-moves are outside the diffusion-local objective (gap risk is
        what the λ/LR sensitivities and the stress ladders carry).
        Capability absent from the reference (delta-only hedging,
        risk.py:283). Validated in-economy by the hedging backtest:
        `HedgingBacktest.run_backtest(dynamics="svj", hedge="mv_delta")`
        shows lower P&L dispersion than the plain BS-delta hedge.
        """
        _, d_spot, _, d_params = self._grads(spot, strike, T, is_call)
        p = self.params
        adjustment = (float(d_params.v0) * float(p.rho) * float(p.xi)
                      / float(spot))
        return {
            "delta": float(d_spot),
            "dP_dv0": float(d_params.v0),
            "adjustment": float(adjustment),
            "mv_delta": float(d_spot + adjustment),
        }

    def cross_greeks(self, spot: float, strike: float, T: float,
                     is_call: bool = True, spot_bump: float = 0.01,
                     vol_bump: float = 0.02) -> Dict[str, float]:
        """Second-order cross Greeks: vanna (∂²P/∂S∂σ) and volga (∂²P/∂σ²).

        Central CRN differences of exact AD first derivatives at a 4-point
        (spot, v₀) batch — one vmapped backward pass (same recipe as gamma;
        see _ad_delta_vega_batch on why not raw second-order AD).

        The vol axis is bumped *multiplicatively in σ* (v₀(1±b)² ⇔ σ(1±b))
        and volga differences the σ-vega g(σ) = 2σ·∂P/∂v₀ directly.
        Reconstructing ∂²P/∂σ² from v₀-space second differences
        (2·P_v + 4v·P_vv) is numerically poisoned near ATM: the two terms
        are each ~100× the result, so sub-percent FD error in P_vv destroys
        it (measured: 40% off on the BS oracle) — the direct σ-difference
        has no cancellation. Capability absent from the reference
        (first-order FD only, greeks.py:53-252).
        """
        p = self.params
        v0 = float(p.v0)
        sigma = float(np.sqrt(v0))
        sig_up, sig_dn = sigma * (1 + vol_bump), sigma * (1 - vol_bump)
        v_up, v_dn = sig_up**2, sig_dn**2
        s_up, s_dn = spot * (1 + spot_bump), spot * (1 - spot_bump)
        k = ("cross", float(spot), float(strike), float(T), bool(is_call),
             float(spot_bump), float(vol_bump), self._state_key(p))
        if k not in self._memo:
            if len(self._memo) > 256:
                self._memo.clear()
            d_s, d_v = jax.device_get(_ad_delta_vega_batch(
                p, [s_up, s_dn, spot, spot], [v0, v0, v_up, v_dn],
                strike, T, self._key(), num_paths=self.num_paths,
                num_steps=self._steps(T), is_call=is_call))
            self._memo[k] = (np.asarray(d_s, np.float64),
                             np.asarray(d_v, np.float64))
        d_s, d_v = self._memo[k]

        d_sig = sig_up - sig_dn
        # vanna two ways off the same batch: ∂delta/∂σ and ∂(σ-vega)/∂S —
        # equal up to FD error (Schwarz symmetry), both reported.
        vanna = (d_s[2] - d_s[3]) / d_sig
        vanna_alt = 2 * sigma * (d_v[0] - d_v[1]) / (s_up - s_dn)
        volga = (2 * sig_up * d_v[2] - 2 * sig_dn * d_v[3]) / d_sig
        return {
            "vanna": float(vanna),
            "vanna_cross_check": float(vanna_alt),
            "volga": float(volga),
            "vanna_v0": float(vanna / (2 * sigma)),
        }

    def second_order_greeks(self, spot: float, strike: float, T: float,
                            is_call: bool = True, spot_bump: float = 0.01,
                            vol_bump: float = 0.02,
                            t_bump: float = 1 / 252) -> Dict[str, float]:
        """The remaining second/third-order Greeks: charm, speed, zomma,
        color, veta — all central CRN differences of *exact AD first
        derivatives* at a 12-point (spot, v₀, T) batch, ONE vmapped
        backward pass (the gamma/vanna/volga recipe extended with a
        maturity axis; see _ad_delta_vega_batch on why not raw
        second-order AD of a kinked payoff).

        Sign conventions (annualized; *_daily = /252):
        - charm = −∂Δ/∂T  (delta drift per year of calendar time passing)
        - speed =  ∂Γ/∂S  (third spot derivative, ∂³P/∂S³)
        - zomma =  ∂Γ/∂σ  (σ bumped multiplicatively, like volga)
        - color = −∂Γ/∂T  (gamma drift per calendar year)
        - veta  = −∂(2σ·∂P/∂v₀)/∂T  (σ-vega drift per calendar year)

        Capability absent from the reference (first-order FD only,
        greeks.py:53-252). Degenerate-SVJ values are pinned against
        f64 closed-form Black-Scholes derivatives in tests/test_greeks.py.
        """
        p = self.params
        v0 = float(p.v0)
        sigma = float(np.sqrt(v0))
        sig_up, sig_dn = sigma * (1 + vol_bump), sigma * (1 - vol_bump)
        v_up, v_dn = sig_up**2, sig_dn**2
        s_up, s_dn = spot * (1 + spot_bump), spot * (1 - spot_bump)
        h = spot * spot_bump
        ht = min(t_bump, T / 4)  # keep T−ht well inside (0, T)
        t_up, t_dn = T + ht, T - ht
        k = ("second", float(spot), float(strike), float(T), bool(is_call),
             float(spot_bump), float(vol_bump), float(ht),
             self._state_key(p))
        if k not in self._memo:
            if len(self._memo) > 256:
                self._memo.clear()
            pts = [
                (s_up, v0, T), (s_dn, v0, T),          # 0,1  gamma/speed
                (spot, v0, t_up), (spot, v0, t_dn),    # 2,3  charm/veta
                (s_up, v_up, T), (s_dn, v_up, T),      # 4,5  zomma (σ↑)
                (s_up, v_dn, T), (s_dn, v_dn, T),      # 6,7  zomma (σ↓)
                (s_up, v0, t_up), (s_dn, v0, t_up),    # 8,9  color (T↑)
                (s_up, v0, t_dn), (s_dn, v0, t_dn),    # 10,11 color (T↓)
            ]
            d_s, d_v = jax.device_get(_ad_dsdv_T_batch(
                p, [x[0] for x in pts], [x[1] for x in pts],
                [x[2] for x in pts], strike, self._key(),
                num_paths=self.num_paths, num_steps=self._steps(T),
                is_call=is_call))
            self._memo[k] = (np.asarray(d_s, np.float64),
                             np.asarray(d_v, np.float64))
        d_s, d_v = self._memo[k]

        # Base delta off the memoized fused backward pass (CRN: same key).
        _, delta0, _, _ = self._grads(spot, strike, T, is_call)

        def gam(i_up, i_dn):
            return (d_s[i_up] - d_s[i_dn]) / (s_up - s_dn)

        d_sig = sig_up - sig_dn
        gamma0 = gam(0, 1)
        charm_dT = (d_s[2] - d_s[3]) / (2 * ht)
        speed = (d_s[0] - 2 * delta0 + d_s[1]) / (h * h)
        zomma = (gam(4, 5) - gam(6, 7)) / d_sig
        color_dT = (gam(8, 9) - gam(10, 11)) / (2 * ht)
        # σ-vega(T±ht) = 2σ·∂P/∂v₀ on the charm lanes.
        veta_dT = 2 * sigma * (d_v[2] - d_v[3]) / (2 * ht)
        return {
            "charm": float(-charm_dT),
            "charm_daily": float(-charm_dT / 252),
            "speed": float(speed),
            "zomma": float(zomma),
            "color": float(-color_dT),
            "color_daily": float(-color_dT / 252),
            "veta": float(-veta_dT),
            "veta_daily": float(-veta_dT / 252),
            "gamma_check": float(gamma0),
            "dDelta_dT": float(charm_dT),
            "dGamma_dT": float(color_dT),
        }

    def model_sensitivities(self, spot: float, strike: float, T: float,
                            is_call: bool = True) -> Dict[str, float]:
        """∂P/∂{κ, θ, ξ, ρ} — exact AD model-risk sensitivities (new)."""
        _, _, _, d = self._grads(spot, strike, T, is_call)
        return {"kappa": float(d.kappa), "theta": float(d.theta),
                "xi": float(d.xi), "rho_corr": float(d.rho)}

    def _store_device_out(self, out, spot: float, strike: float, T: float,
                          is_call: bool, with_lr: bool) -> None:
        """Fill every block's memo from a host-materialized
        `_all_greeks_device` result."""
        state = self._state_key(self.params)
        p = self.params
        bump = 0.01
        v0, lam = float(p.v0), float(p.lambda_j)
        v0_up, v0_dn = v0 + DEFAULT_VEGA_BUMP, max(v0 - DEFAULT_VEGA_BUMP,
                                                   0.001)
        lam_up = lam + DEFAULT_LAMBDA_BUMP
        lam_dn = max(lam - DEFAULT_LAMBDA_BUMP, 0.0)
        rel = np.array([1.0 + bump, 1.0 - bump])
        args = (float(spot), float(strike), float(T), bool(is_call))
        self._memo[("grads", *args, state)] = (
            float(out["price"]), float(out["d_spot"]), float(out["d_T"]),
            jax.tree.map(float, out["d_params"]))
        pr = np.asarray(out["spot_bumped"], np.float64) * rel
        self._memo[("spot2", *args, float(bump), state)] = \
            (float(pr[0]), float(pr[1]))
        pb = np.asarray(out["pbatch"], np.float64)
        self._memo[("pbatch", *args, float(DEFAULT_VEGA_BUMP),
                    float(DEFAULT_LAMBDA_BUMP), state)] = {
            "v0_up": (v0_up, float(pb[0])), "v0_dn": (v0_dn, float(pb[1])),
            "lam_up": (lam_up, float(pb[2])),
            "lam_dn": (lam_dn, float(pb[3])),
        }
        dp = np.asarray(out["d_pair"], np.float64)
        self._memo[("adpair", *args, float(bump), state)] = \
            (float(dp[0]), float(dp[1]))
        if with_lr:
            self._memo[("lr", *args, state)] = (
                float(out["lr_raw"]) + float(out["lr_drift"]),
                float(out["lr_se"]))

    def _prefetch_all(self, spot: float, strike: float, T: float,
                      is_call: bool) -> None:
        """Fill every block's memo from ONE fused device program + ONE
        host transfer (see _all_greeks_device)."""
        state = self._state_key(self.params)
        kg = ("grads", float(spot), float(strike), float(T), bool(is_call),
              state)
        if kg in self._memo:
            return
        if len(self._memo) > 256:
            self._memo.clear()
        with_lr = float(self.params.lambda_j) > 1e-6
        out = jax.device_get(_all_greeks_device(
            self.params, spot, strike, T, self._key(),
            num_paths=self.num_paths, num_steps=self._steps(T),
            is_call=is_call, with_lr=with_lr))
        self._store_device_out(out, spot, strike, T, is_call, with_lr)

    def all_greeks(self, spot: float, strike: float, T: float,
                   is_call: bool = True) -> Dict[str, Dict]:
        """All Greeks (reference key layout, greeks.py:254-263) — ONE fused
        device program + ONE host transfer feeds all seven blocks."""
        self._prefetch_all(spot, strike, T, is_call)
        return {
            "delta": self.delta(spot, strike, T, is_call),
            "vega": self.vega(spot, strike, T, is_call),
            "gamma": self.gamma(spot, strike, T, is_call),
            "theta": self.theta(spot, strike, T, is_call),
            "rho": self.rho(spot, strike, T, is_call),
            "jumps": self.jump_sensitivities(spot, strike, T, is_call),
            "model": self.model_sensitivities(spot, strike, T, is_call),
        }

    def all_greeks_dividends(self, spot: float, strike: float, T: float,
                             is_call: bool, dividends) -> Dict[str, Dict]:
        """all_greeks with a discrete dividend schedule (ops/dividends.py).

        The core engine prices the *effective* process: spot·Π(1−d) for
        proportional dividends (exact under the multiplicative dynamics) or
        the escrowed spot S − PV_r(divs) for cash. Greeks taken w.r.t. the
        effective spot convert back to raw-spot Greeks by the chain rule:

            Δ = f·Δ_eff,  Γ = f²·Γ_eff        (f = ∂S_eff/∂S)
            ρ = ρ_eff + Δ_eff·∂S_eff/∂r        (escrowed cash only:
                                                ∂S_eff/∂r = Σ t_i D_i e^{−rt_i})

        vega/theta/jump/model sensitivities pass through unchanged (the
        adjustment is independent of v₀ and, between ex-dates, of T).
        """
        from mcos_tpu.ops.dividends import effective_spot, pv_cash

        r = float(self.params.r)
        eff, f = effective_spot(spot, dividends, r, float(T))
        out = self.all_greeks(eff, strike, T, is_call)
        if f != 1.0:
            for key in ("pathwise", "finite_diff"):
                out["delta"][key] *= f
            for key in ("gamma", "gamma_fd2"):
                out["gamma"][key] *= f * f
        if dividends is not None and dividends.kind == "cash"                 and dividends.before(float(T)):
            sub = dividends.before(float(T))
            ds_dr = sum(t * a * math.exp(-r * t)
                        for t, a in zip(sub.times, sub.amounts))
            rho_extra = out["delta"]["pathwise"] * ds_dr
            out["rho"]["rho"] += rho_extra
            out["rho"]["rho_per_rate_point"] += rho_extra / 100
            out["dividends"] = {"model": "escrowed",
                                "spot_effective": eff,
                                "pv": pv_cash(dividends, r, float(T))}
        elif dividends is not None and dividends.before(float(T)):
            out["dividends"] = {"model": "proportional-exact",
                                "spot_effective": eff,
                                "chain_factor": f}
        return out

    def all_greeks_chain(self, spot: float, strikes, T: float,
                         is_call: bool = True) -> list:
        """All Greeks for a strike CHAIN with pipelined dispatch.

        `all_greeks` per contract pays one synchronous device_get per
        call. JAX dispatch is asynchronous, so the chain path enqueues
        EVERY contract's fused program first and synchronizes ONCE; the
        host waits once per chain instead of once per contract.
        Returns a list of per-contract all_greeks dicts (same layout)."""
        if len(self._memo) > 256:
            self._memo.clear()
        with_lr = float(self.params.lambda_j) > 1e-6
        steps = self._steps(T)
        pending = [
            _all_greeks_device(
                self.params, spot, float(k), T, self._key(),
                num_paths=self.num_paths, num_steps=steps,
                is_call=is_call, with_lr=with_lr)
            for k in strikes
        ]                                  # async enqueue, no host sync
        outs = jax.device_get(pending)     # ONE synchronization
        results = []
        for k, out in zip(strikes, outs):
            self._store_device_out(out, spot, float(k), T, is_call, with_lr)
            results.append({
                "strike": float(k),
                "delta": self.delta(spot, float(k), T, is_call),
                "vega": self.vega(spot, float(k), T, is_call),
                "gamma": self.gamma(spot, float(k), T, is_call),
                "theta": self.theta(spot, float(k), T, is_call),
                "rho": self.rho(spot, float(k), T, is_call),
                "jumps": self.jump_sensitivities(spot, float(k), T,
                                                 is_call),
                "model": self.model_sensitivities(spot, float(k), T,
                                                  is_call),
            })
        return results
