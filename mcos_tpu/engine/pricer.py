"""Monte Carlo pricing runtime.

Re-design of the reference's `MonteCarloEngine`
(reference: engine/monte_carlo.py:249-471).

Architecture:

- `mc_price_core(...)` is a *pure functional* pricer: params in, price/stderr
  pytree out. It is jit-compiled, differentiable end-to-end (used by the
  AD Greeks engine), and vmappable over strikes (used by `price_batch` and the
  smile endpoint — the reference loops strikes in Python at
  monte_carlo.py:420-448; here strikes are a vectorized payoff axis over one
  shared terminal-spot tensor).
- `MonteCarloEngine` is a thin stateful wrapper exposing the reference's API
  surface (`price`, `price_batch`, `get_sample_paths`) with the same result
  keys, so downstream engines and the HTTP layer translate 1:1.

Variance reduction:
- antithetic pairs ride a single fused pass (sign-flip on normals, shared jump
  uniforms — monte_carlo.py:318-324), matching the reference exactly;
- the Black-Scholes control variate (σ = √v0, β = 1) is implemented
  *correctly*: a GBM companion leg driven by the same dW₁ provides a control
  whose expectation is the analytic BS price. The reference instead reuses the
  SVJ payoff itself as the "BS leg" (monte_carlo.py:358-362), which makes its
  CV-adjusted price an unbiased estimator of the **Black-Scholes** price — all
  SVJ skew/jump effects are cancelled whenever use_control_variate=True (its
  default). `cv_mode="reference"` reproduces that arithmetic for parity
  testing; the default `cv_mode="companion"` keeps the SVJ price unbiased and
  still collapses variance in the BS limit.

Random drivers:
- "threefry": counter-based keys, device-foldable for sharded scale.
- "sobol": scrambled Sobol + Brownian-bridge (mcos_tpu.ops.sobol), the
  reference's default driver (monte_carlo.py:290-299); the bridge is a
  precomputed matrix so path construction is one matmul. Scales past one
  chip via index-partitioned slices of the ONE global sequence
  (parallel/mesh.py:sharded_sobol_price — each device generates points
  [i·ppd, (i+1)·ppd) with the offset XOR expansion, so the device union is
  exactly the single-host point set).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import (
    DEFAULT_NUM_PATHS,
    DEFAULT_NUM_STEPS,
    DEFAULT_TOLERANCE,
    MAX_PATHS,
    scaled_steps,
)
from mcos_tpu.models.params import SVJParams
from mcos_tpu.ops import simulate
from mcos_tpu.ops.backend import SVJ_EULER_DRAWS, simulator_for
from mcos_tpu.ops.bs import bs_price

Array = jax.Array


# ─────────────────────────────────────────────────────────────────────────────
# Functional core
# ─────────────────────────────────────────────────────────────────────────────
def _payoff_table(s_final: Array, strikes: Array, is_call: bool) -> Array:
    """(n_branch, paths) terminal spots → antithetic-combined (K, paths) payoffs."""
    pay = simulate.vanilla_payoff(s_final[None], strikes[:, None, None], is_call)
    return simulate.combine_antithetic(jnp.swapaxes(pay, 0, 1))


def _finalize_price(
    params: SVJParams, spot, strikes, T, discount,
    pay: Array, s_final: Array, g_final: Optional[Array],
    is_call: bool, control_variate: bool, cv_mode: str,
    cv_beta: str = "one",
) -> Dict[str, Array]:
    """Shared price/stderr/CV arithmetic for both random drivers.

    cv_beta: "one" = β=1 (reference convention, monte_carlo.py:364-366);
    "optimal" = β* = Cov(pay, ctrl)/Var(ctrl) estimated per strike on the
    same sample (never worse in expectation; matters when ξ or λ decorrelate
    the SVJ payoff from its GBM companion).
    """
    raw_mean, raw_se = simulate.mc_mean_stderr(pay)
    raw_price = discount * raw_mean
    out: Dict[str, Array] = {
        "price": raw_price,
        "std_error": discount * raw_se,
        "raw_mc_price": raw_price,
    }
    if control_variate:
        sigma_bs = jnp.sqrt(params.v0)  # σ = √v0 proxy (monte_carlo.py:354)
        bs_ref = bs_price(spot, strikes, T, params.r, params.q, sigma_bs, is_call)
        if cv_mode == "companion":
            # Correct CV: GBM companion leg, E[disc·payoff(G_T)] = bs_ref.
            ctrl = _payoff_table(g_final, strikes, is_call)
        elif cv_mode == "reference":
            # Reference arithmetic (monte_carlo.py:358-362): control leg is the
            # *base-branch SVJ payoff* — biases the price toward bs_ref.
            # Kept only for parity testing against the reference.
            ctrl = simulate.vanilla_payoff(
                s_final[0][None], strikes[:, None], is_call)
        else:
            raise ValueError(f"unknown cv_mode: {cv_mode!r}")

        if cv_beta == "optimal":
            ctrl_c = ctrl - jnp.mean(ctrl, axis=-1, keepdims=True)
            var_c = jnp.mean(ctrl_c**2, axis=-1)
            cov = jnp.mean(
                (pay - jnp.mean(pay, axis=-1, keepdims=True)) * ctrl_c,
                axis=-1)
            beta = jnp.where(var_c > 1e-12, cov / jnp.maximum(var_c, 1e-12),
                             0.0)
            out["cv_beta"] = beta
        elif cv_beta == "one":
            beta = jnp.ones_like(raw_price)
        else:
            raise ValueError(f"unknown cv_beta: {cv_beta!r}")

        ctrl_mc = discount * jnp.mean(ctrl, axis=-1)
        out["price"] = raw_price - beta * (ctrl_mc - bs_ref)
        out["bs_cv_adjustment"] = ctrl_mc - bs_ref
        out["bs_ref"] = bs_ref
        # CV-adjusted stderr (β=1 shape mirrors monte_carlo.py:372-373).
        cv_pay = pay - beta[:, None] * (ctrl - bs_ref[:, None] / discount)
        _, cv_se = simulate.mc_mean_stderr(cv_pay)
        out["std_error"] = discount * cv_se
    return out


@partial(
    jax.jit,
    static_argnames=(
        "num_paths", "num_steps", "is_call", "antithetic", "control_variate",
        "cv_mode", "cv_beta", "scheme",
    ),
)
def mc_price_core(
    params: SVJParams,
    spot,
    strikes: Array,
    T,
    key: Array,
    *,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    antithetic: bool = True,
    control_variate: bool = True,
    cv_mode: str = "companion",
    cv_beta: str = "one",
    scheme: str = "euler",
) -> Dict[str, Array]:
    """Price European options at one or many strikes off one shared path set.

    Args:
        strikes: shape (num_strikes,) — vectorized payoff axis.
        scheme: "euler" (full-truncation log-Euler, reference semantics and
            the differentiable default) or "qe" (Andersen quadratic-
            exponential — near-exact variance transitions, ~60x fewer steps
            for the same bias; see ops/simulate.py:simulate_terminal_qe).

    Returns dict of arrays, each shaped (num_strikes,):
        price, std_error, raw_mc_price, bs_ref, bs_cv_adjustment
        plus scalar terminal-state stats (s_mean, v_mean, v_max, frac_nonfinite)
        consumed by the post-price guards.
    """
    strikes = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))
    sim = (simulate.simulate_terminal_qe if scheme == "qe"
           else simulate.simulate_terminal)
    s_final, v_final, g_final = sim(
        params, spot, T, key,
        num_paths=num_paths, num_steps=num_steps, antithetic=antithetic,
        companion=control_variate and cv_mode == "companion",
    )
    discount = jnp.exp(-params.r * jnp.asarray(T, jnp.float32))
    pay = _payoff_table(s_final, strikes, is_call)
    out = _finalize_price(params, spot, strikes, T, discount,
                          pay, s_final, g_final, is_call,
                          control_variate, cv_mode, cv_beta)
    # Terminal-state diagnostics for guards (engine/guards.py:173-218 inputs).
    out["s_mean"] = jnp.mean(s_final)
    out["v_mean"] = jnp.mean(v_final)
    out["v_max"] = jnp.max(v_final)
    out["frac_nonfinite"] = jnp.mean(~jnp.isfinite(s_final))
    return out


@partial(
    jax.jit,
    static_argnames=("is_call", "antithetic", "control_variate", "cv_mode",
                     "cv_beta", "simulator", "steps_major", "scheme"),
)
def mc_price_from_draws(
    params: SVJParams,
    spot,
    strikes: Array,
    T,
    z1: Array,
    z2: Array,
    u_jump: Optional[Array],
    z_js: Array,
    *,
    seed=0,
    is_call: bool = True,
    antithetic: bool = True,
    control_variate: bool = True,
    cv_mode: str = "companion",
    cv_beta: str = "one",
    simulator: Optional[Callable] = None,
    steps_major: bool = False,
    scheme: str = "euler",
) -> Dict[str, Array]:
    """QMC / CRN pricing path: externally supplied draws, antithetic pairing.

    scheme="qe" interprets the draw tuple as the QE layout (z1 slot = z_x
    log-spot normals, z2 slot = u_v variance-transition *uniforms*, see
    ops/sobol.py:sobol_qe_draws) and runs the Andersen scheme from draws.

    When `antithetic`, the second branch negates (z1, z2, z_js) and shares
    u_jump, matching monte_carlo.py:318-324 (note: negating Sobol points is a
    digital reflection, not a fresh net — disable for pure-QMC studies).
    Used with the Sobol+Brownian-bridge driver and by the CRN
    finite-difference Greeks oracle.

    The Euler scheme runs the simulator `simulator` (default:
    `simulator_for(SVJ_EULER_DRAWS)` — the GPU draws kernel on a GPU, the
    scan twin elsewhere). Both take identical draws, jump uniforms included,
    and tests pin them to f32 rounding.
    """
    strikes = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))
    want_g = control_variate and cv_mode == "companion"
    if u_jump is None:
        # Same stream the Sobol driver would have generated (seed+1,
        # monte_carlo.py:306-308 convention), drawn inside this jit.
        u_jump = jax.random.uniform(
            jax.random.key(jnp.asarray(seed, jnp.int32) + 1),
            z1.shape, jnp.float32)
    if scheme == "qe":
        s_final, v_all, g_final = simulate.simulate_terminal_qe_from_draws(
            params, spot, T, z1, z2, u_jump, z_js,
            antithetic=antithetic, companion=want_g, steps_major=steps_major)
    else:
        if not steps_major:
            z1, z2, u_jump, z_js = z1.T, z2.T, u_jump.T, z_js.T
        sim = simulator or simulator_for(SVJ_EULER_DRAWS)
        s_final, v_all, g_final = sim(
            params, spot, T, z1, z2, u_jump, z_js,
            antithetic=antithetic, companion=want_g)
    v_base = v_all[0]
    discount = jnp.exp(-params.r * jnp.asarray(T, jnp.float32))

    pay = _payoff_table(s_final, strikes, is_call)
    out = _finalize_price(params, spot, strikes, T, discount,
                          pay, s_final, g_final, is_call,
                          control_variate, cv_mode, cv_beta)
    out["s_mean"] = jnp.mean(s_final)
    out["v_mean"] = jnp.mean(v_base)
    out["v_max"] = jnp.max(v_base)
    out["frac_nonfinite"] = jnp.mean(~jnp.isfinite(s_final))
    return out


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_steps", "is_call", "antithetic",
                     "control_variate"),
)
def mc_price_importance(
    params: SVJParams,
    spot,
    strikes: Array,
    T,
    key: Array,
    shift,
    *,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    antithetic: bool = True,
    control_variate: bool = True,
) -> Dict[str, Array]:
    """Importance-sampled European pricing (exponentially tilted dW₁).

    For deep-OTM strikes the plain estimator wastes almost every path (the
    payoff indicator fires with tiny probability); tilting the spot Brownian
    toward the strike (ops/simulate.py:simulate_terminal_tilted) makes most
    paths informative and the likelihood-ratio weight keeps the estimator
    unbiased. The companion control variate is computed on the *weighted*
    legs with the per-strike optimal β (β=1 has no special status once
    weights rescale the payoffs). Capability absent from the reference.

    Extra output: `ess` — Kish effective sample size of the weights,
    (Σw)²/Σw², as a quality diagnostic (≈ n when the tilt is mild).
    """
    strikes = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))
    s_final, v_final, g_final, log_w = simulate.simulate_terminal_tilted(
        params, spot, T, key, shift,
        num_paths=num_paths, num_steps=num_steps, antithetic=antithetic,
        companion=control_variate,
    )
    w = jnp.exp(log_w)                       # (n_branch, paths)
    discount = jnp.exp(-params.r * jnp.asarray(T, jnp.float32))

    def weighted_table(terminal):
        pay = simulate.vanilla_payoff(
            terminal[None], strikes[:, None, None], is_call)
        return simulate.combine_antithetic(
            jnp.swapaxes(w[None] * pay, 0, 1))   # (K, paths)

    wpay = weighted_table(s_final)
    raw_mean, raw_se = simulate.mc_mean_stderr(wpay)
    out: Dict[str, Array] = {
        "price": discount * raw_mean,
        "std_error": discount * raw_se,
        "raw_mc_price": discount * raw_mean,
    }
    if control_variate:
        sigma_bs = jnp.sqrt(params.v0)
        bs_ref = bs_price(spot, strikes, T, params.r, params.q, sigma_bs,
                          is_call)
        ctrl = weighted_table(g_final)       # E[ctrl] = bs_ref / discount
        ctrl_c = ctrl - jnp.mean(ctrl, axis=-1, keepdims=True)
        var_c = jnp.mean(ctrl_c**2, axis=-1)
        cov = jnp.mean(
            (wpay - jnp.mean(wpay, axis=-1, keepdims=True)) * ctrl_c, axis=-1)
        beta = jnp.where(var_c > 1e-12, cov / jnp.maximum(var_c, 1e-12), 0.0)
        ctrl_mc = discount * jnp.mean(ctrl, axis=-1)
        out["price"] = out["raw_mc_price"] - beta * (ctrl_mc - bs_ref)
        out["bs_ref"] = bs_ref
        out["cv_beta"] = beta
        cv_pay = wpay - beta[:, None] * (ctrl - bs_ref[:, None] / discount)
        _, cv_se = simulate.mc_mean_stderr(cv_pay)
        out["std_error"] = discount * cv_se
    w_flat = w.reshape(-1)
    out["ess"] = jnp.sum(w_flat) ** 2 / jnp.maximum(jnp.sum(w_flat**2), 1e-30)
    out["v_max"] = jnp.max(v_final)
    out["frac_nonfinite"] = jnp.mean(~jnp.isfinite(s_final))
    return out


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_steps", "is_call", "antithetic",
                     "counts"),
)
def _convergence_core(
    params: SVJParams, spot, strike, T, key, *,
    num_paths: int, num_steps: int, is_call: bool, antithetic: bool,
    counts: tuple,
):
    """Prefix-mean convergence series, fully on device.

    Checkpoint k reports mean/stderr of the FIRST counts[k] payoffs, so the
    series is the same martingale the host reduction produced. Payoffs are
    centered on the full-sample mean before the cumulative sums: the running
    sum then stays O(√n·σ) instead of O(n·mean), which keeps f32 prefix
    sums accurate at 2M paths without f64.
    """
    s_final, _, _ = simulate.simulate_terminal(
        params, spot, T, key,
        num_paths=num_paths, num_steps=num_steps, antithetic=antithetic,
    )
    pay = simulate.combine_antithetic(
        simulate.vanilla_payoff(s_final, strike, is_call))
    discount = jnp.exp(-params.r * T)
    center = jnp.mean(pay)
    c = pay - center
    csum = jnp.cumsum(c)
    csum_sq = jnp.cumsum(c * c)
    idx = jnp.asarray(counts, jnp.int32) - 1
    n = jnp.asarray(counts, jnp.float32)
    mean_c = csum[idx] / n                       # prefix mean of centered pay
    var = jnp.maximum(csum_sq[idx] / n - mean_c**2, 0.0)
    prices = discount * (center + mean_c)
    errors = discount * jnp.sqrt(var / n)
    return prices, errors


# ─────────────────────────────────────────────────────────────────────────────
# Stateful wrapper (reference API surface)
# ─────────────────────────────────────────────────────────────────────────────
# Sobol draw sets shared across engine instances (see _sobol_draws). Each
# slot holds 3 (steps, paths) f32 arrays on device (1.5 GB at 500k × 252,
# 6 GB at the 2M-path cap). Bounded by count and by bytes: 12 slots fit one
# default price_rqmc call (7 new-seed entries) on top of the 3 warmed
# serving shapes; the byte budget keeps a run of cap-sized requests from
# filling the device. The newest entry always stays. Guarded for the
# threaded HTTP server.
import threading
from collections import OrderedDict

_SOBOL_DRAWS_CACHE: "OrderedDict" = OrderedDict()
_SOBOL_DRAWS_CACHE_MAX = 12
_SOBOL_DRAWS_CACHE_MAX_BYTES = 16 << 30
_SOBOL_DRAWS_LOCK = threading.Lock()


def _draws_nbytes(draws) -> int:
    return sum(x.nbytes for x in draws if x is not None)

# One process-wide auto mesh (largest power-of-two device prefix), built
# lazily on first sharded price. [None] sentinel = "computed, single device".
_AUTO_MESH: list = []


def _auto_mesh():
    if not _AUTO_MESH:
        devs = jax.devices()
        n = 1 << (len(devs).bit_length() - 1)  # largest power of two ≤ len
        if n >= 2:
            from mcos_tpu.parallel.mesh import make_mesh

            _AUTO_MESH.append(make_mesh(devs[:n]))
        else:
            _AUTO_MESH.append(None)
    return _AUTO_MESH[0]


def resolve_mesh(mesh):
    """None | "auto" | Mesh → Mesh | None (single device).

    Shared by every engine that honors the MCOS_AUTO_MESH=1 serving toggle
    (MonteCarloEngine, TDSVJEngine, AmericanEngine, BasketEngine): None
    consults the env toggle; "auto" resolves to the process-wide mesh over
    the largest power-of-two device prefix, or None on a single device."""
    import os

    if mesh is None and os.environ.get("MCOS_AUTO_MESH") == "1":
        mesh = "auto"
    if mesh == "auto":
        mesh = _auto_mesh()
    return mesh


class MonteCarloEngine:
    """Drop-in equivalent of the reference `MonteCarloEngine`
    (engine/monte_carlo.py:249-272 constructor semantics).

    Args:
        use_sobol: scrambled Sobol + Brownian bridge driver (reference default).
        use_antithetic / use_control_variate: variance reduction toggles.
    """

    def __init__(
        self,
        params: SVJParams,
        num_paths: int = DEFAULT_NUM_PATHS,
        num_steps: int = DEFAULT_NUM_STEPS,
        seed: int = 42,
        use_sobol: bool = True,
        use_antithetic: bool = True,
        use_control_variate: bool = True,
        cv_mode: str = "companion",
        cv_beta: str = "one",
        scheme: str = "euler",
        mesh=None,
        dividends=None,
        rate_curve=None,
    ):
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.use_sobol = bool(use_sobol)
        self.use_antithetic = bool(use_antithetic)
        self.use_control_variate = bool(use_control_variate)
        self.cv_mode = cv_mode
        self.cv_beta = cv_beta
        self.scheme = scheme
        # Deterministic rate term structure (ops/curves.RateCurve): for
        # European/terminal payoffs only ∫r dt enters (drift and discount),
        # so pricing at the flat-equivalent rate r_eff(T) = R(T)/T is EXACT
        # — params.r is substituted per maturity; params.r is ignored when
        # a curve is set.
        self.rate_curve = rate_curve
        # Discrete dividends (ops/dividends.DividendSchedule): European
        # pricing adjusts the spot before the unchanged kernels — EXACT for
        # kind="proportional" (multiplicative dynamics commute with the
        # deterministic drop factor), the standard escrowed model
        # (S0 − PV_r(divs)) for kind="cash". Path-exact cash handling lives
        # where paths are recorded (engine/american.py). q should then hold
        # only any non-discrete remainder.
        self.dividends = dividends
        # mesh: None (single device), "auto" (all local devices when >1 —
        # largest power-of-two prefix so the Sobol net splits evenly), or an
        # explicit jax.sharding.Mesh with a "paths" axis. None also honors
        # the MCOS_AUTO_MESH=1 env toggle, which the API server sets so the
        # WHOLE serving surface shards without per-handler wiring.
        self.mesh = mesh

    # -- internals ------------------------------------------------------------
    def _key(self) -> Array:
        return jax.random.key(self.seed)

    def _sobol_draws(self, steps: int):
        # Module-level LRU (not per-instance): the HTTP layer builds a FRESH
        # engine per request, so an instance slot would regenerate the nets
        # (tens of ms + GBs of HBM churn) on every request. The cached arrays
        # live on device; serving re-hits the same few (paths, steps, seed)
        # shapes indefinitely.
        key = (self.scheme, steps, self.num_paths, self.seed)
        with _SOBOL_DRAWS_LOCK:
            hit = _SOBOL_DRAWS_CACHE.get(key)
            if hit is not None:
                _SOBOL_DRAWS_CACHE.move_to_end(key)
                return hit
        from mcos_tpu.ops.sobol import sobol_qe_draws, sobol_svj_draws

        if self.scheme == "qe":
            draws = sobol_qe_draws(self.num_paths, steps, seed=self.seed,
                                   jump_uniforms=False)
        else:
            draws = sobol_svj_draws(self.num_paths, steps, seed=self.seed,
                                    layout="steps", jump_uniforms=False)
        with _SOBOL_DRAWS_LOCK:
            _SOBOL_DRAWS_CACHE[key] = draws
            while len(_SOBOL_DRAWS_CACHE) > 1 and (
                    len(_SOBOL_DRAWS_CACHE) > _SOBOL_DRAWS_CACHE_MAX
                    or sum(map(_draws_nbytes, _SOBOL_DRAWS_CACHE.values()))
                    > _SOBOL_DRAWS_CACHE_MAX_BYTES):
                _SOBOL_DRAWS_CACHE.popitem(last=False)
        return draws

    def _steps(self, T: float) -> int:
        return scaled_steps(self.num_steps, T)

    def _params_T(self, T: float) -> SVJParams:
        """Per-maturity params: r substituted by the curve's flat
        equivalent (exact for terminal payoffs)."""
        if self.rate_curve is None:
            return self.params
        return self.params.replace(r=self.rate_curve.r_eff(float(T)))

    def _spot_eff(self, spot: float, T: float) -> float:
        """Dividend-adjusted spot for European pricing (raw spot if no
        schedule). Raises ValueError when dividend PV exceeds the spot —
        the HTTP layer maps that to a 400. Escrow discounting honors the
        rate curve when one is set."""
        if self.dividends is None:
            return float(spot)
        from mcos_tpu.ops.dividends import effective_spot

        disc = (self.rate_curve.discount
                if self.rate_curve is not None else None)
        eff, _ = effective_spot(spot, self.dividends, float(self.params.r),
                                float(T), discount=disc)
        return eff

    def _resolved_mesh(self):
        """The pricing mesh, or None for the single-device path."""
        return resolve_mesh(self.mesh)

    def _price_result(self, spot, strikes, T, is_call: bool) -> Dict[str, Array]:
        spot = self._spot_eff(spot, T)
        params = self._params_T(T)
        steps = self._steps(T)
        use_sobol = self.use_sobol
        mesh = self._resolved_mesh()
        if mesh is not None and self.cv_beta == "one" \
                and self.cv_mode == "companion":
            # Multi-device path-sharded pricing (parallel/mesh.py). Routed
            # only for the serving-default estimator configuration; exotic
            # configurations (optimal-β CV, reference-parity CV, QE×Sobol)
            # fall through to the single-device drivers below.
            from mcos_tpu.parallel import mesh as pmesh

            if use_sobol and self.scheme != "qe" and self.use_antithetic:
                return pmesh.sharded_sobol_price(
                    params, spot, jnp.asarray(strikes), T,
                    mesh=mesh, num_paths=self.num_paths, num_steps=steps,
                    seed=self.seed, is_call=is_call,
                    control_variate=self.use_control_variate,
                )
            if not use_sobol:
                return pmesh.sharded_price(
                    params, spot, jnp.asarray(strikes), T, self._key(),
                    mesh=mesh, num_paths=self.num_paths, num_steps=steps,
                    is_call=is_call, antithetic=self.use_antithetic,
                    control_variate=self.use_control_variate,
                    cv_mode=self.cv_mode, scheme=self.scheme,
                )
        if use_sobol:
            z1, z2, u_jump, z_js = self._sobol_draws(steps)
            return mc_price_from_draws(
                params, spot, jnp.asarray(strikes), T,
                z1, z2, u_jump, z_js, seed=self.seed,
                is_call=is_call, antithetic=self.use_antithetic,
                control_variate=self.use_control_variate,
                cv_mode=self.cv_mode, cv_beta=self.cv_beta,
                simulator=simulator_for(SVJ_EULER_DRAWS), steps_major=True,
                scheme=self.scheme,
            )
        return mc_price_core(
            params, spot, jnp.asarray(strikes), T, self._key(),
            num_paths=self.num_paths, num_steps=steps, is_call=is_call,
            antithetic=self.use_antithetic,
            control_variate=self.use_control_variate,
            cv_mode=self.cv_mode, cv_beta=self.cv_beta, scheme=self.scheme,
        )

    # -- reference API ----------------------------------------------------------
    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True) -> Dict[str, float]:
        """Price one European option. Result keys match the reference
        (monte_carlo.py:273-285 docstring + :345-373)."""
        res = jax.device_get(  # ONE host transfer, not one per scalar
            self.price_device(spot, strike, T, is_call))
        return self.format_price(res, T)

    def price_device(self, spot: float, strike: float, T: float,
                     is_call: bool = True) -> Dict[str, Array]:
        """Enqueue the price program, return the on-device result pytree.

        JAX dispatch is asynchronous, so a serving handler can enqueue this
        plus the viz programs and wait for the device ONCE with a single
        `jax.device_get` over all of them. Pair with `format_price`.
        """
        return self._price_result(spot, np.array([strike], np.float32), T,
                                  is_call)

    def format_price(self, res: Dict, T: float) -> Dict[str, float]:
        """Host-side formatting of a fetched `price_device` pytree."""
        out = {
            "price": float(res["price"][0]),
            "std_error": float(res["std_error"][0]),
            "num_paths_used": int(np.asarray(
                res.get("num_paths_used", self.num_paths))),
            "num_steps": self._steps(T),
        }
        if self.use_control_variate:
            # The sharded drivers fold the CV into `price` on device and
            # report bs_ref only; the single-device drivers also expose the
            # adjustment decomposition.
            if "bs_cv_adjustment" in res:
                out["bs_cv_adjustment"] = float(res["bs_cv_adjustment"][0])
            if "bs_ref" in res:
                out["bs_ref"] = float(res["bs_ref"][0])
            if "raw_mc_price" in res:
                out["raw_mc_price"] = float(res["raw_mc_price"][0])
        if self.dividends is not None:
            out["dividend_model"] = ("proportional-exact"
                                     if self.dividends.kind == "proportional"
                                     else "escrowed")
        # Guard diagnostics (not in the reference dict; cheap and useful).
        if "v_max" in res:
            out["v_max"] = float(res["v_max"])
        if "frac_nonfinite" in res:
            out["frac_nonfinite"] = float(res["frac_nonfinite"])
        return out

    def price_batch(self, spot: float, strikes: Sequence[float], T: float,
                    is_call: bool = True) -> list:
        """Price many strikes off one shared path set
        (monte_carlo.py:377-450 semantics, vectorized instead of looped)."""
        strikes = np.asarray(strikes, np.float32)
        res = jax.device_get(self._price_result(spot, strikes, T, is_call))
        results = []
        for i, k in enumerate(strikes):
            row = {
                "strike": float(k),
                "price": float(res["price"][i]),
                "std_error": float(res["std_error"][i]),
            }
            if self.use_control_variate:
                row["bs_ref"] = float(res["bs_ref"][i])
            results.append(row)
        return results

    def price_to_tolerance(self, spot: float, strike: float, T: float,
                           is_call: bool = True,
                           tolerance: float = DEFAULT_TOLERANCE,
                           max_paths: int = MAX_PATHS,
                           batch_paths: int = 250_000) -> Dict[str, float]:
        """Adaptive pricing: add path batches until stderr/price ≤ tolerance.

        The reference *configures* this contract (DEFAULT_TOLERANCE 0.1% of
        premium, MAX_PATHS 2M cap — config.py:23-26; guards alert on
        violation at guards.py:139-142) but never implements the adaptive
        loop. Batches use independent key folds and combine by exact moment
        pooling, so the result is identical in law to one big run.

        Honors the engine's antithetic/CV/cv_beta configuration and its
        discretization `scheme`. The random driver is always counter-based: batches must be mutually
        independent, and chopping a Sobol net into batches destroys its
        equidistribution — with use_sobol=True a note is logged and PRNG
        batching is used.
        """
        if self.use_sobol:
            import logging
            logging.getLogger("mcos_tpu.pricer").info(
                "price_to_tolerance uses independent PRNG batches; the "
                "engine's Sobol driver does not batch soundly")
        spot = self._spot_eff(spot, T)
        params = self._params_T(T)
        steps = self._steps(T)
        strikes = jnp.asarray([strike], jnp.float32)
        total_n = 0
        sum_mean = 0.0      # Σ nᵢ·meanᵢ
        sum_sq = 0.0        # Σ nᵢ·E[x²]ᵢ
        batches = 0
        price = se = 0.0
        bs_ref = None
        # Geometric schedule: batch k doubles (power-of-two sizes), so a run
        # to the 2M cap costs ~log₂ host round trips and a bounded compile
        # universe, instead of max_paths/batch_paths sequential launches.
        n_next = 1 << max(int(np.ceil(np.log2(max(batch_paths, 1024)))), 10)
        while total_n < max_paths:
            n_batch = min(n_next, max_paths - total_n)
            n_next *= 2
            kwargs = dict(
                num_paths=n_batch, num_steps=steps, is_call=is_call,
                antithetic=self.use_antithetic,
                control_variate=self.use_control_variate,
                cv_mode=self.cv_mode, cv_beta=self.cv_beta,
                scheme=self.scheme)
            key = jax.random.fold_in(self._key(), batches)
            res = mc_price_core(params, spot, strikes, T, key, **kwargs)
            p_i = float(res["price"][0])
            se_i = float(res["std_error"][0])
            if bs_ref is None and "bs_ref" in res:
                bs_ref = float(res["bs_ref"][0])
            # Pool raw moments: E[x²]ᵢ = n·seᵢ² + meanᵢ².
            sum_mean += n_batch * p_i
            sum_sq += n_batch * (n_batch * se_i**2 + p_i**2)
            total_n += n_batch
            batches += 1
            price = sum_mean / total_n
            var = max(sum_sq / total_n - price**2, 0.0)
            se = (var / total_n) ** 0.5
            if price > 0 and se / price <= tolerance:
                break
        out = {
            "price": price,
            "std_error": se,
            "num_paths_used": total_n,
            "num_steps": steps,
            "num_batches": batches,
            "tolerance_met": bool(price > 0 and se / price <= tolerance),
        }
        if bs_ref is not None:
            out["bs_ref"] = bs_ref
        return out

    def price_importance(self, spot: float, strike: float, T: float,
                         is_call: bool = True,
                         shift: Optional[float] = None) -> Dict[str, float]:
        """Importance-sampled price for far-from-the-money strikes.

        Tilts the spot-driving Brownian so the path cloud lands around the
        strike (`shift=None` auto-aims via ops/simulate.py:optimal_tilt) and
        reweights by the exact likelihood ratio — unbiased, with a measured
        10-100× variance reduction on deep-OTM contracts where the plain
        estimator's payoff indicator almost never fires. Honors the engine's
        antithetic and control-variate settings (CV uses per-strike optimal
        β on the weighted legs). Capability absent from the reference.
        """
        spot = self._spot_eff(spot, T)
        params = self._params_T(T)
        steps = self._steps(T)
        if shift is None:
            shift = simulate.optimal_tilt(params, spot, strike, T, steps)
        res = jax.device_get(mc_price_importance(
            params, spot, np.array([strike], np.float32), T,
            self._key(), float(shift),
            num_paths=self.num_paths, num_steps=steps, is_call=is_call,
            antithetic=self.use_antithetic,
            control_variate=self.use_control_variate,
        ))
        out = {
            "price": float(res["price"][0]),
            "std_error": float(res["std_error"][0]),
            "num_paths_used": self.num_paths,
            "num_steps": steps,
            "tilt_shift": float(shift),
            "ess": float(res["ess"]),
        }
        if self.use_control_variate:
            out["bs_ref"] = float(res["bs_ref"][0])
            out["cv_beta"] = float(res["cv_beta"][0])
        return out

    def price_rqmc(self, spot: float, strike: float, T: float,
                   is_call: bool = True,
                   randomizations: int = 8) -> Dict[str, float]:
        """Randomized-QMC pricing with honest error bars.

        R independent Owen scrambles of the same Sobol net (hash-based
        nested-uniform, ops/sobol.py) give R iid unbiased estimates; the
        reported std_error is their empirical spread / √R — the *correct*
        uncertainty for a QMC estimate (the within-net "std_error" of a
        single QMC run reads the points as iid and overstates the error,
        since scrambled nets converge ~n⁻¹ vs MC's n^{-1/2}). Capability
        absent from the reference (one Owen scramble, MC-formula stderr:
        monte_carlo.py:78-85, 342-343).
        """
        import copy

        if randomizations < 2:
            raise ValueError("randomizations must be ≥ 2 for an error bar")
        vals = []
        bs_ref = None
        for rep in range(randomizations):
            eng = copy.copy(self)
            eng.seed = self.seed + 7919 * rep
            eng.use_sobol = True
            res = eng.price(spot, strike, T, is_call)
            vals.append(res["price"])
            bs_ref = res.get("bs_ref", bs_ref)
        arr = np.asarray(vals, np.float64)
        out = {
            "price": float(arr.mean()),
            "std_error": float(arr.std(ddof=1) / np.sqrt(randomizations)),
            "randomizations": randomizations,
            "num_paths_used": self.num_paths * randomizations,
            "price_min": float(arr.min()),
            "price_max": float(arr.max()),
        }
        if bs_ref is not None:
            out["bs_ref"] = bs_ref
        return out

    def convergence(self, spot: float, strike: float, T: float,
                    is_call: bool = True,
                    num_checkpoints: int = 12) -> Dict[str, list]:
        """True MC convergence diagnostics: the estimate at geometrically
        spaced path-count checkpoints, from prefix means of ONE path set.

        The reference computes this honestly only in its legacy browser
        engine (js/engine.js:195-214) and *fakes* it in the Gen-2 UI from the
        single API price (js/app.js:415-420 — a documented bug). This is the
        real thing: checkpoint k uses the first n_k paths, so the series is
        a martingale converging to the full-sample estimate.

        The prefix moments are reduced ON DEVICE (centered f32 cumsum — the
        centering keeps the running sum near zero so f32 carries the full
        display precision) and only the ~num_checkpoints scalars go to the
        host, instead of the whole payoff vector (≈4 MB at 500k paths).
        """
        counts = np.unique(np.geomspace(
            max(self.num_paths // (2 ** (num_checkpoints - 1)), 64),
            self.num_paths, num_checkpoints).astype(int))
        prices, errors = jax.device_get(_convergence_core(
            self._params_T(T), self._spot_eff(spot, T), strike, T,
            self._key(),
            num_paths=self.num_paths, num_steps=self._steps(T),
            is_call=is_call, antithetic=self.use_antithetic,
            counts=tuple(int(n) for n in counts),
        ))
        return {
            "num_paths": counts.tolist(),
            "price": [float(x) for x in prices],
            "std_error": [float(x) for x in errors],
        }

    def get_sample_paths(self, spot: float, T: float,
                         num_samples: int = 50) -> np.ndarray:
        """Record a few full paths for visualization
        (monte_carlo.py:452-471 semantics: PRNG driver, ≥50 steps floor)."""
        return np.asarray(self.sample_paths_device(spot, T, num_samples))

    def sample_paths_device(self, spot: float, T: float,
                            num_samples: int = 50) -> Array:
        """Enqueue the viz-path recorder; return the device array unsynced."""
        steps = max(int(self.num_steps * T), 50)
        key = jax.random.key(self.seed + 999)
        return simulate.simulate_paths_recorded(
            self._params_T(T), self._spot_eff(spot, T), T, key,
            num_paths=int(num_samples), num_steps=steps,
        )

    def terminal_samples(self, spot: float, T: float,
                         num_samples: int = 1024) -> np.ndarray:
        """A small sample of terminal spots for distribution visualization
        (the reference's dashboard histograms its 50 viz paths' endpoints,
        dashboard.html — here the histogram gets a real sample)."""
        return np.asarray(self.terminal_samples_device(spot, T, num_samples))

    def terminal_samples_device(self, spot: float, T: float,
                                num_samples: int = 1024) -> Array:
        """Enqueue the terminal-sample program; device array, unsynced."""
        s_final, _, _ = simulate.simulate_terminal(
            self._params_T(T), self._spot_eff(spot, T), T,
            jax.random.key(self.seed + 1234),
            num_paths=int(num_samples), num_steps=self._steps(T),
            antithetic=False,
        )
        return s_final[0]


def price_term_structure(
    ts,
    spot: float,
    strikes,
    maturities,
    is_call: bool = True,
    num_paths: int = 100_000,
    num_steps: int = 252,
    seed: int = 42,
) -> list:
    """Price a strikes × maturities grid under a `TermStructureSVJ`.

    Materializes the maturity-interpolated `SVJParams`
    (models.py:114-124 semantics) per expiry and batch-prices each slice off
    one shared path set. Returns one dict per maturity with the strike rows.
    """
    out = []
    for T in maturities:
        params_t = ts.get_params_at_maturity(float(T))
        eng = MonteCarloEngine(params_t, num_paths=num_paths,
                               num_steps=num_steps, seed=seed,
                               use_sobol=False)
        out.append({
            "maturity": float(T),
            "params": params_t.as_dict(),
            "chain": eng.price_batch(spot, strikes, float(T), is_call),
        })
    return out
