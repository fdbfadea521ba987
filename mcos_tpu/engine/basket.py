"""Multi-asset SVJ basket options.

Capability beyond the reference (single-asset only) and beyond the GBM
portfolio VaR: every asset follows its own SVJ dynamics (per-asset κ, θ, ξ,
ρ, v₀, jumps) while the spot-driving Brownian motions are correlated across
assets through a Cholesky factor. Variance processes stay asset-local (each
v_i is driven by its own dW₂ correlated only with its own dW₁ — the standard
multi-asset Heston reduction), and jumps are idiosyncratic.

Device shape: ONE `lax.scan` over steps with every per-asset computation
batched on a leading asset axis — the A-asset step is the single-asset step
on (A, paths) tensors plus one (A×A)·(A, paths) matmul for the spot-shock
mixing. Antithetic pairing as usual.

Estimator: the basket payoff max(±(Σ wᵢ S_T,i − K), 0) with a GBM-companion
control variate is not available in closed form (the basket is not
lognormal), so the control is the *geometric* basket on the companion legs —
Π (G_i)^{w̃ᵢ} is lognormal with a known BS price — which tracks the
arithmetic basket closely for near-equal weights (same trick as the
Kemna-Vorst Asian control, applied across assets instead of across time).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import scaled_steps
from mcos_tpu.models.params import SVJParams
from mcos_tpu.ops.simulate import (_safe_sqrt, combine_antithetic,
                                   mc_mean_stderr)

Array = jax.Array


def _basket_cols(p: SVJParams) -> dict:
    """Per-asset scalar coefficients shaped (1, A, 1) for broadcasting
    against (..., A, paths) state blocks — ONE construction shared by every
    multi-asset simulator (terminal, observations/states, and the dual
    bound's nested inner transitions)."""
    col = lambda x: jnp.asarray(x, jnp.float32)[None, :, None]  # noqa: E731
    rho = col(p.rho)
    k_comp = jnp.exp(p.mu_j + 0.5 * p.sigma_j**2) - 1.0
    return {
        "kappa": col(p.kappa), "theta": col(p.theta), "xi": col(p.xi),
        "rho": rho, "rho_perp": jnp.sqrt(1.0 - rho * rho),
        "drift": col(p.r) - col(p.q) - col(p.lambda_j * k_comp),
        "lam": col(p.lambda_j), "mu_j": col(p.mu_j),
        "sig_j": col(p.sigma_j), "v0": col(p.v0),
    }


def _basket_step(c: dict, dt, sqrt_dt, log_s, v, z1, z2, z_js, u_jump):
    """One correlated multi-asset SVJ step on (..., A, paths) blocks.

    `z1` is the ALREADY correlated+signed spot shock (chol @ z, ± for the
    antithetic branch); z2/z_js idiosyncratic signed normals; u_jump
    uniforms. ONE implementation of the step algebra — the twin-sharing
    discipline (see ops/simulate._svj_step_core for the single-asset
    family)."""
    v_pos = jnp.maximum(v, 0.0)
    sqrt_v = _safe_sqrt(v_pos)
    dw1 = z1 * sqrt_dt
    dw2 = c["rho"] * dw1 + c["rho_perp"] * z2 * sqrt_dt
    jump = jnp.where(u_jump < c["lam"] * dt,
                     c["mu_j"] + c["sig_j"] * z_js, 0.0)
    log_s = log_s + (c["drift"] - 0.5 * v_pos) * dt + sqrt_v * dw1 + jump
    v = jnp.maximum(v_pos + c["kappa"] * (c["theta"] - v_pos) * dt
                    + c["xi"] * sqrt_v * dw2, 0.0)
    return log_s, v


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "antithetic",
                                   "companion"))
def simulate_basket_terminal(
    params_batch: SVJParams,
    spots: Array,
    corr_chol: Array,
    T,
    key: Array,
    *,
    num_paths: int,
    num_steps: int,
    antithetic: bool = True,
    companion: bool = True,
):
    """Terminal spots of A correlated SVJ assets.

    Args:
        params_batch: SVJParams pytree with leading asset axis (A,).
        spots: (A,) initial spots.
        corr_chol: (A, A) Cholesky factor of the spot-shock correlation.
    Returns:
        (S, G or None): S shaped (n_branch, A, num_paths); G the per-asset
        GBM companion legs on the same correlated dW₁ (σᵢ = √v₀ᵢ).
    """
    dtype = jnp.float32
    p = params_batch
    n_assets = spots.shape[0]
    n_branch = 2 if antithetic else 1
    T = jnp.asarray(T, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None, None]

    cols = _basket_cols(p)
    sigma_cv = jnp.sqrt(cols["v0"])
    col = lambda x: jnp.asarray(x, dtype)[None, :, None]  # noqa: E731
    g_drift = (col(p.r) - col(p.q) - 0.5 * sigma_cv**2) * dt

    shape = (n_branch, n_assets, num_paths)
    log_s0 = jnp.zeros(shape, dtype)           # log(S/S0) carries
    v0 = jnp.broadcast_to(cols["v0"], shape)

    def step(carry, step_idx):
        log_s, v, log_g = carry
        k_step = jax.random.fold_in(key, step_idx)
        k_n, k_u = jax.random.split(k_step)
        z = jax.random.normal(k_n, (3, n_assets, num_paths), dtype)
        u_jump = jax.random.uniform(k_u, (n_assets, num_paths), dtype)
        # Cross-asset correlation on the SPOT shocks only (z1); the variance
        # and jump shocks stay idiosyncratic.
        z1 = (corr_chol @ z[0])[None] * sign      # (n_branch, A, paths)
        z2 = z[1][None] * sign
        z_js = z[2][None] * sign
        if companion:
            log_g = log_g + g_drift + sigma_cv * (z1 * sqrt_dt)
        log_s, v = _basket_step(cols, dt, sqrt_dt, log_s, v, z1, z2, z_js,
                                u_jump[None])
        return (log_s, v, log_g), None

    (log_s, _, log_g), _ = jax.lax.scan(
        step, (log_s0, v0, log_s0), jnp.arange(num_steps))
    spots_c = jnp.asarray(spots, dtype)[None, :, None]
    return (spots_c * jnp.exp(log_s),
            (spots_c * jnp.exp(log_g) if companion else None))


@partial(jax.jit, static_argnames=("num_paths", "n_obs",
                                   "steps_per_period"))
def simulate_basket_states(
    params_batch: SVJParams,
    spots: Array,
    corr_chol: Array,
    T,
    key: Array,
    *,
    num_paths: int,
    n_obs: int,
    steps_per_period: int,
):
    """(levels, v) of A correlated SVJ assets at the observation dates
    t_1..t_m — levels are S_{t_i}/S_0 ratios, v the variance states, each
    (m, n_branch=2, A, paths).

    Outer scan over observation periods, inner scan over intra-period
    steps (the cliquet construction of engine/cliquet.py, widened to the
    correlated multi-asset state) — only the (log S, v) sheet crosses
    period boundaries. The step algebra is `_basket_step` (shared). The
    variance states exist for the dual bound's nested restarts; the
    autocall/LSM paths read the levels only (see
    `simulate_basket_observations`).
    """
    dtype = jnp.float32
    p = params_batch
    n_assets = spots.shape[0]
    T = jnp.asarray(T, dtype)
    n_steps = n_obs * steps_per_period
    dt = T / n_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[:, None, None]
    cols = _basket_cols(p)

    shape = (2, n_assets, num_paths)
    init = (jnp.zeros(shape, dtype),
            jnp.broadcast_to(cols["v0"], shape))

    def inner(carry, global_idx):
        log_s, v = carry
        k_step = jax.random.fold_in(key, global_idx)
        k_n, k_u = jax.random.split(k_step)
        z = jax.random.normal(k_n, (3, n_assets, num_paths), dtype)
        u_jump = jax.random.uniform(k_u, (n_assets, num_paths), dtype)
        z1 = (corr_chol @ z[0])[None] * sign
        z2 = z[1][None] * sign
        z_js = z[2][None] * sign
        log_s, v = _basket_step(cols, dt, sqrt_dt, log_s, v, z1, z2, z_js,
                                u_jump[None])
        return (log_s, v), None

    def period(carry, p_idx):
        idx = p_idx * steps_per_period + jnp.arange(steps_per_period)
        carry, _ = jax.lax.scan(inner, carry, idx)
        return carry, (jnp.exp(carry[0]), carry[1])

    _, (levels, v_states) = jax.lax.scan(period, init, jnp.arange(n_obs))
    return levels, v_states


def simulate_basket_observations(
    params_batch: SVJParams,
    spots: Array,
    corr_chol: Array,
    T,
    key: Array,
    *,
    num_paths: int,
    n_obs: int,
    steps_per_period: int,
):
    """Gross return levels at the observation dates (m, 2, A, paths) —
    `simulate_basket_states` minus the variance sheet (ONE simulator)."""
    return simulate_basket_states(
        params_batch, spots, corr_chol, T, key, num_paths=num_paths,
        n_obs=n_obs, steps_per_period=steps_per_period)[0]


def basket_payoff_and_control(s, g, weights, spots, strike, is_call: bool,
                              use_cv: bool):
    """(pay, ctrl_pay | None): antithetic-combined per-path payoffs.

    ONE implementation of the arithmetic-basket payoff and its
    geometric-companion control, shared by `BasketEngine.price` and the
    mesh-sharded driver (`parallel/mesh.py:sharded_basket_price`) so the
    estimator algebra cannot drift between the two. `s`/`g` are the
    (n_branch, A, paths) terminal/companion sheets; `weights`/`spots` are
    (A,) f32 arrays. The control is X = notional·Π(G_i/S_i)^w̃ with value
    weights w̃ ∝ wᵢSᵢ — lognormal, so its expectation is Black-76 in closed
    form (`_geometric_basket_undiscounted`)."""
    w = weights[None, :, None]
    basket = jnp.sum(w * s, axis=1)              # (n_branch, paths)
    phi = 1.0 if is_call else -1.0
    pay = combine_antithetic(jnp.maximum(phi * (basket - strike), 0.0))
    if not use_cv:
        return pay, None
    wv = weights * spots
    w_tilde = (wv / jnp.sum(wv))[None, :, None]
    notional = jnp.sum(wv)
    geo = notional * jnp.exp(
        jnp.sum(w_tilde * jnp.log(jnp.maximum(g, 1e-20)
                                  / spots[None, :, None]), axis=1))
    ctrl_pay = combine_antithetic(jnp.maximum(phi * (geo - strike), 0.0))
    return pay, ctrl_pay


def _geometric_basket_undiscounted(notional, w_tilde, drifts_T, vol2_T,
                                   strike, is_call):
    """E[max(±(X − K), 0)] for the lognormal geometric basket
    X = notional·exp(Σ w̃ᵢ(driftᵢT + σᵢWᵢ)) — Black-76 on its forward.

    drifts_T: per-asset (rᵢ − qᵢ − σᵢ²/2)·T; vol2_T: w̃ᵀ(σσᵀ∘C)w̃·T.
    """
    from scipy.stats import norm

    m = float(np.sum(w_tilde * drifts_T))
    sd = float(np.sqrt(max(vol2_T, 1e-16)))
    fwd = notional * np.exp(m + 0.5 * vol2_T)
    d1 = (np.log(fwd / strike) + 0.5 * vol2_T) / sd
    d2 = d1 - sd
    phi = 1.0 if is_call else -1.0
    return phi * (fwd * norm.cdf(phi * d1) - strike * norm.cdf(phi * d2))


class BasketEngine:
    """European options on a weighted basket of correlated SVJ assets."""

    def __init__(self, params_list: Sequence[SVJParams], corr,
                 num_paths: int = 200_000, num_steps: int = 64,
                 seed: int = 42, use_control_variate: bool = True,
                 mesh=None):
        self.params_list = list(params_list)
        # None | "auto" | Mesh — price() routes through the mesh-sharded
        # driver (parallel/mesh.py:sharded_basket_price) when a multi-device
        # mesh resolves; rainbow/spread payoffs stay single-device. None
        # honors MCOS_AUTO_MESH=1 (the serving toggle).
        self.mesh = mesh
        self.corr = np.asarray(corr, np.float64)
        a = len(self.params_list)
        if self.corr.shape != (a, a):
            raise ValueError(f"corr must be ({a},{a}), got {self.corr.shape}")
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.use_control_variate = bool(use_control_variate)
        self._batch = jax.tree.map(
            lambda *xs: jnp.stack([jnp.asarray(x, jnp.float32) for x in xs]),
            *self.params_list)
        # Accept PSD-singular correlation (e.g. rho=1 blocks): retry the
        # factorization with escalating diagonal jitter.
        corr_j = self.corr.copy()
        for jitter in (0.0, 1e-10, 1e-8, 1e-6):
            try:
                chol = np.linalg.cholesky(
                    corr_j + jitter * np.eye(a))
                break
            except np.linalg.LinAlgError:
                continue
        else:
            raise ValueError("correlation matrix is not PSD")
        self._chol = jnp.asarray(chol, jnp.float32)

    def price(self, spots: Sequence[float], weights: Sequence[float],
              strike: float, T: float, is_call: bool = True
              ) -> Dict[str, float]:
        """Price max(±(Σ wᵢ S_T,i − K), 0) with a geometric-basket control."""
        from mcos_tpu.engine.pricer import resolve_mesh

        mesh = resolve_mesh(self.mesh)
        if mesh is not None:
            from mcos_tpu.parallel.families import sharded_basket_price

            return sharded_basket_price(
                self, spots, weights, strike, T, jax.random.key(self.seed),
                mesh=mesh, is_call=is_call)
        steps = scaled_steps(self.num_steps, T)
        spots = np.asarray(spots, np.float64)
        weights = np.asarray(weights, np.float64)
        s, g = simulate_basket_terminal(
            self._batch, jnp.asarray(spots, jnp.float32), self._chol, T,
            jax.random.key(self.seed), num_paths=self.num_paths,
            num_steps=steps, antithetic=True,
            companion=self.use_control_variate)
        # Control: the geometric value-weighted basket of the companion
        # legs — lognormal, E[payoff] in closed form (the Kemna-Vorst trick
        # applied across assets instead of across time). Payoff + control
        # algebra shared with the mesh driver (basket_payoff_and_control).
        pay, ctrl_pay = basket_payoff_and_control(
            s, g, jnp.asarray(weights, jnp.float32),
            jnp.asarray(spots, jnp.float32), strike, is_call,
            self.use_control_variate)
        # Discount at the first asset's rate (a basket needs one numéraire;
        # heterogeneous r is allowed per asset for drift but the payoff
        # discounts at r of the quote currency = params_list[0].r).
        r_eff = float(self.params_list[0].r)
        discount = float(np.exp(-r_eff * T))
        mean, se = mc_mean_stderr(pay)
        out = {
            "price": discount * float(mean),
            "std_error": discount * float(se),
            "num_paths_used": self.num_paths,
            "num_steps": steps,
        }
        if self.use_control_variate:
            ctrl_exact = self._geo_ctrl_exact(spots, weights, strike, T,
                                              is_call)
            ctrl_c = ctrl_pay - jnp.mean(ctrl_pay)
            var_c = float(jnp.mean(ctrl_c**2))
            cov_pc = float(jnp.mean((pay - jnp.mean(pay)) * ctrl_c))
            beta = cov_pc / max(var_c, 1e-12) if var_c > 1e-12 else 0.0
            adj = pay - beta * (ctrl_pay - ctrl_exact)
            mean_cv, se_cv = mc_mean_stderr(adj)
            out["price"] = discount * float(mean_cv)
            out["std_error"] = discount * float(se_cv)
            out["cv_beta"] = float(beta)
        return out

    def _geo_ctrl_exact(self, spots, weights, strike, T,
                        is_call: bool) -> float:
        """Closed-form (undiscounted) expectation of the geometric control
        (host f64); shared by `price` and the mesh-sharded driver."""
        spots = np.asarray(spots, np.float64)
        weights = np.asarray(weights, np.float64)
        wv = weights * spots
        w_tilde = wv / wv.sum()
        sig = np.array([np.sqrt(float(p.v0)) for p in self.params_list])
        r_vec = np.array([float(p.r) for p in self.params_list])
        q_vec = np.array([float(p.q) for p in self.params_list])
        drifts_T = (r_vec - q_vec - 0.5 * sig**2) * T
        vol2_T = float(w_tilde @ (np.outer(sig, sig) * self.corr)
                       @ w_tilde) * T
        return _geometric_basket_undiscounted(
            float(wv.sum()), w_tilde, drifts_T, vol2_T, strike, is_call)

    def _companion_carry_qs(self, r_eff: float):
        """Effective dividend yields that express each companion leg's true
        carry b_i = r_i − q_i under the single quote-currency rate r_eff
        (Stulz/Margrabe take one r; heterogeneous per-asset rates fold into
        q_i' = r_eff − b_i exactly)."""
        return [r_eff - (float(p.r) - float(p.q)) for p in self.params_list]

    def _cv_adjust(self, out, pay, ctrl_pay, ctrl_exact, discount):
        """Optimal-β control-variate adjustment (shared by all payoffs)."""
        ctrl_c = ctrl_pay - jnp.mean(ctrl_pay)
        var_c = float(jnp.mean(ctrl_c**2))
        cov_pc = float(jnp.mean((pay - jnp.mean(pay)) * ctrl_c))
        beta = cov_pc / max(var_c, 1e-12) if var_c > 1e-12 else 0.0
        adj = pay - beta * (ctrl_pay - ctrl_exact)
        mean_cv, se_cv = mc_mean_stderr(adj)
        out["price"] = discount * float(mean_cv)
        out["std_error"] = discount * float(se_cv)
        out["cv_beta"] = float(beta)
        return out

    def price_american(self, spots: Sequence[float], strike: float,
                       T: float, kind: str = "max", is_call: bool = True,
                       weights: Sequence[float] = None, n_ex: int = 9,
                       steps_per_period: int = 8) -> Dict[str, float]:
        """Bermudan multi-asset option (max/min/basket underlier) by the
        multi-asset LSM — see engine/basket_american.py."""
        from mcos_tpu.engine.basket_american import price_basket_american

        return price_basket_american(
            self, spots, strike, T, kind=kind, is_call=is_call,
            weights=weights, n_ex=n_ex, steps_per_period=steps_per_period)

    def price_bounds_american(self, spots: Sequence[float], strike: float,
                              T: float, kind: str = "max",
                              is_call: bool = True,
                              weights: Sequence[float] = None,
                              n_ex: int = 9, steps_per_period: int = 1,
                              n_outer: int = 2048,
                              n_inner: int = 64) -> Dict[str, float]:
        """Bracket the multi-asset Bermudan price: out-of-sample LSM lower
        bound + Andersen-Broadie dual upper bound — see
        engine/basket_american.py:price_bounds_basket."""
        from mcos_tpu.engine.basket_american import price_bounds_basket

        return price_bounds_basket(
            self, spots, strike, T, kind=kind, is_call=is_call,
            weights=weights, n_ex=n_ex, steps_per_period=steps_per_period,
            n_outer=n_outer, n_inner=n_inner)

    def price_rainbow(self, spots: Sequence[float], strike: float, T: float,
                      kind: str = "worst_of", is_call: bool = True
                      ) -> Dict[str, float]:
        """Rainbow vanilla on the best/worst performer:
        max(±(extremeᵢ S_T,i − K), 0).

        For two assets with the control variate on, the companion GBM legs'
        rainbow payoff has an EXACT Stulz (1982) closed form
        (`ops/rainbow.py`) — the same companion-CV construction as the
        single-asset pricer, lifted to the joint law. For A > 2 the
        estimator runs plain antithetic (Johnson's N-asset formula is not
        implemented).
        """
        if kind not in ("worst_of", "best_of"):
            raise ValueError(f"kind must be worst_of|best_of, got {kind!r}")
        steps = scaled_steps(self.num_steps, T)
        spots = np.asarray(spots, np.float64)
        n_assets = spots.shape[0]
        use_cv = self.use_control_variate and n_assets == 2
        s, g = simulate_basket_terminal(
            self._batch, jnp.asarray(spots, jnp.float32), self._chol, T,
            jax.random.key(self.seed), num_paths=self.num_paths,
            num_steps=steps, antithetic=True, companion=use_cv)
        extreme = jnp.min if kind == "worst_of" else jnp.max
        phi = 1.0 if is_call else -1.0
        pay = combine_antithetic(
            jnp.maximum(phi * (extreme(s, axis=1) - strike), 0.0))
        r_eff = float(self.params_list[0].r)
        discount = float(np.exp(-r_eff * T))
        mean, se = mc_mean_stderr(pay)
        out = {
            "price": discount * float(mean),
            "std_error": discount * float(se),
            "kind": kind,
            "num_paths_used": self.num_paths,
            "num_steps": steps,
        }
        if use_cv:
            from mcos_tpu.ops.rainbow import rainbow_price

            ctrl_pay = combine_antithetic(
                jnp.maximum(phi * (extreme(g, axis=1) - strike), 0.0))
            q1e, q2e = self._companion_carry_qs(r_eff)
            sig = [float(np.sqrt(float(p.v0))) for p in self.params_list]
            # rainbow_price returns the r_eff-discounted value; the CV runs
            # on undiscounted payoffs.
            ctrl_exact = rainbow_price(
                float(spots[0]), float(spots[1]), float(strike), T, r_eff,
                q1e, q2e, sig[0], sig[1], float(self.corr[0, 1]),
                kind=kind, is_call=is_call) / discount
            out = self._cv_adjust(out, pay, ctrl_pay, ctrl_exact, discount)
        return out

    def price_spread(self, spots: Sequence[float], strike: float, T: float,
                     is_call: bool = True) -> Dict[str, float]:
        """Two-asset spread option max(±(S₁ − S₂ − K), 0).

        Control: the companion legs' EXCHANGE payoff max(G₁ − G₂, 0), whose
        expectation is exact Margrabe (1978) — highly correlated with the
        K≠0 spread payoff, so the CV bites even where the spread itself has
        no closed form. At K=0 (call) the estimator is near-exact.
        """
        if len(spots) != 2:
            raise ValueError("spread option needs exactly 2 assets")
        steps = scaled_steps(self.num_steps, T)
        spots = np.asarray(spots, np.float64)
        s, g = simulate_basket_terminal(
            self._batch, jnp.asarray(spots, jnp.float32), self._chol, T,
            jax.random.key(self.seed), num_paths=self.num_paths,
            num_steps=steps, antithetic=True,
            companion=self.use_control_variate)
        phi = 1.0 if is_call else -1.0
        spread = s[:, 0, :] - s[:, 1, :]
        pay = combine_antithetic(jnp.maximum(phi * (spread - strike), 0.0))
        r_eff = float(self.params_list[0].r)
        discount = float(np.exp(-r_eff * T))
        mean, se = mc_mean_stderr(pay)
        out = {
            "price": discount * float(mean),
            "std_error": discount * float(se),
            "num_paths_used": self.num_paths,
            "num_steps": steps,
        }
        if self.use_control_variate:
            from mcos_tpu.ops.rainbow import margrabe_exchange

            ctrl_pay = combine_antithetic(
                jnp.maximum(g[:, 0, :] - g[:, 1, :], 0.0))
            q1e, q2e = self._companion_carry_qs(r_eff)
            sig = [float(np.sqrt(float(p.v0))) for p in self.params_list]
            ctrl_exact = margrabe_exchange(
                float(spots[0]), float(spots[1]), T, q1e, q2e,
                sig[0], sig[1], float(self.corr[0, 1])) / discount
            out = self._cv_adjust(out, pay, ctrl_pay, ctrl_exact, discount)
        return out


def implied_correlation(params_list: Sequence[SVJParams], spots, weights,
                        strike: float, T: float, market_price: float,
                        is_call: bool = True, num_paths: int = 200_000,
                        seed: int = 42, tol: float = 1e-3,
                        max_iter: int = 40) -> Dict[str, float]:
    """Flat pairwise correlation implied by a basket option quote.

    The dispersion desk's inverse problem: with CRN paths (one seed,
    correlation entering only through the Cholesky mix) the basket price
    is smooth and monotone increasing in the flat rho for a call — more
    co-movement means more basket variance — so plain bisection on
    [-1/(A-1)+eps, 0.999] converges without MC-noise chatter.
    """
    a = len(params_list)
    lo = -1.0 / (a - 1) + 1e-3          # PSD boundary for the flat matrix
    hi = 0.999

    def price_at(rho: float) -> float:
        corr = np.full((a, a), rho)
        np.fill_diagonal(corr, 1.0)
        eng = BasketEngine(params_list, corr, num_paths=num_paths,
                           seed=seed)
        return eng.price(spots, weights, strike, T, is_call)["price"]

    p_lo, p_hi = price_at(lo), price_at(hi)
    sign = 1.0 if p_hi >= p_lo else -1.0     # calls ↑ in rho, puts too
    if not min(p_lo, p_hi) - tol <= market_price <= max(p_lo, p_hi) + tol:
        raise ValueError(
            f"market price {market_price:.4f} outside the attainable "
            f"range [{min(p_lo, p_hi):.4f}, {max(p_lo, p_hi):.4f}]")
    iters = 0
    for iters in range(1, max_iter + 1):
        mid = 0.5 * (lo + hi)
        p_mid = price_at(mid)
        if abs(p_mid - market_price) < tol:
            break
        if sign * (p_mid - market_price) < 0.0:
            lo = mid
        else:
            hi = mid
    return {
        "implied_correlation": float(0.5 * (lo + hi)),
        "model_price": float(p_mid),
        "market_price": float(market_price),
        "iterations": iters,
    }
