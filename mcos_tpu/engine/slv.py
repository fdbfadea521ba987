r"""Stochastic local volatility (SLV) — the exotics desk's workhorse mix.

Capability beyond the reference: local vol reprices every vanilla but
kills forward skew; Heston has dynamics but misses today's smile. SLV
keeps both:

    dS/S = (r - q) dt + L(t, S) sqrt(v_t) dW1
    dv   = kappa (theta - v) dt + xi sqrt(v) dW2,   <dW1, dW2> = rho dt,

with the leverage surface fixed by the Gyongy/mimicking condition

    L(t, S)^2 * E[v_t | S_t = S] = sigma_loc(t, S)^2,

so the SLV marginals match the Dupire surface (exactly in the particle
limit; the tests bound the finite-cloud remainder at <=2 sigma across a
chain) while the v-dynamics keep smile movement stochastic.

Design — the particle method (Guyon & Henry-Labordere) runs entirely
inside one `lax.scan`: at each step the conditional expectation
E[v_t | S_t] is estimated from the path cloud itself by binning paths in
forward log-moneyness (`jax.ops.segment_sum` over a static bin count —
two segment-sums and a gather, no host round-trips, no kernel density
loops), the leverage row is formed on the fly, and the step advances with
L interpolated per path. Self-consistency emerges forward in time, the
way the particle method is meant to run — there is no outer fixed-point
iteration to converge.

Oracles: xi -> 0 collapses v to v0 and SLV to pure local vol (pinned to
LocalVolEngine); a flat Dupire surface makes vanillas Black-Scholes
(pinned for full-strength Heston mixing — the leverage must neutralize
the Heston smile); a skewed SSVI-derived surface reprices its own
vanilla chain through the SLV mix (the property desks buy SLV for).
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.engine.localvol import LocalVolSurface
from mcos_tpu.models.params import SVJParams
from mcos_tpu.ops.simulate import _safe_sqrt, combine_antithetic

Array = jax.Array

_VAR_FLOOR, _VAR_CAP = 1e-6, 16.0
_LEV2_MIN, _LEV2_MAX = 0.01, 100.0      # leverage^2 clip (stability)


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "n_bins",
                                   "k_snapshot", "track_extremes",
                                   "emit_sheet", "axis_name"))
def slv_terminal(params: SVJParams, var_rows, t_mid, y0, dy, spot, T,
                 key, *, num_paths: int, num_steps: int,
                 n_bins: int = 101, k_snapshot: int = -1,
                 track_extremes: bool = False,
                 emit_sheet: bool = False,
                 axis_name: str = None) -> Array:
    """(2, num_paths) terminal spots under the particle-calibrated SLV —
    or, with `k_snapshot >= 0`, a (2, 2, num_paths) stack of
    (S at step k_snapshot, S at T) for forward-start payoffs; with
    `track_extremes`, a (3, 2, num_paths) stack of (S_T, running max,
    running min) for barrier/lookback payoffs.

    `params` supplies the Heston block (kappa, theta, xi, rho, v0, r, q;
    jumps ignored); `var_rows`/`t_mid`/`y0`/`dy` are the Dupire table in
    the localvol engine's step-table layout.

    `axis_name`: when running inside `shard_map` over a path-sharded mesh,
    the per-step particle statistics (bin sums/counts and the cloud mean
    feeding the prior) are pooled with `lax.psum` over this axis, so the
    leverage function is estimated from the GLOBAL particle cloud — the
    mean-field interaction is what makes SLV genuinely distributed rather
    than N independent small-cloud runs (small clouds bias E[v|S] noisy-to-
    flat). The caller must fold its device index into `key`.
    """
    dtype = jnp.float32
    p = params
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    r = jnp.asarray(p.r, dtype)
    q = jnp.asarray(p.q, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[:, None]
    n_y = var_rows.shape[1]
    y_hi = y0 + dy * (n_y - 1)
    bin_w = (y_hi - y0) / n_bins
    rho_perp = jnp.sqrt(1.0 - p.rho * p.rho)

    def step(carry, inputs):
        log_s, v, snap, mx, mn = carry
        step_idx, row, t = inputs
        k_step = jax.random.fold_in(key, step_idx)
        z = jax.random.normal(k_step, (2, num_paths), dtype)
        z1 = z[0][None] * sign
        z2 = z[1][None] * sign

        y = log_s - (r - q) * t                      # (2, paths)
        # Local variance at (t, y): uniform-grid linear interp.
        pos = jnp.clip((y - y0) / dy, 0.0, float(n_y - 1))
        i = jnp.minimum(pos.astype(jnp.int32), n_y - 2)
        frac = pos - i.astype(dtype)
        sig_loc2 = (jnp.take(row, i) * (1.0 - frac)
                    + jnp.take(row, i + 1) * frac)
        sig_loc2 = jnp.clip(sig_loc2, _VAR_FLOOR, _VAR_CAP)

        # Particle estimate of E[v | S] by binning the cloud in y (both
        # antithetic branches pooled — they are valid particles too).
        # Each path reads its OWN bin's mean — the self-consistent choice
        # (interpolating between bin means overestimates the convex
        # E[v|y] and systematically under-levers; measured). A mild
        # ~16-particle prior toward the cloud mean stabilizes near-empty
        # wing bins without flattening the leverage effect.
        v_pos = jnp.maximum(v, 0.0)
        bins = jnp.clip(((y - y0) / bin_w).astype(jnp.int32), 0,
                        n_bins - 1).reshape(-1)
        v_flat = v_pos.reshape(-1)
        sums = jax.ops.segment_sum(v_flat, bins, num_segments=n_bins)
        cnts = jax.ops.segment_sum(jnp.ones_like(v_flat), bins,
                                   num_segments=n_bins)
        v_sum = jnp.sum(v_flat)
        v_cnt = jnp.float32(v_flat.shape[0])
        if axis_name is not None:
            # One fused psum per step: the (n_bins+2)-word vector rides ICI.
            pooled = jax.lax.psum(
                jnp.concatenate([sums, cnts, jnp.stack([v_sum, v_cnt])]),
                axis_name)
            sums, cnts = pooled[:n_bins], pooled[n_bins:2 * n_bins]
            v_sum, v_cnt = pooled[-2], pooled[-1]
        prior = jnp.float32(16.0)
        ev_bin = (sums + prior * (v_sum / v_cnt)) / (cnts + prior)
        ev = ev_bin[bins].reshape(2, num_paths)

        lev2 = jnp.clip(sig_loc2 / jnp.maximum(ev, _VAR_FLOOR),
                        _LEV2_MIN, _LEV2_MAX)
        eff_var = lev2 * v_pos
        sig_eff = _safe_sqrt(eff_var)

        log_s = log_s + (r - q - 0.5 * eff_var) * dt \
            + sig_eff * z1 * sqrt_dt
        dw2 = p.rho * z1 + rho_perp * z2
        v = jnp.maximum(v_pos + p.kappa * (p.theta - v_pos) * dt
                        + p.xi * _safe_sqrt(v_pos) * dw2 * sqrt_dt, 0.0)
        if k_snapshot >= 0:
            snap = jnp.where(step_idx == k_snapshot, log_s, snap)
        if track_extremes:
            mx = jnp.maximum(mx, log_s)
            mn = jnp.minimum(mn, log_s)
        return (log_s, v, snap, mx, mn), (log_s if emit_sheet else None)

    zeros = jnp.zeros((2, num_paths), dtype)
    init = (zeros, jnp.full((2, num_paths), jnp.asarray(p.v0, dtype)),
            zeros, zeros, zeros)   # log(S/S0)=0 seeds max/min with t_0
    (log_s, _, snap, mx, mn), sheet = jax.lax.scan(
        step, init,
        (jnp.arange(num_steps), var_rows, jnp.asarray(t_mid, dtype)))
    if emit_sheet:
        return sheet                       # (n, 2, paths) log(S/S0)
    if track_extremes:
        return spot * jnp.exp(jnp.stack([log_s, mx, mn]))
    if k_snapshot >= 0:
        return spot * jnp.exp(jnp.stack([snap, log_s]))
    return spot * jnp.exp(log_s)


class SLVEngine:
    """Particle-method SLV pricer on a Dupire surface + Heston mix."""

    def __init__(self, surface: LocalVolSurface, heston: SVJParams,
                 num_paths: int = 200_000, num_steps: int = 128,
                 n_bins: int = 101, seed: int = 42):
        self.surface = surface
        self.heston = heston.replace(lambda_j=0.0, mu_j=0.0, sigma_j=1e-4,
                                     r=surface.r, q=surface.q)
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.n_bins = int(n_bins)
        self.seed = int(seed)

    def terminal(self, spot: float, T: float) -> Array:
        rows, t_mid = self.surface.step_tables(T, self.num_steps)
        return slv_terminal(
            self.heston, jnp.asarray(rows), jnp.asarray(t_mid),
            float(self.surface.y_grid[0]),
            float(self.surface.y_grid[1] - self.surface.y_grid[0]),
            spot, T, jax.random.key(self.seed),
            num_paths=self.num_paths, num_steps=self.num_steps,
            n_bins=self.n_bins)

    def price_forward_start(self, spot: float, t1: float, T: float,
                            k: float = 1.0,
                            is_call: bool = True) -> Dict[str, float]:
        """Forward-start performance option e^{-rT} E[(±(S_T/S_t1 − k))⁺].

        THE payoff where SLV earns its keep: pure local vol and SLV
        reprice identical vanillas, but LV's forward smile flattens as
        the spot diffuses across the surface while SLV's stochastic v
        keeps it — their forward-start prices differ materially
        (test-quantified against LocalVolEngine on the same surface).
        """
        rows, t_mid = self.surface.step_tables(T, self.num_steps)
        k1 = max(min(int(round(t1 / T * self.num_steps)),
                     self.num_steps - 1), 0)
        s = slv_terminal(
            self.heston, jnp.asarray(rows), jnp.asarray(t_mid),
            float(self.surface.y_grid[0]),
            float(self.surface.y_grid[1] - self.surface.y_grid[0]),
            spot, T, jax.random.key(self.seed),
            num_paths=self.num_paths, num_steps=self.num_steps,
            n_bins=self.n_bins, k_snapshot=k1)   # (2: t1/T, 2, paths)
        ratio = s[1] / s[0]
        phi = 1.0 if is_call else -1.0
        pay = combine_antithetic(jnp.maximum(phi * (ratio - k), 0.0))
        disc = float(np.exp(-float(self.heston.r) * T))
        return {
            "price": disc * float(jnp.mean(pay)),
            "std_error": disc * float(jnp.std(pay))
            / float(np.sqrt(pay.shape[0])),
            "t1_effective": (k1 + 1) * T / self.num_steps,
            "num_paths_used": self.num_paths,
        }

    def price_barrier(self, spot: float, strike: float, T: float,
                      barrier: float, is_call: bool = True,
                      knock: str = "out",
                      direction: str = None) -> Dict[str, float]:
        """Discretely-monitored barrier under SLV — the canonical SLV
        product: with vanillas pinned to one surface, the barrier price
        moves monotonically with the mixing strength between the pure-LV
        and Heston-like values (the trader's 'mixing fraction' dial)."""
        if direction is None:
            direction = "up" if barrier >= spot else "down"
        rows, t_mid = self.surface.step_tables(T, self.num_steps)
        s = slv_terminal(
            self.heston, jnp.asarray(rows), jnp.asarray(t_mid),
            float(self.surface.y_grid[0]),
            float(self.surface.y_grid[1] - self.surface.y_grid[0]),
            spot, T, jax.random.key(self.seed),
            num_paths=self.num_paths, num_steps=self.num_steps,
            n_bins=self.n_bins, track_extremes=True)  # (3, 2, paths)
        s_t, s_max, s_min = s[0], s[1], s[2]
        hit = s_max >= barrier if direction == "up" else s_min <= barrier
        alive = hit if knock == "in" else ~hit
        phi = 1.0 if is_call else -1.0
        pay = combine_antithetic(
            jnp.maximum(phi * (s_t - strike), 0.0) * alive)
        disc = float(np.exp(-float(self.heston.r) * T))
        return {
            "price": disc * float(jnp.mean(pay)),
            "std_error": disc * float(jnp.std(pay))
            / float(np.sqrt(pay.shape[0])),
            "hit_fraction": float(jnp.mean(hit)),
            "mixing_xi": float(self.heston.xi),
            "num_paths_used": self.num_paths,
        }

    def hedging_backtest(self, spot: float, strike: float, T: float,
                         is_call: bool = True,
                         num_days: int = None,
                         txn_cost_bps: float = 5.0,
                         slippage_bps: float = 2.0) -> Dict[str, object]:
        """Daily BS-delta replication PnL in the SLV world.

        The risk question SLV answers: two worlds calibrated to the SAME
        vanilla surface (pure LV at xi~0 vs the full mix) produce
        different hedging-error distributions for the same delta
        strategy — run this at both mixing strengths to see it. Reuses
        the sheet-driven hedge scan (`engine/risk.py`)."""
        from mcos_tpu.engine.risk import _hedge_paths_from_sheet

        if num_days is None:
            num_days = max(int(T * 252), 16)
        rows, t_mid = self.surface.step_tables(T, num_days)
        sheet = slv_terminal(
            self.heston, jnp.asarray(rows), jnp.asarray(t_mid),
            float(self.surface.y_grid[0]),
            float(self.surface.y_grid[1] - self.surface.y_grid[0]),
            spot, T, jax.random.key(self.seed),
            num_paths=self.num_paths, num_steps=int(num_days),
            n_bins=self.n_bins, emit_sheet=True)   # (days, 2, paths)
        sheet = jnp.moveaxis(sheet, 0, -1).reshape(-1, int(num_days))
        premium = self.price(spot, strike, T, is_call)["price"]
        sigma_h = float(np.sqrt(float(self.heston.v0)))
        pnl, cost = _hedge_paths_from_sheet(
            sheet, jnp.float32(spot), jnp.float32(strike),
            jnp.float32(T), jnp.float32(premium), jnp.float32(sigma_h),
            jnp.float32(self.heston.r), jnp.float32(self.heston.q),
            num_days=int(num_days), is_call=is_call,
            txn_cost_bps=txn_cost_bps, slippage_bps=slippage_bps)
        pnl = np.asarray(pnl)
        return {
            "mean_pnl": float(pnl.mean()),
            "std_pnl": float(pnl.std()),
            "pnl_percentiles": {f"{p}%": float(np.percentile(pnl, p))
                                for p in (1, 5, 50, 95, 99)},
            "mixing_xi": float(self.heston.xi),
            "premium": premium,
        }

    def greeks(self, spot: float, strike: float, T: float,
               is_call: bool = True,
               rel_bump: float = 0.005) -> Dict[str, float]:
        """delta/gamma by CRN central differences of the engine price.

        Deliberately NOT pathwise AD: the particle estimator's bin
        assignment is a discrete function of the path cloud, so AD would
        silently drop the d(leverage)/d(spot) term; CRN bumps reprice
        through the full self-calibrating pipeline (leverage re-forms
        under each bumped cloud — sticky-local-vol-style dynamics).
        """
        h = spot * rel_bump
        pu = self.price(spot + h, strike, T, is_call)["price"]
        pm = self.price(spot, strike, T, is_call)
        pd = self.price(spot - h, strike, T, is_call)["price"]
        return {
            "price": pm["price"],
            "delta": (pu - pd) / (2 * h),
            "gamma": (pu - 2 * pm["price"] + pd) / h**2,
            "std_error": pm["std_error"],
        }

    def price(self, spot: float, strikes, T: float,
              is_call: bool = True) -> Dict[str, object]:
        strikes_arr = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))
        s = self.terminal(spot, T)
        phi = 1.0 if is_call else -1.0
        pay = combine_antithetic(
            jnp.maximum(phi * (s[..., None] - strikes_arr[None, None, :]),
                        0.0))                      # (paths, strikes)
        disc = float(np.exp(-float(self.heston.r) * T))
        mean = np.asarray(jnp.mean(pay, axis=0))
        se = np.asarray(jnp.std(pay, axis=0)) / np.sqrt(pay.shape[0])
        scalar = np.ndim(strikes) == 0
        price, stderr = disc * mean, disc * se
        return {
            "price": float(price[0]) if scalar else price.tolist(),
            "std_error": float(stderr[0]) if scalar else stderr.tolist(),
            "num_paths_used": self.num_paths,
            "num_steps": self.num_steps,
            "mixing_xi": float(self.heston.xi),
        }
