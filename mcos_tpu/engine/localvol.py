"""Dupire local volatility: surface construction + device Monte Carlo.

A model family the reference does not have (its model set is BS + SVJ,
engine/models.py): the unique diffusion σ_loc(t, S) that reprices an entire
arbitrage-free European option surface exactly (Dupire 1994). Given any
implied-vol surface — market-fitted, SABR, or generated from the SVJ/COS
oracle — the local-vol engine reprices vanillas consistently with it and
prices path-dependent payoffs under the surface-consistent dynamics.

Design (device-first):

- **Surface construction is host-side f64** (small, precision-critical —
  Dupire is a ratio of second derivatives and f32 FD noise would dominate;
  same policy as the IV inversion and COS pricer).
  The formula is applied in total-variance form, which is numerically the
  tame one (no discounting terms, no raw ∂²C/∂K²):

      w(y, T) = σ_imp²(y, T)·T,   y = log(K / F_T)

                             ∂_T w
      σ_loc²(y, T) = ─────────────────────────────────────────────────────
                     1 − (y/w)·∂_y w + ¼(−¼ − 1/w + y²/w²)(∂_y w)² + ½∂²_y w

- **Simulation is a jitted scan with a uniform-grid lookup.** The (t, y)
  local-variance table is resampled at the simulator's own step midpoints on
  the host, so the device kernel does a single 1-D *uniform-grid* interpolation
  per step (index arithmetic + two gathers — no searchsorted), which XLA
  vectorizes across the path axis. Carry is log(S/S0) (f32 drift-quantization
  policy of ops/simulate.py).

Reference parity anchor: the surface inputs come from the same IV machinery
as engine/surface.py (spline slices, total-variance interpolation in T —
reference engine/surface.py:329-356 semantics).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.engine.surface import NaturalCubicSpline
from mcos_tpu.ops.bs import bs_price

Array = jax.Array

# Local-variance clamps: keep the diffusion well-posed where the input
# surface is noisy / extrapolated (vols between ~3% and ~300%).
_VAR_FLOOR = 1e-3**2
_VAR_CAP = 3.0**2


def dupire_local_variance(
    y: np.ndarray, w: np.ndarray, wy: np.ndarray, wyy: np.ndarray,
    wt: np.ndarray,
) -> np.ndarray:
    """Dupire's formula in total-variance form (all inputs on one grid).

    Args:
        y: log-moneyness grid values (broadcastable to w's shape).
        w: total implied variance σ²T (must be > 0).
        wy, wyy: first/second y-derivatives of w.
        wt: T-derivative of w (calendar slope; ≥ 0 iff no calendar arbitrage).

    Returns local variance, clamped to a sane positive window wherever the
    denominator goes non-positive (butterfly-arbitrage pockets of a noisy
    input surface).
    """
    w_safe = np.maximum(w, 1e-12)
    denom = (1.0 - (y / w_safe) * wy
             + 0.25 * (-0.25 - 1.0 / w_safe + (y / w_safe) ** 2) * wy**2
             + 0.5 * wyy)
    local_var = np.where(denom > 1e-8, wt / np.maximum(denom, 1e-8),
                         np.maximum(wt, _VAR_FLOOR))
    return np.clip(local_var, _VAR_FLOOR, _VAR_CAP)


@dataclass
class LocalVolSurface:
    """Local-variance table σ_loc²(t, y) on a regular (t, y) grid.

    Attributes:
        t_grid: (n_t,) increasing times > 0.
        y_grid: (n_y,) uniform log-moneyness grid (y = log(S/F_t)).
        local_var: (n_t, n_y) local variance.
        r, q: carry rates the y-coordinate (forward) uses.
    """

    t_grid: np.ndarray
    y_grid: np.ndarray
    local_var: np.ndarray
    r: float
    q: float

    @classmethod
    def flat(cls, sigma: float, r: float = 0.065, q: float = 0.012,
             t_max: float = 2.0) -> "LocalVolSurface":
        """Constant-vol surface (the BS-oracle degenerate case)."""
        t = np.linspace(0.01, t_max, 16)
        y = np.linspace(-1.0, 1.0, 9)
        lv = np.full((t.size, y.size), float(sigma) ** 2)
        return cls(t, y, lv, float(r), float(q))

    @classmethod
    def from_ssvi(cls, ssvi, spot: float, r: float = 0.065,
                  q: float = 0.012, n_strikes: int = 21,
                  n_mats: int = 8, **kw) -> "LocalVolSurface":
        """Dupire table from a fitted SSVI surface (engine/ssvi.py).

        SSVI gives an arbitrage-aware parametric IV everywhere, which is
        exactly what the Dupire derivatives want — the smooth w(k, t)
        avoids the quote-noise amplification of raw-grid differentiation.
        Samples the SSVI surface on a (maturity, strike) grid spanning its
        fitted maturities and feeds `from_iv_points`.
        """
        t_lo = float(ssvi.maturities[0])
        t_hi = float(ssvi.maturities[-1])
        mats = np.linspace(t_lo, t_hi, n_mats)
        # Strike span: ±3 ATM sigmas at the longest maturity.
        sig = float(np.sqrt(ssvi.theta_at(t_hi) / t_hi))
        strikes = spot * np.exp(np.linspace(-3.0, 3.0, n_strikes)
                                * sig * np.sqrt(t_hi))
        iv = ssvi.iv_grid(spot, strikes, mats, r, q)
        return cls.from_iv_points(spot, strikes, mats, iv, r=r, q=q, **kw)

    @classmethod
    def from_iv_points(
        cls,
        spot: float,
        strikes: Sequence[float],
        maturities: Sequence[float],
        iv: np.ndarray,
        r: float = 0.065,
        q: float = 0.012,
        n_y: int = 101,
        n_t: int = 64,
        y_span: Optional[float] = None,
    ) -> "LocalVolSurface":
        """Build the Dupire table from an implied-vol grid.

        Args:
            iv: (n_maturities, n_strikes) implied vols (NaN = missing quote;
                slices need ≥ 4 live quotes).
            n_y, n_t: output grid resolution.
            y_span: half-width of the y grid; default = data span + margin.

        Pipeline (host f64): per-maturity natural cubic spline of w = σ²T in
        y → total-variance linear interpolation in T at fixed y (calendar-
        consistent, engine/surface.py:329-356 semantics; w ∝ t below the
        first maturity) → central finite differences → Dupire formula.
        """
        strikes = np.asarray(strikes, np.float64)
        maturities = np.asarray(maturities, np.float64)
        iv = np.asarray(iv, np.float64)
        if iv.shape != (maturities.size, strikes.size):
            raise ValueError("iv must be (n_maturities, n_strikes)")

        # Per-slice w(y) splines in forward log-moneyness.
        slices = []
        y_min, y_max = np.inf, -np.inf
        for i, T in enumerate(maturities):
            f_t = spot * np.exp((r - q) * T)
            y_pts = np.log(strikes / f_t)
            live = np.isfinite(iv[i]) & (iv[i] > 0)
            if live.sum() < 4:
                continue
            w_pts = iv[i, live] ** 2 * T
            order = np.argsort(y_pts[live])
            ys, ws = y_pts[live][order], w_pts[order]
            slices.append((float(T), NaturalCubicSpline(ys, ws),
                           ys[0], ys[-1]))
            y_min, y_max = min(y_min, ys[0]), max(y_max, ys[-1])
        if len(slices) < 2:
            raise ValueError("need ≥ 2 maturities with ≥ 4 live quotes each")

        if y_span is None:
            y_span = max(abs(y_min), abs(y_max))
        y_grid = np.linspace(-y_span, y_span, n_y)
        t_lo, t_hi = slices[0][0], slices[-1][0]
        t_grid = np.linspace(max(t_lo * 0.25, 1e-3), t_hi, n_t)

        # w(T_i, y) rows, flat-extrapolated in y beyond each slice's quotes
        # (constant-vol wings keep the Dupire denominator positive there).
        slice_t = np.array([s[0] for s in slices])
        slice_w = np.empty((len(slices), n_y))
        for i, (T, spl, lo, hi) in enumerate(slices):
            yq = np.clip(y_grid, lo, hi)
            slice_w[i] = np.maximum(spl(yq), 1e-10)

        def w_at(t: np.ndarray) -> np.ndarray:
            """(len(t), n_y) total variance, linear in T at fixed y."""
            out = np.empty((t.size, n_y))
            for j, tj in enumerate(t):
                if tj <= slice_t[0]:
                    out[j] = slice_w[0] * (tj / slice_t[0])  # w(0,·) = 0
                elif tj >= slice_t[-1]:
                    # Linear continuation of the last calendar segment.
                    w0, w1 = slice_w[-2], slice_w[-1]
                    t0, t1 = slice_t[-2], slice_t[-1]
                    out[j] = np.maximum(
                        w1 + (w1 - w0) * (tj - t1) / (t1 - t0), 1e-10)
                else:
                    k = np.searchsorted(slice_t, tj) - 1
                    lam = (tj - slice_t[k]) / (slice_t[k + 1] - slice_t[k])
                    out[j] = (1 - lam) * slice_w[k] + lam * slice_w[k + 1]
            return out

        dt_fd = 1e-4
        w_mid = w_at(t_grid)
        wt = (w_at(t_grid + dt_fd) - w_at(np.maximum(t_grid - dt_fd, 1e-5))) \
            / (dt_fd + np.minimum(t_grid - 1e-5, dt_fd))[:, None]
        wt = np.maximum(wt, 1e-8)  # calendar-arbitrage floor

        dy = y_grid[1] - y_grid[0]
        wy = np.gradient(w_mid, dy, axis=1)
        wyy = np.gradient(wy, dy, axis=1)

        local_var = dupire_local_variance(y_grid[None, :], w_mid, wy, wyy, wt)
        return cls(t_grid, y_grid, local_var, float(r), float(q))

    def local_vol(self, t: float, y: float) -> float:
        """Point lookup (bilinear), mostly for inspection/tests."""
        ti = np.clip(np.searchsorted(self.t_grid, t) - 1, 0,
                     self.t_grid.size - 2)
        lam = np.clip((t - self.t_grid[ti])
                      / (self.t_grid[ti + 1] - self.t_grid[ti]), 0.0, 1.0)
        row = (1 - lam) * self.local_var[ti] + lam * self.local_var[ti + 1]
        return float(np.sqrt(np.interp(y, self.y_grid, row)))

    def step_tables(self, T: float, num_steps: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Resample the table at step midpoints → ((steps, n_y) var, (steps,) t).

        Host-side prep for the scan kernel: the device then only does uniform
        1-D interpolation in y.
        """
        t_mid = (np.arange(num_steps) + 0.5) * (T / num_steps)
        rows = np.empty((num_steps, self.y_grid.size), np.float32)
        for k, t in enumerate(t_mid):
            ti = int(np.clip(np.searchsorted(self.t_grid, t) - 1, 0,
                             self.t_grid.size - 2))
            lam = float(np.clip(
                (t - self.t_grid[ti])
                / (self.t_grid[ti + 1] - self.t_grid[ti]), 0.0, 1.0))
            rows[k] = ((1 - lam) * self.local_var[ti]
                       + lam * self.local_var[ti + 1])
        return rows, t_mid.astype(np.float32)


@partial(jax.jit, static_argnames=("num_paths", "num_steps", "antithetic"))
def simulate_terminal_localvol(
    var_rows: Array,      # (num_steps, n_y) local variance at step midpoints
    t_mid: Array,         # (num_steps,) midpoint times
    y0: float,            # y_grid[0]
    dy: float,            # uniform y spacing
    spot,
    r,
    q,
    T,
    key: Array,
    num_paths: int,
    num_steps: int,
    antithetic: bool = True,
) -> Array:
    """Terminal spots under d log S = (r − q − σ²/2)dt + σ(t, y) dW.

    y = log(S_t / F_t) with F_t = S₀e^{(r−q)t}; σ² is a uniform-grid linear
    interpolation of the step's variance row (two gathers + one FMA per
    path-step). Returns (n_branch, num_paths).
    """
    dtype = jnp.float32
    n_branch = 2 if antithetic else 1
    spot = jnp.asarray(spot, dtype)
    T = jnp.asarray(T, dtype)
    r = jnp.asarray(r, dtype)
    q = jnp.asarray(q, dtype)
    dt = T / num_steps
    sqrt_dt = jnp.sqrt(dt)
    sign = jnp.array([1.0, -1.0], dtype)[:n_branch, None]
    n_y = var_rows.shape[1]

    log_s = jnp.zeros((n_branch, num_paths), dtype)  # log(S/S0) carry

    def step(log_s, inputs):
        step_idx, row, t = inputs
        z = jax.random.normal(jax.random.fold_in(key, step_idx),
                              (num_paths,), dtype) * sign
        y = log_s - (r - q) * t
        pos = jnp.clip((y - y0) / dy, 0.0, float(n_y - 1))
        # Integer clamp (not a float-epsilon clip: n_y − 1 − ε rounds back up
        # to n_y − 1 in f32 once n_y ≳ 100, and i+1 would gather OOB → NaN).
        i = jnp.minimum(pos.astype(jnp.int32), n_y - 2)
        frac = pos - i.astype(dtype)
        v = jnp.take(row, i) * (1.0 - frac) + jnp.take(row, i + 1) * frac
        sig = jnp.sqrt(jnp.clip(v, _VAR_FLOOR, _VAR_CAP))
        log_s = log_s + (r - q - 0.5 * sig * sig) * dt + sig * sqrt_dt * z
        return log_s, None

    log_s, _ = jax.lax.scan(
        step, log_s, (jnp.arange(num_steps), var_rows, t_mid))
    return spot * jnp.exp(log_s)


class LocalVolEngine:
    """Monte Carlo pricer under Dupire local-vol dynamics.

    API mirrors `MonteCarloEngine.price/price_batch` so desk code can swap
    model families without changing call sites.
    """

    def __init__(self, surface: LocalVolSurface, num_paths: int = 200_000,
                 num_steps: int = 100, seed: int = 42,
                 use_antithetic: bool = True, mesh=None):
        self.surface = surface
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.use_antithetic = bool(use_antithetic)
        # None honors MCOS_AUTO_MESH=1; "auto"/Mesh routes price_batch()
        # through parallel/families.py:sharded_localvol_price.
        self.mesh = mesh

    def _terminal(self, spot: float, T: float) -> Array:
        steps = max(int(self.num_steps * T), 16)
        rows, t_mid = self.surface.step_tables(T, steps)
        return simulate_terminal_localvol(
            jnp.asarray(rows), jnp.asarray(t_mid),
            float(self.surface.y_grid[0]),
            float(self.surface.y_grid[1] - self.surface.y_grid[0]),
            spot, self.surface.r, self.surface.q, T,
            jax.random.key(self.seed),
            num_paths=self.num_paths, num_steps=steps,
            antithetic=self.use_antithetic,
        )

    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True) -> Dict[str, float]:
        rows = self.price_batch(spot, [strike], T, is_call)
        return rows[0]

    def price_batch(self, spot: float, strikes: Sequence[float], T: float,
                    is_call: bool = True) -> list:
        """Price a strike chain off one shared local-vol path set."""
        from mcos_tpu.engine.pricer import resolve_mesh
        from mcos_tpu.ops import simulate as sim

        mesh = resolve_mesh(self.mesh)
        if mesh is not None and self.use_antithetic:
            from mcos_tpu.parallel.families import sharded_localvol_price

            res = jax.device_get(sharded_localvol_price(
                self.surface, spot, np.asarray(strikes, np.float32), T,
                jax.random.key(self.seed), mesh=mesh,
                num_paths=self.num_paths,
                num_steps=max(int(self.num_steps * T), 16),
                is_call=is_call))
            return [
                {"strike": float(k), "price": float(p),
                 "std_error": float(s)}
                for k, p, s in zip(np.asarray(strikes, np.float64),
                                   np.atleast_1d(res["price"]),
                                   np.atleast_1d(res["std_error"]))]

        s_final = self._terminal(spot, T)
        strikes_arr = jnp.asarray(np.asarray(strikes, np.float32))
        pay = sim.vanilla_payoff(
            s_final[None], strikes_arr[:, None, None], is_call)
        pay = sim.combine_antithetic(jnp.swapaxes(pay, 0, 1))
        mean, se = sim.mc_mean_stderr(pay)
        disc = float(np.exp(-self.surface.r * T))
        mean = np.asarray(jax.device_get(mean), np.float64)
        se = np.asarray(jax.device_get(se), np.float64)
        return [
            {"strike": float(k), "price": disc * float(m),
             "std_error": disc * float(s)}
            for k, m, s in zip(np.asarray(strikes, np.float64), mean, se)
        ]

    def implied_surface_error(self, spot: float, strikes: Sequence[float],
                              T: float, target_iv: Sequence[float]) -> float:
        """Max |model IV − target IV| over the chain — the round-trip metric
        (a perfect Dupire build reprices its input surface exactly)."""
        from mcos_tpu.engine.surface import implied_vol

        rows = self.price_batch(spot, strikes, T, is_call=True)
        errs = []
        for row, iv_t in zip(rows, np.asarray(target_iv, np.float64)):
            iv_m = implied_vol(row["price"], spot, row["strike"], T,
                               self.surface.r, self.surface.q, is_call=True)
            if iv_m is not None and np.isfinite(iv_t):
                errs.append(abs(iv_m - iv_t))
        return float(max(errs)) if errs else float("nan")
