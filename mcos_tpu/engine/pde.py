r"""Crank-Nicolson PDE pricer — the framework's second numerical method.

Capability beyond the reference (Monte Carlo only): a deterministic
finite-difference engine for the Black-Scholes / Dupire-local-vol PDE

    V_t + 1/2 sig(x,t)^2 V_xx + (r - q - 1/2 sig^2) V_x - r V = 0,

in log-spot x, backward from the payoff. It serves as an *independent
cross-check* on every MC price (different discretization, different error
structure — disagreement localizes bugs that two MC runs sharing a kernel
cannot see) and prices American exercise without regression noise.

Design: one `lax.scan` over time steps whose body is a single
`jax.lax.linalg.tridiagonal_solve` — the XLA-native O(n) solver — on the
(n_x,) grid; there is no assembly loop, the three diagonals are closed
forms. Theta-scheme with Rannacher start-up (the first two steps run
fully implicit to damp the payoff-kink oscillation Crank-Nicolson is
famous for), Dirichlet boundaries from the discounted asymptotics, and
American exercise by projection (max against intrinsic after each step).
Delta and gamma come from central differences of the final grid — one
solve yields price AND spatial Greeks for every spot on the grid.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.lax.linalg import tridiagonal_solve

from mcos_tpu.config import DIVIDEND_YIELD, RISK_FREE_RATE

Array = jax.Array


@partial(jax.jit, static_argnames=("n_x", "n_t", "is_call", "american"))
def _cn_solve(sig2_grid, strike, T, r, q, x_grid, div_shift, *,
              n_x: int, n_t: int, is_call: bool, american: bool) -> Array:
    """Backward theta-scheme on the log-spot grid; returns V(t=0, x).

    sig2_grid: (n_t, n_x) local variance at each (time-step, node) — a
    constant array for Black-Scholes, the Dupire table for local vol.
    Time index 0 is the step nearest maturity (backward order).

    div_shift: (n_t,) per-step log-shift for discrete PROPORTIONAL
    dividends. When step k's interval contains an ex-date with fraction
    d, div_shift[k] = log(1 - d) and the jump condition
    V(t⁻, x) = V(t⁺, x + log(1-d)) is applied by linear interpolation on
    the grid (zero entries are a no-op).
    """
    dtype = jnp.float32
    dt = jnp.asarray(T, dtype) / n_t
    dx = x_grid[1] - x_grid[0]
    s_grid = jnp.exp(x_grid)
    phi = 1.0 if is_call else -1.0
    intrinsic = jnp.maximum(phi * (s_grid - strike), 0.0)

    def diagonals(sig2, theta_dt):
        """(sub, diag, super) of I - theta_dt * L on interior ordering."""
        a = 0.5 * sig2 / dx**2                       # V_xx coefficient
        b = (r - q - 0.5 * sig2) / (2.0 * dx)        # V_x coefficient
        lo = theta_dt * (a - b)                      # sub-diagonal of L
        mid = theta_dt * (-2.0 * a - r)              # diagonal of L
        hi = theta_dt * (a + b)                      # super-diagonal of L
        return -lo, 1.0 - mid, -hi

    def apply_explicit(v, sig2, theta_dt):
        """(I + theta_dt * L) v with one-sided zero-padding (boundaries
        are overwritten by the Dirichlet values afterwards)."""
        a = 0.5 * sig2 / dx**2
        b = (r - q - 0.5 * sig2) / (2.0 * dx)
        v_m = jnp.roll(v, 1)
        v_p = jnp.roll(v, -1)
        lv = (a - b) * v_m + (-2.0 * a - r) * v + (a + b) * v_p
        return v + theta_dt * lv

    def boundaries(tau):
        """Dirichlet values at x_min / x_max from discounted asymptotics."""
        disc_r = jnp.exp(-r * tau)
        disc_q = jnp.exp(-q * tau)
        if is_call:
            return jnp.float32(0.0), s_grid[-1] * disc_q - strike * disc_r
        return strike * disc_r - s_grid[0] * disc_q, jnp.float32(0.0)

    def step(v, inputs):
        k, sig2, dshift = inputs
        # Rannacher: two fully-implicit start-up steps, then CN.
        theta_im = jnp.where(k < 2, 1.0, 0.5) * dt
        theta_ex = dt - theta_im
        rhs = apply_explicit(v, sig2, theta_ex)
        tau = (k + 1.0) * dt                        # time to maturity
        lo_bc, hi_bc = boundaries(tau)
        sub, diag, sup = diagonals(sig2, theta_im)
        # Dirichlet rows: identity on the first/last node.
        diag = diag.at[0].set(1.0).at[-1].set(1.0)
        sub = sub.at[0].set(0.0).at[-1].set(0.0)
        sup = sup.at[0].set(0.0).at[-1].set(0.0)
        rhs = rhs.at[0].set(lo_bc).at[-1].set(hi_bc)
        v_new = tridiagonal_solve(sub, diag, sup, rhs[:, None])[:, 0]
        # Discrete-dividend jump condition (no-op where dshift == 0):
        # crossing the ex-date backwards, V(t⁻, x) = V(t⁺, x + log(1-d)).
        v_new = jnp.where(
            dshift != 0.0,
            jnp.interp(x_grid + dshift, x_grid, v_new), v_new)
        if american:
            # Early-exercise boundary at this time-to-maturity: the edge
            # of the region where continuation < intrinsic (projection
            # binding). Puts exercise below s*, calls above; ±inf encodes
            # "no exercise anywhere" (→ NaN on the host).
            binding = (v_new < intrinsic) & (intrinsic > 0.0)
            if is_call:
                s_star = jnp.min(jnp.where(binding, s_grid, jnp.inf))
            else:
                s_star = jnp.max(jnp.where(binding, s_grid, -jnp.inf))
            v_new = jnp.maximum(v_new, intrinsic)
        else:
            s_star = jnp.float32(jnp.nan)
        return v_new, s_star

    v0 = intrinsic
    v, s_stars = jax.lax.scan(step, v0,
                              (jnp.arange(n_t, dtype=dtype), sig2_grid,
                               div_shift))
    return v, s_stars


class PDEEngine:
    """Crank-Nicolson pricer for European/American vanillas under
    Black-Scholes or a Dupire local-vol surface."""

    def __init__(self, sigma: Optional[float] = None, localvol=None,
                 r: float = RISK_FREE_RATE, q: float = DIVIDEND_YIELD,
                 n_x: int = 401, n_t: int = 256, x_span: float = 4.0):
        """Either a flat `sigma` or a `LocalVolSurface` (engine/localvol)."""
        if (sigma is None) == (localvol is None):
            raise ValueError("pass exactly one of sigma / localvol")
        self.sigma = None if sigma is None else float(sigma)
        self.localvol = localvol
        self.r = float(r if localvol is None else localvol.r)
        self.q = float(q if localvol is None else localvol.q)
        self.n_x = int(n_x)
        self.n_t = int(n_t)
        self.x_span = float(x_span)

    def _grids(self, spot: float, strike: float, T: float):
        # Center the grid between spot and strike; span ±x_span vol-stds.
        sig0 = self.sigma if self.sigma is not None else float(
            np.sqrt(np.median(self.localvol.local_var)))
        center = 0.5 * (np.log(spot) + np.log(strike))
        half = max(self.x_span * sig0 * np.sqrt(max(T, 0.05)), 0.5)
        x = np.linspace(center - half, center + half, self.n_x)
        if self.sigma is not None:
            sig2 = np.full((self.n_t, self.n_x), sig0 ** 2, np.float32)
        else:
            # Dupire rows resampled at step midpoints (step_tables), then
            # interpolated onto this grid's y = x - log F_t coordinate.
            # Backward ordering: scan step k covers calendar time
            # t = T - (k + 1/2) * dt.
            rows, t_mid = self.localvol.step_tables(T, self.n_t)
            lv = self.localvol
            sig2 = np.empty((self.n_t, self.n_x), np.float32)
            for k in range(self.n_t):
                t = float(T - t_mid[k])                 # backward index
                ti = int(np.clip(np.searchsorted(t_mid, t), 0,
                                 self.n_t - 1))
                y = x - (np.log(spot) + (self.r - self.q) * max(t, 1e-4))
                sig2[k] = np.interp(y, lv.y_grid, rows[ti],
                                    left=rows[ti][0], right=rows[ti][-1])
        return (jnp.asarray(x, jnp.float32), jnp.asarray(sig2))

    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True, american: bool = False,
              dividends=None) -> Dict[str, float]:
        """`dividends`: optional [(t_ex, fraction), ...] discrete
        PROPORTIONAL dividends (S drops to S(1-frac) at t_ex); under
        flat vol the European price equals BS at S0·Π(1-frac_i) — the
        classic exact adjustment, used as the test oracle. American
        calls regain early-exercise value just before ex-dates."""
        x, sig2 = self._grids(spot, strike, T)
        div_shift = np.zeros(self.n_t, np.float32)
        if dividends:
            dt = T / self.n_t
            for t_ex, frac in dividends:
                if not 0.0 < t_ex < T:
                    continue
                if not 0.0 <= frac < 1.0:
                    raise ValueError("dividend fraction must be in [0, 1)")
                # backward step k covers calendar (T-(k+1)dt, T-k·dt].
                k = min(int((T - t_ex) / dt), self.n_t - 1)
                div_shift[k] += np.log1p(-frac)
        v, _ = _cn_solve(sig2, jnp.float32(strike), jnp.float32(T),
                         jnp.float32(self.r), jnp.float32(self.q), x,
                         jnp.asarray(div_shift),
                         n_x=self.n_x, n_t=self.n_t, is_call=is_call,
                         american=american)
        v = np.asarray(v, np.float64)
        xg = np.asarray(x, np.float64)
        x0 = np.log(spot)
        price = float(np.interp(x0, xg, v))
        # Spatial Greeks from the grid: dV/dS = (dV/dx)/S etc.
        dvdx = np.gradient(v, xg)
        d2vdx2 = np.gradient(dvdx, xg)
        delta = float(np.interp(x0, xg, dvdx)) / spot
        gamma = (float(np.interp(x0, xg, d2vdx2))
                 - float(np.interp(x0, xg, dvdx))) / spot**2
        return {
            "price": price,
            "delta": delta,
            "gamma": gamma,
            "n_x": self.n_x,
            "n_t": self.n_t,
            "method": "crank-nicolson" + ("-projected" if american else ""),
        }

    def exercise_boundary(self, spot: float, strike: float, T: float,
                          is_call: bool = False,
                          dividends=None) -> Dict:
        """Early-exercise boundary S*(t) of the American contract.

        Extracted inside the same Crank–Nicolson scan that prices the
        option: at each backward step the projection's binding edge (where
        continuation < intrinsic meets intrinsic > 0) is the boundary node
        — no extra solve, no regression noise (the LSM boundary is a noisy
        by-product; the PDE one is the textbook object). Returned in
        calendar time, ascending; NaN where exercise is never optimal at
        that date (e.g. anywhere on a q=0 American call). The boundary
        converges to the strike (puts, q≤r) as t→T.

        Capability absent from the reference (no American support at all).
        """
        x, sig2 = self._grids(spot, strike, T)
        div_shift = np.zeros(self.n_t, np.float32)
        if dividends:
            dt_ = T / self.n_t
            for t_ex, frac in dividends:
                if 0.0 < t_ex < T:
                    k = min(int((T - t_ex) / dt_), self.n_t - 1)
                    div_shift[k] += np.log1p(-frac)
        v, s_stars = _cn_solve(
            sig2, jnp.float32(strike), jnp.float32(T), jnp.float32(self.r),
            jnp.float32(self.q), x, jnp.asarray(div_shift),
            n_x=self.n_x, n_t=self.n_t, is_call=is_call, american=True)
        s_stars = np.asarray(s_stars, np.float64)
        s_stars[~np.isfinite(s_stars)] = np.nan
        # Backward step k sits at time-to-maturity (k+1)·dt ⇒ calendar
        # t = T − (k+1)·dt; reverse into ascending calendar order.
        dt = T / self.n_t
        t_cal = T - (np.arange(self.n_t) + 1.0) * dt
        order = np.argsort(t_cal)
        price = float(np.interp(np.log(spot), np.asarray(x, np.float64),
                                np.asarray(v, np.float64)))
        return {
            "t": t_cal[order].tolist(),
            "s_star": s_stars[order].tolist(),
            "price": price,
            "strike": float(strike),
            "is_call": bool(is_call),
        }


# ─────────────────────────────────────────────────────────────────────────────
# 2-D ADI Heston PDE: the second independent method for the flagship
# stochastic-vol model itself (the CN engine above covers BS / local vol).
# ─────────────────────────────────────────────────────────────────────────────


def _merton_jump_tables(x: np.ndarray, lam: float, mu_j: float,
                        sig_j: float):
    """Host-f64 discretization of the Merton jump operator on a UNIFORM
    log-spot grid, for the Bates PIDE's integral term

        lam * ( ∫ V(x+y) phi(y; mu_J, sig_J) dy  -  V(x) ).

    Cell-mass quadrature: W[i, j] = P(y ∈ cell_j - x_i) — exact Gaussian
    mass per cell, so each row plus its two tail probabilities sums to 1
    EXACTLY (probability is conserved by construction; a constant field
    with matching tail extension is a fixed point). Piecewise-constant-
    in-cell is midpoint-rule O(dx²) for the smooth post-smoothing V. The
    mass landing beyond the grid multiplies the same Dirichlet asymptotes
    the x-edge boundary conditions use, via the analytic partial moments

        p_hi_i = P(y > a_i),          e_hi_i = E[e^y; y > a_i],
        p_lo_i = P(y < b_i),          e_lo_i = E[e^y; y < b_i],

    with a_i / b_i the distance from node i to the grid's outer cell
    faces and E[e^y; y > a] = e^{mu+sig²/2} Phi((mu+sig² − a)/sig).
    Returns f32 device-ready tables (lam, kbar, W, p_hi, p_lo, e_hi,
    e_lo); kbar = E[e^J − 1] is the drift compensator."""
    from scipy.special import ndtr

    if sig_j <= 0.0:
        raise ValueError(
            "sigma_j must be > 0 when lambda_j > 0 for the PIDE grid "
            "(the Merton cell-mass quadrature divides by sigma_j)")

    x = np.asarray(x, np.float64)
    dx = x[1] - x[0]
    kbar = float(np.exp(mu_j + 0.5 * sig_j**2) - 1.0)
    dxx = x[None, :] - x[:, None]                    # y_ij = x_j - x_i
    W = (ndtr((dxx + 0.5 * dx - mu_j) / sig_j)
         - ndtr((dxx - 0.5 * dx - mu_j) / sig_j))    # (n_x, n_x) cell mass
    a_hi = x[-1] + 0.5 * dx - x                      # upper tail starts
    b_lo = x[0] - 0.5 * dx - x                       # lower tail ends
    m1 = np.exp(mu_j + 0.5 * sig_j**2)
    p_hi = ndtr((mu_j - a_hi) / sig_j)
    p_lo = ndtr((b_lo - mu_j) / sig_j)
    e_hi = m1 * ndtr((mu_j + sig_j**2 - a_hi) / sig_j)
    e_lo = m1 * ndtr((b_lo - mu_j - sig_j**2) / sig_j)
    f32 = lambda arr: jnp.asarray(arr, jnp.float32)  # noqa: E731
    return (jnp.float32(lam), jnp.float32(kbar), f32(W), f32(p_hi),
            f32(p_lo), f32(e_hi), f32(e_lo))


@partial(jax.jit, static_argnames=("n_x", "n_v", "n_t", "is_call",
                                   "american", "scheme", "x_lo_bc",
                                   "x_hi_bc", "rebate_at_hit"))
def _adi_heston_solve(strike, T, r, q, kappa, theta, xi, rho,
                      x_grid, v_grid, rebate=0.0, jump=None, *,
                      n_x: int, n_v: int,
                      n_t: int, is_call: bool, american: bool,
                      scheme: str = "cs", x_lo_bc: str = "asym",
                      x_hi_bc: str = "asym", rebate_at_hit: bool = False):
    r"""Backward ADI solve of the 2-D Heston PDE in (x = ln S, v):

        V_t + 1/2 v V_xx + (r - q - v/2) V_x + rho xi v V_xv
            + 1/2 xi^2 v V_vv + kappa(theta - v) V_v - r V = 0,

    or, when `jump` carries the `_merton_jump_tables` pytree, the full
    Bates/SVJ partial integro-differential equation: the x-drift gains the
    compensator −lam·kbar, the reaction gains −lam·V, and the nonlocal
    integral lam·∫V(x+y)phi(y)dy enters as ONE (n_v, n_x)·(n_x, n_x)
    matmul per step — the convolution rides the MXU, which is the
    Device-native reading of the PIDE (vs the reference's MC-only jumps).
    The integral is explicit (IMEX à la In 't Hout-Toivanen); the CS
    corrector sweep includes it, restoring second order in time.

    Operator split (In 't Hout & Foulon 2010): A0 = the mixed derivative
    (always explicit), A1 = the x-direction operator, A2 = the v-direction
    operator, each carrying half of the -rV reaction term. One `lax.scan`
    over time steps; each stage is ONE batched XLA-native
    `tridiagonal_solve` — A1 batches the x-solve over the v rows, A2
    batches the v-solve over the x columns (a transpose pair). Schemes:
    "douglas" (one predictor + two implicit legs) or "cs" (Craig-Sneyd:
    a second corrector sweep restores second-order accuracy in time in the
    presence of the mixed term). The v = 0 edge uses the degenerate PDE
    (drift-only, one-sided V_v — full truncation's PDE analogue); v_max and
    the x edges take the large-|x|/large-v Dirichlet asymptotics. American
    exercise by projection after each full step.

    Barrier variant: `x_lo_bc`/`x_hi_bc` = "barrier" makes that x edge an
    absorbing knock-out boundary sitting EXACTLY on the grid edge — the
    Dirichlet value is the `rebate` (paid at hit: R; at expiry:
    R·e^{-r·tau}) — which prices continuously-monitored KO options under
    full Heston with no Monte Carlo (the cross-check for the bridge-MC
    barrier engine under stochastic vol). American projection skips the
    absorbing edges (the contract is dead there).

    Returns V(t=0) on the (n_v, n_x) grid.
    """
    dtype = jnp.float32
    rebate = jnp.asarray(rebate, dtype)
    dt = jnp.asarray(T, dtype) / n_t
    dx = x_grid[1] - x_grid[0]
    dv = v_grid[1] - v_grid[0]
    s_grid = jnp.exp(x_grid)                       # (n_x,)
    v_col = v_grid[:, None]                        # (n_v, 1)
    phi = 1.0 if is_call else -1.0
    intrinsic = jnp.maximum(phi * (s_grid[None, :] - strike), 0.0)

    # Jump compensator shifts the risk-neutral x-drift: r - q - lam*kbar.
    comp = 0.0 if jump is None else jump[0] * jump[1]

    # A1 (x-direction) diagonals, (n_v, n_x) broadcast from v rows; zero
    # rows at the x edges (Dirichlet). Central differencing throughout:
    # exponential fitting was tried for the heavy-jump compensator-drift
    # regimes (λ=20 → |r−q−comp| ≈ 0.93/yr, cell Péclet > 1 at default
    # grids) and REJECTED — its |b|·dx/2 artificial diffusion rivals v
    # itself on low-variance rows and smears long-dated solves by ~50%
    # of spot; the central scheme's O(dx²) error with the Rannacher
    # start-up damping is strictly better (measured both ways).
    a = 0.5 * v_col / dx**2
    b = (r - q - comp - 0.5 * v_col) / (2.0 * dx)
    x_interior = jnp.ones((n_x,), dtype).at[0].set(0.0).at[-1].set(0.0)
    a1_sub = (a - b) * x_interior[None, :]
    a1_diag = (-2.0 * a - 0.5 * r) * jnp.ones((n_v, n_x), dtype) \
        * x_interior[None, :]
    a1_sup = (a + b) * x_interior[None, :]

    # A2 (v-direction) diagonals, (n_v, n_x) broadcast from v rows; the
    # v = 0 row is the degenerate drift-only PDE with one-sided V_v, the
    # v_max row is zero (Dirichlet).
    c = 0.5 * xi**2 * v_col / dv**2
    e = kappa * (theta - v_col) / (2.0 * dv)
    a2_sub = jnp.broadcast_to(c - e, (n_v, n_x))
    a2_diag = jnp.broadcast_to(-2.0 * c - 0.5 * r, (n_v, n_x))
    a2_sup = jnp.broadcast_to(c + e, (n_v, n_x))
    e0 = kappa * theta / dv                        # forward difference at v=0
    a2_sub = a2_sub.at[0].set(0.0).at[-1].set(0.0)
    a2_diag = a2_diag.at[0].set(-e0 - 0.5 * r).at[-1].set(0.0)
    a2_sup = a2_sup.at[0].set(e0).at[-1].set(0.0)

    # Mixed-term coefficient rho*xi*v / (4 dx dv), interior only.
    v_interior = jnp.ones((n_v,), dtype).at[0].set(0.0).at[-1].set(0.0)
    mix = (rho * xi * v_col / (4.0 * dx * dv)) \
        * v_interior[:, None] * x_interior[None, :]

    def apply_a1(u):
        return (a1_sub * jnp.roll(u, 1, axis=1) + a1_diag * u
                + a1_sup * jnp.roll(u, -1, axis=1))

    def apply_a2(u):
        return (a2_sub * jnp.roll(u, 1, axis=0) + a2_diag * u
                + a2_sup * jnp.roll(u, -1, axis=0))

    def apply_a0(u):
        # V_xv by central differences of the four diagonal neighbours.
        upp = jnp.roll(jnp.roll(u, -1, 0), -1, 1)
        upm = jnp.roll(jnp.roll(u, -1, 0), 1, 1)
        ump = jnp.roll(jnp.roll(u, 1, 0), -1, 1)
        umm = jnp.roll(jnp.roll(u, 1, 0), 1, 1)
        return mix * (upp - upm - ump + umm)

    def jump_tails(tau):
        """(n_x,) value of the jump mass landing beyond the grid: the
        SAME Dirichlet asymptotes `boundaries` uses, integrated against
        the analytic tail moments of the jump law (barrier edges are the
        knock-out value — a jump OVERSHOOTING the barrier kills the
        contract, which the diffusion-only solve cannot express)."""
        _, _, _, p_hi, p_lo, e_hi, e_lo = jump
        disc_r = jnp.exp(-r * tau)
        disc_q = jnp.exp(-q * tau)
        barrier_val = rebate if rebate_at_hit else rebate * disc_r
        if x_hi_bc == "barrier":
            t_hi = barrier_val * p_hi
        elif is_call:
            t_hi = disc_q * s_grid * e_hi - strike * disc_r * p_hi
            if american:
                # The projection lifts the grid to intrinsic; the mass
                # landing beyond the grid must extend the SAME surface —
                # deep-ITM American value ~ max(European asymptote,
                # intrinsic), taken elementwise in expectation (advisor
                # r3: pure European tails understate deep-ITM American).
                t_hi = jnp.maximum(t_hi, s_grid * e_hi - strike * p_hi)
        else:
            t_hi = jnp.zeros((n_x,), dtype)
        if x_lo_bc == "barrier":
            t_lo = barrier_val * p_lo
        elif is_call:
            t_lo = jnp.zeros((n_x,), dtype)
        else:
            t_lo = strike * disc_r * p_lo - disc_q * s_grid * e_lo
            if american:
                t_lo = jnp.maximum(t_lo, strike * p_lo - s_grid * e_lo)
        return t_lo + t_hi

    def apply_jump(u, tails):
        # (Wu)_i = sum_j W[i,j] u_j per v-row: one MXU matmul. The
        # cell-mass quadrature is midpoint-rule O(dx²); applying W to
        # u − δ²u/24 (δ² = the centered second difference) cancels the
        # leading term — measured 1.45e-4 → 5.7e-8 relative error on the
        # e^x eigenfield at dx = 0.59·σ_J — restoring O(dx⁴). Without it
        # the per-application error compounds ~ λT·relerr over the
        # backward solve (the 2.6%-of-spot drift the advisor measured at
        # λ=5, T=30). Edge cells replicate the neighbour's curvature
        # (the analytic tails own the region beyond the grid).
        d2 = jnp.roll(u, -1, 1) - 2.0 * u + jnp.roll(u, 1, 1)
        d2 = d2.at[:, 0].set(d2[:, 1]).at[:, -1].set(d2[:, -2])
        return jump[0] * ((u - d2 / 24.0) @ jump[2].T
                          + tails[None, :] - u)

    def boundaries(tau):
        """(x_lo (n_v,), x_hi (n_v,)) Dirichlet values at the x edges.

        The v_max edge takes homogeneous Neumann (V_v = 0) instead of the
        v->infinity Dirichlet asymptote: the grid tops out at a moderate
        quantile of the variance law (mean + 5 stationary sd), where
        V ~ S e^{-q tau} is grossly wrong but the vega has already
        flattened — the Neumann condition is the accurate one there
        (measured: Dirichlet at this v_max biases an ATM call by ~15%;
        Neumann prices it to ~1e-3 of the COS oracle).
        """
        disc_r = jnp.exp(-r * tau)
        disc_q = jnp.exp(-q * tau)
        if is_call:
            x_lo = jnp.zeros((n_v,), dtype)
            x_hi = jnp.full((n_v,), s_grid[-1] * disc_q - strike * disc_r)
        else:
            x_lo = jnp.full((n_v,), strike * disc_r - s_grid[0] * disc_q)
            x_hi = jnp.zeros((n_v,), dtype)
        barrier_val = jnp.full((n_v,),
                               rebate if rebate_at_hit else rebate * disc_r)
        if x_lo_bc == "barrier":
            x_lo = barrier_val
        if x_hi_bc == "barrier":
            x_hi = barrier_val
        return x_lo, x_hi

    def set_boundaries(u, bc):
        x_lo, x_hi = bc
        u = u.at[:, 0].set(x_lo).at[:, -1].set(x_hi)
        return u.at[-1, :].set(u[-2, :])       # Neumann: V_v = 0 at v_max

    def solve_x(rhs, th_dt, bc):
        """(I - th_dt*A1) y = rhs with x-edge Dirichlet rows."""
        x_lo, x_hi = bc
        rhs = rhs.at[:, 0].set(x_lo).at[:, -1].set(x_hi)
        return tridiagonal_solve(-th_dt * a1_sub, 1.0 - th_dt * a1_diag,
                                 -th_dt * a1_sup, rhs[:, :, None])[:, :, 0]

    def solve_v(rhs, th_dt, bc):
        """(I - th_dt*A2) y = rhs with the Neumann v_max row
        (y[n_v-1] - y[n_v-2] = 0)."""
        rhs = rhs.at[-1, :].set(0.0)
        dl = (-th_dt * a2_sub).at[-1].set(-1.0)
        yt = tridiagonal_solve(
            dl.T, (1.0 - th_dt * a2_diag).T,
            (-th_dt * a2_sup).T, rhs.T[:, :, None])[:, :, 0]
        return yt.T

    def step(u, k):
        tau = (k + 1.0) * dt
        bc = boundaries(tau)
        # Rannacher-style start-up: two fully-implicit steps with the
        # mixed term off (damps the payoff-kink mode the explicit stage
        # would propagate).
        th_dt = jnp.where(k < 2, 1.0, 0.5) * dt
        damp = jnp.where(k < 2, 0.0, 1.0)
        a0_u = damp * apply_a0(u)
        a1_u = apply_a1(u)
        a2_u = apply_a2(u)
        if jump is not None:
            tails = jump_tails(tau)
            aj_u = apply_jump(u, tails)
        else:
            aj_u = jnp.float32(0.0)
        y0 = u + dt * (a0_u + a1_u + a2_u + aj_u)
        y1 = solve_x(y0 - th_dt * a1_u, th_dt, bc)
        y2 = solve_v(y1 - th_dt * a2_u, th_dt, bc)
        if scheme == "cs":
            y0h = y0 + damp * 0.5 * dt * (apply_a0(y2) - a0_u)
            if jump is not None:
                y0h = y0h + 0.5 * dt * (apply_jump(y2, tails) - aj_u)
            y1h = solve_x(y0h - th_dt * a1_u, th_dt, bc)
            y2 = solve_v(y1h - th_dt * a2_u, th_dt, bc)
        u_new = set_boundaries(y2, bc)
        if american:
            # Projection skips absorbing (knock-out) edges: dead there.
            # The binding edge per v-row is the exercise boundary S*(t, v)
            # — the genuinely 2-D object the 1-D CN engine can only proxy
            # (its docstring says so); read it off the projection for free.
            binding = (u_new < intrinsic) & (intrinsic > 0.0) \
                & proj_mask[None, :]
            if is_call:
                s_star = jnp.min(jnp.where(binding, s_grid[None, :],
                                           jnp.inf), axis=1)
            else:
                s_star = jnp.max(jnp.where(binding, s_grid[None, :],
                                           -jnp.inf), axis=1)
            u_new = jnp.where(proj_mask[None, :],
                              jnp.maximum(u_new, intrinsic), u_new)
        else:
            s_star = jnp.full((n_v,), jnp.nan, dtype)
        return u_new, s_star

    proj_mask = jnp.ones((n_x,), bool)
    u0 = jnp.broadcast_to(intrinsic, (n_v, n_x)).astype(dtype)
    if x_lo_bc == "barrier":
        u0 = u0.at[:, 0].set(rebate)
        proj_mask = proj_mask.at[0].set(False)
    if x_hi_bc == "barrier":
        u0 = u0.at[:, -1].set(rebate)
        proj_mask = proj_mask.at[-1].set(False)
    u, s_stars = jax.lax.scan(step, u0, jnp.arange(n_t, dtype=dtype))
    return u, s_stars


class HestonPDEEngine:
    """ADI finite-difference pricer for the 2-D Heston PDE — and, with
    `params.lambda_j > 0`, the full Bates/SVJ PIDE (the flagship model,
    jumps included): the Merton integral term rides one MXU matmul per
    backward step (`_merton_jump_tables`), exactly cross-checkable
    against the COS oracle (`ops/cos_pricer.py:cos_price`, the exact
    Bates CF).

    The framework's THIRD independent numerical route to the flagship
    model (after Monte Carlo and the semi-analytic COS oracle): a
    deterministic (x, v) grid solve with a completely different error
    structure — and the only one of the three that prices *American*
    exercise under stochastic volatility without regression noise (the
    LSM does, with it).
    """

    def __init__(self, params, n_x: int = 201, n_v: int = 101,
                 n_t: int = 128, x_span: float = 4.0,
                 scheme: str = "cs"):
        if scheme not in ("cs", "douglas"):
            raise ValueError("scheme must be 'cs' or 'douglas'")
        self.params = params
        self.n_x = int(n_x)
        self.n_v = int(n_v)
        self.n_t = int(n_t)
        self.x_span = float(x_span)
        self.scheme = scheme
        self.jumps = float(params.lambda_j) != 0.0

    def _jump_tables(self, x):
        if not self.jumps:
            return None
        p = self.params
        return _merton_jump_tables(np.asarray(x, np.float64),
                                   float(p.lambda_j), float(p.mu_j),
                                   float(p.sigma_j))

    def _resolution(self, width: float, T: float):
        """Effective (n_x, n_t) for one solve. Jump regimes need two
        guards the user-facing defaults can't know about (advisor r3 —
        λ=20, T=30 NaN'd; λ=5, T=30 silently drifted 2.6% of spot):

        * the explicit IMEX jump stage is only conditionally stable —
          sub-step until λ·dt ≤ 0.5 (λ·dt ≈ 1 is the stability edge);
        * the cell-mass quadrature must resolve the jump law — refine x
          until dx ≤ 0.75·σ_J (capped at 801 nodes; with the δ²/24
          correction in `apply_jump` the error there is O(dx⁴)).

        Values are rounded up onto a coarse menu (multiples of 32 steps /
        100 nodes) so the jit cache stays small."""
        n_x, n_t = self.n_x, self.n_t
        if self.jumps:
            p = self.params
            need_t = int(np.ceil(2.0 * float(p.lambda_j) * max(T, 0.0)))
            if need_t > n_t:
                n_t = int(32 * np.ceil(need_t / 32.0))
            need_x = int(np.ceil(
                width / max(0.75 * float(p.sigma_j), 1e-6))) + 1
            if need_x > n_x:
                n_x = min(int(100 * np.ceil((need_x - 1) / 100.0)) + 1,
                          801)
        return n_x, n_t

    def _grids(self, spot: float, strike: float, T: float):
        p = self.params
        v_char = max(float(p.v0), float(p.theta))
        # Jumps widen the terminal law: add the jump variance-per-year
        # lam*(mu_J² + sig_J²) to the diffusive v_char (exact second
        # moment of the compound-Poisson log increment); reduces to the
        # old sig0·sqrt(T) half-width at lam = 0.
        jvar = float(p.lambda_j) * (float(p.mu_j)**2 + float(p.sigma_j)**2)
        sig0 = float(np.sqrt(v_char + jvar))
        center = 0.5 * (np.log(spot) + np.log(strike))
        half = max(self.x_span * sig0 * np.sqrt(max(T, 0.05)), 0.5)
        n_x, n_t = self._resolution(2.0 * half, T)
        x = np.linspace(center - half, center + half, n_x)
        # v-range: level + 5 stationary sd OR + 4 transient sd (CIR sd over
        # the horizon ~ xi*sqrt(v*T)), whichever is larger — the stationary
        # formula alone under-covers high-v0 / high-xi corners over short
        # horizons (hypothesis-found: v0=0.25, xi=1 spiked past the grid
        # top and biased the price ~1%). Floor at 2x level.
        sd_stat = float(p.xi) * np.sqrt(
            max(float(p.theta), 1e-6) / (2.0 * max(float(p.kappa), 1e-6)))
        sd_tran = float(p.xi) * np.sqrt(v_char * max(T, 0.05))
        v_max = max(v_char + 5.0 * sd_stat, v_char + 4.0 * sd_tran,
                    2.0 * v_char, 0.05)
        v = np.linspace(0.0, v_max, self.n_v)
        return (jnp.asarray(x, jnp.float32), jnp.asarray(v, jnp.float32),
                n_x, n_t)

    def price(self, spot: float, strike: float, T: float,
              is_call: bool = True, american: bool = False
              ) -> Dict[str, float]:
        p = self.params
        x, v, n_x, n_t = self._grids(spot, strike, T)
        u, _ = _adi_heston_solve(
            jnp.float32(strike), jnp.float32(T), jnp.float32(p.r),
            jnp.float32(p.q), jnp.float32(p.kappa), jnp.float32(p.theta),
            jnp.float32(p.xi), jnp.float32(p.rho), x, v,
            jump=self._jump_tables(x),
            n_x=n_x, n_v=self.n_v, n_t=n_t, is_call=is_call,
            american=american, scheme=self.scheme)
        return self._extract(u, x, v, spot, american, n_t)

    def _extract(self, u, x, v, spot: float,
                 american: bool, n_t: int = None) -> Dict[str, float]:
        """Price + grid Greeks at (ln spot, v0) from a solved (n_v, n_x)
        grid: bilinear price, x-gradient delta/gamma, v-gradient vega
        (the 2-D solve yields dP/dv0 for free — the MC engines need a
        backward AD pass for the same number; conventions match
        engine/greeks.py: vega_per_vol_point = 2σ·dP/dv0)."""
        p = self.params
        u = np.asarray(u, np.float64)
        xg = np.asarray(x, np.float64)
        vg = np.asarray(v, np.float64)
        x0 = float(np.log(spot))
        v0 = float(np.clip(float(p.v0), vg[0], vg[-1]))
        # Bilinear extraction at (x0, v0): interpolate the two bracketing
        # v rows in x, then linearly in v.
        n_v, n_x = u.shape
        j = int(np.clip(np.searchsorted(vg, v0) - 1, 0, n_v - 2))
        w = (v0 - vg[j]) / (vg[j + 1] - vg[j])
        row = (1.0 - w) * u[j] + w * u[j + 1]
        price = float(np.interp(x0, xg, row))
        dvdx = np.gradient(row, xg)
        d2vdx2 = np.gradient(dvdx, xg)
        delta = float(np.interp(x0, xg, dvdx)) / spot
        gamma = (float(np.interp(x0, xg, d2vdx2))
                 - float(np.interp(x0, xg, dvdx))) / spot**2
        lo, hi = max(j - 1, 0), min(j + 3, n_v)
        col = np.array([np.interp(x0, xg, u[jj]) for jj in range(lo, hi)])
        dv_dv0 = float(np.interp(v0, vg[lo:hi],
                                 np.gradient(col, vg[lo:hi])))
        sigma0 = float(np.sqrt(max(float(p.v0), 1e-12)))
        return {
            "price": price,
            "delta": delta,
            "gamma": gamma,
            "ad_vega_v0": dv_dv0,
            "vega_per_vol_point": dv_dv0 * 2.0 * sigma0,
            "n_x": int(n_x),
            "n_v": int(n_v),
            "n_t": int(n_t if n_t is not None else self.n_t),
            "method": f"adi-{self.scheme}"
                      + ("-pide" if self.jumps else "")
                      + ("-projected" if american else ""),
        }

    def price_barrier(self, spot: float, strike: float, T: float,
                      barrier: float, is_call: bool = True,
                      knock: str = "out", direction: str = "up",
                      barrier_lo: float = None, rebate: float = 0.0,
                      rebate_at_hit: bool = False,
                      american: bool = False) -> Dict[str, float]:
        """Continuously-monitored barrier option under full Heston — the
        absorbing edge sits EXACTLY on the grid boundary, so monitoring is
        continuous by construction (no BGK correction, no bridge
        approximation). This is the deterministic cross-check for the
        bridge-MC barrier engine under stochastic vol (`ExoticEngine.
        price_barrier(monitoring="bridge")` with λ=0): under GBM the
        bridge weights are exact and both must match Reiner-Rubinstein;
        under Heston the bridge uses the per-step variance as the bridge
        variance — this grid quantifies that approximation.

        `direction="up"`/"down" single barriers; `barrier_lo` makes it a
        double (corridor) KO with `barrier` as the upper level. Knock-in
        via in-out parity (rebates on KO only). `rebate_at_hit` pays R at
        the hit time (else at expiry).
        """
        p = self.params
        if knock == "in":
            if rebate != 0.0:
                raise ValueError("rebate is supported on knock-out only")
            if american:
                raise ValueError("American knock-in has no in-out parity; "
                                 "price the KO directly")
            vanilla = self.price(spot, strike, T, is_call)
            ko = self.price_barrier(spot, strike, T, barrier, is_call,
                                    "out", direction, barrier_lo)
            return {
                "price": vanilla["price"] - ko["price"],
                "vanilla": vanilla["price"],
                "knock_out": ko["price"],
                "n_x": self.n_x, "n_v": self.n_v, "n_t": self.n_t,
                "method": f"adi-{self.scheme}-parity",
            }
        if knock != "out":
            raise ValueError("knock must be 'out' or 'in'")

        v_char = max(float(p.v0), float(p.theta))
        jvar = float(p.lambda_j) * (float(p.mu_j)**2 + float(p.sigma_j)**2)
        sig0 = float(np.sqrt(v_char + jvar))
        half = max(self.x_span * sig0 * np.sqrt(max(T, 0.05)), 0.5)
        if barrier_lo is not None:
            if not barrier_lo < spot < barrier:
                raise ValueError("spot must sit inside (barrier_lo, "
                                 "barrier)")
            x_min, x_max = np.log(barrier_lo), np.log(barrier)
            lo_bc = hi_bc = "barrier"
        elif direction == "up":
            if not spot < barrier:
                raise ValueError("up-and-out needs spot < barrier")
            x_max = np.log(barrier)
            x_min = min(np.log(spot), np.log(strike)) - half
            lo_bc, hi_bc = "asym", "barrier"
        elif direction == "down":
            if not spot > barrier:
                raise ValueError("down-and-out needs spot > barrier")
            x_min = np.log(barrier)
            x_max = max(np.log(spot), np.log(strike)) + half
            lo_bc, hi_bc = "barrier", "asym"
        else:
            raise ValueError("direction must be 'up' or 'down'")
        n_x, n_t = self._resolution(float(x_max - x_min), T)
        x = jnp.asarray(np.linspace(x_min, x_max, n_x), jnp.float32)
        _, v, _, _ = self._grids(spot, strike, T)
        u, _ = _adi_heston_solve(
            jnp.float32(strike), jnp.float32(T), jnp.float32(p.r),
            jnp.float32(p.q), jnp.float32(p.kappa), jnp.float32(p.theta),
            jnp.float32(p.xi), jnp.float32(p.rho), x, v,
            jnp.float32(rebate), self._jump_tables(x),
            n_x=n_x, n_v=self.n_v, n_t=n_t,
            is_call=is_call, american=american, scheme=self.scheme,
            x_lo_bc=lo_bc, x_hi_bc=hi_bc, rebate_at_hit=rebate_at_hit)
        out = self._extract(u, x, v, spot, american, n_t)
        out["method"] += "-barrier"
        return out

    def exercise_boundary(self, spot: float, strike: float, T: float,
                          is_call: bool = False) -> Dict:
        """Early-exercise boundary SURFACE S*(t, v) of the American
        contract under full Heston — the genuinely two-dimensional object
        the 1-D engines can only proxy at a frozen vol (the /api/american
        with_boundary note says exactly that). Read off the ADI
        projection's binding edge per (backward step, variance row): no
        extra solve. Returned in ascending calendar time with the variance
        grid, plus the v0-row slice (the curve a desk plots). NaN where
        exercise is never optimal at that (t, v) — e.g. everywhere on a
        q=0 call, or at high variance where continuation always wins.
        """
        p = self.params
        x, v, n_x, n_t = self._grids(spot, strike, T)
        _, s_stars = _adi_heston_solve(
            jnp.float32(strike), jnp.float32(T), jnp.float32(p.r),
            jnp.float32(p.q), jnp.float32(p.kappa), jnp.float32(p.theta),
            jnp.float32(p.xi), jnp.float32(p.rho), x, v,
            jump=self._jump_tables(x),
            n_x=n_x, n_v=self.n_v, n_t=n_t, is_call=is_call,
            american=True, scheme=self.scheme)
        s_stars = np.asarray(s_stars, np.float64)        # (n_t, n_v)
        s_stars[~np.isfinite(s_stars)] = np.nan
        dt = T / n_t
        t_cal = T - (np.arange(n_t) + 1.0) * dt          # backward order
        order = np.argsort(t_cal)
        surf = s_stars[order]
        vg = np.asarray(v, np.float64)
        v0 = float(np.clip(float(p.v0), vg[0], vg[-1]))
        j = int(np.clip(np.searchsorted(vg, v0) - 1, 0, self.n_v - 2))
        w = (v0 - vg[j]) / (vg[j + 1] - vg[j])
        slice_v0 = (1.0 - w) * surf[:, j] + w * surf[:, j + 1]
        return {
            "t": t_cal[order].tolist(),
            "v": vg.tolist(),
            "s_star": surf.tolist(),
            "s_star_at_v0": slice_v0.tolist(),
            "strike": float(strike),
            "is_call": bool(is_call),
        }
