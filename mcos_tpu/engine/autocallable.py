"""Autocallable (Express) notes under SVJ dynamics.

Capability beyond the reference (vanilla-only): the flagship retail
structured product. At observation dates t_1..t_m the note redeems early
at notional + accrued coupon if S_{t_i} >= autocall_barrier * S_0; if it
survives to maturity it pays notional + final coupon above the coupon
barrier, notional between the protection barrier and the coupon barrier,
and notional * S_T/S_0 below the protection barrier (the embedded
down-and-in short put).

Device shape: reuses the cliquet engine's periods-scan
(`simulate_period_log_returns` — only the (log S, v) carry crosses period
boundaries, one period return emitted per reset) and reduces the
(m, branches, paths) return cube with a vectorized first-crossing
argmax — no per-path Python, no early-exit control flow.

Oracles (host f64, GBM limit): with the autocall barrier unreachable the
note is a European digital structure with closed form from cash-or-nothing
and asset-or-nothing pieces (`no_call_note_bs`); with full principal
protection and guaranteed coupon it collapses to a zero-coupon bond plus
the digital coupon leg. Both are test-pinned; the autocall flow itself is
pinned by probability accounting (call probs + survival sum to 1) and
monotonicity in the barriers.
"""

from __future__ import annotations

from typing import Dict, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from scipy.stats import norm

from mcos_tpu.config import DEFAULT_NUM_PATHS
from mcos_tpu.engine.cliquet import simulate_period_log_returns
from mcos_tpu.models.params import SVJParams

Array = jax.Array


def no_call_note_bs(T: float, r: float, q: float, sigma: float,
                    coupon_barrier: float, protection_barrier: float,
                    final_coupon: float, notional: float = 1.0) -> float:
    """GBM closed form for the never-called terminal structure.

    Payoff on the gross return R = S_T/S_0:
        R >= cb:  1 + c
        pb <= R < cb:  1
        R < pb:  R
    Priced from digitals: P(R >= x) = Phi(d2(x)) and the partial
    expectation E[R 1{R < x}] = e^{(r-q)T} Phi(-d1(x)).
    """
    st = sigma * np.sqrt(T)
    mu = (r - q - 0.5 * sigma**2) * T

    def d2(x):
        return (mu - np.log(x)) / st

    def d1(x):
        return d2(x) + st

    p_above_cb = norm.cdf(d2(coupon_barrier))
    p_above_pb = norm.cdf(d2(protection_barrier))
    e_r_below_pb = np.exp((r - q) * T) * norm.cdf(-d1(protection_barrier))
    value = ((1.0 + final_coupon) * p_above_cb
             + (p_above_pb - p_above_cb)
             + e_r_below_pb)
    return float(notional * np.exp(-r * T) * value)


class AutocallableEngine:
    """Express/Phoenix note pricing with early-redemption accounting."""

    def __init__(self, params: SVJParams, num_paths: int = DEFAULT_NUM_PATHS,
                 steps_per_period: int = 16, seed: int = 42):
        self.params = params
        self.num_paths = int(num_paths)
        self.steps_per_period = int(steps_per_period)
        self.seed = int(seed)

    def price(self, T: float, n_obs: int = 4,
              autocall_barrier: float = 1.0,
              coupon_barrier: float = 0.8,
              protection_barrier: float = 0.7,
              coupon: float = 0.02,
              final_coupon: float = None,
              notional: float = 1.0) -> Dict[str, object]:
        """Price the note; barriers are fractions of S_0, `coupon` accrues
        per observation period (paid on call: i-th call pays 1 + i*c).

        `final_coupon` defaults to n_obs * coupon (full accrual at
        maturity above the coupon barrier).
        """
        p = self.params
        if final_coupon is None:
            final_coupon = n_obs * coupon
        dlog_s, _ = simulate_period_log_returns(
            p, T, jax.random.key(self.seed), num_paths=self.num_paths,
            n_periods=n_obs, steps_per_period=self.steps_per_period,
            companion=False)
        # Gross return level at each observation date: (m, 2, paths).
        ratio = jnp.exp(jnp.cumsum(dlog_s, axis=0))
        return _note_value(ratio, T, float(p.r), n_obs, autocall_barrier,
                           coupon_barrier, protection_barrier, coupon,
                           final_coupon, notional, self.num_paths)



    def solve_par_coupon(self, T: float, target: float = 1.0,
                         **terms) -> Dict[str, object]:
        """Coupon that prices the note at `target` (default par) — exact
        from two CRN evaluations (`_solve_par_coupon`); `terms` are the
        `price` kwargs except `coupon`."""
        terms.pop("coupon", None)
        return _solve_par_coupon(
            lambda c: self.price(T, coupon=c, **terms), target)


def _note_path_values(ratio: Array, T, r, n_obs, autocall_barrier,
                      coupon_barrier, protection_barrier, coupon,
                      final_coupon, notional):
    """(paths,) per-path discounted note values from (m, branches, paths)
    driving performance levels, antithetic branches collapsed; second
    return is (ever_called, first_index, r_T, dts) for the redemption
    accounting. ONE shared function: `_note_value` (single device) and
    `parallel/families.py:_worstof_note_payoffs` (mesh-sharded) both
    consume it — never fork the payoff algebra."""
    called = ratio >= autocall_barrier                 # (m, 2, paths)
    ever = jnp.any(called, axis=0)
    # First crossing index (argmax finds the first True).
    first = jnp.argmax(called, axis=0)                 # (2, paths)

    dts = T / n_obs * jnp.arange(1, n_obs + 1, dtype=jnp.float32)
    df = jnp.exp(-jnp.asarray(r, jnp.float32) * dts)   # (m,)
    call_pay = df * (1.0 + coupon * jnp.arange(1, n_obs + 1,
                                               dtype=jnp.float32))
    pay_called = call_pay[first]                       # (2, paths)

    r_T = ratio[-1]
    pay_final = jnp.where(
        r_T >= coupon_barrier, 1.0 + final_coupon,
        jnp.where(r_T >= protection_barrier, 1.0, r_T)) * df[-1]
    pay = jnp.where(ever, pay_called, pay_final)
    pay = notional * jnp.mean(pay, axis=0)             # antithetic
    return pay, (ever, first, r_T, dts)


def _note_value(ratio: Array, T, r, n_obs, autocall_barrier,
                coupon_barrier, protection_barrier, coupon, final_coupon,
                notional, num_paths) -> Dict[str, object]:
    """Reduce (m, branches, paths) driving performance levels to the note
    value + redemption accounting (shared by single-asset and worst-of)."""
    pay, (ever, first, r_T, dts) = _note_path_values(
        ratio, T, r, n_obs, autocall_barrier, coupon_barrier,
        protection_barrier, coupon, final_coupon, notional)

    mean = float(jnp.mean(pay))
    se = float(jnp.std(pay)) / np.sqrt(pay.shape[0])
    # Redemption accounting: P(call at t_i), P(survive), P(loss).
    oh = jax.nn.one_hot(first, n_obs) * ever[..., None]  # (2, paths, m)
    first_call = jnp.mean(oh, axis=(0, 1))               # (m,)
    p_loss = float(jnp.mean(
        (~ever & (r_T < protection_barrier)).astype(jnp.float32)))
    return {
        "price": mean,
        "std_error": se,
        "call_prob_by_date": np.asarray(first_call, np.float64).tolist(),
        "survival_prob": float(1.0 - np.asarray(first_call,
                                                np.float64).sum()),
        "loss_prob": p_loss,
        "expected_life": float(
            jnp.sum(first_call * dts) + (1.0 - first_call.sum()) * T),
        "n_obs": n_obs,
        "num_paths_used": num_paths,
    }


def _solve_par_coupon(price_fn, target: float = 1.0) -> Dict[str, object]:
    """The issuance question: which coupon prices the note at par?

    On a FIXED path set the note value is exactly linear in the coupon
    (every coupon cashflow scales with c, everything else is constant),
    so two CRN evaluations solve it in closed form — no iteration.
    """
    p0 = price_fn(0.0)
    p1 = price_fn(0.10)
    slope = (p1["price"] - p0["price"]) / 0.10
    if slope <= 1e-9:
        raise ValueError("note value does not increase in the coupon "
                         "(no feasible par coupon)")
    coupon = (target - p0["price"]) / slope
    check = price_fn(coupon)
    return {
        "par_coupon": float(coupon),
        "price_at_par_coupon": check["price"],
        "std_error": check["std_error"],
        "coupon_sensitivity": float(slope),
        **{k: check[k] for k in ("call_prob_by_date", "survival_prob",
                                 "loss_prob", "expected_life")},
    }


class WorstOfAutocallableEngine:
    """Worst-of autocallable on a correlated multi-asset SVJ basket —
    the product as actually issued: trigger, coupon, and capital-at-risk
    legs all read the WORST performer min_i S_i(t)/S_i(0)."""

    def __init__(self, params_list: Sequence[SVJParams], corr,
                 num_paths: int = DEFAULT_NUM_PATHS,
                 steps_per_period: int = 16, seed: int = 42, mesh=None):
        # None honors MCOS_AUTO_MESH=1; "auto"/Mesh routes price() through
        # parallel/families.py:sharded_worstof_autocall (same payoff
        # algebra via the shared _note_path_values).
        self.mesh = mesh
        self.params_batch = jax.tree.map(
            lambda *xs: jnp.stack([jnp.asarray(x, jnp.float32)
                                   for x in xs]), *list(params_list))
        self.n_assets = len(params_list)
        corr = np.asarray(corr, np.float64)
        if corr.shape != (self.n_assets, self.n_assets):
            raise ValueError("corr must be (A, A)")
        # PSD-singular correlations (rho=1 blocks, the degenerate test
        # oracle) factor with escalating diagonal jitter, as BasketEngine.
        for jitter in (0.0, 1e-10, 1e-8, 1e-6):
            try:
                chol = np.linalg.cholesky(
                    corr + jitter * np.eye(self.n_assets))
                break
            except np.linalg.LinAlgError:
                continue
        else:
            raise ValueError("correlation matrix is not PSD")
        self.corr_chol = jnp.asarray(chol, jnp.float32)
        # One payoff currency ⇒ one discount rate: reject mixed r inputs
        # rather than silently discounting at asset 0's rate.
        rates = {float(np.asarray(p.r)) for p in params_list}
        if len(rates) > 1:
            raise ValueError("all basket assets must share the discount "
                             f"rate r; got {sorted(rates)}")
        self.r = rates.pop()
        self.num_paths = int(num_paths)
        self.steps_per_period = int(steps_per_period)
        self.seed = int(seed)

    def price(self, T: float, n_obs: int = 4,
              autocall_barrier: float = 1.0,
              coupon_barrier: float = 0.8,
              protection_barrier: float = 0.7,
              coupon: float = 0.02,
              final_coupon: float = None,
              notional: float = 1.0) -> Dict[str, object]:
        from mcos_tpu.engine.basket import simulate_basket_observations
        from mcos_tpu.engine.pricer import resolve_mesh

        if final_coupon is None:
            final_coupon = n_obs * coupon
        mesh = resolve_mesh(self.mesh)
        if mesh is not None:
            from mcos_tpu.parallel.families import sharded_worstof_autocall

            res = jax.device_get(sharded_worstof_autocall(
                self, T, jax.random.key(self.seed), mesh=mesh,
                n_obs=n_obs, autocall_barrier=autocall_barrier,
                coupon_barrier=coupon_barrier,
                protection_barrier=protection_barrier, coupon=coupon,
                final_coupon=final_coupon, notional=notional))
            res["price"] = float(res["price"])
            res["std_error"] = float(res["std_error"])
            res["num_paths_used"] = int(np.asarray(res["num_paths_used"]))
            return res
        levels = simulate_basket_observations(
            self.params_batch, jnp.ones((self.n_assets,), jnp.float32),
            self.corr_chol, T, jax.random.key(self.seed),
            num_paths=self.num_paths, n_obs=n_obs,
            steps_per_period=self.steps_per_period)
        worst = jnp.min(levels, axis=2)        # (m, 2, paths)
        out = _note_value(worst, T, self.r, n_obs, autocall_barrier,
                          coupon_barrier, protection_barrier, coupon,
                          final_coupon, notional, self.num_paths)
        out["n_assets"] = self.n_assets
        return out

    def solve_par_coupon(self, T: float, target: float = 1.0,
                         **terms) -> dict:
        """Worst-of par coupon — exact from two CRN evaluations."""
        terms.pop("coupon", None)
        return _solve_par_coupon(
            lambda c: self.price(T, coupon=c, **terms), target)
