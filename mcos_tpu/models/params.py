"""Model parameter pytrees.

Re-design of the reference's parameter substrate
(reference: engine/models.py:20-194). Key difference: `SVJParams` is a JAX
*pytree* — every field is a traced leaf, so the whole parameter set can be
vmapped (batched calibration restarts), differentiated (exact Greeks wrt any
model parameter via `jax.grad`), and donated through `jit` without host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from mcos_tpu.config import (
    DIVIDEND_YIELD,
    MAX_VARIANCE,
    RISK_FREE_RATE,
    check_feller,
)

Array = jax.Array

# Field order used by to_array/from_array (optimizer layout;
# mirrors reference engine/models.py:55-69).
_ARRAY_FIELDS = ("kappa", "theta", "xi", "rho", "v0", "lambda_j", "mu_j", "sigma_j")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SVJParams:
    """SVJ (Heston + Merton lognormal jumps) parameters — single maturity slice.

    Dynamics (reference engine/models.py:25-28):
        dS = (r - q - λk) S dt + √v S dW₁ + S (e^J - 1) dN
        dv = κ(θ - v) dt + ξ √v dW₂,   dW₁·dW₂ = ρ dt
        J ~ N(μ_J, σ_J²),  k = E[e^J - 1]

    All fields are pytree leaves (python floats or 0-d jax arrays). When a field
    holds a traced array, properties like `jump_compensation` return traced
    arrays too, so the object composes with jit/grad/vmap.
    """

    # Heston core
    kappa: float = 3.0        # mean-reversion speed
    theta: float = 0.04       # long-run variance
    xi: float = 0.5           # vol-of-vol
    rho: float = -0.7         # spot-vol correlation
    v0: float = 0.04          # initial variance

    # Jump component
    lambda_j: float = 1.0     # jump intensity (events/year)
    mu_j: float = -0.05       # mean log jump size
    sigma_j: float = 0.10     # jump size std

    # Market
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD

    @property
    def jump_compensation(self):
        """k = E[e^J - 1] used to compensate the drift (engine/models.py:46-49)."""
        return jnp.exp(self.mu_j + 0.5 * self.sigma_j**2) - 1.0

    @property
    def feller_satisfied(self) -> bool:
        """Feller condition 2κθ > ξ² (host-side check; engine/models.py:51-53)."""
        return check_feller(float(self.kappa), float(self.theta), float(self.xi))

    def to_array(self) -> Array:
        """Flatten to the 8-element optimizer layout (engine/models.py:55-60)."""
        return jnp.stack(
            [jnp.asarray(getattr(self, f), jnp.float32) for f in _ARRAY_FIELDS]
        )

    @classmethod
    def from_array(cls, arr, r: float = RISK_FREE_RATE,
                   q: float = DIVIDEND_YIELD) -> "SVJParams":
        """Rebuild from the optimizer layout (engine/models.py:62-69)."""
        kwargs = {f: arr[i] for i, f in enumerate(_ARRAY_FIELDS)}
        return cls(r=r, q=q, **kwargs)

    def replace(self, **updates) -> "SVJParams":
        """Functional update (pytree-friendly analogue of dataclasses.replace)."""
        return dataclasses.replace(self, **updates)

    def validate(self) -> List[str]:
        """Host-side validation warnings (engine/models.py:71-85)."""
        warnings = []
        kappa, theta, xi = float(self.kappa), float(self.theta), float(self.xi)
        if not check_feller(kappa, theta, xi):
            warnings.append(
                f"Feller violated: 2κθ={2 * kappa * theta:.4f} ≤ ξ²={xi**2:.4f}"
            )
        if abs(float(self.rho)) > 0.999:
            warnings.append(f"|ρ|={abs(float(self.rho)):.4f} exceeds 0.999")
        if float(self.v0) > MAX_VARIANCE:
            warnings.append(f"v0={float(self.v0):.4f} exceeds MAX_VARIANCE={MAX_VARIANCE}")
        if float(self.theta) > MAX_VARIANCE:
            warnings.append(f"θ={float(self.theta):.4f} exceeds MAX_VARIANCE={MAX_VARIANCE}")
        return warnings

    def as_dict(self) -> Dict[str, float]:
        """Plain-float dict (for JSON serialization in the API layer)."""
        return {f.name: float(getattr(self, f.name))
                for f in dataclasses.fields(self)}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SVCJParams:
    """SVCJ (Duffie-Pan-Singleton 2000): contemporaneous jumps in price AND
    variance, correlated through the variance jump size.

    Dynamics (extends the SVJ dynamics the reference models at
    engine/models.py:25-28 — the reference has no variance jumps at all):
        dS/S = (r − q − λ k̄) dt + √v dW₁ + (e^{Z_s} − 1) dN
        dv   = κ(θ − v) dt + ξ √v dW₂ + Z_v dN
        Z_v ~ Exp(μ_v),  Z_s | Z_v ~ N(μ_j + ρ_J Z_v, σ_j²)
        k̄ = E[e^{Z_s}] − 1 = e^{μ_j + σ_j²/2} / (1 − ρ_J μ_v) − 1

    One Poisson clock drives both jumps: a crash event simultaneously gaps
    the spot down and kicks variance up — the co-movement pure-SVJ cannot
    produce (it must inflate ξ instead). Requires ρ_J μ_v < 1 for the
    compensator to exist. All fields are pytree leaves (jit/grad/vmap-able,
    same design as SVJParams).
    """

    kappa: float = 3.0
    theta: float = 0.04
    xi: float = 0.5
    rho: float = -0.7
    v0: float = 0.04
    lambda_j: float = 1.0
    mu_j: float = -0.05
    sigma_j: float = 0.10
    mu_v: float = 0.05        # mean variance jump  E[Z_v]
    rho_j: float = -0.5       # jump-size correlation loading  (Z_s on Z_v)
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD

    @property
    def jump_compensation(self):
        """k̄ = E[e^{Z_s} − 1]; the ρ_J μ_v tilt is the SVCJ correction."""
        return (jnp.exp(self.mu_j + 0.5 * self.sigma_j**2)
                / (1.0 - self.rho_j * self.mu_v) - 1.0)

    @property
    def stationary_variance(self):
        """E[v_∞] = θ + λ μ_v / κ — variance jumps raise the long-run mean."""
        return self.theta + self.lambda_j * self.mu_v / self.kappa

    def svj_part(self) -> SVJParams:
        """The μ_v → 0 projection (drops variance jumps; Bates limit)."""
        return SVJParams(kappa=self.kappa, theta=self.theta, xi=self.xi,
                         rho=self.rho, v0=self.v0, lambda_j=self.lambda_j,
                         mu_j=self.mu_j, sigma_j=self.sigma_j,
                         r=self.r, q=self.q)

    def replace(self, **updates) -> "SVCJParams":
        return dataclasses.replace(self, **updates)

    def validate(self) -> List[str]:
        warnings = self.svj_part().validate()
        if float(self.rho_j) * float(self.mu_v) >= 1.0:
            warnings.append(
                f"ρ_J·μ_v={float(self.rho_j) * float(self.mu_v):.3f} ≥ 1: "
                "jump compensator diverges")
        if float(self.mu_v) < 0.0:
            warnings.append(f"μ_v={float(self.mu_v):.4f} < 0: variance jump "
                            "mean must be non-negative")
        return warnings

    def as_dict(self) -> Dict[str, float]:
        return {f.name: float(getattr(self, f.name))
                for f in dataclasses.fields(self)}


def gbm_params(sigma: float, r: float = RISK_FREE_RATE,
               q: float = DIVIDEND_YIELD) -> SVJParams:
    """Degenerate SVJ that reduces exactly to GBM with volatility `sigma`.

    Sets v0 = θ = σ², ξ = 0, λ = 0 so the variance process is constant and the
    jump term vanishes — the degenerate-parameter oracle the reference's smoke
    test relies on (verify.py:29-30 uses ξ=1e-4, λ=0; we can use ξ=0 exactly).
    """
    var = sigma * sigma
    return SVJParams(kappa=0.0, theta=var, xi=0.0, rho=0.0, v0=var,
                     lambda_j=0.0, mu_j=0.0, sigma_j=0.0, r=r, q=q)


@dataclasses.dataclass
class TermStructureSVJ:
    """Maturity-dependent SVJ parameters θ(T), ξ(T), λ(T) with fixed κ, ρ, μ_J, σ_J.

    Host-side container (reference engine/models.py:88-144): curves are
    piecewise-linear in T; `get_params_at_maturity` materializes a per-maturity
    `SVJParams` pytree for the pricing kernels.
    """

    kappa: float = 3.0
    rho: float = -0.7
    mu_j: float = -0.05
    sigma_j: float = 0.10
    v0: float = 0.04
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD

    theta_curve: Dict[float, float] = dataclasses.field(default_factory=dict)
    xi_curve: Dict[float, float] = dataclasses.field(default_factory=dict)
    lambda_curve: Dict[float, float] = dataclasses.field(default_factory=dict)

    def get_params_at_maturity(self, T: float) -> SVJParams:
        theta = self._interp(self.theta_curve, T, default=0.04)
        xi = self._interp(self.xi_curve, T, default=0.5)
        lambda_j = self._interp(self.lambda_curve, T, default=1.0)
        return SVJParams(
            kappa=self.kappa, theta=theta, xi=xi, rho=self.rho, v0=self.v0,
            lambda_j=lambda_j, mu_j=self.mu_j, sigma_j=self.sigma_j,
            r=self.r, q=self.q,
        )

    @staticmethod
    def _interp(curve: Dict[float, float], T: float, default: float) -> float:
        """Piecewise-linear interpolation with flat extrapolation
        (engine/models.py:126-144)."""
        if not curve:
            return default
        mats = sorted(curve.keys())
        vals = [curve[m] for m in mats]
        if T <= mats[0]:
            return vals[0]
        if T >= mats[-1]:
            return vals[-1]
        idx = int(np.searchsorted(mats, T) - 1)
        w = (T - mats[idx]) / (mats[idx + 1] - mats[idx])
        return vals[idx] * (1 - w) + vals[idx + 1] * w


def forward_price(spot, r, q, T):
    """Forward price F = S₀·e^{(r−q)T} (engine/models.py:147-149). Traceable."""
    return spot * jnp.exp((r - q) * T)


def extract_forward_variance(atm_iv: float, T_shortest: float) -> float:
    """v₀ ≈ σ²_ATM(T_min) — surface-consistent initial variance
    (engine/models.py:152-158)."""
    del T_shortest  # kept for signature parity; heuristic only uses the IV
    return atm_iv**2


def build_term_structure_from_surface(
    maturities: np.ndarray,
    atm_ivs: np.ndarray,
    skew_slopes: np.ndarray,
    base_params: SVJParams,
) -> TermStructureSVJ:
    """Bootstrap a term structure from observed surface data using the
    reference's heuristics (engine/models.py:161-194):
      θ(T) = ATM_IV(T)², ξ(T) = ξ·min(3, 1/√T), λ(T) = λ·max(1, |skew|/0.03).
    """
    ts = TermStructureSVJ(
        kappa=float(base_params.kappa), rho=float(base_params.rho),
        mu_j=float(base_params.mu_j), sigma_j=float(base_params.sigma_j),
        v0=extract_forward_variance(float(atm_ivs[0]), float(maturities[0])),
        r=float(base_params.r), q=float(base_params.q),
    )
    for i, T in enumerate(maturities):
        ts.theta_curve[float(T)] = float(atm_ivs[i] ** 2)
        xi_scale = min(3.0, 1.0 / np.sqrt(max(float(T), 1 / 252)))
        ts.xi_curve[float(T)] = float(base_params.xi) * xi_scale
        skew_scale = max(1.0, abs(float(skew_slopes[i])) / 0.03)
        ts.lambda_curve[float(T)] = float(base_params.lambda_j) * skew_scale
    return ts
