"""mcos_tpu — Monte Carlo option pricing & risk framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the reference
Monte-Carlo-Option-Simulator (NSE/NIFTY SVJ trading-desk engine): SVJ/GBM path
simulation (differentiable lax.scan + a fused GPU kernel), Black-Scholes
analytics, AD Greeks, Sobol+Brownian-bridge QMC, two-stage calibration,
IV-surface/SABR tools, risk/stress/hedging engines, regime detection, pricing
guards, and an HTTP serving layer — path-parallel across device meshes via
shard_map + psum.
"""

__version__ = "0.1.0"

from mcos_tpu.config import (  # noqa: F401
    CALIBRATION_CONFIG,
    DEFAULT_NUM_PATHS,
    DEFAULT_NUM_STEPS,
    DIVIDEND_YIELD,
    PARAM_BOUNDS,
    REGIME_THRESHOLDS,
    RISK_FREE_RATE,
    check_feller,
)
from mcos_tpu.models.params import (  # noqa: F401
    SVJParams,
    TermStructureSVJ,
    forward_price,
    gbm_params,
)
from mcos_tpu.ops.cos_pricer import bates_cf, cos_price, heston_price  # noqa: F401
from mcos_tpu.ops.tdsvj import (  # noqa: F401
    cos_price_td,
    segments_from_term_structure,
    simulate_terminal_td,
)
from mcos_tpu.ops.bs import (  # noqa: F401
    bs_all_greeks,
    bs_delta,
    bs_gamma,
    bs_price,
    bs_rho,
    bs_theta,
    bs_vega,
)
from mcos_tpu.engine.pricer import MonteCarloEngine, mc_price_core  # noqa: F401
from mcos_tpu.engine.american import (  # noqa: F401
    AmericanEngine,
    american_greeks_ad,
    binomial_american_bs,
    dual_upper_bound,
    lsm_lower_bound,
    lsm_train,
)
from mcos_tpu.engine.basket import (  # noqa: F401
    BasketEngine,
    implied_correlation,
)
from mcos_tpu.engine.cliquet import (  # noqa: F401
    CliquetEngine,
    cliquet_bs,
    forward_start_bs,
)
from mcos_tpu.engine.book import BookEngine  # noqa: F401
from mcos_tpu.engine.rough import (  # noqa: F401
    RoughBergomiEngine,
    calibrate_rbergomi,
)
from mcos_tpu.engine.exposure import ExposureEngine  # noqa: F401
from mcos_tpu.engine.ssvi import SSVISurface, calibrate_ssvi  # noqa: F401
from mcos_tpu.engine.hhw import HHWEngine  # noqa: F401
from mcos_tpu.engine.pde import PDEEngine  # noqa: F401
from mcos_tpu.engine.autocallable import (  # noqa: F401
    AutocallableEngine,
    WorstOfAutocallableEngine,
)
from mcos_tpu.engine.quanto import QuantoEngine, quanto_bs  # noqa: F401
from mcos_tpu.engine.pnl import pnl_explain  # noqa: F401
from mcos_tpu.engine.modelrisk import model_risk_report  # noqa: F401
from mcos_tpu.engine.slv import SLVEngine  # noqa: F401
from mcos_tpu.engine.termsvj import (  # noqa: F401
    TDSVJEngine,
    bootstrap_calibrate_td,
)
from mcos_tpu.engine.volderivs import VolDerivsEngine  # noqa: F401
from mcos_tpu.engine.margin import MarginEngine  # noqa: F401
from mcos_tpu.ops.dividends import DividendSchedule  # noqa: F401
from mcos_tpu.ops.curves import RateCurve  # noqa: F401
from mcos_tpu.ops.levy import (  # noqa: F401
    NIGParams,
    VGParams,
    calibrate_nig,
    calibrate_vg,
    levy_price_mc,
    nig_cos_price,
    nig_price_mc,
    nig_terminal,
    vg_cos_price,
    vg_price_mc,
    vg_terminal,
)
from mcos_tpu.ops.hhw import HHWParams, bsm_hullwhite, vasicek_bond  # noqa: F401
from mcos_tpu.ops.rough import RoughBergomiParams  # noqa: F401
from mcos_tpu.engine.exotics import ExoticEngine  # noqa: F401
from mcos_tpu.engine.greeks import GreeksEngine  # noqa: F401
from mcos_tpu.engine.calibration import CalibrationEngine  # noqa: F401
from mcos_tpu.engine.guards import PricingGuard, validate_simulation_output  # noqa: F401
from mcos_tpu.engine.localvol import LocalVolEngine, LocalVolSurface  # noqa: F401
from mcos_tpu.engine.mlmc import mlmc_price  # noqa: F401
from mcos_tpu.engine.regime import MarketRegime, RegimeDetector  # noqa: F401
from mcos_tpu.engine.risk import (  # noqa: F401
    HedgingBacktest,
    LiquidityStress,
    StressTestEngine,
    compute_risk_metrics,
    portfolio_var,
)
from mcos_tpu.engine.surface import (  # noqa: F401
    ArbitrageFreeSpline,
    calibrate_sabr,
    extract_iv_surface,
    implied_vol,
    implied_vol_grid,
    sabr_vol,
)
