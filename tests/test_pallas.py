"""The GPU draws kernel (`ops/draws_kernel.py`) against its scan twin, and
the one function that chooses between them (`ops/backend.py`).

On the CPU the kernel runs in the Pallas interpreter (`interpret=True`),
which executes the same per-tile program, masks included; the scan and the
kernel then agree to the last bit. Tests marked `gpu` compile the kernel for
the card and skip elsewhere; `python chip_smoke.py` runs them on a GPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcos_tpu.models.params import SVJParams, gbm_params
from mcos_tpu.ops import simulate
from mcos_tpu.ops.backend import SVJ_EULER_DRAWS, simulator_for
from mcos_tpu.ops.draws_kernel import svj_terminal_from_draws_kernel

P = SVJParams(kappa=3.0, theta=0.06, xi=0.4, rho=-0.6, v0=0.04,
              lambda_j=1.5, mu_j=-0.05, sigma_j=0.1)


def _draws(steps, paths, seed=0):
    rng = np.random.default_rng(seed)
    z1, z2, zj = (rng.standard_normal((steps, paths)).astype(np.float32)
                  for _ in range(3))
    u = rng.uniform(size=(steps, paths)).astype(np.float32)
    return z1, z2, u, zj


def _assert_same(kernel_out, scan_out, rtol):
    for k, s in zip(kernel_out, scan_out):
        if s is None:
            assert k is None
            continue
        assert k.shape == s.shape
        np.testing.assert_allclose(np.asarray(k), np.asarray(s), rtol=rtol)


def test_ndtri_kernel_accuracy():
    """Acklam inverse-CDF helper vs scipy, f32-arithmetic tolerance."""
    from scipy.special import ndtri as ref

    from mcos_tpu.ops.sobol import ndtri_acklam

    u = np.linspace(1e-5, 1 - 1e-5, 50_001)
    ours = np.asarray(ndtri_acklam(jnp.asarray(u, jnp.float32)), np.float64)
    exact = ref(np.asarray(u, np.float32).astype(np.float64))
    assert np.abs(ours - exact).max() < 5e-4


def test_draws_kernel_matches_scan_exactly():
    """Deterministic given the draws: the interpreted kernel and the scan
    twin run the same f32 operations in the same order, per branch."""
    z1, z2, u, zj = _draws(20, 2048)
    ker = svj_terminal_from_draws_kernel(
        P, 22500.0, 0.5, z1, z2, u, zj, antithetic=True, companion=True,
        tile=256, interpret=True)
    s_b, v_b, g_b = simulate.simulate_terminal_from_draws(
        P, 22500.0, 0.5, z1, z2, u, zj, companion=True, steps_major=True)
    s_a, v_a, g_a = simulate.simulate_terminal_from_draws(
        P, 22500.0, 0.5, -z1, -z2, u, -zj, companion=True, steps_major=True)
    _assert_same(ker, (jnp.stack([s_b, s_a]), jnp.stack([v_b, v_a]),
                       jnp.stack([g_b, g_a])), rtol=1e-6)


# odd step count; ragged last tile; a single partial tile.
_SHAPES = {"odd_steps": (13, 512), "ragged": (8, 700), "one_tile": (6, 100)}


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("companion", [True, False])
@pytest.mark.parametrize("antithetic", [True, False])
def test_draws_kernel_matches_scan_interpret(antithetic, companion, shape):
    steps, paths = _SHAPES[shape]
    draws = _draws(steps, paths, seed=steps + paths)
    ker = svj_terminal_from_draws_kernel(
        P, 100.0, 0.25, *draws, antithetic=antithetic, companion=companion,
        tile=256, interpret=True)
    ref = simulate.simulate_terminal_from_draws_pair(
        P, 100.0, 0.25, *draws, antithetic=antithetic, companion=companion)
    assert ker[0].shape == ((2 if antithetic else 1), paths)
    _assert_same(ker, ref, rtol=1e-6)


@pytest.mark.parametrize("tile", [16, 64, 512])
def test_draws_kernel_tiling_and_tail_mask(tile):
    """Results do not depend on the tile: every path of a ragged last tile
    is simulated from its own column, and nothing past the end is written."""
    draws = _draws(5, 300, seed=3)
    ker = svj_terminal_from_draws_kernel(
        P, 100.0, 0.25, *draws, companion=True, tile=tile, interpret=True)
    ref = simulate.simulate_terminal_from_draws_pair(
        P, 100.0, 0.25, *draws, companion=True)
    _assert_same(ker, ref, rtol=1e-6)
    # A path's result moves with its draws column (no cross-lane mixing).
    perm = np.random.default_rng(1).permutation(300)
    shuffled = svj_terminal_from_draws_kernel(
        P, 100.0, 0.25, *(d[:, perm] for d in draws), companion=True,
        tile=tile, interpret=True)
    np.testing.assert_array_equal(np.asarray(shuffled[0]),
                                  np.asarray(ker[0])[:, perm])


def test_draws_kernel_rejects_non_power_of_two_tile():
    with pytest.raises(ValueError, match="power of two"):
        svj_terminal_from_draws_kernel(P, 100.0, 0.25, *_draws(4, 64),
                                       tile=100, interpret=True)


def test_draws_kernel_without_interpret_raises_off_gpu():
    """No silent fallback: off a GPU the kernel refuses to run unless the
    caller asks for the interpreter."""
    if jax.default_backend() == "gpu":
        pytest.skip("the default backend is a GPU")
    with pytest.raises(RuntimeError, match="interpret=True"):
        svj_terminal_from_draws_kernel(P, 100.0, 0.25, *_draws(4, 64))


@pytest.mark.parametrize("platform,differentiable,want_kernel", [
    ("gpu", False, True),
    ("gpu", True, False),
    ("cpu", False, False),
    ("cpu", True, False),
])
def test_simulator_for(platform, differentiable, want_kernel):
    sim = simulator_for(SVJ_EULER_DRAWS, differentiable=differentiable,
                        platform=platform)
    expected = (svj_terminal_from_draws_kernel if want_kernel
                else simulate.simulate_terminal_from_draws_pair)
    assert sim is expected


def test_simulator_for_default_platform_and_unknown_family():
    expected = (svj_terminal_from_draws_kernel
                if jax.default_backend() == "gpu"
                else simulate.simulate_terminal_from_draws_pair)
    assert simulator_for(SVJ_EULER_DRAWS) is expected
    with pytest.raises(ValueError, match="unknown simulator family"):
        simulator_for("svj_qe_prng")


def test_pricer_kernel_route_matches_scan_route():
    """`mc_price_from_draws` gives the same price whichever simulator it
    is handed (here the kernel through the interpreter)."""
    from mcos_tpu.engine.pricer import mc_price_from_draws

    z1, z2, _, zj = _draws(16, 1000, seed=5)
    kw = dict(seed=3, steps_major=True)
    kernel = functools.partial(svj_terminal_from_draws_kernel, tile=256,
                               interpret=True)
    a = mc_price_from_draws(P, 100.0, jnp.asarray([95.0, 105.0]), 0.25,
                            z1, z2, None, zj, simulator=kernel, **kw)
    b = mc_price_from_draws(P, 100.0, jnp.asarray([95.0, 105.0]), 0.25,
                            z1, z2, None, zj,
                            simulator=simulate.simulate_terminal_from_draws_pair,
                            **kw)
    for key in ("price", "std_error", "v_max"):
        np.testing.assert_allclose(np.asarray(a[key]), np.asarray(b[key]),
                                   rtol=1e-6)


@pytest.mark.gpu
def test_draws_kernel_compiled_matches_scan_on_gpu():
    """The compiled kernel against the scan twin on the card. Same f32
    inputs; XLA and Triton may order and contract (FMA) differently, so the
    bound is a few f32 ulps compounded over the steps."""
    draws = [jnp.asarray(d) for d in _draws(252, 10_000, seed=7)]
    ker = svj_terminal_from_draws_kernel(P, 22500.0, 1.0, *draws,
                                         companion=True)
    ref = simulate.simulate_terminal_from_draws_pair(
        P, 22500.0, 1.0, *draws, companion=True)
    for k, r in zip(ker, ref):
        np.testing.assert_allclose(np.asarray(k), np.asarray(r), rtol=2e-5,
                                   atol=1e-7)


@pytest.mark.gpu
def test_sobol_engine_on_gpu_matches_bs_oracle():
    """The served configuration (Sobol + bridge, draws kernel) against
    Black–Scholes in the degenerate-SVJ limit."""
    from mcos_tpu.engine.pricer import MonteCarloEngine
    from mcos_tpu.ops.bs import bs_price

    p = gbm_params(0.2, r=0.065, q=0.012)
    eng = MonteCarloEngine(p, num_paths=1 << 17, num_steps=252)
    res = eng.price(22500.0, 22500.0, 0.25)
    ref = float(bs_price(22500.0, 22500.0, 0.25, 0.065, 0.012, 0.2, True))
    assert abs(res["price"] - ref) < max(4 * res["std_error"], 1.0)


@pytest.mark.gpu
def test_bridge_product_is_full_precision_on_gpu():
    """bb @ z must not run in TF32: M·Mᵀ = I/n holds to f32 accuracy."""
    from mcos_tpu.ops.sobol import _bridge, brownian_bridge_matrix

    n = 252
    bb = jnp.asarray(brownian_bridge_matrix(n))
    mmt = np.asarray(_bridge(bb, bb.T), np.float64)
    np.testing.assert_allclose(mmt, np.eye(n) / n, atol=2e-6)
