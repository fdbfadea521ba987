"""Scrambled Sobol QMC + Brownian-bridge construction, device-resident.

Re-design of the reference's QMC pipeline
(reference: engine/monte_carlo.py:61-183).

Differences from the reference — all deliberate:

- **Points are generated on device.** The reference materializes Sobol
  uniforms on the host with scipy (monte_carlo.py:78-79). Here only the Sobol
  *direction numbers* (dims × 30 uint32, a few KB) come from scipy's tables;
  the gray-code XOR expansion, digital-shift scrambling, uniform conversion and
  inverse-CDF all run inside one jit on the device.
- **Hash-based Owen scrambling** (Burley, JCGT 2020: bit-reverse →
  Laine-Karras multiply-xor permutation → bit-reverse) replaces scipy's
  sequential Owen tree walk: statistically equivalent nested-uniform
  scrambling, O(1) per point, fully vectorized. A cheaper
  digital-shift mode (scramble="shift") is kept for studies.
- **The Brownian bridge is a precomputed matrix**, so path construction is a
  single (paths × steps) @ (steps × steps) matmul instead of the
  reference's per-dimension Python loop (monte_carlo.py:115-145).
- **Bug fixed:** the reference's endpoint search (`_find_bridge_endpoints`,
  monte_carlo.py:172-183) initializes the right bracket at the terminal index
  with W(T) treated as a known zero, which gives the first placed point —
  the terminal point itself — *zero* conditional variance. Its "Brownian
  motion" is therefore a bridge pinned to W(T)=0 (total terminal variance 0),
  silently masked by the BS control variate. Here the first Sobol dimension
  drives W(T) = √T·Z₀ as the construction requires.

As in the reference, path counts are rounded up to the next power of two for
sampling balance and truncated back (monte_carlo.py:74-85).
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

_SOBOL_BITS = 30  # scipy's qmc.Sobol uses 30-bit integers
_U32_SCALE = np.float32(2.0 ** -_SOBOL_BITS)
_CLIP = 1e-7  # f32-safe tail clip before ndtri (reference clips 1e-10 in f64)


@functools.lru_cache(maxsize=32)
def sobol_direction_numbers(dims: int) -> np.ndarray:
    """Joe-Kuo direction numbers, shape (dims, 30) uint32, from scipy's table."""
    from scipy.stats import qmc

    return np.array(qmc.Sobol(d=dims, scramble=False)._sv[:, :_SOBOL_BITS],
                    dtype=np.uint32)


# ─────────────────────────────────────────────────────────────────────────────
# Brownian-bridge construction matrix
# ─────────────────────────────────────────────────────────────────────────────
def bb_ordering(num_steps: int) -> np.ndarray:
    """Bisection order of time points for the bridge.

    Returns indices into the *cumulative* grid 1..num_steps (1-based point k is
    time k·dt). order[0] is the terminal point; subsequent entries bisect the
    intervals breadth-first so low Sobol dimensions carry coarse structure.
    """
    order = [num_steps]
    queue = [(0, num_steps)]
    while queue:
        lo, hi = queue.pop(0)
        if hi - lo <= 1:
            continue
        mid = (lo + hi) // 2
        order.append(mid)
        queue.append((lo, mid))
        queue.append((mid, hi))
    return np.asarray(order, np.int64)


@functools.lru_cache(maxsize=64)
def brownian_bridge_matrix(num_steps: int) -> np.ndarray:
    """Matrix M with dW = Z @ Mᵀ for unit-horizon Brownian increments.

    Z holds iid standard normals in bridge-construction order (Sobol dim k
    drives the k-th placed point); dW are the `num_steps` increments of a
    standard Brownian motion on [0, 1]. Scale by √T for horizon T.

    Built in float64 on the host once per step count (cached), cast to f32.
    """
    n = num_steps
    order = bb_ordering(n)
    # a[k] = coefficient vector of cumulative point k (0..n) over the Z dims.
    a = np.zeros((n + 1, n), dtype=np.float64)
    t = np.linspace(0.0, 1.0, n + 1)
    placed = [0]  # cumulative index 0 is pinned at W=0
    for dim, k in enumerate(order):
        left = max(p for p in placed if p < k)
        right_candidates = [p for p in placed if p > k]
        if right_candidates:
            right = min(right_candidates)
            w = (t[k] - t[left]) / (t[right] - t[left])
            var = (t[k] - t[left]) * (t[right] - t[k]) / (t[right] - t[left])
            a[k] = (1.0 - w) * a[left] + w * a[right]
        else:
            # Unconditioned segment end (the terminal point): W_k = W_left + √Δt·Z.
            var = t[k] - t[left]
            a[k] = a[left]
        a[k, dim] += np.sqrt(var)
        placed.append(k)
    # Increments: dW_i = W_{i+1} − W_i.
    m = a[1:] - a[:-1]
    return np.ascontiguousarray(m, dtype=np.float32)


def _bridge(bb: Array, z: Array) -> Array:
    """Bridge product bb @ z at full f32 precision.

    A float32 matmul may otherwise run in TF32 (about three decimal digits)
    on a GPU, which would break the bridge's exactness (M·Mᵀ = dt·I).
    """
    return jnp.matmul(bb, z, precision=jax.lax.Precision.HIGHEST)


# Acklam's rational approximation of the inverse normal CDF (relative error
# < 1.2e-9 — far below f32 resolution). Horner-form polynomials over a
# branchless central/tail select: 1 log + 1 sqrt + 2 rational evals per draw.
_ACK_A = (-3.969683028665376e+01, 2.209460984245205e+02,
          -2.759285104469687e+02, 1.383577518672690e+02,
          -3.066479806614716e+01, 2.506628277459239e+00)
_ACK_B = (-5.447609879822406e+01, 1.615858368580409e+02,
          -1.556989798598866e+02, 6.680131188771972e+01,
          -1.328068155288572e+01)
_ACK_C = (-7.784894002430293e-03, -3.223964580411365e-01,
          -2.400758277161838e+00, -2.549732539343734e+00,
          4.374664141464968e+00, 2.938163982698783e+00)
_ACK_D = (7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00)
_ACK_PLOW = 0.02425


def _horner(x: Array, coeffs) -> Array:
    acc = jnp.float32(coeffs[0])
    for c in coeffs[1:]:
        acc = acc * x + jnp.float32(c)
    return acc


def ndtri_acklam(u: Array) -> Array:
    """Inverse normal CDF for u strictly inside (0, 1) (see _ACK_* above)."""
    # Central region |u - 0.5| ≤ 0.5 - plow.
    qc = u - 0.5
    r = qc * qc
    x_central = _horner(r, _ACK_A) * qc / (_horner(r, _ACK_B) * r + 1.0)
    # Tails, symmetric via pm = min(u, 1-u); magnitude is the lower-tail value.
    pm = jnp.minimum(u, 1.0 - u)
    qt = jnp.sqrt(-2.0 * jnp.log(pm))
    x_tail = _horner(qt, _ACK_C) / (_horner(qt, _ACK_D) * qt + 1.0)
    x_tail = jnp.where(qc < 0.0, x_tail, -x_tail)
    central = jnp.abs(qc) <= jnp.float32(0.5 - _ACK_PLOW)
    return jnp.where(central, x_central, x_tail)


# ─────────────────────────────────────────────────────────────────────────────
# Device-side point generation (dims-major: the natural layout for both the
# BB matmul and the step-streaming consumers)
# ─────────────────────────────────────────────────────────────────────────────
def _reverse_bits32(x: Array) -> Array:
    """Bit-reverse each uint32 lane (5 masked swap rounds)."""
    x = ((x >> 1) & jnp.uint32(0x55555555)) | ((x & jnp.uint32(0x55555555)) << 1)
    x = ((x >> 2) & jnp.uint32(0x33333333)) | ((x & jnp.uint32(0x33333333)) << 2)
    x = ((x >> 4) & jnp.uint32(0x0F0F0F0F)) | ((x & jnp.uint32(0x0F0F0F0F)) << 4)
    x = ((x >> 8) & jnp.uint32(0x00FF00FF)) | ((x & jnp.uint32(0x00FF00FF)) << 8)
    return (x >> 16) | (x << 16)


def _owen_scramble30(x: Array, seed: Array) -> Array:
    """Hash-based Owen (nested-uniform) scrambling of 30-bit Sobol integers.

    Burley's construction (Practical Hash-based Owen Scrambling, JCGT 2020):
    reverse bits → Laine-Karras multiply-xor permutation (each output bit
    depends only on lower bits, i.e. on the *prefix* in the original
    orientation) → reverse back. Statistically equivalent to Owen's random
    binary-tree scrambling — the estimator-variance gold standard for
    digital nets — at O(1) per point and fully vectorized, unlike the
    sequential tree walk (which is why the reference leans on scipy for it,
    monte_carlo.py:78-79). `seed` is one uint32 per dimension.
    """
    x = x << jnp.uint32(2)          # occupy the full 32-bit space
    x = _reverse_bits32(x)
    x = x + seed                    # Laine-Karras permutation
    x = x ^ (x * jnp.uint32(0x6C50B47C))
    x = x ^ (x * jnp.uint32(0xB82F1E52))
    x = x ^ (x * jnp.uint32(0xC7AFE638))
    x = x ^ (x * jnp.uint32(0x8D22F6E6))
    x = _reverse_bits32(x)
    return x >> jnp.uint32(2)


def _sobol_uniforms_core(sv: Array, shift: Array, idx: Array, n_bits: int,
                         scramble: str) -> Array:
    """Shared XOR-expansion core: uniforms at arbitrary point indices `idx`.

    Statically unrolled over `n_bits` gray-code bits: the whole chain fuses
    into ONE elementwise pass (a fori_loop body round-trips the
    (dims × points) accumulator through device memory every iteration —
    30× the traffic).
    """
    gray = idx ^ (idx >> 1)
    dims = sv.shape[0]
    acc = jnp.zeros((dims, 1), jnp.uint32) if scramble == "owen" \
        else shift[:, None]
    for b in range(min(n_bits, _SOBOL_BITS)):
        bit = ((gray >> jnp.uint32(b)) & jnp.uint32(1)).astype(bool)
        acc = acc ^ jnp.where(bit[None, :], sv[:, b][:, None], jnp.uint32(0))
    if scramble == "owen":
        acc = _owen_scramble30(acc, shift[:, None])
    # Center each 30-bit integer in its cell for an unbiased uniform.
    return (acc.astype(jnp.float32) + 0.5) * _U32_SCALE


@partial(jax.jit, static_argnames=("num_points", "scramble"))
def _sobol_uniforms_T(sv: Array, shift: Array, num_points: int,
                      scramble: str = "owen") -> Array:
    """Sobol points via gray-code XOR expansion + scrambling.

    Args:
        sv: (dims, 30) uint32 direction numbers.
        shift: (dims,) uint32 scramble seed per dimension (30-bit digital
            shift for scramble="shift"; LK hash seed for scramble="owen").
        scramble: "owen" (hash-based nested-uniform — Owen-quality variance)
            or "shift" (digital shift — preserves equidistribution only).
    Returns:
        (dims, num_points) float32 uniforms in (0, 1) — dims-major.
    """
    idx = jax.lax.broadcasted_iota(jnp.uint32, (1, num_points), 1)[0]
    # Only the low ⌈log2(num_points)⌉ gray-code bits can ever be set, so
    # the unrolled chain is ~19 terms at 2^19 points, not 30.
    n_bits = max(1, int(np.ceil(np.log2(max(num_points, 2)))))
    return _sobol_uniforms_core(sv, shift, idx, n_bits, scramble)


def _sobol_uniforms_slice_T(sv: Array, shift: Array, offset: Array,
                            num_points: int, total_points: int,
                            scramble: str = "owen") -> Array:
    """Uniforms for the slice [offset, offset+num_points) of ONE global
    scrambled-Sobol sequence of `total_points` points.

    The sharded-QMC primitive: each device of a paths-sharded mesh
    generates its own contiguous slice (offset = axis_index · ppd) of the
    SAME sequence — the union over devices is exactly the single-host
    point set, so sharded RQMC keeps the full low-discrepancy variance
    win (device-independent streams would degrade it to √N pooling of
    short sequences). `offset` is a traced uint32 scalar; the bit unroll
    covers log2(total_points) so any slice is reachable.
    """
    idx = offset + jax.lax.broadcasted_iota(jnp.uint32, (1, num_points), 1)[0]
    n_bits = max(1, int(np.ceil(np.log2(max(total_points, 2)))))
    return _sobol_uniforms_core(sv, shift, idx, n_bits, scramble)


@partial(jax.jit, static_argnames=("num_points", "num_keep", "scramble"))
def _sobol_normals_T(sv: Array, shift: Array, num_points: int,
                     num_keep: int, scramble: str = "owen") -> Array:
    """(dims, num_keep) scrambled-Sobol normals — one fused device program.

    The inverse CDF is the Acklam rational approximation (`ndtri_acklam`):
    |Δz| < 4e-4 in f32 — far below MC noise — with one log, one sqrt and
    two rational evaluations per draw.
    """
    u = _sobol_uniforms_T(sv, shift, num_points, scramble)
    return ndtri_acklam(jnp.clip(u, _CLIP, 1.0 - _CLIP))[:, :num_keep]


@partial(jax.jit, static_argnames=("num_points", "num_keep", "scramble"))
def _sobol_bb_normals_T(sv: Array, shift: Array, bb: Array, num_points: int,
                        num_keep: int, scramble: str = "owen") -> Array:
    """Brownian-bridge-ordered per-step normals, (num_steps, num_keep).

    Fuses uniforms → inverse-CDF → bridge matmul → √n rescale in ONE compiled
    program, so no (dims × points) temporary survives the pipeline (the
    eager pipeline this replaces held 3+ such arrays live — 5 GB at 2M×252 —
    and OOM'd the chip).
    """
    z = _sobol_normals_T(sv, shift, num_points, num_keep, scramble)
    num_steps = bb.shape[0]
    # dW (unit horizon) = bb @ Z; convert to per-step unit normals by √n.
    return _bridge(bb, z) * jnp.sqrt(jnp.float32(num_steps))


def _scramble_shift(key: Array, dims: int) -> Array:
    return jax.random.bits(key, (dims,), jnp.uint32) \
        & jnp.uint32(2**_SOBOL_BITS - 1)


def sobol_normals(num_paths: int, dims: int, seed: int = 0,
                  stream: int = 0, scramble: str = "owen") -> Array:
    """Scrambled-Sobol standard normals, shape (num_paths, dims).

    Mirrors generate_sobol_normals (monte_carlo.py:61-85): rounds the point
    count up to a power of two, inverse-CDF transforms, truncates to
    `num_paths`. `stream` decouples scrambles for independent blocks.
    """
    m = int(np.ceil(np.log2(max(num_paths, 2))))
    n_sobol = 2**m
    sv = jnp.asarray(sobol_direction_numbers(dims))
    key = jax.random.fold_in(jax.random.key(seed), stream)
    shift = _scramble_shift(key, dims)
    return _sobol_normals_T(sv, shift, n_sobol, num_paths, scramble).T


def sobol_svj_draws(num_paths: int, num_steps: int, seed: int = 0,
                    layout: str = "steps", jump_uniforms: bool = True,
                    scramble: str = "owen",
                    ) -> Tuple[Array, Array, Array, Array]:
    """Full SVJ draw set from one scrambled Sobol stream.

    Matches the reference's dimension assignment (monte_carlo.py:290-308):
    3·steps Sobol dimensions split into Z1 | Z2 | Z_jump_size,
    Brownian-bridge reordering applied to Z1 and Z2, jump-occurrence uniforms
    from an independent PRNG stream (reference uses seed+1). Each Z block
    runs as its own fused device program to bound peak memory.

    Args:
        layout: "steps" → arrays shaped (num_steps, num_paths), the native
            layout for both the scan simulator and the Pallas draws kernel
            (zero-transpose hot path); "paths" → (num_paths, num_steps), the
            reference's layout, kept for CRN oracles and tests.

    Returns:
        (z1, z2, u_jump, z_js) float32; z1/z2 are Brownian *increments of a
        unit-horizon motion scaled back to unit normals* — i.e. dW·√n, so
        the simulator's √dt scaling applies uniformly to both drivers.
    """
    m = int(np.ceil(np.log2(max(num_paths, 2))))
    n_sobol = 2**m
    s = num_steps
    sv = jnp.asarray(sobol_direction_numbers(3 * s))
    shift = _scramble_shift(jax.random.key(seed), 3 * s)
    bb = jnp.asarray(brownian_bridge_matrix(s))

    z1 = _sobol_bb_normals_T(sv[:s], shift[:s], bb, n_sobol, num_paths,
                             scramble)
    z2 = _sobol_bb_normals_T(sv[s:2 * s], shift[s:2 * s], bb, n_sobol,
                             num_paths, scramble)
    z_js = _sobol_normals_T(sv[2 * s:], shift[2 * s:], n_sobol, num_paths,
                            scramble)
    if jump_uniforms:
        u_jump = jax.random.uniform(jax.random.key(seed + 1), (s, num_paths),
                                    jnp.float32)
    else:
        # The jump-occurrence uniforms carry no QMC structure (the reference
        # also draws them from a plain PRNG, monte_carlo.py:306-308); the
        # Pallas draws kernel generates them in-kernel from the hardware
        # PRNG instead, so they never touch HBM.
        u_jump = None
    if layout == "paths":
        return z1.T, z2.T, (u_jump.T if u_jump is not None else None), z_js.T
    if layout != "steps":
        raise ValueError(f"unknown layout: {layout!r}")
    return z1, z2, u_jump, z_js


@partial(jax.jit, static_argnames=("num_points", "num_keep", "scramble"))
def _sobol_uniforms_keep_T(sv: Array, shift: Array, num_points: int,
                           num_keep: int, scramble: str = "owen") -> Array:
    u = _sobol_uniforms_T(sv, shift, num_points, scramble)
    return jnp.clip(u, _CLIP, 1.0 - _CLIP)[:, :num_keep]


def sobol_svj_draws_slice(paths_slice: int, total_paths: int, offset,
                          num_steps: int, seed: int = 0,
                          scramble: str = "owen",
                          ) -> Tuple[Array, Array, None, Array]:
    """Per-device slice of the GLOBAL Sobol SVJ draw set (sharded QMC).

    Same dimension assignment and Brownian-bridge treatment as
    `sobol_svj_draws`, but generates only points [offset, offset+paths_slice)
    of a `total_paths`-point sequence (total_paths must be a power of two;
    the caller rounds up and splits across the mesh). Called INSIDE
    `shard_map` with `offset = axis_index · paths_slice` (a traced scalar) —
    the device union reconstructs the exact single-host point set, so the
    sharded estimator keeps full QMC variance behavior rather than
    degrading to pooled short sequences.

    Jump-occurrence uniforms are NOT generated here (no QMC structure;
    monte_carlo.py:306-308 uses a plain PRNG too) — the caller draws them
    from a device-folded threefry key. Returns steps-major
    (z1, z2, None, z_js).
    """
    s = num_steps
    sv = jnp.asarray(sobol_direction_numbers(3 * s))
    shift = _scramble_shift(jax.random.key(seed), 3 * s)
    bb = jnp.asarray(brownian_bridge_matrix(s))
    offset = jnp.asarray(offset, jnp.uint32)
    sqrt_n = jnp.sqrt(jnp.float32(s))

    def normals(block, shift_block):
        u = _sobol_uniforms_slice_T(block, shift_block, offset, paths_slice,
                                    total_paths, scramble)
        return ndtri_acklam(jnp.clip(u, _CLIP, 1.0 - _CLIP))

    z1 = _bridge(bb, normals(sv[:s], shift[:s])) * sqrt_n
    z2 = _bridge(bb, normals(sv[s:2 * s], shift[s:2 * s])) * sqrt_n
    z_js = normals(sv[2 * s:], shift[2 * s:])
    return z1, z2, None, z_js


def sobol_qe_draws(num_paths: int, num_steps: int, seed: int = 0,
                   jump_uniforms: bool = True, scramble: str = "owen",
                   ) -> Tuple[Array, Array, Array, Array]:
    """Draw set for the Andersen QE scheme from one scrambled Sobol stream.

    Dimension assignment (3·steps dims, importance-ordered like the Euler
    set): dims 0..s drive the log-spot Brownian motion (Brownian-bridge
    reordered, exactly like Euler's z1); dims s..2s are the variance-
    transition *uniforms* — QE consumes uniforms directly (quadratic branch
    inverts them, exponential branch uses them raw), so no inverse-CDF is
    applied; dims 2s..3s are jump-size normals. Jump-occurrence uniforms are
    a PRNG stream (or in-kernel when jump_uniforms=False), as in the Euler
    driver.

    Returns (z_x, u_v, u_jump, z_js), steps-major (num_steps, num_paths).
    """
    m = int(np.ceil(np.log2(max(num_paths, 2))))
    n_sobol = 2**m
    s = num_steps
    sv = jnp.asarray(sobol_direction_numbers(3 * s))
    shift = _scramble_shift(jax.random.key(seed), 3 * s)
    bb = jnp.asarray(brownian_bridge_matrix(s))

    z_x = _sobol_bb_normals_T(sv[:s], shift[:s], bb, n_sobol, num_paths,
                              scramble)
    u_v = _sobol_uniforms_keep_T(sv[s:2 * s], shift[s:2 * s], n_sobol,
                                 num_paths, scramble)
    z_js = _sobol_normals_T(sv[2 * s:], shift[2 * s:], n_sobol, num_paths,
                            scramble)
    u_jump = (jax.random.uniform(jax.random.key(seed + 1), (s, num_paths),
                                 jnp.float32) if jump_uniforms else None)
    return z_x, u_v, u_jump, z_js
