"""JAX-native optimizers for calibration: vmapped differential evolution + box
reparameterization helpers for gradient polish.

Replacement for the reference's `scipy.optimize.differential_evolution`
with `workers=1` (engine/calibration.py:195-227, engine/surface.py:204-238):
here the whole DE population is evaluated in ONE batched objective call
(vmap over members — on device that is one big fused MC batch instead of a
Python loop over members × strikes), and generations advance under `lax.scan`.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


class DEResult(NamedTuple):
    x: Array          # best member, shape (D,)
    fun: Array        # best objective value
    nit: Array        # generations run
    history: Array    # best value per generation, shape (iters,)


def _clip_to_bounds(x: Array, lo: Array, hi: Array) -> Array:
    return jnp.clip(x, lo, hi)


def differential_evolution(
    obj_fn: Callable,
    bounds: Array,
    key: Array,
    pop_size: int = 32,
    iters: int = 100,
    mutation: float = 0.7,
    crossover: float = 0.9,
    x0: Array | None = None,
    args=None,
    static_kwargs: tuple = (),
    mesh=None,
    pop_axis: str = "paths",
) -> DEResult:
    """DE/rand/1/bin with a fully vectorized population.

    Args:
        obj_fn: pure objective. Either `f(x)` (closure; convenient but keyed
            into the jit cache by *identity*, so fresh closures recompile) or
            `f(x, args, **static_kwargs)` with `args` a traced pytree of data
            — pass a stable module-level function there and repeated
            calibrations with the same shapes reuse the compiled DE loop
            (review finding: per-request closures forced full recompiles).
        bounds: (D, 2) array of [lo, hi] per dimension.
        key: PRNG key (deterministic optimization given the key).
        x0: optional (D,) warm-start — replaces population member 0
            (e.g. the surface-consistent heuristic v0=θ=ATM_IV²; DE keeps the
            global search while converging far faster from a sane seed).
        args: traced data pytree forwarded to obj_fn (None ⇒ closure mode).
        static_kwargs: ((name, value), ...) hashable compile-time settings
            forwarded as keyword args.
        mesh: optional `jax.sharding.Mesh` — shards the POPULATION axis
            across `pop_axis` devices, so each device evaluates
            pop_size/n_dev full objective calls per generation (the
            per-member MC pricing is what dominates; the (pop, dim)
            population itself is bytes, so the generation step's random
            cross-member gathers are free). pop_size rounds up to a
            multiple of the axis size.
        pop_axis: mesh axis name carrying the population.

    Returns:
        DEResult with the best member, value, and per-generation best history.
    """
    closure_mode = args is None
    if mesh is not None:
        n_dev = mesh.shape[pop_axis]
        pop_size = int(-(-pop_size // n_dev) * n_dev)
    return _de_impl(obj_fn, jnp.asarray(bounds, jnp.float32), key,
                    () if closure_mode else args, x0,
                    pop_size=pop_size, iters=iters, mutation=mutation,
                    crossover=crossover, static_kwargs=tuple(static_kwargs),
                    closure_mode=closure_mode, mesh=mesh, pop_axis=pop_axis)


@partial(jax.jit, static_argnames=("obj_fn", "pop_size", "iters",
                                   "static_kwargs", "closure_mode",
                                   "mesh", "pop_axis"))
def _de_impl(
    obj_fn,
    bounds: Array,
    key: Array,
    args,
    x0,
    *,
    pop_size: int,
    iters: int,
    mutation: float,
    crossover: float,
    static_kwargs: tuple,
    closure_mode: bool,
    mesh=None,
    pop_axis: str = "paths",
) -> DEResult:
    lo, hi = bounds[:, 0], bounds[:, 1]
    dim = bounds.shape[0]
    if closure_mode:
        scalar_obj = obj_fn
    else:
        static = dict(static_kwargs)
        scalar_obj = lambda x: obj_fn(x, args, **static)  # noqa: E731
    batched_obj = jax.vmap(scalar_obj)
    if mesh is None:
        shard_pop = lambda p: p                           # noqa: E731
    else:
        from jax.sharding import NamedSharding, PartitionSpec

        sharding = NamedSharding(mesh, PartitionSpec(pop_axis))
        shard_pop = lambda p: jax.lax.with_sharding_constraint(  # noqa: E731
            p, sharding)

    k_init, k_loop = jax.random.split(key)
    pop = lo + (hi - lo) * jax.random.uniform(k_init, (pop_size, dim))
    if x0 is not None:
        pop = pop.at[0].set(jnp.clip(jnp.asarray(x0, jnp.float32), lo, hi))
    pop = shard_pop(pop)
    fitness = batched_obj(pop)

    def generation(carry, k_gen):
        pop, fitness = carry
        k_idx, k_cross, k_forced = jax.random.split(k_gen, 3)

        # rand/1 mutation: x_a + F (x_b − x_c), indices drawn iid (the rare
        # self-pick collision only wastes that member's trial).
        idx = jax.random.randint(k_idx, (3, pop_size), 0, pop_size)
        mutant = pop[idx[0]] + mutation * (pop[idx[1]] - pop[idx[2]])
        mutant = _clip_to_bounds(mutant, lo, hi)

        # Binomial crossover with one forced dimension per member.
        cross = jax.random.uniform(k_cross, (pop_size, dim)) < crossover
        forced = jax.nn.one_hot(
            jax.random.randint(k_forced, (pop_size,), 0, dim), dim,
            dtype=bool)
        trial = shard_pop(jnp.where(cross | forced, mutant, pop))

        f_trial = batched_obj(trial)
        improved = f_trial < fitness
        pop = jnp.where(improved[:, None], trial, pop)
        fitness = jnp.where(improved, f_trial, fitness)
        return (pop, fitness), jnp.min(fitness)

    keys = jax.random.split(k_loop, iters)
    (pop, fitness), best_hist = jax.lax.scan(generation, (pop, fitness), keys)

    best = jnp.argmin(fitness)
    return DEResult(x=pop[best], fun=fitness[best],
                    nit=jnp.int32(iters), history=best_hist)


# ─────────────────────────────────────────────────────────────────────────────
# Box reparameterization (for gradient-based polish inside bounds)
# ─────────────────────────────────────────────────────────────────────────────
def to_box(u: Array, bounds: Array) -> Array:
    """Unconstrained ℝᴰ → box via sigmoid: x = lo + (hi−lo)·σ(u)."""
    bounds = jnp.asarray(bounds, jnp.float32)
    return bounds[:, 0] + (bounds[:, 1] - bounds[:, 0]) * jax.nn.sigmoid(u)


def from_box(x: Array, bounds: Array, eps: float = 1e-6) -> Array:
    """Box → unconstrained (logit), clipped away from the faces."""
    bounds = jnp.asarray(bounds, jnp.float32)
    t = (x - bounds[:, 0]) / (bounds[:, 1] - bounds[:, 0])
    t = jnp.clip(t, eps, 1.0 - eps)
    return jnp.log(t) - jnp.log1p(-t)


def adam_polish(
    obj_fn: Callable,
    x0: Array,
    bounds: Array,
    steps: int = 50,
    lr: float = 0.05,
    args=None,
    static_kwargs: tuple = (),
) -> Tuple[Array, Array]:
    """Gradient descent in the box-reparameterized space from a DE solution.

    Exploits the differentiability of the MC pricer (pathwise gradients) —
    the capability the reference's derivative-free pipeline cannot use.
    Same obj_fn calling conventions as `differential_evolution` (closure mode
    or args mode; args mode keeps the jit cache warm across calls).
    Returns (x_best, f_best); never leaves the bounds.
    """
    closure_mode = args is None
    u_best, f_best, bounds_f = _polish_impl(
        obj_fn, jnp.asarray(x0, jnp.float32),
        jnp.asarray(bounds, jnp.float32),
        () if closure_mode else args,
        steps=steps, lr=lr, static_kwargs=tuple(static_kwargs),
        closure_mode=closure_mode)
    return to_box(u_best, bounds_f), f_best


@partial(jax.jit, static_argnames=("obj_fn", "steps", "lr", "static_kwargs",
                                   "closure_mode"))
def _polish_impl(obj_fn, x0, bounds, args, *, steps, lr, static_kwargs,
                 closure_mode):
    import optax

    if closure_mode:
        scalar_obj = obj_fn
    else:
        static = dict(static_kwargs)
        scalar_obj = lambda x: obj_fn(x, args, **static)  # noqa: E731

    u0 = from_box(x0, bounds)
    opt = optax.adam(lr)

    def loss(u):
        return scalar_obj(to_box(u, bounds))

    def step(carry, _):
        u, state = carry
        val, grad = jax.value_and_grad(loss)(u)
        updates, state = opt.update(grad, state)
        return (optax.apply_updates(u, updates), state), (u, val)

    (_, _), (us, vals) = jax.lax.scan(step, (u0, opt.init(u0)), None,
                                      length=steps)
    best = jnp.argmin(vals)
    return us[best], vals[best], bounds
