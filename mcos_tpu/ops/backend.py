"""The one place that chooses between a simulator's scan twin and its kernel.

Every simulator family has a differentiable `lax.scan` implementation that
runs on any platform. A family may also have a hand-written kernel for one
platform; `simulator_for` returns it only where it compiles and only where no
gradient is taken through it (a Pallas call has no autodiff rule here).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax

from mcos_tpu.ops import simulate

SVJ_EULER_DRAWS = "svj_euler_draws"


def _draws_kernel() -> Callable:
    from mcos_tpu.ops.draws_kernel import svj_terminal_from_draws_kernel

    return svj_terminal_from_draws_kernel


# family → (scan twin, kernel loader or None, platform the kernel compiles
# for). Kernels load lazily so importing this module imports no Pallas code.
_FAMILIES = {
    SVJ_EULER_DRAWS: (simulate.simulate_terminal_from_draws_pair,
                      _draws_kernel, "gpu"),
}


def simulator_for(family: str, *, differentiable: bool = False,
                  platform: Optional[str] = None) -> Callable:
    """The simulator to run for `family` on `platform`.

    Args:
        family: a key of `_FAMILIES`, e.g. `SVJ_EULER_DRAWS`.
        differentiable: True when the caller takes a gradient through the
            result; only the scan twin carries one.
        platform: defaults to `jax.default_backend()`.
    Returns:
        A callable with the scan twin's signature.
    """
    try:
        scan, kernel, kernel_platform = _FAMILIES[family]
    except KeyError:
        raise ValueError(f"unknown simulator family: {family!r}") from None
    platform = platform or jax.default_backend()
    if kernel is not None and platform == kernel_platform \
            and not differentiable:
        return kernel()
    return scan
