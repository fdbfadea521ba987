"""Multi-process (multi-host) initialization and global meshes.

SURVEY.md §5.8 names the distributed design: one `"paths"` mesh axis
spanning the devices of a host and the hosts of a cluster, with all
reductions as XLA collectives. Within a host nothing special is needed —
`jax.devices()` sees every device. Across hosts, JAX runs one process per
host (or per device) and the runtime must be initialized before first use;
this module wraps that wiring so every engine entry point can scale out
without code changes:

- `initialize(...)`: `jax.distributed.initialize` with explicit
  (coordinator, num_processes, process_id), or the cluster environment's
  auto-detection where the platform provides one.
- `global_mesh(...)`: a Mesh over ALL global devices (every process must
  build it identically — standard JAX SPMD contract).
- The sharded engine functions in `parallel/mesh.py` work unchanged on a
  global mesh: inputs are replicated, every reduction is a `psum`, and the
  per-device threefry fold uses the GLOBAL `axis_index`, so process count
  never changes the estimator — a 2-process × 4-device run returns
  bit-identical prices to a 1-process × 8-device run (pinned by
  tests/test_distributed.py).

The reference has no distributed backend at all (engine/monte_carlo.py:222
Numba threads; calibration workers=1, engine/calibration.py:203) — this is
the capability SURVEY §5.8 maps it to.

CPU-simulated smoke (what the tests run):

    # per process i of N:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
    python -m mcos_tpu.parallel.distributed \\
        --coordinator 127.0.0.1:9955 --num-processes N --process-id i
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger("mcos_tpu.distributed")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Bring up the JAX distributed runtime (idempotent).

    Pass the first three explicitly (a coordinator such as
    `localhost:<port>` for processes of one host); they may be None only
    where the cluster environment lets JAX detect them. On a GPU host that
    runs one process per card, pass `local_device_ids=[card]`: otherwise
    every process opens every card, and each reserves most of each card's
    memory. Must be called before any other JAX call in the process.
    """
    import jax

    # Idempotency WITHOUT touching the backend: jax.process_count() would
    # itself initialize XLA, after which distributed init is rejected.
    try:
        from jax._src.distributed import global_state
        if getattr(global_state, "client", None) is not None:
            return  # already initialized
    except ImportError:  # private module moved — fall through to init
        pass
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    if local_device_ids is not None:
        kwargs["local_device_ids"] = [int(i) for i in local_device_ids]
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        # Single-process fallback: initialize() is optional on one host.
        if "already" in str(e).lower():
            return
        raise
    logger.info("distributed: process %d/%d, %d local / %d global devices",
                jax.process_index(), jax.process_count(),
                jax.local_device_count(), jax.device_count())


def global_mesh(axis_name: str = "paths"):
    """1-D mesh over ALL global devices (call identically on every
    process); XLA routes the collectives within and across hosts."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis_name,))


def is_distributed() -> bool:
    import jax

    return jax.process_count() > 1


def _demo_price(num_paths: int, num_steps: int) -> dict:
    """The smoke workload: mesh-sharded SVJ price over the global mesh.
    Every process computes (and returns) the same replicated result."""
    import jax

    from mcos_tpu.models.params import SVJParams
    from mcos_tpu.parallel.mesh import sharded_price

    mesh = global_mesh()
    res = sharded_price(
        SVJParams(), 22500.0, [22000.0, 22500.0, 23000.0], 0.25,
        jax.random.key(7), mesh=mesh, num_paths=num_paths,
        num_steps=num_steps)
    return {
        "process_id": jax.process_index(),
        "num_processes": jax.process_count(),
        "global_devices": jax.device_count(),
        "price": np.asarray(res["price"]).tolist(),
        "std_error": np.asarray(res["std_error"]).tolist(),
    }


def main() -> None:
    parser = argparse.ArgumentParser(
        description="mcos_tpu multi-process worker (smoke demo)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0 (None = auto-detect)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--local-device-id", type=int, default=None,
                        help="the one local GPU this process uses")
    parser.add_argument("--num-paths", type=int, default=8192)
    parser.add_argument("--num-steps", type=int, default=16)
    args = parser.parse_args()

    initialize(args.coordinator, args.num_processes, args.process_id,
               None if args.local_device_id is None
               else [args.local_device_id])
    out = _demo_price(args.num_paths, args.num_steps)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
