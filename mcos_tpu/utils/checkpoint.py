"""Checkpoint / resume for calibration state + compilation caching.

The reference has no persistence at all — calibration history and regime
history live in in-memory lists (engine/calibration.py:145,244-251;
engine/regime.py:37,92) and die with the process; its only "cache" is Numba's
on-disk JIT cache (SURVEY.md §5.4). This framework provides:

- `save_calibration` / `load_calibration`: durable SVJParams (`params.npz`)
  + history and metadata in a JSON sidecar for human inspection.
- `enable_compilation_cache`: JAX persistent compilation cache, the analogue
  of `cache=True` on the reference's Numba kernel (monte_carlo.py:189) —
  first-compile latency paid once per machine, not per process.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from mcos_tpu.models.params import SVJParams

#: Cache directory used when JAX_COMPILATION_CACHE_DIR is not set: fixed and
#: inside the checkout, because the path is part of the cache key.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache() -> Optional[str]:
    """Persistent XLA compilation cache (Numba cache=True analogue).

    If JAX_COMPILATION_CACHE_DIR is set, JAX already caches there and no
    other directory is set; otherwise the cache goes to DEFAULT_CACHE_DIR.
    Returns the directory, or None when MCOS_DISABLE_JIT_CACHE=1 — the
    operator escape hatch: the cache's native executable serializer has
    been observed to segfault on some large CPU executables (jax
    compilation_cache.py:238/265, the reason tests/conftest.py disables
    the cache for the suite).
    """
    import jax

    if os.environ.get("MCOS_DISABLE_JIT_CACHE") == "1":
        return None
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def save_calibration(directory: str, params: SVJParams,
                     history: Optional[List[Dict]] = None,
                     metadata: Optional[Dict] = None) -> str:
    """Persist calibrated params (+ history) to `directory`.

    The params go to `params.npz`, history and metadata to the JSON
    sidecar `calibration.json` (which also lists the params for reading).
    Returns the directory path.
    """
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    values = {k: np.float64(v) for k, v in params.as_dict().items()}
    np.savez(os.path.join(directory, "params.npz"), **values)
    sidecar = {
        "params": params.as_dict(),
        "history": history or [],
        "metadata": metadata or {},
    }
    with open(os.path.join(directory, "calibration.json"), "w") as f:
        json.dump(sidecar, f, indent=2)
    return directory


def load_calibration(directory: str) -> Tuple[SVJParams, List[Dict], Dict]:
    """Restore (params, history, metadata) saved by `save_calibration`."""
    directory = os.path.abspath(directory)
    with np.load(os.path.join(directory, "params.npz")) as z:
        params = SVJParams(**{k: float(z[k]) for k in z.files})
    with open(os.path.join(directory, "calibration.json")) as f:
        sidecar = json.load(f)
    return params, sidecar.get("history", []), sidecar.get("metadata", {})
