"""Multi-process (DCN-simulated) pricing: 2 processes × 4 virtual devices.

Spawns two REAL worker processes (mcos_tpu.parallel.distributed CLI) that
initialize the JAX distributed runtime over a localhost coordinator, build
one GLOBAL 8-device mesh, and price through parallel/mesh.py:sharded_price.
Pins: both processes return the same replicated result, and it matches the
single-process 8-device run in this test process — the device-folded keys
and psum reductions make the estimator independent of the process layout
(ICI-within-slice / DCN-across-slices contract, SURVEY.md §5.8).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_workers(num_processes: int, devices_per_proc: int,
                   num_paths: int, num_steps: int, timeout: float = 300):
    port = _free_port()
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={devices_per_proc}",
        PYTHONPATH=str(REPO),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "mcos_tpu.parallel.distributed",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(num_processes),
             "--process-id", str(i),
             "--num-paths", str(num_paths),
             "--num-steps", str(num_steps)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, cwd=str(REPO), text=True)
        for i in range(num_processes)
    ]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=timeout)
        assert p.returncode == 0, f"worker failed:\n{stderr[-2000:]}"
        line = [ln for ln in stdout.splitlines() if ln.startswith("{")][-1]
        outs.append(json.loads(line))
    return outs


def test_two_process_price_matches_single_process():
    outs = _spawn_workers(num_processes=2, devices_per_proc=4,
                          num_paths=8192, num_steps=16)
    assert all(o["global_devices"] == 8 for o in outs)
    assert all(o["num_processes"] == 2 for o in outs)
    # replicated result: every process sees the same numbers
    assert outs[0]["price"] == pytest.approx(outs[1]["price"], rel=1e-6)

    # single-process 8-device reference (this test process has the
    # 8-virtual-device conftest environment)
    from mcos_tpu.models.params import SVJParams
    from mcos_tpu.parallel.mesh import make_mesh, sharded_price

    assert jax.device_count() == 8
    ref = sharded_price(
        SVJParams(), 22500.0, [22000.0, 22500.0, 23000.0], 0.25,
        jax.random.key(7), mesh=make_mesh(), num_paths=8192, num_steps=16)
    # identical global axis_index folds → same per-device streams; only
    # cross-process reduction order can differ (f32 noise)
    np.testing.assert_allclose(outs[0]["price"],
                               np.asarray(ref["price"]), rtol=1e-5)


def test_initialize_passes_one_card_per_process(monkeypatch):
    """`local_device_ids` reaches jax.distributed.initialize, so a process
    per GPU opens only its own card."""
    from mcos_tpu.parallel import distributed

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setattr(distributed.logger, "info", lambda *a, **k: None)
    distributed.initialize("localhost:1234", 4, 2, local_device_ids=[2])
    assert seen == {"coordinator_address": "localhost:1234",
                    "num_processes": 4, "process_id": 2,
                    "local_device_ids": [2]}
