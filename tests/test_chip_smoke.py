"""`chip_smoke.py` refuses to run anywhere but on a GPU: with no GPU, or
without the rest of the repository beside it, it exits non-zero and prints
no result line."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu(where, tmp_path):
    if where == "repo":
        cwd, script = REPO, "chip_smoke.py"
    else:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd, script = str(tmp_path), "chip_smoke.py"
    out = _run(cwd, script)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
