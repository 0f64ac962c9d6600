"""Contract of the GPU measurement entry points on a machine without a GPU.

``bench.py`` and ``chip_smoke.py`` measure the card and nothing else: on
the CPU they must exit non-zero and print no number and no ok line — a
CPU timing under a device metric's name would be a wrong result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(script: str, *argv: str):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, str(REPO / script), *argv],
        capture_output=True, text=True, timeout=240, cwd=REPO, env=env,
    )


def _json_lines(stdout: str):
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


@pytest.mark.parametrize("script,argv", [
    ("bench.py", ("--frames", "16", "--videos", "2", "--repeat", "1")),
    ("chip_smoke.py", ()),
], ids=["bench", "chip_smoke"])
def test_no_gpu_exits_nonzero_without_a_result(script, argv):
    proc = _run(script, *argv)
    assert proc.returncode != 0, proc.stdout[-800:]
    parsed = _json_lines(proc.stdout)
    assert not any(isinstance(p, dict) and (p.get("ok") or p.get("value"))
                   for p in parsed), proc.stdout[-800:]
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied without the rest of the repository, chip_smoke.py exits
    non-zero with no ok line (it has nothing to drive)."""
    import shutil

    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(alone)], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
