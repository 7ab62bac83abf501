"""bench.py contract tests: it measures the GPU or refuses, and its
CPU smoke (explicit JAX_PLATFORMS=cpu) prints one line naming the
device it ran on."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")


def _run(env_extra, *args, timeout=600):
    env = dict(os.environ)
    env.update(env_extra)
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, BENCH, *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout,
    )


@pytest.mark.slow  # full bench subprocess, ~80 s
def test_cpu_smoke_live_line(tmp_path):
    """With JAX_PLATFORMS=cpu set explicitly the harness runs at toy
    geometry and its line says it ran on the CPU."""
    r = _run({"JAX_PLATFORMS": "cpu"}, "--maxlen", "32", "--batch", "2")
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["count"] == 1
    assert out["metric"] == "train_seqs_per_sec_per_device"
    assert out["value"] > 0
    assert out["decode_seqs_per_sec_per_device"] > 0
