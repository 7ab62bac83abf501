"""chip_smoke.py and bench.py refuse to run without a GPU, and
chip_smoke's phases hold on this CPU backend at tiny widths."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "script, args, platforms, alone",
    [
        ("chip_smoke.py", [], "cpu", False),
        ("chip_smoke.py", ["--four"], "cpu", False),
        ("chip_smoke.py", [], None, True),
        ("bench.py", [], None, False),
    ],
    ids=["smoke-cpu", "smoke-four-cpu", "smoke-alone", "bench-no-gpu"],
)
def test_refuses_without_gpu(tmp_path, script, args, platforms, alone):
    """No accelerator: non-zero exit and no result line. ``alone`` runs
    the script from a directory that holds nothing else of the repo."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    if platforms:
        env["JAX_PLATFORMS"] = platforms
    path = os.path.join(REPO, script)
    cwd = REPO
    if alone:
        path = str(shutil.copy(path, tmp_path / script))
        cwd = str(tmp_path)
        env["PYTHONPATH"] = ""
    r = subprocess.run([sys.executable, path, *args], capture_output=True,
                       text=True, env=env, cwd=cwd, timeout=300)
    assert r.returncode != 0, r.stdout[-2000:]
    for line in r.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(rec, dict) and ("ok" in rec or "value" in rec)
                    ), line


def _import_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def test_smoke_ctc_phase_interpreted():
    """The kernel phase's checks at a small width, kernel interpreted."""
    cs = _import_smoke()
    out = cs.check_ctc_kernel(B=6, T=50, K=44, N=12, interpret=True)
    assert out["loss_rel_err"] < cs.LOSS_RTOL
    assert out["grad_err_kernel_vs_f64"] <= out["grad_tol"]
    assert "fwd_bwd_kernel_ms" not in out  # no timings off the card


def test_smoke_mesh_phase_virtual_devices():
    """--four's comparison on 4 of the virtual CPU devices: DP=4 and
    DP2xTP2 steps and the mesh decode against one device."""
    from mgr_tpu.core import config as cfglib

    cs = _import_smoke()
    tiny = cfglib.get_preset("speech").replace(
        maxlen=40, encoder=cfglib.EncoderConfig(hidden=8, depth=2))
    out = cs.mesh_check(4, B=8, cfg=tiny)
    assert out["decode_mismatches"] == 0
    assert out["DP=4"]["d_loss"] <= cs.MESH_LOSS_RTOL
    assert out["DP2xTP2"]["d_csum"] <= cs.MESH_CSUM_RTOL
