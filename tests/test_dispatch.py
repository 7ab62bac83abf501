"""Kernel-backend dispatch policy (mgr_tpu.ops.dispatch)."""

import jax
import jax.numpy as jnp
import pytest

from mgr_tpu.ops import ctc as ctc_lib
from mgr_tpu.ops import dispatch


@pytest.fixture(autouse=True)
def _reset_mode():
    yield
    dispatch.set_mode("auto")


def test_xla_mode_disables():
    dispatch.set_mode("xla")
    assert not dispatch.pallas_ok()


def test_invalid_mode_rejected():
    with pytest.raises(ValueError):
        dispatch.set_mode("cuda")


@pytest.mark.parametrize(
    "backend, n_devices, local, want",
    [
        ("gpu", 1, False, True),    # one card: the kernel
        ("cpu", 1, False, False),   # no kernel off the GPU
        ("gpu", 8, False, False),   # global arrays under GSPMD
        ("gpu", 8, True, True),     # per-device shard_map body
        ("cpu", 8, True, False),
    ],
    ids=["gpu-1dev", "cpu", "gpu-multidev-global", "gpu-shard_local",
         "cpu-shard_local"],
)
def test_auto_routing(monkeypatch, backend, n_devices, local, want):
    monkeypatch.setattr(dispatch, "_backend", lambda: backend)
    monkeypatch.setattr(dispatch.jax, "device_count", lambda: n_devices)
    dispatch.set_mode("auto")
    if local:
        with dispatch.shard_local():
            assert dispatch.in_shard_local()
            assert dispatch.pallas_ok() is want
        assert not dispatch.in_shard_local()
    else:
        assert dispatch.pallas_ok() is want


def test_forcing_kernel_off_gpu_raises():
    """This suite runs on the CPU backend, where Triton cannot compile:
    forcing the kernel is an error, never a quiet interpret fallback."""
    dispatch.set_mode("pallas")
    with pytest.raises(RuntimeError, match="GPU"):
        dispatch.pallas_ok()
    dispatch.set_mode("auto")
    lp = jax.nn.log_softmax(jnp.zeros((1, 6, 4)), axis=-1)
    with pytest.raises(RuntimeError, match="GPU"):
        ctc_lib.ctc_loss(lp, jnp.array([[1, 2]]), jnp.array([6]),
                         jnp.array([2]), backend="pallas")


def test_shard_local_context_restores_on_error(monkeypatch):
    monkeypatch.setattr(dispatch, "_backend", lambda: "gpu")
    dispatch.set_mode("auto")
    with pytest.raises(RuntimeError):
        with dispatch.shard_local():
            raise RuntimeError("boom")
    assert not dispatch.in_shard_local()
