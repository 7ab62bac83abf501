"""Test harness setup: force an 8-device virtual CPU backend BEFORE jax
initializes, so mesh/collective code paths are exercised without
accelerators (the standard JAX fake-backend idiom; see SURVEY.md §4).

Tests that need the GPU carry ``@pytest.mark.gpu`` and take the ``gpu``
fixture, which skips them unless JAX's backend is the GPU. To run them
on a machine with a card, leave the platform to JAX:

    MGR_TPU_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu
"""

import os

import pytest

if os.environ.get("MGR_TPU_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX backend is "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]


@pytest.fixture
def triton_interpret(monkeypatch):
    """Let the dispatch choose the CTC kernel on this CPU backend: the
    backend reads as "gpu" and the kernel runs in the Pallas
    interpreter. Yields the list of kernel calls."""
    from mgr_tpu.ops import dispatch
    from mgr_tpu.ops import pallas_kernels as pk

    calls = []
    real = pk.pallas_ctc_loss

    def interpreted(*args, **kwargs):
        calls.append(1)
        return real(*args, **dict(kwargs, interpret=True))

    monkeypatch.setattr(dispatch, "_backend", lambda: "gpu")
    monkeypatch.setattr(pk, "pallas_ctc_loss", interpreted)
    yield calls
    dispatch.set_mode("auto")
