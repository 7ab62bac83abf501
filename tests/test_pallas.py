"""Triton-route Pallas CTC kernel vs the XLA phi/emit scan and the
NumPy lattice reference — values and custom-VJP gradients, in the
Pallas interpreter (the compiled kernel runs only on the GPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgr_tpu.ops import ctc as ctc_lib
from mgr_tpu.ops import pallas_kernels as pk


# ---------------------------------------------------------------------------
# Pallas CTC vs the XLA phi/emit scan (values + gradients).
# ---------------------------------------------------------------------------

def _ctc_case(seed, B=3, T=14, K=6, N=5):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, K)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    lab_len = rng.integers(1, N + 1, size=B)
    in_len = rng.integers(2 * N + 1, T + 1, size=B)
    labels = np.full((B, N), -1, np.int32)
    for b in range(B):
        labels[b, : lab_len[b]] = rng.integers(0, K - 1, size=lab_len[b])
    return (jnp.asarray(lp), jnp.asarray(labels), jnp.asarray(in_len),
            jnp.asarray(lab_len))


def test_pallas_ctc_matches_xla_values():
    lp, labels, in_len, lab_len = _ctc_case(0)
    want = ctc_lib.ctc_loss(lp, labels, in_len, lab_len, backend="xla")
    got = pk.pallas_ctc_loss(lp, labels, in_len, lab_len, interpret=True)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4
    )


def test_pallas_ctc_repeats_blank_label_and_empty():
    B, T, K, N = 3, 12, 5, 4
    rng = np.random.default_rng(1)
    lp = jnp.asarray(np.asarray(jax.nn.log_softmax(
        jnp.asarray(rng.standard_normal((B, T, K)).astype(np.float32)), -1
    )))
    labels = jnp.asarray(
        np.array([[2, 2, 2, -1], [K - 1, -1, -1, -1], [0, 0, 0, 0]],
                 np.int32)
    )
    lab_len = jnp.asarray([3, 1, 0])
    in_len = jnp.asarray([12, 10, 8])
    want = ctc_lib.ctc_loss(lp, labels, in_len, lab_len, backend="xla")
    got = pk.pallas_ctc_loss(lp, labels, in_len, lab_len, interpret=True)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4
    )


def test_pallas_ctc_gradients_match_xla():
    lp, labels, in_len, lab_len = _ctc_case(2)

    def loss_xla(lp):
        return ctc_lib.ctc_loss(
            lp, labels, in_len, lab_len, backend="xla"
        ).sum()

    def loss_pal(lp):
        return pk.pallas_ctc_loss(
            lp, labels, in_len, lab_len, interpret=True
        ).sum()

    g_xla = np.asarray(jax.grad(loss_xla)(lp))
    g_pal = np.asarray(jax.grad(loss_pal)(lp))
    np.testing.assert_allclose(g_pal, g_xla, rtol=1e-3, atol=1e-4)


def test_pallas_ctc_grad_through_logits_chain():
    # End-to-end: logits -> log_softmax -> pallas ctc; grads finite and
    # match the xla chain.
    lp, labels, in_len, lab_len = _ctc_case(3, B=2, T=10, K=5, N=3)
    logits = lp * 2.0  # arbitrary pre-softmax tensor

    def chain(backend):
        def f(lg):
            lsp = jax.nn.log_softmax(lg, axis=-1)
            if backend == "xla":
                return ctc_lib.ctc_loss(
                    lsp, labels, in_len, lab_len, backend="xla"
                ).mean()
            return pk.pallas_ctc_loss(
                lsp, labels, in_len, lab_len, interpret=True
            ).mean()
        return f

    g_xla = np.asarray(jax.grad(chain("xla"))(logits))
    g_pal = np.asarray(jax.grad(chain("pallas"))(logits))
    np.testing.assert_allclose(g_pal, g_xla, rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# Against the independent NumPy lattice, across shapes and state widths.
# ---------------------------------------------------------------------------

def _labels(rng, B, N, K, lab_len):
    labels = np.full((B, N), -1, np.int32)
    for b in range(B):
        labels[b, :lab_len[b]] = rng.integers(0, K - 1, size=lab_len[b])
    return labels


# (B, T, K, N, label lengths, input lengths, packed state width)
_REF_CASES = {
    "odd_T": (2, 13, 5, 4, [4, 2], [13, 13], 8),
    "empty_label": (3, 10, 4, 3, [0, 2, 0], [10, 7, 4], 4),
    "repeats": (2, 16, 4, 5, [5, 3], [16, 16], 8),
    "short_inputs": (3, 20, 6, 4, [3, 4, 1], [9, 12, 3], 8),
    "speech_width": (2, 24, 44, 150, [6, 9], [24, 21], 256),
    "skeletal_width": (2, 30, 22, 28, [12, 5], [30, 17], 32),
    "fusion_width": (2, 40, 22, 35, [17, 3], [40, 29], 64),
}


@pytest.mark.parametrize("case", sorted(_REF_CASES))
def test_triton_ctc_matches_numpy_reference(case):
    B, T, K, N, lab_len, in_len, width = _REF_CASES[case]
    assert pk.state_width(N) == width
    rng = np.random.default_rng(len(case))
    lp = np.asarray(jax.nn.log_softmax(
        jnp.asarray(rng.standard_normal((B, T, K)).astype(np.float32)), -1))
    labels = _labels(rng, B, N, K, lab_len)
    if case == "repeats":
        labels[0, :5] = [1, 1, 2, 2, 2]
        labels[1, :3] = [2, 0, 2]
    want = ctc_lib.ctc_loss_reference_batch(lp, labels, np.array(in_len),
                                            np.array(lab_len))
    got = pk.pallas_ctc_loss(jnp.asarray(lp), jnp.asarray(labels),
                             jnp.asarray(in_len), jnp.asarray(lab_len),
                             interpret=True)
    assert got.shape == (B,)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("layout", ["batch_major", "time_major",
                                    "logits_chain"])
def test_triton_ctc_gradients_match_autodiff(layout):
    """The hand-derived adjoint equals XLA autodiff of the scan, for both
    input layouts and through log_softmax."""
    lp, labels, in_len, lab_len = _ctc_case(11, B=3, T=15, K=6, N=4)
    tm = layout == "time_major"
    x = jnp.swapaxes(lp, 0, 1) if tm else lp * (2.0 if layout ==
                                                 "logits_chain" else 1.0)

    def loss(fn):
        def f(v):
            if layout == "logits_chain":
                v = jax.nn.log_softmax(v, axis=-1)
            return (fn(v) * jnp.arange(1.0, 4.0)).sum()
        return f

    want = jax.grad(loss(lambda v: ctc_lib.ctc_loss(
        v, labels, in_len, lab_len, backend="xla", time_major=tm)))(x)
    got = jax.grad(loss(lambda v: pk.pallas_ctc_loss(
        v, labels, in_len, lab_len, interpret=True, time_major=tm)))(x)
    assert got.shape == x.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_triton_ctc_compiled_matches_xla(gpu):
    """The compiled kernel (no interpreter) on the card at speech widths,
    held to chip_smoke's tolerances (float64 truth beside both paths)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    out = chip_smoke.check_ctc_kernel(B=8, T=400, K=44, N=150, reps=1)
    assert out["loss_rel_err"] <= chip_smoke.LOSS_RTOL
    assert out["grad_err_kernel_vs_f64"] <= out["grad_tol"]
