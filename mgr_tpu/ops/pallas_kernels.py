"""Pallas CTC kernel for the GPU, through the Triton route.

The CTC alpha recursion is independent per sequence, so one Triton
program owns one sequence and walks all T frames in an in-kernel loop
with its alpha/phi state vectors in registers: one launch for the whole
recursion instead of one or more XLA kernels per frame. The backward
pass is a second kernel that walks time in reverse and applies the
hand-derived adjoint of each step (``ctc_alpha_loss``'s custom VJP).

State packing: one buffer of width ``Np`` (the next power of two above
N + 1) holds both chains. Emission scores sit in cols 0..N-1, the blank
(phi) score in col N, padding above. alpha_phi uses cols 0..N,
alpha_emit cols 0..N-1. Dead padded states start at -1e5 and never leak
gradient: their upstream adjoints are identically zero.

Triton has no lane roll, so the one-state shift ``alpha[s - 1]`` is a
masked load of the previous step's row from the alpha history the
kernel writes anyway (``a_hist[b, t]``), behind a block barrier. The
backward pass shifts its step adjoint the other way through a two-slot
scratch row. No product in either kernel is a matrix product, so
nothing runs in TF32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_CTC_NEG = -1.0e5


def state_width(n_labels: int) -> int:
    """Packed state width: the next power of two >= n_labels + 1."""
    return 1 << int(n_labels).bit_length()


def _num_warps(np_: int) -> int:
    # The recursion is latency-bound: few threads per sequence keep the
    # per-step barrier cheap. At Np=256 four warps measured fastest on
    # an H100 (4.6 ms against 5.0 with two and 8.1 with one, fwd+bwd at
    # B=128, T=1898).
    return max(1, min(4, np_ // 64))


def _lse2(x, y):
    m = jnp.maximum(x, y)
    return m + jnp.log(jnp.exp(x - m) + jnp.exp(y - m))


def _lse3(x, y, z):
    m = jnp.maximum(jnp.maximum(x, y), z)
    return m + jnp.log(jnp.exp(x - m) + jnp.exp(y - m) + jnp.exp(z - m))


def _barrier(interpret: bool) -> None:
    if not interpret:
        plgpu.debug_barrier()


def _ctc_fwd_kernel(lp_ref, skip_ref, len_ref, a_ref, p_ref, *,
                    n_labels: int, interpret: bool):
    """One sequence. a_ref/p_ref[b, t] hold the state BEFORE frame t
    (row 0 is the initial state, row T the final one)."""
    b = pl.program_id(0)
    T, Np = lp_ref.shape[1], lp_ref.shape[2]
    col = jax.lax.broadcasted_iota(jnp.int32, (Np,), 0)
    left = jnp.maximum(col - 1, 0)
    skip = skip_ref[b, :]
    length = len_ref[b]

    a0 = jnp.full((Np,), _CTC_NEG, jnp.float32)
    p0 = jnp.where(col == 0, 0.0, _CTC_NEG).astype(jnp.float32)
    a_ref[b, 0, :] = a0
    p_ref[b, 0, :] = p0

    def body(t, carry):
        a, p = carry
        _barrier(interpret)  # row t is visible to every thread
        shift_a = plgpu.load(a_ref.at[b, t, left], mask=col >= 1,
                             other=_CTC_NEG)
        lp = lp_ref[b, t, :]
        lpb = lp_ref[b, t, n_labels]
        new_a = _lse3(a, p, shift_a + skip) + lp
        new_p = _lse2(p, shift_a) + lpb
        valid = t < length
        a = jnp.where(valid, new_a, a)
        p = jnp.where(valid, new_p, p)
        a_ref[b, t + 1, :] = a
        p_ref[b, t + 1, :] = p
        return a, p

    jax.lax.fori_loop(0, T, body, (a0, p0))


def _ctc_bwd_kernel(lp_ref, skip_ref, len_ref, a_ref, p_ref, ga_ref, gp_ref,
                    dlp_ref, g_scr, *, n_labels: int, interpret: bool):
    """Reverse walk. Carries are the adjoints of the state after frame t;
    each step emits d loss / d lp[t] and the adjoint of the state
    before it."""
    b = pl.program_id(0)
    T, Np = lp_ref.shape[1], lp_ref.shape[2]
    col = jax.lax.broadcasted_iota(jnp.int32, (Np,), 0)
    left = jnp.maximum(col - 1, 0)
    right = jnp.minimum(col + 1, Np - 1)
    skip = skip_ref[b, :]
    length = len_ref[b]

    def body(i, carry):
        da, dp = carry
        t = T - 1 - i
        a_prev = a_ref[b, t, :]
        p_prev = p_ref[b, t, :]
        a_cur = a_ref[b, t + 1, :]
        p_cur = p_ref[b, t + 1, :]
        shift_a = plgpu.load(a_ref.at[b, t, left], mask=col >= 1,
                             other=_CTC_NEG)
        lp = lp_ref[b, t, :]
        lpb = lp_ref[b, t, n_labels]

        y_emit = a_cur - lp  # logsumexp of the emit sources
        y_phi = p_cur - lpb
        da_prev = da * jnp.exp(a_prev - y_emit)
        dp_prev = da * jnp.exp(p_prev - y_emit) + dp * jnp.exp(p_prev - y_phi)
        # Adjoint reaching alpha[s - 1] through the shifted sources; it
        # lands one state to the left.
        g = (da * jnp.exp(shift_a + skip - y_emit)
             + dp * jnp.exp(shift_a - y_phi))
        slot = jax.lax.rem(i, 2)
        g_scr[b, slot, :] = g
        _barrier(interpret)
        da_prev = da_prev + plgpu.load(g_scr.at[b, slot, right],
                                       mask=col < Np - 1, other=0.0)

        dlp = jnp.where(col == n_labels, jnp.sum(dp), da)
        valid = t < length
        dlp_ref[b, t, :] = jnp.where(valid, dlp, 0.0)
        return jnp.where(valid, da_prev, da), jnp.where(valid, dp_prev, dp)

    jax.lax.fori_loop(0, T, body, (ga_ref[b, :], gp_ref[b, :]))


def _call(kernel, out_shape, B, Np, interpret):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(B,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_num_warps(Np),
                                             num_stages=1),
        interpret=interpret,
    )


def _ctc_pallas_fwd(lp_full, skip_pen, lengths, n_labels, interpret):
    B, T, Np = lp_full.shape
    hist = jax.ShapeDtypeStruct((B, T + 1, Np), jnp.float32)
    kern = functools.partial(_ctc_fwd_kernel, n_labels=n_labels,
                             interpret=interpret)
    return _call(kern, (hist, hist), B, Np, interpret)(
        lp_full, skip_pen, lengths)


def _ctc_pallas_bwd(lp_full, skip_pen, lengths, a_hist, p_hist, ga, gp,
                    n_labels, interpret):
    B, T, Np = lp_full.shape
    kern = functools.partial(_ctc_bwd_kernel, n_labels=n_labels,
                             interpret=interpret)
    dlp, _ = _call(
        kern,
        (jax.ShapeDtypeStruct((B, T, Np), jnp.float32),
         jax.ShapeDtypeStruct((B, 2, Np), jnp.float32)),
        B, Np, interpret,
    )(lp_full, skip_pen, lengths, a_hist, p_hist, ga, gp)
    return dlp


def _ctc_final(a_hist, p_hist, label_lengths):
    B = a_hist.shape[0]
    idx = jnp.arange(B)
    ll = label_lengths
    phi_end = p_hist[:, -1][idx, ll]
    emit_end = jnp.where(
        ll > 0, a_hist[:, -1][idx, jnp.maximum(ll - 1, 0)], _CTC_NEG
    )
    logp = jnp.logaddexp(phi_end, emit_end)
    return -logp, (phi_end, emit_end, logp)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def ctc_alpha_loss(lp_full, skip_pen, lengths, label_lengths, n_labels,
                   interpret):
    loss, _ = _ctc_alpha_loss_fwd(lp_full, skip_pen, lengths, label_lengths,
                                  n_labels, interpret)
    return loss


def _ctc_alpha_loss_fwd(lp_full, skip_pen, lengths, label_lengths, n_labels,
                        interpret):
    a_hist, p_hist = _ctc_pallas_fwd(lp_full, skip_pen, lengths, n_labels,
                                     interpret)
    loss, (phi_end, emit_end, logp) = _ctc_final(a_hist, p_hist,
                                                 label_lengths)
    res = (lp_full, skip_pen, lengths, label_lengths, a_hist, p_hist,
           phi_end, emit_end, logp)
    return loss, res


def _ctc_alpha_loss_bwd(n_labels, interpret, res, dloss):
    (lp_full, skip_pen, lengths, label_lengths, a_hist, p_hist,
     phi_end, emit_end, logp) = res
    Np = lp_full.shape[2]
    ll = label_lengths
    # d loss_b / d phi_end = -exp(phi_end - logp); same for emit_end.
    g_phi = -dloss * jnp.exp(phi_end - logp)
    g_emit = jnp.where(ll > 0, -dloss * jnp.exp(emit_end - logp), 0.0)
    gp = g_phi[:, None] * jax.nn.one_hot(ll, Np, dtype=jnp.float32)
    ga = g_emit[:, None] * jax.nn.one_hot(jnp.maximum(ll - 1, 0), Np,
                                          dtype=jnp.float32)
    dlp = _ctc_pallas_bwd(lp_full, skip_pen, lengths, a_hist, p_hist, ga, gp,
                          n_labels, interpret)
    zeros_i = tuple(np.zeros(x.shape, dtype=jax.dtypes.float0)
                    for x in (lengths, label_lengths))
    return (dlp, jnp.zeros_like(skip_pen)) + zeros_i


ctc_alpha_loss.defvjp(_ctc_alpha_loss_fwd, _ctc_alpha_loss_bwd)


def pallas_ctc_loss(
    log_probs, labels, input_lengths, label_lengths, blank=None,
    *, interpret: bool = False, time_major: bool = False,
):
    """CTC loss on the Triton kernels; same contract as
    :func:`mgr_tpu.ops.ctc.ctc_loss`.

    Takes (B, T, K) log-probs, or (T, B, K) with ``time_major``.
    Differentiable w.r.t. ``log_probs`` through the custom VJP. The
    emission gather is one batched einsum in full float32 precision
    whose layout change absorbs ``time_major``. ``interpret=True`` runs
    the kernels in the Pallas interpreter (CPU tests).
    """
    if time_major:
        T, B, K = log_probs.shape
    else:
        B, T, K = log_probs.shape
    N = labels.shape[1]
    if blank is None:
        blank = K - 1
    log_probs = log_probs.astype(jnp.float32)
    labels_s = jnp.where(labels < 0, 0, labels).astype(jnp.int32)
    input_lengths = input_lengths.astype(jnp.int32).reshape(B)
    label_lengths = label_lengths.astype(jnp.int32).reshape(B)

    Np = state_width(N)
    onehot = jax.nn.one_hot(labels_s, K, dtype=jnp.float32)  # (B, N, K)
    hi = jax.lax.Precision.HIGHEST
    if time_major:
        lp_emit = jnp.einsum("tbk,bnk->btn", log_probs, onehot, precision=hi)
        lp_phi = jnp.swapaxes(log_probs[:, :, blank], 0, 1)  # (B, T)
    else:
        lp_emit = jnp.einsum("btk,bnk->btn", log_probs, onehot, precision=hi)
        lp_phi = log_probs[:, :, blank]
    lp_full = jnp.concatenate(
        [lp_emit, lp_phi[:, :, None],
         jnp.full((B, T, Np - N - 1), _CTC_NEG, jnp.float32)],
        axis=2,
    )

    same = labels_s[:, 1:] == labels_s[:, :-1]  # (B, N-1)
    skip_pen = jnp.concatenate(
        [jnp.full((B, 1), _CTC_NEG),  # state 0 has no emit two back
         jnp.where(same, _CTC_NEG, 0.0),
         jnp.zeros((B, Np - N), jnp.float32)],
        axis=1,
    ).astype(jnp.float32)

    return ctc_alpha_loss(lp_full, skip_pen, input_lengths, label_lengths,
                          N, interpret)
