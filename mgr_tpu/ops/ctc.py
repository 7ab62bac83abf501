"""CTC loss: log-space forward recursion, XLA-autodiff backward.

Replacement for the reference's ``K.ctc_batch_cost`` call
(/root/reference/audio_network/losses.py:4-15 — TF 1.12's C++ CTC op).
Conventions preserved from the reference (see SURVEY.md §2.2):

  * blank label index = nb_classes - 1
    (/root/reference/audio_network/data_generator.py:42)
  * label sequences padded with -1
    (/root/reference/audio_network/data_generator.py:217-220)
  * the first ``trim_frames`` RNN outputs are dropped before the loss and
    ``input_length`` already excludes them
    (/root/reference/audio_network/losses.py:9-11,
     /root/reference/audio_network/data_generator.py:223)

Design notes:

  The classic lattice formulation walks a (T, 2L+1) trellis with a
  per-step gather of label scores. We instead use the phi/emit split
  (the canonical JAX CTC factorization): emission scores for all labels
  are pre-gathered in ONE batched matmul
  ``einsum('btk,bnk->tbn', log_probs, onehot(labels))`` in full float32
  precision, and the time scan then carries two dense vectors,
  alpha_phi (B, N+1) and alpha_emit (B, N), using only element-wise
  ops. The backward recursion of this plain path is never hand-written:
  the loss is a composition of logaddexp under ``lax.scan``, so XLA
  autodiff produces the standard CTC gradient. On the GPU the same
  recursion also runs as a Triton kernel with a hand-derived adjoint
  (mgr_tpu.ops.pallas_kernels), chosen by mgr_tpu.ops.dispatch.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mgr_tpu.ops import dispatch as _dispatch

_LOG_EPS = -1e5  # effectively -inf but safe for autodiff (no nan * 0)


def ctc_loss(
    log_probs: jax.Array,
    labels: jax.Array,
    input_lengths: jax.Array,
    label_lengths: jax.Array,
    blank: Optional[int] = None,
    unroll: int = 1,
    backend: str = "auto",
    time_major: bool = False,
) -> jax.Array:
    """Per-sequence negative log-likelihood, shape (B,).

    Args:
      log_probs: (B, T, K) log-probabilities (e.g. ``jax.nn.log_softmax``),
        or (T, B, K) with ``time_major``.
      labels: (B, N) int labels; positions >= label_length may hold any
        value (the reference pads with -1).
      input_lengths: (B,) valid frame counts (<= T).
      label_lengths: (B,) valid label counts (<= N). A length of 0 is
        scored as "emit only blanks".
      blank: blank class index; defaults to K - 1 (the reference's
        convention, data_generator.py:42).
      backend: "auto" (the Triton kernel where mgr_tpu.ops.dispatch
        allows it, the lax.scan recursion elsewhere), "pallas" (the
        kernel; raises off the GPU), or "xla" (the scan).
    """
    if backend == "pallas" or (backend == "auto" and _dispatch.pallas_ok()):
        _dispatch.require_gpu()
        from mgr_tpu.ops.pallas_kernels import pallas_ctc_loss

        return pallas_ctc_loss(
            log_probs, labels, input_lengths, label_lengths, blank,
            time_major=time_major,
        )
    if time_major:
        T, B, K = log_probs.shape
    else:
        B, T, K = log_probs.shape
    N = labels.shape[1]
    if blank is None:
        blank = K - 1

    # At least float32 (float64 stays: the on-card reference runs in it).
    dtype = jnp.promote_types(log_probs.dtype, jnp.float32)
    log_probs = log_probs.astype(dtype)
    labels = jnp.where(labels < 0, 0, labels).astype(jnp.int32)
    input_lengths = input_lengths.astype(jnp.int32).reshape(B)
    label_lengths = label_lengths.astype(jnp.int32).reshape(B)

    # Pre-gather emission scores with one batched matmul that emits the
    # scan's time-major layout directly (full f32: these are scores).
    onehot = jax.nn.one_hot(labels, K, dtype=log_probs.dtype)  # (B, N, K)
    lp_emit_t = jnp.einsum(
        "tbk,bnk->tbn" if time_major else "btk,bnk->tbn",
        log_probs, onehot, precision=jax.lax.Precision.HIGHEST,
    )  # (T, B, N)
    lp_phi_t = log_probs[:, :, blank]
    if not time_major:
        lp_phi_t = lp_phi_t.T  # (T, B)

    # Direct emit[n-1] -> emit[n] transition is illegal when the labels
    # repeat (CTC requires a blank between equal labels).
    same = labels[:, 1:] == labels[:, :-1]  # (B, N-1)
    skip_penalty = jnp.where(same, _LOG_EPS, 0.0)  # add to emit[n-1] source

    alpha_phi0 = jnp.full((B, N + 1), _LOG_EPS, dtype=dtype)
    alpha_phi0 = alpha_phi0.at[:, 0].set(0.0)
    alpha_emit0 = jnp.full((B, N), _LOG_EPS, dtype=dtype)

    time_idx = jnp.arange(T, dtype=jnp.int32)

    def step(carry, xs):
        alpha_phi, alpha_emit = carry
        lp_e, lp_b, t = xs  # (B, N), (B,), ()

        # Sources reaching emit[n]: stay on emit[n] (repeat the symbol),
        # come from phi[n] (blank before label n), or skip directly from
        # emit[n-1] when labels differ.
        prev_emit_shift = jnp.concatenate(
            [jnp.full((B, 1), _LOG_EPS, dtype),
             alpha_emit[:, :-1] + skip_penalty],
            axis=1,
        )
        new_emit = (
            jnp.logaddexp(
                jnp.logaddexp(alpha_emit, alpha_phi[:, :N]), prev_emit_shift
            )
            + lp_e
        )

        # Sources reaching phi[n]: stay in phi[n], or finish emit[n-1].
        emit_shift = jnp.concatenate(
            [jnp.full((B, 1), _LOG_EPS, dtype), alpha_emit], axis=1
        )
        new_phi = jnp.logaddexp(alpha_phi, emit_shift) + lp_b[:, None]

        # Frames at/after input_length leave the carry unchanged.
        valid = (t < input_lengths)[:, None]
        new_phi = jnp.where(valid, new_phi, alpha_phi)
        new_emit = jnp.where(valid, new_emit, alpha_emit)
        return (new_phi, new_emit), None

    (alpha_phi, alpha_emit), _ = jax.lax.scan(
        step, (alpha_phi0, alpha_emit0), (lp_emit_t, lp_phi_t, time_idx),
        unroll=unroll,
    )

    # Accept in phi[N_b] (ended on a blank) or emit[N_b - 1] (ended on the
    # last label).
    idx = jnp.arange(B)
    final_phi = alpha_phi[idx, label_lengths]
    final_emit = jnp.where(
        label_lengths > 0,
        alpha_emit[idx, jnp.maximum(label_lengths - 1, 0)],
        _LOG_EPS,
    )
    return -jnp.logaddexp(final_phi, final_emit)


def ctc_loss_from_logits(
    logits: jax.Array,
    labels: jax.Array,
    input_lengths: jax.Array,
    label_lengths: jax.Array,
    blank: Optional[int] = None,
    trim_frames: int = 0,
    time_major: bool = False,
) -> jax.Array:
    """CTC loss from unnormalized logits, with the reference's leading-
    frame trim (losses.py:9-11). ``input_lengths`` must already exclude
    the trimmed frames, matching data_generator.py:223.

    ``time_major`` accepts (T, B, K) logits directly from the
    time-major model path; the emission-gather einsum absorbs the
    layout, so the large activation never transposes."""
    if trim_frames:
        logits = logits[trim_frames:] if time_major else \
            logits[:, trim_frames:, :]
    log_probs = jax.nn.log_softmax(logits, axis=-1)
    return ctc_loss(log_probs, labels, input_lengths, label_lengths, blank,
                    time_major=time_major)


# ---------------------------------------------------------------------------
# NumPy reference implementation (tests only): the classic (T, 2L+1)
# lattice forward pass, O(T * S) per sequence. Deliberately independent
# of the JAX formulation above so the two cross-check each other.
# ---------------------------------------------------------------------------

def ctc_loss_reference(
    log_probs: np.ndarray,
    labels: np.ndarray,
    input_length: int,
    label_length: int,
    blank: Optional[int] = None,
) -> float:
    """Single-sequence CTC NLL via the extended-label lattice."""
    T, K = log_probs.shape
    if blank is None:
        blank = K - 1
    lab = [int(x) for x in labels[:label_length]]
    # Extended sequence: blank, l1, blank, l2, ..., lN, blank.
    ext = [blank]
    for l in lab:
        ext += [l, blank]
    S = len(ext)

    neg_inf = -np.inf
    alpha = np.full(S, neg_inf)
    alpha[0] = log_probs[0, ext[0]]
    if S > 1:
        alpha[1] = log_probs[0, ext[1]]

    def lse(*xs):
        xs = [x for x in xs if x != neg_inf]
        if not xs:
            return neg_inf
        m = max(xs)
        return m + np.log(sum(np.exp(x - m) for x in xs))

    for t in range(1, input_length):
        new = np.full(S, neg_inf)
        for s in range(S):
            cands = [alpha[s]]
            if s >= 1:
                cands.append(alpha[s - 1])
            if s >= 2 and ext[s] != blank and ext[s] != ext[s - 2]:
                cands.append(alpha[s - 2])
            new[s] = lse(*cands) + log_probs[t, ext[s]]
        alpha = new

    if S == 1:
        total = alpha[0]
    else:
        total = lse(alpha[S - 1], alpha[S - 2])
    return float(-total)


def ctc_loss_reference_batch(
    log_probs: np.ndarray,
    labels: np.ndarray,
    input_lengths: np.ndarray,
    label_lengths: np.ndarray,
    blank: Optional[int] = None,
) -> np.ndarray:
    return np.array(
        [
            ctc_loss_reference(
                log_probs[b], labels[b], int(input_lengths[b]),
                int(label_lengths[b]), blank,
            )
            for b in range(log_probs.shape[0])
        ]
    )
