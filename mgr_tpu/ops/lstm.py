"""Fused bidirectional LSTM scan with Keras-2 semantics.

Replacement for the reference's ``keras.layers.LSTM`` inside
``Bidirectional(..., merge_mode='concat')`` stacks
(/root/reference/audio_network/speech_lstm_ctc_words.py:56-77).

Semantics preserved (each silently changes accuracy if dropped —
SURVEY.md §7 "hard parts" item 3):
  * gate order i, f, g(c), o; activation tanh; recurrent_activation
    hard_sigmoid (clip(0.2x + 0.5, 0, 1)) — Keras 2.1.4 defaults used
    explicitly at speech_lstm_ctc_words.py:58-59.
  * kernel init RandomUniform(+-0.05) (speech_lstm_ctc_words.py:42-44),
    recurrent kernel orthogonal, bias zeros with unit forget bias
    (Keras LSTM defaults).
  * input dropout with masks constant over time; Keras draws one mask per
    gate — we default to a single shared mask (keeps the hoisted input
    projection one matmul) with ``per_gate=True`` for strict parity.
  * recurrent_dropout = 0 everywhere in the reference; not implemented.

Design:
  * The input projection x @ W for ALL timesteps is hoisted out of the
    recurrence into one large bf16 matmul. The ``lax.scan`` step only
    computes the (B, H) @ (H, 4H) recurrent matmul plus gate math.
  * Forward and backward directions run as ONE batched scan: weights are
    stacked on a leading direction axis, so the recurrent matmul per step
    is a single (2, B, H) @ (2, H, 4H) batched matmul instead of two
    serial scans.
  * Every large tensor is time-major (T, ...): the scan consumes the
    projections and emits the h stream without layout copies.
  * Weights are stored gate-blocked as (..., 4, H) rather than a fused
    4H axis. Gate selection is then a static index on the size-4 axis,
    and tensor parallelism shards the trailing H axis cleanly: each
    device owns all four gates for a block of hidden units, and the
    recurrent contraction over the (sharded) carry H produces the psum
    XLA inserts automatically under pjit (Megatron-style RNN TP).
  * Cell state stays float32; matmul operands are cast to
    ``compute_dtype`` (bfloat16 by default).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from mgr_tpu.ops import dispatch as _dispatch

Params = Dict[str, jax.Array]


def hard_sigmoid(x: jax.Array) -> jax.Array:
    """Keras hard_sigmoid: piecewise-linear sigmoid, clip(0.2x+0.5, 0, 1)."""
    return jnp.clip(0.2 * x + 0.5, 0.0, 1.0)


def init_lstm_params(
    rng: jax.Array, in_dim: int, hidden: int, kernel_scale: float = 0.05
) -> Params:
    """One direction's parameters, gate-blocked:
    W (F, 4, H), U (H, 4, H), b (4, H); gate order i, f, g, o."""
    k_w, k_u = jax.random.split(rng)
    W = jax.random.uniform(
        k_w, (in_dim, 4, hidden), minval=-kernel_scale, maxval=kernel_scale,
        dtype=jnp.float32,
    )
    # Keras initializes the fused (H, 4H) recurrent kernel as one
    # orthogonal matrix; reshape to the gate-blocked layout.
    U = jax.nn.initializers.orthogonal()(
        k_u, (hidden, 4 * hidden), jnp.float32
    ).reshape(hidden, 4, hidden)
    b = jnp.zeros((4, hidden), jnp.float32)
    b = b.at[1].set(1.0)  # unit forget-gate bias (Keras unit_forget_bias)
    return {"W": W, "U": U, "b": b}


def init_bilstm_params(
    rng: jax.Array, in_dim: int, hidden: int, kernel_scale: float = 0.05
) -> Params:
    """Stacked fwd/bwd parameters with a leading direction axis (2, ...)."""
    k_f, k_b = jax.random.split(rng)
    fwd = init_lstm_params(k_f, in_dim, hidden, kernel_scale)
    bwd = init_lstm_params(k_b, in_dim, hidden, kernel_scale)
    return {k: jnp.stack([fwd[k], bwd[k]]) for k in fwd}


def _project_tm(
    x2: jax.Array,
    W: jax.Array,
    b: jax.Array,
    dirs,
    *,
    rng: Optional[jax.Array],
    dropout: float,
    per_gate: bool,
    train: bool,
    compute_dtype,
) -> jax.Array:
    """Input projection for all timesteps at once.

    x2: (T, D, B, F) per-direction inputs, W: (D, F, 4, H), b: (D, 4, H)
    -> (T, D, B, 4, H) in compute dtype. Direction slot i draws its
    dropout mask (constant over time) from ``fold_in(rng, dirs[i])``.
    """
    _, D, B, F = x2.shape
    xc = x2.astype(compute_dtype)
    Wc = W.astype(compute_dtype)
    bias = b[None, :, None]
    if train and dropout > 0.0:
        keep = 1.0 - dropout
        shape = (4, B, F) if per_gate else (B, F)
        mask = jnp.stack([
            jax.random.bernoulli(jax.random.fold_in(rng, d), keep, shape)
            for d in dirs
        ]).astype(compute_dtype) / keep  # (D, [4,] B, F)
        if per_gate:
            # Keras-exact: one mask per gate.
            xg = xc[None] * jnp.moveaxis(mask, 1, 0)[:, None]
            xp = jnp.einsum("gtdbf,dfgh->tdbgh", xg, Wc,
                            preferred_element_type=jnp.float32)
            return (xp + bias).astype(compute_dtype)
        xc = xc * mask[None]
    xp = jnp.einsum("tdbf,dfgh->tdbgh", xc, Wc,
                    preferred_element_type=jnp.float32)
    # The projection is the dominant activation buffer (4H >> F): keep
    # it in compute dtype; gate math re-accumulates in f32 in the scan.
    return (xp + bias).astype(compute_dtype)


def _lstm_step(Uc, compute_dtype):
    """Scan body over (D, B, ...) carries: one batched (D, B, H) @
    (D, H, 4H) product plus the gate math for every direction."""

    def step(carry, z):
        h, c = carry  # (D, B, H) f32 each
        gates = z.astype(jnp.float32) + jnp.einsum(
            "dbh,dhgk->dbgk", h.astype(compute_dtype), Uc,
            preferred_element_type=jnp.float32,
        )
        i = hard_sigmoid(gates[:, :, 0])
        f = hard_sigmoid(gates[:, :, 1])
        g = jnp.tanh(gates[:, :, 2])
        o = hard_sigmoid(gates[:, :, 3])
        c_new = f * c + i * g
        h_new = o * jnp.tanh(c_new)
        # Carries stay f32 for recurrence stability; the emitted stream
        # is compute dtype (it feeds the next layer's matmul).
        return (h_new, c_new), h_new.astype(compute_dtype)

    return step


def _recurrent_scan(
    xp: jax.Array, U: jax.Array, compute_dtype, unroll: int = 8
) -> jax.Array:
    """xp: (T, D, B, 4, H) time-major projections; U: (D, H, 4, H)
    -> h (T, D, B, H). One scan over time for all D directions."""
    _, D, B, _, H = xp.shape
    step = _lstm_step(U.astype(compute_dtype), compute_dtype)
    zeros = jnp.zeros((D, B, H), jnp.float32)
    _, hs = jax.lax.scan(step, (zeros, zeros), xp, unroll=unroll)
    return hs


def _recurrent_scan_remat(
    xp: jax.Array, U: jax.Array, compute_dtype, chunk: int = 64
) -> jax.Array:
    """Memory-light :func:`_recurrent_scan`: a scan over time CHUNKS
    whose body is ``jax.checkpoint``-ed, so backward recomputes one
    chunk's activations at a time and residual memory is O(T/chunk
    carries + one chunk) instead of O(T) (SURVEY.md §5.7). Wrapping the
    whole layer in checkpoint instead blows up compile time;
    scan-of-checkpointed-chunks keeps the HLO linear."""
    T, D, B, _, H = xp.shape
    step = _lstm_step(U.astype(compute_dtype), compute_dtype)
    Tp = -(-T // chunk) * chunk
    if Tp != T:
        xp = jnp.pad(xp, ((0, Tp - T),) + ((0, 0),) * 4)
    xs = xp.reshape((Tp // chunk, chunk) + xp.shape[1:])

    @jax.checkpoint
    def chunk_body(carry, xs_chunk):
        return jax.lax.scan(step, carry, xs_chunk)

    zeros = jnp.zeros((D, B, H), jnp.float32)
    _, hs = jax.lax.scan(chunk_body, (zeros, zeros), xs)
    return hs.reshape((Tp, D, B, H))[:T]


def bilstm_layer_tm(
    params: Params,
    x_tm: jax.Array,
    *,
    rng: Optional[jax.Array] = None,
    dropout: float = 0.0,
    per_gate: bool = False,
    train: bool = False,
    compute_dtype=jnp.bfloat16,
    unroll: int = 8,
    remat: bool = False,
) -> jax.Array:
    """Bidirectional LSTM, merge_mode='concat': (T, B, F) -> (T, B, 2H).

    ``params`` comes from :func:`init_bilstm_params` (direction-stacked).
    Every large tensor stays time-major: direction 1 projects the
    time-reversed input (the small F-wide tensor is the one flipped),
    both directions run as one scan, and only the h stream of direction
    1 flips back. ``remat=True`` uses the chunked-remat recurrence
    (memory O(one chunk) instead of O(T) in backward).
    """
    if train and dropout > 0.0 and rng is None:
        raise ValueError("dropout requires an rng key in train mode")
    dir_axis = _dispatch.direction_shard_axis()
    if dir_axis is not None:
        # Tensor-parallel context (ops.dispatch.direction_shard): this
        # device computes one direction only. Refuse remat rather than
        # silently drop a caller's memory plan.
        if remat:
            raise NotImplementedError(
                "remat is not supported under direction-sharded TP; "
                "drop remat=True or use the GSPMD (non-dirsharded) path"
            )
        return bilstm_layer_tm_dirsharded(
            params, x_tm, axis=dir_axis, rng=rng, dropout=dropout,
            per_gate=per_gate, train=train, compute_dtype=compute_dtype,
            unroll=unroll,
        )
    x2 = jnp.stack([x_tm, jnp.flip(x_tm, axis=0)], axis=1)  # (T, 2, B, F)
    xp = _project_tm(
        x2, params["W"], params["b"], (0, 1), rng=rng, dropout=dropout,
        per_gate=per_gate, train=train, compute_dtype=compute_dtype,
    )
    if remat:
        hs = _recurrent_scan_remat(xp, params["U"], compute_dtype)
    else:
        hs = _recurrent_scan(xp, params["U"], compute_dtype, unroll)
    return jnp.concatenate(
        [hs[:, 0], jnp.flip(hs[:, 1], axis=0)], axis=-1
    ).astype(compute_dtype)


def bilstm_layer_tm_dirsharded(
    params: Params,
    x_tm: jax.Array,
    *,
    axis: str,
    rng: Optional[jax.Array] = None,
    dropout: float = 0.0,
    per_gate: bool = False,
    train: bool = False,
    compute_dtype=jnp.bfloat16,
    unroll: int = 8,
) -> jax.Array:
    """Direction-sharded BLSTM for tensor parallelism: (T, B, F) ->
    (T, B, 2H) inside a ``shard_map`` body whose mesh axis ``axis`` has
    size 2. Device d computes ONLY direction d (its projection and its
    scan), then the two h streams all_gather over ``axis`` and concat.
    The serial per-step chain halves per device with zero per-step
    collectives; weights stay replicated (an H-sharded variant would
    psum every one of the T steps).

    Numerics match :func:`bilstm_layer_tm`: same projection math, same
    per-direction dropout keys (fold_in(rng, d)), same scan step.
    """
    if train and dropout > 0.0 and rng is None:
        raise ValueError("dropout requires an rng key in train mode")
    d = jax.lax.axis_index(axis)
    # Dynamic gather of direction d's weights: the gradient scatters
    # back into slot d of the stacked (2, ...) params, so a psum over
    # ``axis`` reassembles the full dW/dU/db (train.step's grad rule).
    xp = _project_tm(
        x_tm[:, None], params["W"][d][None], params["b"][d][None], (d,),
        rng=rng, dropout=dropout, per_gate=per_gate, train=train,
        compute_dtype=compute_dtype,
    )
    Ud = params["U"][d][None]

    def scan_one(reverse):
        def run(xp_, U_):
            x_in = jnp.flip(xp_, axis=0) if reverse else xp_
            hs_ = _recurrent_scan(x_in, U_, compute_dtype, unroll)[:, 0]
            return jnp.flip(hs_, axis=0) if reverse else hs_
        return run

    hs = jax.lax.cond(d == 0, scan_one(False), scan_one(True), xp, Ud)
    both = jax.lax.all_gather(hs.astype(compute_dtype), axis)  # (2,T,B,H)
    return jnp.concatenate([both[0], both[1]], axis=-1)


def bilstm_layer(params: Params, x: jax.Array, **kwargs) -> jax.Array:
    """Batch-major :func:`bilstm_layer_tm`: (B, T, F) -> (B, T, 2H)."""
    out = bilstm_layer_tm(params, jnp.swapaxes(x, 0, 1), **kwargs)
    return jnp.swapaxes(out, 0, 1)


def lstm_layer(
    params: Params,
    x: jax.Array,
    *,
    reverse: bool = False,
    compute_dtype=jnp.bfloat16,
    unroll: int = 8,
) -> jax.Array:
    """Single-direction LSTM (no dropout): (B, T, F) -> (B, T, H)."""
    xi = jnp.flip(x, axis=1) if reverse else x
    xp = _project_tm(
        jnp.swapaxes(xi, 0, 1)[:, None], params["W"][None],
        params["b"][None], (0,), rng=None, dropout=0.0, per_gate=False,
        train=False, compute_dtype=compute_dtype,
    )
    hs = _recurrent_scan(xp, params["U"][None], compute_dtype, unroll)
    hs = jnp.swapaxes(hs[:, 0], 0, 1)
    return jnp.flip(hs, axis=1) if reverse else hs
