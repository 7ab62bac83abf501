"""Fused BLSTM scan vs a straightforward NumPy step-by-step LSTM with
Keras-2 semantics (ifgo gates, tanh / hard_sigmoid, unit forget bias)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgr_tpu.ops import lstm


def _np_hard_sigmoid(x):
    return np.clip(0.2 * x + 0.5, 0.0, 1.0)


def _fused(params, d=None):
    """Gate-blocked (F,4,H)/(H,4,H)/(4,H) -> fused (F,4H)/(H,4H)/(4H,)."""
    W, U, b = (np.asarray(params[k]) for k in ("W", "U", "b"))
    if d is not None:
        W, U, b = W[d], U[d], b[d]
    F, _, H = W.shape
    return W.reshape(F, 4 * H), U.reshape(H, 4 * H), b.reshape(4 * H)


def _np_lstm(W, U, b, x, reverse=False):
    """x: (B, T, F) -> (B, T, H). Plain per-step NumPy recurrence."""
    B, T, F = x.shape
    H = U.shape[0]
    if reverse:
        x = x[:, ::-1, :]
    h = np.zeros((B, H), np.float32)
    c = np.zeros((B, H), np.float32)
    out = np.zeros((B, T, H), np.float32)
    for t in range(T):
        z = x[:, t, :] @ W + h @ U + b
        i = _np_hard_sigmoid(z[:, :H])
        f = _np_hard_sigmoid(z[:, H : 2 * H])
        g = np.tanh(z[:, 2 * H : 3 * H])
        o = _np_hard_sigmoid(z[:, 3 * H :])
        c = f * c + i * g
        h = o * np.tanh(c)
        out[:, t, :] = h
    if reverse:
        out = out[:, ::-1, :]
    return out


def test_single_direction_matches_numpy():
    rng = jax.random.key(0)
    B, T, F, H = 3, 11, 7, 5
    params = lstm.init_lstm_params(rng, F, H)
    x = np.asarray(
        jax.random.normal(jax.random.key(1), (B, T, F)), np.float32
    )
    got = np.asarray(
        lstm.lstm_layer(params, jnp.asarray(x), compute_dtype=jnp.float32)
    )
    W, U, b = _fused(params)
    want = _np_lstm(W, U, b, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_reverse_direction_matches_numpy():
    rng = jax.random.key(2)
    B, T, F, H = 2, 9, 4, 6
    params = lstm.init_lstm_params(rng, F, H)
    x = np.asarray(
        jax.random.normal(jax.random.key(3), (B, T, F)), np.float32
    )
    got = np.asarray(
        lstm.lstm_layer(
            params, jnp.asarray(x), reverse=True, compute_dtype=jnp.float32
        )
    )
    W, U, b = _fused(params)
    want = _np_lstm(W, U, b, x, reverse=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bilstm_matches_two_numpy_directions():
    rng = jax.random.key(4)
    B, T, F, H = 2, 8, 5, 4
    params = lstm.init_bilstm_params(rng, F, H)
    x = np.asarray(
        jax.random.normal(jax.random.key(5), (B, T, F)), np.float32
    )
    got = np.asarray(
        lstm.bilstm_layer(params, jnp.asarray(x), compute_dtype=jnp.float32)
    )
    Wf, Uf, bf = _fused(params, 0)
    Wb, Ub, bb = _fused(params, 1)
    fwd = _np_lstm(Wf, Uf, bf, x)
    bwd = _np_lstm(Wb, Ub, bb, x, reverse=True)
    want = np.concatenate([fwd, bwd], axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_unit_forget_bias_and_shapes():
    params = lstm.init_bilstm_params(jax.random.key(0), 3, 4)
    b = np.asarray(params["b"])
    assert b.shape == (2, 4, 4)
    np.testing.assert_array_equal(b[:, 1, :], 1.0)  # forget gate block
    np.testing.assert_array_equal(b[:, 0, :], 0.0)


def test_dropout_only_in_train_mode():
    rng = jax.random.key(6)
    params = lstm.init_bilstm_params(rng, 5, 4)
    x = jax.random.normal(jax.random.key(7), (2, 6, 5))
    eval_out = lstm.bilstm_layer(
        params, x, dropout=0.5, train=False, compute_dtype=jnp.float32
    )
    eval_out2 = lstm.bilstm_layer(
        params, x, dropout=0.5, train=False, compute_dtype=jnp.float32
    )
    np.testing.assert_array_equal(np.asarray(eval_out), np.asarray(eval_out2))

    tr1 = lstm.bilstm_layer(
        params, x, dropout=0.5, train=True, rng=jax.random.key(8),
        compute_dtype=jnp.float32,
    )
    tr2 = lstm.bilstm_layer(
        params, x, dropout=0.5, train=True, rng=jax.random.key(9),
        compute_dtype=jnp.float32,
    )
    assert not np.allclose(np.asarray(tr1), np.asarray(tr2))


def test_per_gate_dropout_runs_and_zero_rate_matches_eval():
    rng = jax.random.key(10)
    params = lstm.init_bilstm_params(rng, 5, 4)
    x = jax.random.normal(jax.random.key(11), (2, 6, 5))
    out = lstm.bilstm_layer(
        params, x, dropout=0.4, per_gate=True, train=True,
        rng=jax.random.key(12), compute_dtype=jnp.float32,
    )
    assert out.shape == (2, 6, 8)
    # rate 0 in train mode == eval mode exactly.
    a = lstm.bilstm_layer(
        params, x, dropout=0.0, train=True, rng=jax.random.key(13),
        compute_dtype=jnp.float32,
    )
    b = lstm.bilstm_layer(params, x, compute_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_gradients_flow():
    params = lstm.init_bilstm_params(jax.random.key(14), 4, 3)
    x = jax.random.normal(jax.random.key(15), (2, 5, 4))

    def loss(p):
        return jnp.sum(
            lstm.bilstm_layer(p, x, compute_dtype=jnp.float32) ** 2
        )

    grads = jax.grad(loss)(params)
    for k, g in grads.items():
        assert np.all(np.isfinite(np.asarray(g))), k
        assert np.any(np.asarray(g) != 0.0), k


def test_remat_chunked_scan_matches_plain():
    params = lstm.init_bilstm_params(jax.random.key(20), 5, 6)
    x = jax.random.normal(jax.random.key(21), (2, 70, 5))  # T % chunk != 0
    plain = lstm.bilstm_layer(params, x, compute_dtype=jnp.float32)
    rem = lstm.bilstm_layer(params, x, compute_dtype=jnp.float32,
                            remat=True)
    np.testing.assert_allclose(
        np.asarray(rem), np.asarray(plain), rtol=1e-5, atol=1e-6
    )

    def loss(p, use_remat):
        return jnp.sum(
            lstm.bilstm_layer(p, x, compute_dtype=jnp.float32,
                              remat=use_remat) ** 2
        )

    g_plain = jax.grad(lambda p: loss(p, False))(params)
    g_rem = jax.grad(lambda p: loss(p, True))(params)
    for a, b in zip(jax.tree.leaves(g_plain), jax.tree.leaves(g_rem)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6
        )


def _ref_bilstm_tm(params, x_tm):
    """Straightforward per-step jnp recurrence, one direction at a time,
    fused (F, 4H) weights — independent of lstm.py's batched scan."""
    outs = []
    for d, reverse in ((0, False), (1, True)):
        W, U, b = (params[k][d] for k in ("W", "U", "b"))
        F, _, H = W.shape
        W, U, b = W.reshape(F, 4 * H), U.reshape(H, 4 * H), b.reshape(-1)
        xs = x_tm[::-1] if reverse else x_tm
        h = c = jnp.zeros((x_tm.shape[1], H))
        hs = []
        for t in range(x_tm.shape[0]):
            z = xs[t] @ W + h @ U + b
            i = lstm.hard_sigmoid(z[:, :H])
            f = lstm.hard_sigmoid(z[:, H:2 * H])
            g = jnp.tanh(z[:, 2 * H:3 * H])
            o = lstm.hard_sigmoid(z[:, 3 * H:])
            c = f * c + i * g
            h = o * jnp.tanh(c)
            hs.append(h)
        hs = jnp.stack(hs)
        outs.append(hs[::-1] if reverse else hs)
    return jnp.concatenate(outs, axis=-1)


@pytest.mark.parametrize("remat", [False, True], ids=["scan", "remat"])
@pytest.mark.parametrize("what", ["forward", "grad_params", "grad_inputs"])
def test_time_major_bilstm_matches_reference(what, remat):
    """The production path (bilstm_layer_tm: time-major scan, no layout
    round trip) against a plain per-step recurrence, values and
    gradients. T=67 is not a multiple of the remat chunk."""
    params = lstm.init_bilstm_params(jax.random.key(40), 5, 6)
    x_tm = jax.random.normal(jax.random.key(41), (67, 3, 5))
    tang = jax.random.normal(jax.random.key(42), (67, 3, 12))

    def run(fn):
        if what == "forward":
            return fn(params, x_tm)
        loss = lambda p, x: jnp.sum(fn(p, x) * tang)  # noqa: E731
        return jax.grad(loss, argnums=0 if what == "grad_params" else 1)(
            params, x_tm)

    got = run(lambda p, x: lstm.bilstm_layer_tm(
        p, x, compute_dtype=jnp.float32, remat=remat))
    want = run(_ref_bilstm_tm)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
