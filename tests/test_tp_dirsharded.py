"""Direction-sharded tensor parallelism.

A BLSTM's two scan directions are independent serial chains, so a
size-2 'model' mesh axis can run one direction per device with ZERO
per-step collectives — the honest TP for a 2-direction RNN (an H-shard
would psum every one of the T steps). These tests assert:

  (a) under dp x tp2 each device runs one direction's scan and the CTC
      kernel stays eligible per device;
  (b) the dp x tp2 shard_map train/eval steps match single-device
      numerics exactly (noise/dropout off);
  (c) the grad-combine rule (psum for direction-scattered blstm leaves,
      pmean for shared leaves) reassembles the single-device gradient;
  (d) mesh routing: dp x tp2 -> shard_map fast path, model>2 or
      time>1 -> GSPMD.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgr_tpu.core import config as cfglib
from mgr_tpu.core import prng
from mgr_tpu.models import build_model
from mgr_tpu.ops import dispatch, lstm
from mgr_tpu.parallel import make_mesh, shard_batch, shard_params
from mgr_tpu.parallel.sharding import shardmap_axes
from mgr_tpu.train import create_train_state, make_eval_step, make_train_step
from mgr_tpu.train.step import _combine_model_grads, _loss_and_grads

N_DEV = 8


# ---------------------------------------------------------------------------
# (b)+(c) dp x tp2 shard_map steps vs single device
# ---------------------------------------------------------------------------

def _cfg(batch):
    enc = cfglib.EncoderConfig(
        hidden=8, depth=2, input_noise=0.0, dropout=(0.0, 0.0),
        output_dropout=0.0,
    )
    return cfglib.get_preset("speech").replace(
        maxlen=24, num_feats=5, nb_classes=6, max_label_len=4,
        batch_size=batch, encoder=enc, compute_dtype="float32",
    )


def _batch(cfg):
    B = cfg.batch_size
    rng = np.random.default_rng(0)
    return {
        "inputs": jnp.asarray(
            rng.standard_normal((B, cfg.maxlen, cfg.num_feats)).astype(
                np.float32
            )
        ),
        "labels": jnp.asarray(
            np.pad(
                rng.integers(0, cfg.nb_classes - 1, size=(B, 2)),
                ((0, 0), (0, cfg.max_label_len - 2)),
                constant_values=-1,
            ).astype(np.int32)
        ),
        "input_length": jnp.full((B,), cfg.maxlen - 2, jnp.int32),
        "label_length": jnp.full((B,), 2, jnp.int32),
    }


def _tp_mesh():
    return make_mesh(cfglib.MeshConfig(data=N_DEV // 2, model=2))


def _run_step(cfg, mesh, mode):
    """One train step; mode "pallas" needs the triton_interpret
    fixture (kernel in the interpreter on this CPU backend)."""
    model = build_model(cfg)
    state = create_train_state(model, prng.root_key(0))
    batch = _batch(cfg)
    if mesh is not None:
        state = state._replace(params=shard_params(state.params, mesh))
        batch = shard_batch(batch, mesh)
    step = make_train_step(model, mesh=mesh)
    dispatch.set_mode(mode)
    try:
        state, m = step(state, batch, jax.random.key(7), 1.0)
        loss = float(m["loss"])
        params = jax.tree.map(np.asarray, state.params)
    finally:
        dispatch.set_mode("auto")
    return loss, params


@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_dirsharded_step_matches_single_device(mode, request):
    if mode == "pallas":
        request.getfixturevalue("triton_interpret")
    cfg = _cfg(batch=2 * N_DEV)
    loss_tp, params_tp = _run_step(cfg, _tp_mesh(), mode=mode)
    loss_1, params_1 = _run_step(cfg, None, mode=mode)
    assert np.isfinite(loss_tp)
    np.testing.assert_allclose(loss_tp, loss_1, rtol=1e-5)
    flat_tp, tree_tp = jax.tree_util.tree_flatten_with_path(params_tp)
    flat_1, tree_1 = jax.tree_util.tree_flatten_with_path(params_1)
    assert tree_tp == tree_1
    for (ka, a), (_, b) in zip(flat_tp, flat_1):
        np.testing.assert_allclose(
            a, b, rtol=2e-4, atol=2e-6, err_msg=str(ka)
        )


def test_dirsharded_grads_match_single_device():
    """The psum/pmean combine rule reassembles the exact single-device
    gradient (an Adam step would mask a constant-factor bug — compare
    raw grads)."""
    from jax.sharding import PartitionSpec as P

    cfg = _cfg(batch=2 * N_DEV)
    model = build_model(cfg)
    state = create_train_state(model, prng.root_key(0))
    batch = _batch(cfg)
    mesh = _tp_mesh()
    data_axis, model_axis = shardmap_axes(mesh)
    assert model_axis == "model"

    def local(params, b):
        with dispatch.direction_shard(model_axis):
            loss, grads = _loss_and_grads(model, params, b, rng=None)
        loss = jax.lax.pmean(loss, data_axis)
        loss = jax.lax.pmean(loss, model_axis)
        grads = jax.lax.pmean(grads, data_axis)
        grads = _combine_model_grads(grads, model_axis)
        return loss, grads

    loss_tp, grads_tp = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P(data_axis)),
        out_specs=(P(), P()), check_vma=False,
    ))(state.params, shard_batch(batch, mesh))

    loss_1, grads_1 = jax.jit(
        lambda p, b: _loss_and_grads(model, p, b, rng=None)
    )(state.params, batch)

    np.testing.assert_allclose(float(loss_tp), float(loss_1), rtol=1e-5)
    flat_tp, _ = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, grads_tp)
    )
    flat_1, _ = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, grads_1)
    )
    for (ka, a), (_, b) in zip(flat_tp, flat_1):
        np.testing.assert_allclose(
            a, b, rtol=1e-4, atol=1e-6, err_msg=str(ka)
        )


def test_dirsharded_eval_matches_single_device(triton_interpret):
    cfg = _cfg(batch=2 * N_DEV)
    mesh = _tp_mesh()
    model = build_model(cfg)
    state = create_train_state(model, prng.root_key(0))
    batch = _batch(cfg)
    dispatch.set_mode("pallas")
    try:
        ev_tp = make_eval_step(model, mesh=mesh)
        loss_tp = float(ev_tp(
            shard_params(state.params, mesh), shard_batch(batch, mesh)
        ))
        ev_1 = make_eval_step(model)
        loss_1 = float(ev_1(state.params, batch))
    finally:
        dispatch.set_mode("auto")
    np.testing.assert_allclose(loss_tp, loss_1, rtol=1e-5)


def test_dirsharded_routing_uses_single_direction_scan(monkeypatch,
                                                      triton_interpret):
    """Under dp x tp2 the step runs the direction-sharded BLSTM (one
    direction per device) and the CTC kernel per device."""
    calls = []
    real = lstm.bilstm_layer_tm_dirsharded

    def spy(*a, **k):
        calls.append(k["axis"])
        return real(*a, **k)

    monkeypatch.setattr(lstm, "bilstm_layer_tm_dirsharded", spy)
    cfg = _cfg(batch=2 * N_DEV)
    _run_step(cfg, _tp_mesh(), mode="auto")
    assert calls and set(calls) == {"model"}, calls
    assert triton_interpret, "the CTC kernel did not run per device"


# ---------------------------------------------------------------------------
# (d) mesh routing predicate
# ---------------------------------------------------------------------------

def test_shardmap_axes_predicate():
    axes = shardmap_axes(make_mesh(cfglib.MeshConfig(data=4, model=2)))
    assert axes == ("data", "model")
    axes = shardmap_axes(make_mesh(cfglib.MeshConfig(data=N_DEV)))
    assert axes == ("data", None)
    assert shardmap_axes(
        make_mesh(cfglib.MeshConfig(data=2, model=4))
    ) is None
    assert shardmap_axes(
        make_mesh(cfglib.MeshConfig(data=2, model=2, time=2))
    ) is None
