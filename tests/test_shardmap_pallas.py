"""Multi-device data parallelism keeps the CTC kernel per device.

Under a pure-DP mesh the train/eval steps are built on shard_map, inside
which each device traces over its LOCAL batch shard — so the Triton CTC
kernel stays eligible instead of being a black box over global arrays,
as plain GSPMD would make it. These tests (kernel in the Pallas
interpreter on this CPU backend, via the ``triton_interpret`` fixture)
assert (a) the kernel is actually selected under a dp mesh and NOT
under plain multi-device jit, and (b) the shard_map'd kernel step is
numerically equal to the single-device kernel step and close to the
XLA-scan step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgr_tpu.core import config as cfglib
from mgr_tpu.core import prng
from mgr_tpu.models import build_model
from mgr_tpu.ops import dispatch
from mgr_tpu.parallel import make_mesh, shard_batch, shard_params
from mgr_tpu.parallel.sharding import dp_only
from mgr_tpu.train import create_train_state, make_eval_step, make_train_step

N_DEV = 8


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


def _dp_mesh():
    return make_mesh(cfglib.MeshConfig(data=N_DEV, model=1, time=1))


def _run_step(cfg, mesh, mode):
    """One train step; returns (loss, params) pulled to host."""
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


def test_dp_mesh_is_dp_only():
    mesh = _dp_mesh()
    assert dp_only(mesh)
    assert not dp_only(make_mesh(cfglib.MeshConfig(data=4, model=2)))


def test_shardmap_step_selects_pallas(triton_interpret):
    """Under a dp mesh the step must route through the CTC kernel;
    under plain multi-device jit (no mesh arg) it must NOT."""
    calls = triton_interpret
    cfg = _cfg(batch=2 * N_DEV)
    mesh = _dp_mesh()
    _run_step(cfg, mesh, mode="auto")
    assert calls, "dp shard_map step did not engage the CTC kernel"

    calls.clear()
    _run_step(cfg, mesh=None, mode="auto")
    assert not calls, (
        "plain multi-device jit must NOT call pallas (GSPMD black box)"
    )


def test_shardmap_pallas_matches_single_device_pallas(triton_interpret):
    """Numerical equality: 8-device shard_map kernel step vs the
    single-device kernel step on the identical global batch. Per-row
    kernel math is identical; only the cross-device grad pmean reorders
    float reductions."""
    cfg = _cfg(batch=2 * N_DEV)
    loss_dp, params_dp = _run_step(cfg, _dp_mesh(), mode="pallas")
    loss_1, params_1 = _run_step(cfg, None, mode="pallas")
    assert np.isfinite(loss_dp)
    np.testing.assert_allclose(loss_dp, loss_1, rtol=1e-5)
    flat_dp, tree_dp = jax.tree_util.tree_flatten_with_path(params_dp)
    flat_1, tree_1 = jax.tree_util.tree_flatten_with_path(params_1)
    assert tree_dp == tree_1
    for (ka, a), (_, b) in zip(flat_dp, flat_1):
        np.testing.assert_allclose(
            a, b, rtol=2e-4, atol=2e-6, err_msg=str(ka)
        )


def test_shardmap_pallas_close_to_xla_scan(triton_interpret):
    """Cross-backend: the shard_map kernel step agrees with the XLA-scan
    step."""
    cfg = _cfg(batch=2 * N_DEV)
    loss_pal, _ = _run_step(cfg, _dp_mesh(), mode="pallas")
    loss_xla, _ = _run_step(cfg, _dp_mesh(), mode="xla")
    assert triton_interpret
    np.testing.assert_allclose(loss_pal, loss_xla, rtol=1e-5)


def test_shardmap_eval_step_matches_single_device(triton_interpret):
    cfg = _cfg(batch=2 * N_DEV)
    mesh = _dp_mesh()
    model = build_model(cfg)
    state = create_train_state(model, prng.root_key(0))
    batch = _batch(cfg)

    dispatch.set_mode("pallas")
    try:
        ev_dp = make_eval_step(model, mesh=mesh)
        loss_dp = float(
            ev_dp(
                shard_params(state.params, mesh), shard_batch(batch, mesh)
            )
        )
        ev_1 = make_eval_step(model)
        loss_1 = float(ev_1(state.params, batch))
    finally:
        dispatch.set_mode("auto")
    np.testing.assert_allclose(loss_dp, loss_1, rtol=1e-5)


def test_fit_on_dp_mesh_uses_shardmap_and_learns(tmp_path,
                                                triton_interpret):
    """End-to-end: fit() with a dp mesh trains through the shard_map
    step (CTC kernel forced, interpreted) and the loss decreases."""
    from mgr_tpu.data import datasets, synthetic

    root = tmp_path / "data"
    # 20 files -> 16 train / 4 val after the seeded 80/20 split, so
    # batch=8 yields 2 whole train batches (remainder-drop semantics).
    data_dir, label_file, _ = synthetic.make_audio_dataset(
        str(root), n_files=20, frames_per_label=6, seed=0
    )
    cfg = _cfg(batch=8).replace(
        maxlen=48,
        num_feats=39,
        nb_classes=44,
        optimizer=cfglib.OptimizerConfig(learning_rate=3e-3),
        patience=50,
    )
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    model = build_model(cfg)
    mesh = _dp_mesh()

    from mgr_tpu.train.loop import fit

    dispatch.set_mode("pallas")
    try:
        res = fit(model, ds, mesh=mesh, epochs=3)
    finally:
        dispatch.set_mode("auto")
    assert np.isfinite(res.best_val_loss)
    assert res.history[-1]["train_loss"] < res.history[0]["train_loss"]


def test_decode_step_dp_mesh_matches_single_device():
    """Fused decode under a pure-DP mesh (shard_map) equals the single-device decode bit-for-bit — and the direction-
    sharded dp x model=2 mesh does too."""
    from mgr_tpu.train.step import make_decode_step

    cfg = _cfg(batch=2 * N_DEV)
    model = build_model(cfg)
    params = create_train_state(model, prng.root_key(3)).params
    batch = _batch(cfg)
    lengths = jnp.full((cfg.batch_size,), cfg.maxlen - 2, jnp.int32)

    def run(mesh, mode="auto"):
        step = make_decode_step(model, threshold=0.3, trim_frames=2,
                                mesh=mesh)
        dispatch.set_mode(mode)
        try:
            best, emit = step(params, batch["inputs"], lengths)
            return np.asarray(best), np.asarray(emit)
        finally:
            dispatch.set_mode("auto")

    best_1, emit_1 = run(None)
    for mesh_cfg in (cfglib.MeshConfig(data=N_DEV),
                     cfglib.MeshConfig(data=N_DEV // 2, model=2)):
        best_m, emit_m = run(make_mesh(mesh_cfg))
        np.testing.assert_array_equal(best_m, best_1)
        np.testing.assert_array_equal(emit_m, emit_1)

    # None lengths path under a mesh (synthesized full lengths) must
    # equal the single-device None-lengths decode VALUE-wise, not just
    # in shape: lengths come from the actual time axis.
    step_1 = make_decode_step(model, threshold=0.3, trim_frames=2)
    best_1n, emit_1n = step_1(params, batch["inputs"])
    step = make_decode_step(model, threshold=0.3, trim_frames=2,
                            mesh=make_mesh(cfglib.MeshConfig(data=N_DEV)))
    best_n, emit_n = step(params, batch["inputs"])
    np.testing.assert_array_equal(np.asarray(best_n), np.asarray(best_1n))
    np.testing.assert_array_equal(np.asarray(emit_n), np.asarray(emit_1n))
