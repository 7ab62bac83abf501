"""Training loop: fit on synthetic data, checkpoint/resume, early stop."""

import numpy as np
import pytest

from mgr_tpu.core import checkpoint as ckpt_lib
from mgr_tpu.core import config as cfglib
from mgr_tpu.core import prng
from mgr_tpu.data import datasets, synthetic
from mgr_tpu.models import build_model
from mgr_tpu.train.loop import fit, load_params_for_eval
from mgr_tpu.train.step import create_train_state


def _speech_cfg(**kw):
    enc = cfglib.EncoderConfig(hidden=8, depth=2, input_noise=0.1,
                               dropout=(0.1, 0.1), output_dropout=0.1)
    over = dict(
        maxlen=48, batch_size=2, encoder=enc, compute_dtype="float32",
        optimizer=cfglib.OptimizerConfig(learning_rate=3e-3),
        patience=50,
    )
    over.update(kw)
    return cfglib.get_preset("speech").replace(**over)


@pytest.fixture(scope="module")
def speech_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("loopdata")
    data_dir, label_file, _ = synthetic.make_audio_dataset(
        str(root), n_files=8, frames_per_label=30, seed=0
    )
    return data_dir, label_file


def test_fit_trains_and_checkpoints(speech_data, tmp_path):
    data_dir, label_file = speech_data
    cfg = _speech_cfg()
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    model = build_model(cfg)
    res = fit(model, ds, workdir=str(tmp_path), epochs=3)
    assert res.epochs_run == 3
    assert len(res.history) == 3
    assert np.isfinite(res.best_val_loss)
    # Loss goes down across epochs on the learnable synthetic data.
    assert res.history[-1]["train_loss"] < res.history[0]["train_loss"]
    assert ckpt_lib.has_checkpoint(str(tmp_path), "speech", "latest")
    assert ckpt_lib.has_checkpoint(str(tmp_path), "speech", "best")
    # Metrics JSONL written.
    assert (tmp_path / "speech_metrics.jsonl").exists()

    # Checkpoint roundtrip restores exact params.
    params = load_params_for_eval(model, str(tmp_path), slot="best")
    for a, b in zip(
        __import__("jax").tree.leaves(params),
        __import__("jax").tree.leaves(res.state.params),
    ):
        assert np.asarray(a).shape == np.asarray(b).shape

    # Resume continues from the saved step.
    res2 = fit(model, ds, workdir=str(tmp_path), resume=True, epochs=4)
    assert res2.epochs_run <= 2  # only the remaining epoch(s)

    # An immediate-return resume (everything already trained) is a
    # true no-op: reports 0 epochs and does NOT rewrite checkpoints —
    # a concurrent trainer on the same workdir must not have its newer
    # "latest" clobbered by this process's stale restore.
    import os as _os
    import time as _time

    latest = str(tmp_path / "speech_latest.npz")
    m0 = _os.path.getmtime(latest)
    _time.sleep(0.05)
    res3 = fit(model, ds, workdir=str(tmp_path), resume=True, epochs=4,
               checkpoint_every=100)
    assert res3.epochs_run == 0
    assert _os.path.getmtime(latest) == m0


def test_config_roundtrip(tmp_path):
    cfg = _speech_cfg()
    ckpt_lib.save_config(str(tmp_path), "speech", cfg)
    back = ckpt_lib.load_config(str(tmp_path), "speech")
    assert back == cfg


def test_early_stopping(speech_data, tmp_path):
    data_dir, label_file = speech_data
    # lr=0 so nothing improves. Keras EarlyStopping semantics: epoch 0
    # establishes the best; each later epoch bumps `wait`, stopping when
    # wait >= patience — so patience=1 stops at epoch 1 (2 epochs total)
    # and patience=2 at epoch 2 (3 total). Exact counts guard the
    # off-by-one vs keras (VERDICT r1 item 6).
    for patience, expect in [(1, 2), (2, 3)]:
        cfg = _speech_cfg(
            optimizer=cfglib.OptimizerConfig(learning_rate=0.0),
            patience=patience,
        )
        ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
        model = build_model(cfg)
        res = fit(model, ds, workdir=None, epochs=50)
        assert res.epochs_run == expect, (patience, res.epochs_run)


def test_plateau_follows_train_monitor(speech_data):
    """ReduceLROnPlateau tracks the MONITORED loss: under
    monitor="train" a flat train loss must anneal the LR (memorization
    corpora have no meaningful val signal; measured round 3 — skeletal
    at the big-batch LR oscillates at its floor indefinitely without
    this)."""
    data_dir, label_file = speech_data
    # Deterministic train loss: no noise/dropout + (numerically) zero
    # LR, so the monitored loss never improves and the plateau fires
    # every `reduce_lr_patience` epochs.
    enc = cfglib.EncoderConfig(hidden=8, depth=2, input_noise=0.0,
                               dropout=(0.0, 0.0), output_dropout=0.0)
    cfg = _speech_cfg(
        encoder=enc,
        optimizer=cfglib.OptimizerConfig(learning_rate=1e-12),
        reduce_lr_factor=0.5, reduce_lr_patience=1, reduce_lr_min=1e-18,
    )
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    res = fit(build_model(cfg), ds, workdir=None, epochs=4,
              monitor="train")
    scales = [rec["lr_scale"] for rec in res.history]
    assert scales[0] == 1.0
    assert scales[-1] < 1.0, scales
    assert scales == sorted(scales, reverse=True), scales


def test_plateau_min_delta_gates_patience_reset():
    """Sub-min_delta improvements must not reset patience. Measured
    round-3 failure mode: the fusion grind improves ~1e-3 per sync
    window — above the keras-parity default min_delta 1e-4 — so the
    anneal never fires while the loss descends too slowly to matter.
    A raised min_delta lets the controller treat that as a plateau."""
    from mgr_tpu.train.optimizer import ReduceLROnPlateau

    # keras default: 1e-3/window improvements keep resetting patience.
    c = ReduceLROnPlateau(0.5, 3, 1e-6, 1e-3)
    loss = 10.0
    for _ in range(20):
        loss -= 1e-3
        assert c.update(loss) == 1.0

    # min_delta above the improvement rate: anneals after `patience`.
    c = ReduceLROnPlateau(0.5, 3, 1e-6, 1e-3, min_delta=1e-2)
    loss = 10.0
    scales = []
    for _ in range(20):
        loss -= 1e-3
        scales.append(c.update(loss))
    # First update seeds best; the anneal fires `patience` windows in.
    assert scales[:4] == [1.0, 1.0, 1.0, 0.5], scales
    assert scales[-1] < 0.5, scales


def test_sync_every_identical_trajectory(speech_data):
    """fit(sync_every=K) batches K epochs per host sync (one stacked
    fetch, val only on sync epochs, one history record per window) but
    must NOT change the training math: the rng folds on host_step and
    no decision feeds back into the step, so the parameter trajectory
    is bit-identical to sync_every=1."""
    import jax

    data_dir, label_file = speech_data
    cfg = _speech_cfg()
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)

    res1 = fit(build_model(cfg), ds, workdir=None, epochs=8,
               monitor="train")
    res4 = fit(build_model(cfg), ds, workdir=None, epochs=8,
               monitor="train", sync_every=4)
    for a, b in zip(jax.tree.leaves(res1.state.params),
                    jax.tree.leaves(res4.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    assert len(res1.history) == 8
    assert len(res4.history) == 2  # one record per 4-epoch window
    assert all(r["epochs_in_record"] == 4 for r in res4.history)
    assert res4.history[-1]["epoch"] == 7
    # Best tracking saw every per-epoch train loss, not just window
    # tails.
    assert res4.best_val_loss == res1.best_val_loss
    assert res4.epochs_run == 8


def test_checkpoint_state_roundtrip_exact(tmp_path):
    cfg = _speech_cfg()
    model = build_model(cfg)
    state = create_train_state(model, prng.root_key(0))
    ckpt_lib.save_checkpoint(str(tmp_path), "speech", state)
    template = create_train_state(model, prng.root_key(1))
    restored = ckpt_lib.load_checkpoint(str(tmp_path), "speech", template)
    import jax

    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_async_checkpointing(speech_data, tmp_path):
    data_dir, label_file = speech_data
    cfg = _speech_cfg()
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    model = build_model(cfg)
    res = fit(model, ds, workdir=str(tmp_path), epochs=2,
              async_checkpoints=True)
    assert ckpt_lib.has_checkpoint(str(tmp_path), "speech", "latest")
    assert ckpt_lib.has_checkpoint(str(tmp_path), "speech", "best")
    # Restored latest state matches the in-memory final state.
    import jax

    from mgr_tpu.train.step import create_train_state

    template = create_train_state(model, prng.root_key(1))
    restored = ckpt_lib.load_checkpoint(str(tmp_path), "speech", template)
    for a, b in zip(jax.tree.leaves(restored.params),
                    jax.tree.leaves(res.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fit_with_mesh_on_virtual_devices(speech_data, tmp_path):
    import jax

    if len(jax.devices()) < 8:
        return
    from mgr_tpu.core.config import MeshConfig
    from mgr_tpu.parallel import make_mesh

    data_dir, label_file = speech_data
    cfg = _speech_cfg(batch_size=4, mesh=MeshConfig(data=4, model=2))
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    model = build_model(cfg)
    mesh = make_mesh(cfg.mesh)
    res = fit(model, ds, workdir=str(tmp_path), epochs=2, mesh=mesh)
    assert np.isfinite(res.best_val_loss)
    assert res.history[-1]["train_loss"] < res.history[0]["train_loss"] * 1.5


def _roundtrip_tree(kind):
    import jax
    import jax.numpy as jnp
    import optax

    params = {"enc": {"W": jnp.arange(6.0).reshape(2, 3)},
              "head": {"b": jnp.linspace(-1, 1, 4)}}
    if kind == "bf16":
        return {"w": jnp.linspace(-3, 3, 7).astype(jnp.bfloat16),
                "x": jnp.ones((2, 2), jnp.float32)}
    if kind == "prng_key":
        return {"key": jax.random.key(7),
                "keys": jax.random.split(jax.random.key(3), 3),
                "raw": jax.random.PRNGKey(5)}
    if kind == "optax_state":
        tx = optax.chain(optax.clip(0.5), optax.adam(1e-3))
        opt = tx.init(params)
        grads = jax.tree.map(jnp.ones_like, params)
        _, opt = tx.update(grads, opt, params)
        return {"params": params, "opt_state": opt, "step": jnp.int32(3)}
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["bf16", "prng_key", "optax_state"])
def test_npz_checkpoint_roundtrip(tmp_path, kind):
    """Every leaf comes back bit-exact with its dtype: bfloat16 through
    its raw bits, typed PRNG keys through their key data, and optax
    states (NamedTuples, EmptyState) through their tree paths."""
    import jax

    tree = _roundtrip_tree(kind)
    path = ckpt_lib.save_checkpoint(str(tmp_path), "t", tree)
    assert path.endswith("t_latest.npz")
    template = jax.tree.map(lambda x: x, tree)
    restored = ckpt_lib.load_checkpoint(str(tmp_path), "t", template)
    assert (jax.tree.structure(restored) == jax.tree.structure(tree))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype
        if jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key):
            a, b = jax.random.key_data(a), jax.random.key_data(b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_npz_checkpoint_rejects_mismatch(tmp_path):
    import jax.numpy as jnp

    ckpt_lib.save_checkpoint(str(tmp_path), "t", {"w": jnp.ones(3)})
    with pytest.raises(ValueError):
        ckpt_lib.load_checkpoint(str(tmp_path), "t", {"w": jnp.ones(4)})
    with pytest.raises(KeyError):
        ckpt_lib.load_checkpoint(str(tmp_path), "t", {"v": jnp.ones(3)})


def test_npz_checkpoint_flexible_reload(tmp_path):
    """A resume whose optimizer chain changed restores params + step
    and rewinds the schedule count (load_checkpoint_flexible)."""
    import jax

    cfg = _speech_cfg()
    model = build_model(cfg)
    state = create_train_state(model, prng.root_key(0))
    state = state._replace(step=jax.numpy.asarray(17, jax.numpy.int32))
    ckpt_lib.save_checkpoint(str(tmp_path), "speech", state)
    other = build_model(_speech_cfg(
        optimizer=cfglib.OptimizerConfig(learning_rate=3e-3, decay=1e-5,
                                         skip_nonfinite=3)))
    template = create_train_state(other, prng.root_key(1))
    with pytest.raises((ValueError, KeyError)):
        ckpt_lib.load_checkpoint(str(tmp_path), "speech", template)
    restored = ckpt_lib.load_checkpoint_flexible(str(tmp_path), "speech",
                                                 template)
    assert int(restored.step) == 17
    for a, b in zip(jax.tree.leaves(state.params),
                    jax.tree.leaves(restored.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_every_preserves_true_best(speech_data, tmp_path):
    """Throttled checkpointing (checkpoint_every=N) must still end the
    run with the TRUE best-epoch params on disk — the best state is
    retained in memory and flushed on the cadence / at the end. (Added
    because per-epoch ~100 MB serialization dwarfed sub-second epochs
    on accelerator runs.)"""
    import jax

    data_dir, label_file = speech_data
    cfg = _speech_cfg()
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    model = build_model(cfg)

    wd_every, wd_throttled = str(tmp_path / "a"), str(tmp_path / "b")
    res1 = fit(model, ds, workdir=wd_every, epochs=5)
    res2 = fit(model, ds, workdir=wd_throttled, epochs=5,
               checkpoint_every=3)
    assert res1.best_val_loss == res2.best_val_loss  # same deterministic run

    for slot in ("best", "latest"):
        p1 = load_params_for_eval(model, wd_every, slot=slot)
        p2 = load_params_for_eval(model, wd_throttled, slot=slot)
        for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_monitor_train_and_keep_best_state(speech_data, tmp_path):
    """fit(monitor='train', keep_best_state=True): best selection
    follows TRAIN loss and the returned best_state matches the best
    checkpoint on disk. (Round-2 failure mode: on memorization corpora
    best-val selects the least-trained state, so the fusion graft froze
    a blank-basin encoder.)"""
    import jax

    data_dir, label_file = speech_data
    cfg = _speech_cfg()
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    model = build_model(cfg)

    res = fit(model, ds, workdir=str(tmp_path), epochs=5,
              monitor="train", keep_best_state=True, checkpoint_every=2)
    # best_val_loss now tracks the monitored (train) loss.
    best_train = min(rec["train_loss"] for rec in res.history)
    assert res.best_val_loss == pytest.approx(best_train, rel=1e-6)
    # The retained copy exists and equals the on-disk best slot.
    assert res.best_state is not None
    p_disk = load_params_for_eval(model, str(tmp_path), slot="best")
    for a, b in zip(jax.tree.leaves(p_disk),
                    jax.tree.leaves(res.best_state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_keep_best_state_default_off(speech_data, tmp_path):
    data_dir, label_file = speech_data
    cfg = _speech_cfg()
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    res = fit(build_model(cfg), ds, workdir=None, epochs=2)
    assert res.best_state is None


def test_resume_across_optimizer_wrapper_change(speech_data, tmp_path):
    """fit(resume=True) survives toggling skip_nonfinite between save
    and resume: apply_if_finite changes the opt-state checkpoint layout,
    so the flexible restore falls back to params+step (fresh moments)
    instead of crashing (round-3 wd6->wd7 migration scenario)."""
    import jax

    data_dir, label_file = speech_data
    cfg = _speech_cfg()
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    res = fit(build_model(cfg), ds, workdir=str(tmp_path), epochs=2)
    saved_leaves = jax.tree.leaves(res.state.params)

    guarded = _speech_cfg(
        optimizer=cfglib.OptimizerConfig(
            learning_rate=3e-3, skip_nonfinite=10
        )
    )
    res2 = fit(build_model(guarded), ds, workdir=str(tmp_path),
               resume=True, epochs=3)
    # Continued from the saved step (1 more epoch), params carried over.
    assert res2.epochs_run == 1
    # And the reverse direction: guarded checkpoint, unguarded resume.
    res3 = fit(build_model(cfg), ds, workdir=str(tmp_path),
               resume=True, epochs=4)
    assert res3.epochs_run == 1
    assert len(saved_leaves) == len(jax.tree.leaves(res3.state.params))


def test_stop_below_target(speech_data):
    """fit(stop_below=...) ends the run once the monitored loss reaches
    the target (time-to-target measurement for the curriculum bench)."""
    data_dir, label_file = speech_data
    cfg = _speech_cfg()
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    res = fit(build_model(cfg), ds, workdir=None, epochs=50,
              monitor="train", stop_below=1e9)
    assert res.epochs_run == 1  # first finite loss beats 1e9
    res2 = fit(build_model(cfg), ds, workdir=None, epochs=3,
               monitor="train", stop_below=0.0)
    assert res2.epochs_run == 3  # target never reached -> full budget


def test_plateau_cooldown_blocks_refire():
    """Keras cooldown semantics (cnn_lstm.py:444 cooldown=2): after a
    reduction, patience must not accumulate for `cooldown` updates, so
    the controller cannot re-fire back-to-back on a flat loss."""
    from mgr_tpu.train.optimizer import ReduceLROnPlateau

    # No cooldown: patience=1 on a flat loss fires every update after
    # the first (which seeds best).
    c = ReduceLROnPlateau(0.5, 1, 1e-9, 1e-3)
    scales = [c.update(10.0) for _ in range(5)]
    assert scales == [1.0, 0.5, 0.25, 0.125, 0.0625], scales

    # cooldown=2, keras trace: the decrement happens BEFORE the
    # in-cooldown re-check, so the epoch where the counter hits 0 can
    # already fire — flat-loss cadence stretches from every 1 to every
    # 2 updates (matches keras.callbacks.ReduceLROnPlateau exactly).
    c = ReduceLROnPlateau(0.5, 1, 1e-9, 1e-3, cooldown=2)
    scales = [c.update(10.0) for _ in range(8)]
    assert scales == [1.0, 0.5, 0.5, 0.25, 0.25, 0.125, 0.125, 0.0625], \
        scales


def test_plateau_controller_persists_across_chunked_fits(speech_data):
    """A caller-owned controller must carry its annealed scale across
    fit() calls — chunked drivers (curriculum_bench's accuracy loop)
    otherwise reset lr_scale to 1.0 at every chunk boundary and the run
    re-catapults to the base LR (measured round 5: the speech stage
    sawtoothed 16 -> 38 -> 17 every 400 epochs and the low-LR
    persistence that breaks CTC blank-floor plateaus never
    accumulated)."""
    from mgr_tpu.train.optimizer import plateau_from_config

    data_dir, label_file = speech_data
    enc = cfglib.EncoderConfig(hidden=8, depth=2, input_noise=0.0,
                               dropout=(0.0, 0.0), output_dropout=0.0)
    # (numerically) zero LR -> flat monitored loss -> patience=1 fires
    # every epoch after the first.
    cfg = _speech_cfg(
        encoder=enc,
        optimizer=cfglib.OptimizerConfig(learning_rate=1e-12),
        reduce_lr_factor=0.5, reduce_lr_patience=1, reduce_lr_min=1e-18,
    )
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    model = build_model(cfg)

    ctl = plateau_from_config(cfg)
    res1 = fit(model, ds, workdir=None, epochs=3, monitor="train",
               plateau_controller=ctl)
    end_scale = res1.history[-1]["lr_scale"]
    assert end_scale < 1.0
    res2 = fit(model, ds, workdir=None, epochs=3, monitor="train",
               plateau_controller=ctl)
    chunk2_scales = [rec["lr_scale"] for rec in res2.history]
    # The second chunk continues from (at or below) the annealed scale
    # — never back at 1.0.
    assert all(s <= end_scale for s in chunk2_scales), (
        end_scale, chunk2_scales)

    # Control: without a shared controller the second call resets
    # (the bug this guards against).
    res3 = fit(model, ds, workdir=None, epochs=3, monitor="train")
    assert res3.history[0]["lr_scale"] == 1.0


def test_plateau_state_survives_crash_resume(speech_data, tmp_path):
    """The annealed LR scale must survive a PROCESS restart, not just a
    chunk boundary: fit persists controller state in the fitmeta
    sidecar and resume restores it into a pristine controller.
    (Measured round 5: a process kill + resume at scale 1.0 threw a
    skeletal stage from loss 1.09 back to 9.6 with val divergence.)"""
    from mgr_tpu.train.optimizer import plateau_from_config

    data_dir, label_file = speech_data
    enc = cfglib.EncoderConfig(hidden=8, depth=2, input_noise=0.0,
                               dropout=(0.0, 0.0), output_dropout=0.0)
    cfg = _speech_cfg(
        encoder=enc,
        optimizer=cfglib.OptimizerConfig(learning_rate=1e-12),
        reduce_lr_factor=0.5, reduce_lr_patience=1, reduce_lr_min=1e-18,
    )
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    model = build_model(cfg)
    wd = str(tmp_path)

    ctl = plateau_from_config(cfg)
    res1 = fit(model, ds, workdir=wd, epochs=3, monitor="train",
               plateau_controller=ctl)
    end_scale = res1.history[-1]["lr_scale"]
    assert end_scale < 1.0

    # "Restart": a fresh pristine controller, as a new process builds.
    fresh = plateau_from_config(cfg)
    assert fresh.is_pristine()
    res2 = fit(model, ds, workdir=wd, epochs=6, monitor="train",
               resume=True, plateau_controller=fresh)
    assert res2.history[0]["lr_scale"] <= end_scale, (
        end_scale, res2.history[0]["lr_scale"])

    # Same restart with fit's own internally-built controller
    # (plateau_controller=None) restores too.
    res3 = fit(model, ds, workdir=wd, epochs=9, monitor="train",
               resume=True)
    assert res3.history[0]["lr_scale"] <= end_scale

    # An already-annealed in-memory controller is NOT clobbered by
    # older on-disk state: chunked drivers' in-memory state is newer.
    newer = plateau_from_config(cfg)
    newer.load_state_dict({"scale": 0.015625, "best": 1.0, "wait": 0,
                           "cooldown_counter": 0})
    res4 = fit(model, ds, workdir=wd, epochs=12, monitor="train",
               resume=True, plateau_controller=newer)
    assert res4.history[0]["lr_scale"] == 0.015625


def test_plateau_monitor_decoupled_from_fit_monitor(speech_data):
    """reduce_lr_monitor="train" (the reference-parity default,
    cnn_lstm.py:439 monitor='loss') drives the anneal from per-epoch
    TRAIN losses even when fit(monitor="val") gates early stopping —
    under sync_every=K that is K plateau updates per window vs one
    (ADVICE r3 medium)."""
    data_dir, label_file = speech_data
    enc = cfglib.EncoderConfig(hidden=8, depth=2, input_noise=0.0,
                               dropout=(0.0, 0.0), output_dropout=0.0)
    base = dict(
        encoder=enc,
        optimizer=cfglib.OptimizerConfig(learning_rate=1e-12),
        reduce_lr_factor=0.5, reduce_lr_patience=2, reduce_lr_min=1e-18,
        patience=1000,
    )
    data = datasets.build_audio_dataset(
        data_dir, label_file, _speech_cfg(**base)
    )

    def final_scale(**kw):
        cfg = _speech_cfg(**base, **kw)
        ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
        res = fit(build_model(cfg), ds, workdir=None, epochs=8,
                  monitor="val", sync_every=4)
        return res.history[-1]["lr_scale"]

    # Flat loss, patience=2: per-epoch train feed anneals within the
    # first window (visible in the second record); the one-val-reading
    # -per-window feed has only seen 2 readings by then (seed + 1 wait).
    assert final_scale(reduce_lr_monitor="train") < 1.0
    assert final_scale(reduce_lr_monitor="monitor") == 1.0


def test_fit_reports_loss_of_captured_best_state(speech_data):
    """FitResult.best_state_loss is the monitored loss of the state
    actually captured/saved (window-end), distinguishable from
    best_val_loss which is the min over every fetched reading
    (ADVICE r3 low, train/loop.py:338)."""
    data_dir, label_file = speech_data
    cfg = _speech_cfg()
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)

    res = fit(build_model(cfg), ds, workdir=None, epochs=4,
              monitor="train", keep_best_state=True)
    # sync_every=1: the captured state IS the improving epoch's state.
    assert res.best_state_loss == res.best_val_loss

    res4 = fit(build_model(cfg), ds, workdir=None, epochs=8,
               monitor="train", keep_best_state=True, sync_every=4)
    assert np.isfinite(res4.best_state_loss)
    # Window-end capture can never beat the min over all readings.
    assert res4.best_state_loss >= res4.best_val_loss


def test_sync_every_semantics_warnings(speech_data, caplog):
    """sync_every>1 must warn loudly when it rescales keras-parity
    semantics: patience counts windows under monitor="val", and
    checkpoint_every below sync_every still serializes per epoch
    (VERDICT r3 weak 5 + ADVICE r3 low)."""
    import logging

    data_dir, label_file = speech_data
    cfg = _speech_cfg()
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    with caplog.at_level(logging.WARNING):
        fit(build_model(cfg), ds, workdir=None, epochs=2,
            monitor="val", sync_every=2)
    assert any("counts 2-epoch windows" in r.message for r in caplog.records)

    caplog.clear()
    import tempfile

    with caplog.at_level(logging.WARNING), \
            tempfile.TemporaryDirectory() as wd:
        fit(build_model(cfg), ds, workdir=wd, epochs=2,
            monitor="train", sync_every=2, checkpoint_every=1)
    assert any("raise checkpoint_every" in r.message
               for r in caplog.records)


def test_flexible_restore_rewinds_lr_schedule(speech_data, tmp_path):
    """load_checkpoint_flexible's params+step fallback must rewind the
    fresh scale_by_schedule count to the restored step — otherwise
    decay>0 silently jumps a resumed run back to the base LR
    (ADVICE r3 low, core/checkpoint.py:92)."""
    import jax
    import optax

    cfg = _speech_cfg(
        optimizer=cfglib.OptimizerConfig(learning_rate=1e-3, decay=1e-5)
    )
    model = build_model(cfg)
    state = create_train_state(model, prng.root_key(0))
    state = state._replace(step=np.int32(30_000))
    ckpt_lib.save_checkpoint(str(tmp_path), "speech", state)

    # Resume with a DIFFERENT optimizer wrapper (skip_nonfinite changes
    # the optax tree layout), forcing the fallback path.
    cfg2 = cfg.replace(optimizer=cfglib.OptimizerConfig(
        learning_rate=1e-3, decay=1e-5, skip_nonfinite=100,
    ))
    template = create_train_state(build_model(cfg2), prng.root_key(1))
    restored = ckpt_lib.load_checkpoint_flexible(
        str(tmp_path), "speech", template
    )
    assert int(restored.step) == 30_000
    counts = [
        int(leaf.count)
        for leaf in jax.tree.leaves(
            restored.opt_state,
            is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState),
        )
        if isinstance(leaf, optax.ScaleByScheduleState)
    ]
    assert counts and all(c == 30_000 for c in counts), counts


def test_gspmd_fallback_warns_on_unfused_mesh(caplog):
    """model>2 meshes leave the shard_map path (no CTC kernel, a
    partitioned recurrence) and must say so."""
    import logging

    import jax as _jax

    from mgr_tpu.parallel.mesh import make_mesh
    from mgr_tpu.train.step import make_train_step

    if len(_jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual backend")
    cfg = _speech_cfg(mesh=cfglib.MeshConfig(data=2, model=4))
    mesh = make_mesh(cfg.mesh)
    with caplog.at_level(logging.WARNING):
        make_train_step(build_model(cfg), mesh=mesh)
    assert any("no shard_map mapping" in r.message
               for r in caplog.records)


def test_resume_refuses_mismatched_corpus_geometry(speech_data, tmp_path):
    """fit(resume=True) derives start_epoch = step // num_batches, so a
    relaunch against a different corpus size would silently skip
    training (measured round 3: a 96-file relaunch of a 160-file run
    computed start_epoch past the target and returned immediately).
    The fit-meta sidecar now makes that a loud error."""
    data_dir, label_file = speech_data
    cfg = _speech_cfg()
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    model = build_model(cfg)
    fit(model, ds, workdir=str(tmp_path), epochs=2)

    # Same geometry resumes fine.
    res = fit(model, ds, workdir=str(tmp_path), resume=True, epochs=3)
    assert res.epochs_run == 1

    # Different batch size -> different batches/epoch -> refuse.
    cfg2 = _speech_cfg(batch_size=4)
    ds2 = datasets.build_audio_dataset(data_dir, label_file, cfg2)
    with pytest.raises(ValueError, match="train batches/epoch"):
        fit(build_model(cfg2), ds2, workdir=str(tmp_path), resume=True,
            epochs=4)


def test_resume_preserves_best_val_across_restart(speech_data, tmp_path):
    """A crash-resume must keep protecting the best slot: without the
    fit-meta carry, the resumed run restarts best tracking from +inf
    and its first window overwrites `best` with a possibly-worse state
    (review r5 finding — the generalization chip stage resumes
    best-VAL runs on a memorizing trajectory where val only rises)."""
    import jax

    from mgr_tpu.core import checkpoint as ckpt_lib

    data_dir, label_file = speech_data
    cfg = _speech_cfg()
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    model = build_model(cfg)
    wd = str(tmp_path)

    res1 = fit(model, ds, workdir=wd, epochs=6, monitor="val")
    meta = ckpt_lib.load_fit_meta(wd, cfg.name)
    assert meta.get("best_val_loss") == res1.best_val_loss

    # Resumed continuation: best_val starts from the saved value, so a
    # worse-val continuation must neither lower the reported best nor
    # rewrite the best slot.
    best_before = load_params_for_eval(model, wd, slot="best")
    res2 = fit(model, ds, workdir=wd, epochs=9, resume=True,
               monitor="val")
    assert res2.best_val_loss <= res1.best_val_loss
    if res2.best_val_loss == res1.best_val_loss:
        best_after = load_params_for_eval(model, wd, slot="best")
        for a, b in zip(jax.tree.leaves(best_before),
                        jax.tree.leaves(best_after)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
