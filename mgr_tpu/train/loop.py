"""Training loop: epochs, validation, early stopping, checkpoints, resume.

Covers the reference's driver behavior (speech_lstm_ctc_words.py:137-193):
EarlyStopping(monitor=val_loss, patience), best-val checkpoint, per-epoch
latest checkpoint + reshuffle, optional ReduceLROnPlateau (rgb,
cnn_lstm.py:439-444), resume-from-checkpoint — as an explicit flag
instead of an interactive raw_input prompt.

Batches are host array slices (no per-step file IO), the
step is jitted once, LR plateau scaling is a traced scalar (no
recompiles), and with a mesh the state/batches are sharded dp x tp.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import numpy as np

from mgr_tpu.core import checkpoint as ckpt_lib
from mgr_tpu.core import prng
from mgr_tpu.core.metrics import MetricsLogger
from mgr_tpu.data.batcher import Batcher
from mgr_tpu.models.zoo import ModelDef
from mgr_tpu.parallel import sharding as shard_lib
from mgr_tpu.train import optimizer as opt_lib
from mgr_tpu.train.step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)


@dataclasses.dataclass
class FitResult:
    state: TrainState
    # Minimum MONITORED loss seen at any fetched reading. Under
    # sync_every=K>1 this is finer-grained than the state snapshots:
    # the best/returned state is the WINDOW-END state, whose own loss
    # is `best_state_loss` — report that one next to accuracies of
    # best_state, not best_val_loss (they can differ by up to a
    # window's descent).
    best_val_loss: float
    epochs_run: int
    history: list
    # Device copy of the best-monitored-epoch state; populated only when
    # fit(keep_best_state=True) (it holds a second full parameter tree
    # in device memory, so it is opt-in).
    best_state: Optional[TrainState] = None
    # Monitored loss of the actually-captured best state (window-end
    # reading at capture time); NaN when no state was ever captured.
    best_state_loss: float = float("nan")


def fit(
    model: ModelDef,
    data: Batcher,
    *,
    workdir: Optional[str] = None,
    mesh=None,
    resume: bool = False,
    epochs: Optional[int] = None,
    seed: Optional[int] = None,
    metrics: Optional[MetricsLogger] = None,
    async_checkpoints: bool = False,
    device_data: Optional[bool] = None,
    checkpoint_every: int = 1,
    monitor: str = "val",
    keep_best_state: bool = False,
    sync_every: int = 1,
    stop_below: Optional[float] = None,
    plateau_controller=None,
) -> FitResult:
    """Train one pipeline.

    ``device_data`` — upload the whole featurized corpus to the device once and
    gather batches on-device by row index (no per-step host transfer).
    Defaults to on for array-backed datasets on a single device; lazy
    (video) datasets and mesh runs use the host streaming path.

    ``checkpoint_every`` — write the latest/best slots at most every N
    epochs (final state always flushed). Serializing a ~100 MB tree
    each epoch can dwarf sub-second epochs; raise N when epochs are
    cheap and losing a few on preemption is acceptable.

    ``monitor`` — which loss drives the best checkpoint and early
    stopping: ``"val"`` (reference semantics, speech_lstm_ctc_words.py:
    167-169 monitor='val_loss') or ``"train"``. Train monitoring exists
    for memorization/diagnostic corpora where val loss rises
    monotonically once the model fits the train split, so best-val
    selection would pick the LEAST-trained state (measured: the round-2
    fusion grafts froze a blank-basin skeletal encoder this way).

    ``keep_best_state`` — retain a device copy of the best-epoch state
    and return it as ``FitResult.best_state`` (robust to late-training
    divergence of the final state; costs a second tree in device memory).

    ``stop_below`` — optional time-to-target stop: end training as soon
    as the monitored loss drops below this value (used by the measured
    curriculum bench to report wall-clock-to-target instead of a fixed
    epoch count).

    ``plateau_controller`` — caller-owned ReduceLROnPlateau (see
    optimizer.plateau_from_config) reused across fit() calls so chunked
    drivers keep their annealed LR instead of resetting to the base LR
    every chunk. Default: constructed fresh from the config.

    ``sync_every`` — host-sync cadence in epochs. At K>1 the loop
    dispatches K epochs of train steps back-to-back, runs the val pass
    only on sync epochs, and fetches the whole window's losses in ONE
    stacked device->host transfer, emitting one metrics/history record
    per window (``epochs_in_record`` marks the coverage). Best/early
    -stop/plateau decisions are made per fetched train loss (or once
    per window under ``monitor="val"``, so ``patience`` then counts
    windows), and the retained best state is the WINDOW-END state
    (granularity K). Sub-second epochs at sync_every=1 mean several
    host round-trips per second, each of which drains the device
    queue."""
    cfg = model.config
    stamp = cfg.name
    epochs = epochs if epochs is not None else cfg.epochs
    seed = seed if seed is not None else cfg.seed

    num_train_batches = max(data.num_batches(cfg.batch_size, train=True), 1)
    state = create_train_state(model, prng.root_key(seed))
    resumed_best = None
    saved_meta = {}
    if resume and workdir and ckpt_lib.has_checkpoint(workdir, stamp):
        # Flexible restore: survives an optimizer-wrapper change between
        # save and resume (e.g. toggling skip_nonfinite) by falling back
        # to params+step with fresh optimizer moments.
        state = ckpt_lib.load_checkpoint_flexible(workdir, stamp, state)
        # Resume derives start_epoch = step // num_batches, so a
        # relaunch against a DIFFERENT corpus/batch geometry silently
        # mis-derives it — measured round 3: a 96-file relaunch of a
        # 160-file run computed start_epoch 6266 >= epochs and returned
        # without training. Refuse loudly instead.
        saved = saved_meta = ckpt_lib.load_fit_meta(workdir, stamp)
        if saved.get("num_train_batches") not in (None, num_train_batches):
            raise ValueError(
                f"fit(resume=True) on '{stamp}': this corpus yields "
                f"{num_train_batches} train batches/epoch but the "
                f"checkpoint was written with "
                f"{saved['num_train_batches']} — start_epoch would be "
                f"mis-derived (step // num_batches). Relaunch with the "
                f"original corpus/batch geometry, or start a fresh "
                f"workdir."
            )
        # Carry the best-monitored loss across restarts: without it a
        # resumed run restarts best tracking from +inf and its FIRST
        # window overwrites the `best` slot with a possibly-worse state
        # (on a val-rising memorization trajectory, strictly worse).
        resumed_best = saved.get("best_val_loss")
    if workdir:
        ckpt_lib.save_config(workdir, stamp, cfg)
        meta = {"num_train_batches": num_train_batches}
        if resumed_best is not None:
            meta["best_val_loss"] = resumed_best
        if saved_meta.get("plateau"):
            # Keep the persisted LR-anneal state on disk until the
            # first in-run save refreshes it (the controller restore
            # happens a few lines below).
            meta["plateau"] = saved_meta["plateau"]
        ckpt_lib.save_fit_meta(workdir, stamp, meta)
    if mesh is not None:
        state = state._replace(
            params=shard_lib.shard_params(state.params, mesh)
        )

    if device_data is None:
        device_data = mesh is None and getattr(data, "features", None) is not None
    arrays = None
    if device_data:
        import jax.numpy as jnp

        from mgr_tpu.train.step import (
            make_indexed_eval_step,
            make_indexed_train_step,
        )

        arrays = jax.tree.map(jnp.asarray, data.device_arrays())
        train_step = make_indexed_train_step(model)
        eval_step = make_indexed_eval_step(model)
    else:
        # Pure-DP meshes get the shard_map step (fused Pallas kernels
        # stay engaged per device); tp/sp meshes the GSPMD step.
        train_step = make_train_step(model, mesh=mesh)
        eval_step = make_eval_step(model, mesh=mesh)
    metrics = metrics or MetricsLogger(
        workdir, stamp,
        num_chips=1 if mesh is None else mesh.devices.size,
    )

    ckpt_writer = None
    if async_checkpoints and workdir:
        ckpt_writer = ckpt_lib.AsyncCheckpointer(workdir, stamp)

    def _save(slot: str, which=None) -> None:
        if not workdir:
            return
        s = state if which is None else which
        if ckpt_writer is not None:
            ckpt_writer.save(s, slot=slot)
        else:
            ckpt_lib.save_checkpoint(workdir, stamp, s, slot=slot)
        # Persist the small host-side training state next to every slot
        # write: the best-monitored loss (so a crash-resume keeps
        # protecting the best slot) and the LR-anneal controller state
        # (so a crash-resume continues at the annealed LR instead of
        # re-catapulting to the base LR).
        meta = {"num_train_batches": num_train_batches}
        if best_val != float("inf"):
            meta["best_val_loss"] = best_val
        if plateau is not None:
            meta["plateau"] = plateau.state_dict()
        ckpt_lib.save_fit_meta(workdir, stamp, meta)

    # ``plateau_controller`` — caller-owned ReduceLROnPlateau that
    # PERSISTS across fit() calls (chunked drivers: a fresh controller
    # per chunk resets lr_scale to 1.0 every chunk, so an annealed run
    # re-catapults to the base LR — measured round 5, see
    # opt_lib.plateau_from_config).
    plateau = plateau_controller
    if plateau is None:
        plateau = opt_lib.plateau_from_config(cfg)
    # Crash-resume: restore the annealed LR state persisted in fitmeta.
    # Only a PRISTINE controller is restored — an in-process chunked
    # driver's already-annealed controller must not be clobbered by
    # older on-disk state (its in-memory state is strictly newer).
    # Measured round 5: resuming a wedge-killed skeletal stage at scale
    # 1.0 threw the loss from 1.09 back to 9.6 with val divergence.
    if (plateau is not None and saved_meta.get("plateau")
            and plateau.is_pristine()):
        plateau.load_state_dict(saved_meta["plateau"])

    if sync_every > 1 and monitor != "train":
        # Keras-parity knobs quietly rescale under windowed syncing:
        # the val pass only exists on sync epochs, so patience counts
        # WINDOWS (effective patience = patience * sync_every epochs)
        # and the best slot holds window-end states.
        import logging

        logging.warning(
            "fit(sync_every=%d, monitor='val'): EarlyStopping patience "
            "%d now counts %d-epoch windows (= %d epochs) and the best "
            "state has window-end granularity",
            sync_every, cfg.patience, sync_every,
            cfg.patience * sync_every,
        )
    if sync_every > 1 and checkpoint_every < sync_every and workdir:
        # checkpoint_every=1 (the default) would still serialize the
        # ~100 MB tree per epoch mid-window — exactly the host traffic
        # sync_every exists to avoid.
        import logging

        logging.warning(
            "fit(sync_every=%d, checkpoint_every=%d): the latest slot "
            "is still written every %d epoch(s); raise checkpoint_every "
            ">= sync_every unless per-epoch serialization is intended",
            sync_every, checkpoint_every, max(checkpoint_every, 1),
        )

    data_key = prng.fold_name(prng.root_key(seed), "dropout")
    best_val = float("inf") if resumed_best is None else float(resumed_best)
    best_state_loss = float("nan")
    pending_best = None
    wait = 0
    # A persisted controller resumes at its annealed scale — the very
    # first window's steps must already train at that LR, not 1.0.
    lr_scale = plateau.scale if plateau is not None else 1.0
    history = []
    start_epoch = int(state.step) // num_train_batches

    import jax.numpy as jnp

    # step counter must advance deterministically for the rng fold; the
    # per-step host sync (float(loss)) is deliberately absent — losses
    # stay on device and reduce to ONE fetch per sync window, keeping
    # the device pipeline full (a per-step sync drains the queue).
    host_step = int(state.step)
    sync_every = max(int(sync_every), 1)
    win_losses = []  # per-epoch device mean-loss scalars in this window
    win_gnorms = []
    stop = False
    epoch = start_epoch
    ran_any = False  # did THIS call train at all? (resume may be a no-op)
    for epoch in range(start_epoch, epochs):
        ran_any = True
        if not win_losses:
            metrics.start_epoch(epoch)  # window start: reset wall/seqs
        else:
            metrics.note_epoch(epoch)
        losses = []
        gnorms = []
        n_seqs = 0
        if device_data:
            batches = (
                (ids, jnp.asarray(idx))
                for ids, idx in data.epoch_indices(
                    cfg.batch_size, train=True, shuffle_seed=seed + epoch
                )
            )
        else:
            batches = data.epoch(
                cfg.batch_size, train=True, shuffle_seed=seed + epoch
            )
        for _, payload in batches:
            rng = jax.random.fold_in(data_key, host_step)
            host_step += 1
            if device_data:
                state, m = train_step(state, arrays, payload, rng, lr_scale)
            else:
                if mesh is not None:
                    payload = shard_lib.shard_batch(payload, mesh)
                state, m = train_step(state, payload, rng, lr_scale)
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
            n_seqs += cfg.batch_size
        nan = jnp.asarray(float("nan"))
        win_losses.append(jnp.stack(losses).mean() if losses else nan)
        win_gnorms.append(jnp.stack(gnorms).mean() if gnorms else nan)
        metrics.add_seqs(n_seqs)

        save_now = (epoch - start_epoch + 1) % max(checkpoint_every, 1) == 0
        if save_now:
            _save("latest")

        if len(win_losses) < sync_every and epoch != epochs - 1:
            continue  # keep the device pipeline full; no host sync yet

        # ---- window sync: val pass + ONE stacked host transfer ----
        # Validation pass (no dropout/noise), sync epochs only.
        val_losses = []
        if device_data:
            for _, idx in data.epoch_indices(cfg.batch_size, train=False):
                val_losses.append(
                    eval_step(state.params, arrays, jnp.asarray(idx))
                )
        else:
            for _, batch in data.epoch(cfg.batch_size, train=False):
                if mesh is not None:
                    batch = shard_lib.shard_batch(batch, mesh)
                val_losses.append(eval_step(state.params, batch))
        n_win = len(win_losses)
        fetched = np.asarray(
            jnp.stack(win_losses + win_gnorms + val_losses)
        )
        train_seq = [float(x) for x in fetched[:n_win]]
        grad_norm = float(fetched[2 * n_win - 1])
        val_loss = (
            float(fetched[2 * n_win:].mean()) if val_losses else None
        )
        train_loss = train_seq[-1]

        rec = metrics.end_epoch(
            train_loss, val_loss, lr_scale=lr_scale, grad_norm=grad_norm,
            **({"epochs_in_record": n_win} if sync_every > 1 else {}),
        )
        history.append(rec)

        # Best/early-stop decisions per fetched train loss (one
        # decision per window under monitor="val": the val pass only
        # exists on sync epochs, so patience then counts windows).
        # The plateau controller is updated separately below with its
        # own monitor (cfg.reduce_lr_monitor).
        monitored_seq = (
            train_seq if (monitor == "train" or val_loss is None)
            else [val_loss]
        )
        improved_in_window = False
        for monitored in monitored_seq:
            improved = monitored < best_val
            if improved:
                best_val = monitored
                wait = 0
                improved_in_window = True
                # Time-to-target stop: end the run once the monitored
                # loss reaches the caller's threshold (still finishes
                # the window's best-state/checkpoint bookkeeping below).
                if stop_below is not None and monitored < stop_below:
                    stop = True
            else:
                wait += 1
                # Keras EarlyStopping semantics: stop once `wait`
                # REACHES patience (speech_lstm_ctc_words.py:167-169
                # uses patience=20 with Keras 2.1.4, whose callback
                # breaks on wait >= patience).
                if wait >= cfg.patience:
                    stop = True
        # The plateau controller has its OWN monitor, decoupled from
        # the best-checkpoint/early-stop signal: the reference's only
        # wired ReduceLROnPlateau follows 'loss' — the TRAIN loss —
        # with cooldown=2 (cnn_lstm.py:439-444), so
        # reduce_lr_monitor="train" (the default) feeds it each
        # fetched per-epoch train loss; "monitor" replays the
        # early-stop signal instead (one val reading per window).
        if plateau is not None:
            plateau_seq = (
                train_seq
                if (cfg.reduce_lr_monitor == "train" or val_loss is None)
                else monitored_seq
            )
            for m in plateau_seq:
                if m == m:  # skip NaN readings
                    lr_scale = plateau.update(m)
        if improved_in_window:
            # Loss of the state actually being captured: the window-end
            # reading (== the improving epoch's at sync_every=1).
            best_state_loss = monitored_seq[-1]
            if checkpoint_every > 1 or keep_best_state:
                # Retain a device COPY of the best state — at
                # sync_every=1 exactly the improving epoch's state, at
                # K>1 the window-end state. A copy is required — the
                # jitted step DONATES the input state's buffers, so a
                # plain reference would hold deleted arrays by the next
                # step (donation is a no-op on CPU, which is why only
                # accelerator runs see it).
                pending_best = jax.tree.map(jnp.copy, state)
            if checkpoint_every <= 1:
                _save("best")
        if save_now and pending_best is not None and checkpoint_every > 1:
            _save("best", pending_best)
            if not keep_best_state:
                pending_best = None
        win_losses, win_gnorms = [], []
        if stop:
            break

    # Final flush: the run must always end with the latest state and the
    # true best state on disk, whatever the checkpoint cadence — but
    # ONLY if this call actually trained. An immediate-return resume
    # (start_epoch >= epochs, e.g. an eval-only re-invocation) must not
    # rewrite checkpoints it didn't advance: a concurrent trainer on the
    # same workdir would have its newer "latest" clobbered by this
    # process's stale restore.
    if ran_any and pending_best is not None and checkpoint_every > 1:
        _save("best", pending_best)
    if ran_any and checkpoint_every > 1:
        _save("latest")
    if ckpt_writer is not None:
        ckpt_writer.wait()
    return FitResult(
        state=state, best_val_loss=best_val,
        epochs_run=(epoch - start_epoch + 1) if ran_any else 0,
        history=history,
        best_state=pending_best if keep_best_state else None,
        best_state_loss=best_state_loss,
    )


def load_params_for_eval(
    model: ModelDef, workdir: str, *, slot: str = "best"
) -> Dict[str, Any]:
    """Restore just the params of a trained pipeline (decoders and the
    fusion builder both consume this — sequence_decoding.py:89-94,
    multimodal.py:68-85)."""
    template = create_train_state(model, prng.root_key(model.config.seed))
    state = ckpt_lib.load_checkpoint(
        workdir, model.config.name, template, slot=slot
    )
    return state.params
