"""Checkpoint store: NumPy ``.npz`` pytrees + JSON config, best/latest slots.

Replaces the reference's dual Keras mechanisms — best-val ModelCheckpoint
h5 (speech_lstm_ctc_words.py:172-178) and the generator's epoch-end
JSON+h5 dump (data_generator.py:267-283) — with one format consumed by
resume, decode, and the late-fusion transfer stage
(multimodal.py:68-85).

Layout inside a workdir:
    <stamp>_config.json   pipeline config (reference saved model JSON)
    <stamp>_latest.npz    every-epoch state  (step, params, opt_state)
    <stamp>_best.npz      best-val-loss state
Each ``.npz`` holds one array per pytree leaf, keyed by its tree path
(``jax.tree_util.keystr``), and restores into a template built from the
same config. Leaves NumPy cannot name (bfloat16 and other ml_dtypes) are
stored as same-width unsigned ints with their dtype recorded; PRNG keys
as their key data. Writes are atomic (tmp + rename) so preemption
mid-save never corrupts a slot — the first-class failure-recovery path
the reference lacked (SURVEY.md §5.3).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict

import jax
import numpy as np

from mgr_tpu.core.config import PipelineConfig

_DTYPES_KEY = "__dtypes__"
_KEY_MARK = "prng_key"


def _path(workdir: str, stamp: str, slot: str) -> str:
    return os.path.join(workdir, f"{stamp}_{slot}.npz")


def save_config(workdir: str, stamp: str, cfg: PipelineConfig) -> None:
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f"{stamp}_config.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(cfg.to_json())
    os.replace(tmp, path)


def load_config(workdir: str, stamp: str) -> PipelineConfig:
    with open(os.path.join(workdir, f"{stamp}_config.json")) as f:
        return PipelineConfig.from_json(f.read())


def save_fit_meta(workdir: str, stamp: str, meta: dict) -> None:
    """Sidecar facts about the run that produced the checkpoints —
    currently the per-epoch batch count, which fit(resume=True) needs
    to derive start_epoch correctly (step // num_batches)."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f"{stamp}_fitmeta.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path)


def load_fit_meta(workdir: str, stamp: str) -> dict:
    try:
        with open(os.path.join(workdir, f"{stamp}_fitmeta.json")) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


def _flatten(state: Any) -> Dict[str, np.ndarray]:
    """Tree-path-keyed host arrays, plus the dtype record for leaves
    stored under another dtype."""
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        key = jax.tree_util.keystr(path)
        if jax.dtypes.issubdtype(getattr(leaf, "dtype", None),
                                 jax.dtypes.prng_key):
            leaf = jax.random.key_data(leaf)
            dtypes[key] = _KEY_MARK
        arr = np.asarray(jax.device_get(leaf))
        if arr.dtype.kind == "V":  # bfloat16 & co: keep the raw bits
            dtypes.setdefault(key, arr.dtype.name)
            arr = arr.view(f"u{arr.dtype.itemsize}")
        arrays[key] = arr
    arrays[_DTYPES_KEY] = np.asarray(json.dumps(dtypes))
    return arrays


def _read(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        raw = {k: z[k] for k in z.files}
    dtypes = json.loads(str(raw.pop(_DTYPES_KEY, "{}")))
    for key, name in dtypes.items():
        if name != _KEY_MARK:
            raw[key] = raw[key].view(np.dtype(name))
    return {"arrays": raw, "keys": {k for k, v in dtypes.items()
                                     if v == _KEY_MARK}}


def _restore(template: Any, stored: dict, prefix: str = "") -> Any:
    """Fill ``template``'s leaves from ``stored`` by tree path. Raises
    KeyError for a leaf the file lacks and ValueError for a shape or
    dtype mismatch."""
    arrays = stored["arrays"]
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for path, tmpl in paths:
        key = prefix + jax.tree_util.keystr(path)
        arr = arrays[key]
        if key in stored["keys"]:
            leaves.append(jax.random.wrap_key_data(
                arr, impl=jax.random.key_impl(tmpl)))
            continue
        want = np.dtype(tmpl.dtype)
        if arr.shape != np.shape(tmpl) or arr.dtype != want:
            raise ValueError(
                f"checkpoint leaf {key}: stored {arr.dtype}{arr.shape}, "
                f"template {want}{np.shape(tmpl)}"
            )
        leaves.append(arr)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _write(path: str, arrays: Dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_checkpoint(
    workdir: str, stamp: str, state: Any, *, slot: str = "latest"
) -> str:
    """Serialize a pytree (TrainState or bare params) to a slot.

    Device arrays are fetched to host first so a sharded state saves from
    any mesh layout."""
    os.makedirs(workdir, exist_ok=True)
    path = _path(workdir, stamp, slot)
    _write(path, _flatten(state))
    return path


def load_checkpoint(
    workdir: str, stamp: str, template: Any, *, slot: str = "latest"
) -> Any:
    """Restore into the structure of ``template`` (a freshly built state
    with the same config). Raises ValueError if the file holds leaves
    the template lacks."""
    stored = _read(_path(workdir, stamp, slot))
    n_template = len(jax.tree.leaves(template))
    if len(stored["arrays"]) != n_template:
        raise ValueError(
            f"checkpoint {stamp}/{slot} holds {len(stored['arrays'])} "
            f"leaves, template {n_template}"
        )
    return _restore(template, stored)


def load_checkpoint_flexible(
    workdir: str, stamp: str, template: Any, *, slot: str = "latest"
) -> Any:
    """Like :func:`load_checkpoint`, but tolerant of an optimizer-state
    layout change between the run that saved and the run that resumes
    (e.g. toggling ``OptimizerConfig.skip_nonfinite`` wraps the optax
    chain in ``apply_if_finite``, changing the checkpoint tree).

    Falls back to restoring ``params`` and ``step`` only, keeping the
    template's freshly initialized optimizer state — Adam moments are
    lost, which costs a few warmup steps but preserves the trained
    weights and the resume epoch derivation. The LR schedule count is
    REWOUND to the restored step: a fresh ``scale_by_schedule`` state
    counts from 0, which with ``decay>0`` would silently jump a resumed
    run back to the base LR (e.g. ~1.3x higher after 30k steps at
    decay=1e-5). Adam's own count stays 0 on purpose — its bias
    correction must match the zeroed moments."""
    try:
        return load_checkpoint(workdir, stamp, template, slot=slot)
    except (ValueError, KeyError) as exc:
        stored = _read(_path(workdir, stamp, slot))
        if not (hasattr(template, "params") and ".step" in stored["arrays"]):
            raise
        params = _restore(template.params, stored, prefix=".params")
        step = jax.numpy.asarray(
            int(stored["arrays"][".step"]), jax.numpy.int32
        )
        logging.warning(
            "checkpoint %s/%s: optimizer state layout mismatch (%s); "
            "restored params+step only, optimizer moments reset "
            "(LR-schedule count rewound to step %d)",
            stamp, slot, exc, int(step),
        )
        opt_state = _rewind_schedule_count(template.opt_state, step) \
            if hasattr(template, "opt_state") else None
        if opt_state is not None:
            return template._replace(
                step=step, params=params, opt_state=opt_state
            )
        return template._replace(step=step, params=params)


def _rewind_schedule_count(opt_state: Any, step) -> Any:
    """Set every ``optax.ScaleByScheduleState.count`` in a fresh
    optimizer state to ``step``, so inverse-time LR decay
    (``keras_adam``'s ``neg_decayed_lr``) resumes where it left off."""
    import optax

    step_value = int(step)  # fresh buffer per occurrence: donation in
    # the jitted train step would otherwise see the state.step array
    # aliased into the opt_state and reject the double donation.

    def fix(x):
        if isinstance(x, optax.ScaleByScheduleState):
            return optax.ScaleByScheduleState(
                count=jax.numpy.array(step_value, jax.numpy.int32)
            )
        return x

    return jax.tree_util.tree_map(
        fix, opt_state,
        is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState),
    )


def has_checkpoint(workdir: str, stamp: str, slot: str = "latest") -> bool:
    return os.path.exists(_path(workdir, stamp, slot))


class AsyncCheckpointer:
    """Non-blocking checkpoint writer for long multi-host runs.

    ``save()`` fetches the state to host synchronously (cheap; device
    buffers may be donated next step) and hands serialization + the
    atomic write to a background thread, so the train loop never stalls
    on disk. ``wait()`` drains pending writes (call before exit and
    before loading what was just saved). One in-flight write per slot;
    a newer save for the same slot supersedes a queued one.
    """

    def __init__(self, workdir: str, stamp: str):
        import threading

        self.workdir = workdir
        self.stamp = stamp
        self._lock = threading.Lock()
        self._pending: dict = {}
        self._thread = None
        self._threading = threading

    def save(self, state: Any, *, slot: str = "latest") -> None:
        arrays = _flatten(state)
        with self._lock:
            self._pending[slot] = arrays
            if self._thread is None or not self._thread.is_alive():
                self._thread = self._threading.Thread(
                    target=self._drain, daemon=True
                )
                self._thread.start()

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    return
                slot, arrays = self._pending.popitem()
            os.makedirs(self.workdir, exist_ok=True)
            _write(_path(self.workdir, self.stamp, slot), arrays)

    def wait(self) -> None:
        t = self._thread
        if t is not None:
            t.join()
