"""Jitted train / eval / predict steps.

One generic step serves all five pipelines (the reference copy-pasted
this scaffolding per modality — SURVEY.md §1). Everything here is
SPMD-ready: run inside a ``Mesh`` with sharded params/batches and XLA
inserts the data-parallel gradient psum and the TP collectives.

Batch contract (mirrors the reference's generator outputs,
/root/reference/audio_network/data_generator.py:232-240, minus the
dummy-zeros trick which a real loss function makes unnecessary):
  inputs        (B, T, F) array, or a tuple of arrays for fusion models
  labels        (B, N) int32, -1 padded
  input_length  (B,) int32 — valid frames AFTER the ctc trim
  label_length  (B,) int32
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from mgr_tpu.models.zoo import ModelDef
from mgr_tpu.ops.ctc import ctc_loss_from_logits
from mgr_tpu.train import optimizer as opt_lib

Params = Dict[str, Any]


class TrainState(NamedTuple):
    step: jax.Array
    params: Params
    opt_state: Any

    @property
    def as_pytree(self):
        return self


def create_train_state(model: ModelDef, rng: jax.Array) -> TrainState:
    params = model.init(rng)
    tx = opt_lib.keras_adam(model.config.optimizer)
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        opt_state=tx.init(params),
    )


def _batch_inputs(batch: Dict[str, Any]):
    if "inputs2" in batch:
        return (batch["inputs"], batch["inputs2"])
    return batch["inputs"]


def _loss_from_batch(model: ModelDef, params: Params, batch, *, train, rng):
    cfg = model.config
    if model.apply_tm is not None:
        # Time-major path: logits stay (T, B, C); the CTC packing einsum
        # absorbs the layout (no large-tensor transpose anywhere).
        logits = model.apply_tm(
            params, _batch_inputs(batch), train=train, rng=rng
        )
        time_major = True
    else:
        logits = model.apply(
            params, _batch_inputs(batch), train=train, rng=rng
        )
        time_major = False
    losses = ctc_loss_from_logits(
        logits,
        batch["labels"],
        batch["input_length"],
        batch["label_length"],
        trim_frames=cfg.ctc.trim_frames,
        time_major=time_major,
    )
    return losses.mean()


def _loss_and_grads(model: ModelDef, params: Params, batch, *, rng):
    """value_and_grad of the CTC loss, with optional gradient
    accumulation (OptimizerConfig.accum_steps > 1): the batch splits
    into microbatches scanned sequentially, so activation memory is
    O(batch/accum_steps) while gradients average to the full-batch
    value. Dropout/noise draw a fresh key per microbatch."""
    accum = model.config.optimizer.accum_steps

    def loss_fn(p, mb, r):
        return _loss_from_batch(model, p, mb, train=True, rng=r)

    if accum <= 1:
        return jax.value_and_grad(lambda p: loss_fn(p, batch, rng))(params)

    def split(x):
        if x.shape[0] % accum != 0:
            raise ValueError(
                f"batch dim {x.shape[0]} not divisible by "
                f"accum_steps={accum}"
            )
        return x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))

    micro = jax.tree.map(split, batch)

    def body(carry, xs):
        loss_sum, grads_sum = carry
        i, mb = xs
        r = jax.random.fold_in(rng, i) if rng is not None else None
        loss, grads = jax.value_and_grad(lambda p: loss_fn(p, mb, r))(params)
        return (
            loss_sum + loss,
            jax.tree.map(jnp.add, grads_sum, grads),
        ), None

    init = (
        jnp.zeros((), jnp.float32),
        jax.tree.map(jnp.zeros_like, params),
    )
    (loss_sum, grads_sum), _ = jax.lax.scan(
        body, init, (jnp.arange(accum), micro)
    )
    inv = 1.0 / accum
    return loss_sum * inv, jax.tree.map(lambda g: g * inv, grads_sum)


def _apply_updates(model: ModelDef, state: TrainState, tx, loss, grads,
                   lr_scale):
    """Shared optimizer tail: freeze mask, Adam update, lr scale,
    maxnorm projection."""
    cfg = model.config
    trainable = model.trainable(state.params)
    grads = opt_lib.freeze_mask_grads(grads, trainable)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    updates = jax.tree.map(lambda u: u * lr_scale, updates)
    params = optax.apply_updates(state.params, updates)
    params = opt_lib.apply_maxnorm(params, cfg.optimizer.maxnorm)
    grad_norm = optax.global_norm(grads)
    new_state = TrainState(state.step + 1, params, opt_state)
    return new_state, {"loss": loss, "grad_norm": grad_norm}


def _combine_model_grads(grads, model_axis: str):
    """Uniform pmean over the direction-TP axis is exact for EVERY leaf.

    Each model-device's value_and_grad runs inside the shard_map body,
    so the all_gather of the per-direction h-streams transposes to a
    psum_scatter: the cotangent reaching direction d's stream sums BOTH
    devices' (identical, redundantly computed) downstream losses — a
    uniform 2x on every direction-scattered leaf (blstm W/U/b arrive
    slot-scattered: device d holds 2x dW[d], zeros elsewhere) and on
    every via-direction path into shared leaves below the BLSTM (each
    device holds 2x the via-its-direction HALF of e.g. a CNN grad).
    Purely-local paths (the dense head above the gather) arrive 1x and
    identical on both devices. pmean maps all three cases to the exact
    single-device gradient: (2x slot + 0)/2, (2x half_a + 2x half_b)/2,
    (g + g)/2. Verified leaf-by-leaf in
    tests/test_tp_dirsharded.py::test_dirsharded_grads_match_single_device.
    """
    return jax.tree.map(lambda g: jax.lax.pmean(g, model_axis), grads)


def _make_shardmap_train_step(model: ModelDef, mesh, model_axis=None):
    """shard_map train step: pure DP, or DP x direction-sharded TP.

    Each device computes loss/grads over its LOCAL batch shard; inside
    the shard_map body the CTC kernel stays eligible
    (``ops.dispatch.shard_local`` — under plain GSPMD a pallas_call is a
    black box whose operands would be all-gathered). Gradients and the
    loss pmean over the data axis inside the body; the Adam/maxnorm tail
    runs on replicated params outside.

    Batch is embarrassingly parallel for the recurrence and the CTC
    forward and backward, so per-device results match the
    single-device step on the same rows.

    With ``model_axis`` (size-2 'model' axis), BLSTM layers additionally
    split their two scan directions across the axis
    (``ops.dispatch.direction_shard`` -> ``bilstm_layer_tm_dirsharded``):
    params stay replicated, each device runs one direction's scan,
    h-streams all_gather per layer. Direction-sharded grads
    (blstm_*/{W,U,b}) psum over the axis, shared grads pmean.
    """
    from jax.sharding import PartitionSpec as P

    from mgr_tpu.ops import dispatch

    cfg = model.config
    tx = opt_lib.keras_adam(cfg.optimizer)
    data_axis = mesh.axis_names[0]

    def local_loss_grad(params, batch, rng):
        # Decorrelate dropout/noise across DATA shards only: model-axis
        # devices must draw identical masks (they compute the same rows).
        rng = (
            jax.random.fold_in(rng, jax.lax.axis_index(data_axis))
            if rng is not None else None
        )

        ctx = (
            dispatch.direction_shard(model_axis)
            if model_axis is not None else dispatch.shard_local()
        )
        with ctx:
            loss, grads = _loss_and_grads(model, params, batch, rng=rng)
        loss = jax.lax.pmean(loss, data_axis)
        grads = jax.lax.pmean(grads, data_axis)
        if model_axis is not None:
            loss = jax.lax.pmean(loss, model_axis)
            grads = _combine_model_grads(grads, model_axis)
        return loss, grads

    # check_vma=False: pallas_call out_shapes carry no varying-mesh-axes
    # annotation, so the shard_map vma check rejects them; correctness
    # is covered by the replication of params/outputs via explicit pmean.
    sharded_loss_grad = jax.shard_map(
        local_loss_grad, mesh=mesh,
        in_specs=(P(), P(data_axis), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )

    def step(state: TrainState, batch, rng, lr_scale):
        loss, grads = sharded_loss_grad(state.params, batch, rng)
        return _apply_updates(model, state, tx, loss, grads, lr_scale)

    return jax.jit(step, donate_argnums=(0,))


def _warn_gspmd_fallback(mesh) -> None:
    """Loud, once-per-mesh-shape notice that this mesh takes the GSPMD
    path: model axes != 2 and non-trivial time axes let XLA partition
    the lax.scan recurrence, and the CTC kernel stays off. model=2 gets
    direction-sharded TP on shard_map; model>2 has no shard_map mapping
    (H-sharding would psum every timestep — latency-dominated at
    T=1900)."""
    import logging

    shape = dict(mesh.shape)
    if shape not in _warned_mesh_shapes:
        _warned_mesh_shapes.append(shape)
        logging.warning(
            "mesh %s: no shard_map mapping (model axis != 2 or time "
            "axis > 1) — the GSPMD path runs without the CTC kernel and "
            "with a partitioned recurrence. Use model=2 "
            "(direction-sharded TP) or pure DP for the shard_map path.",
            shape,
        )


_warned_mesh_shapes: list = []


def make_train_step(
    model: ModelDef, mesh=None,
) -> Callable[[TrainState, Dict[str, Any], jax.Array, jax.Array],
              Tuple[TrainState, Dict[str, jax.Array]]]:
    """Returns step(state, batch, rng, lr_scale) -> (state, metrics).

    ``lr_scale`` is a traced scalar so host-side ReduceLROnPlateau never
    triggers recompilation.

    With a pure-DP ``mesh`` — or DP x a size-2 'model' axis (direction-
    sharded TP) — the step is built on shard_map so the CTC kernel can
    keep running per device (see
    :func:`_make_shardmap_train_step`); other meshes use the GSPMD path,
    where XLA partitions the lax.scan recurrence."""
    if mesh is not None and mesh.devices.size > 1:
        from mgr_tpu.parallel import sharding as shard_lib

        axes = shard_lib.shardmap_axes(mesh)
        if axes is not None:
            return _make_shardmap_train_step(model, mesh,
                                             model_axis=axes[1])
        _warn_gspmd_fallback(mesh)
    cfg = model.config
    tx = opt_lib.keras_adam(cfg.optimizer)

    def step(state: TrainState, batch, rng, lr_scale):
        loss, grads = _loss_and_grads(model, state.params, batch, rng=rng)
        return _apply_updates(model, state, tx, loss, grads, lr_scale)

    return jax.jit(step, donate_argnums=(0,))


def _gather_batch(data: Dict[str, jax.Array], idx: jax.Array):
    return {k: v[idx] for k, v in data.items()}


def make_indexed_train_step(model: ModelDef):
    """Device-resident variant of :func:`make_train_step`.

    The WHOLE featurized dataset lives in device memory (uploaded once); the step
    receives only a (B,) row-index vector and gathers its batch
    on-device. Kills the per-step host->device batch transfer — the
    dominant cost when the host link is slow, and a free win everywhere
    else. The audio corpus at reference scale is ~200 MB, far under
    device memory.
    """
    cfg = model.config
    tx = opt_lib.keras_adam(cfg.optimizer)

    def step(state: TrainState, data, idx, rng, lr_scale):
        batch = _gather_batch(data, idx)
        loss, grads = _loss_and_grads(model, state.params, batch, rng=rng)
        return _apply_updates(model, state, tx, loss, grads, lr_scale)

    return jax.jit(step, donate_argnums=(0,))


def make_indexed_eval_step(model: ModelDef):
    def step(params: Params, data, idx):
        batch = _gather_batch(data, idx)
        return _loss_from_batch(model, params, batch, train=False, rng=None)

    return jax.jit(step)


def make_eval_step(model: ModelDef, mesh=None):
    """Returns step(params, batch) -> mean val loss (no dropout/noise).

    Pure-DP and DP x direction-TP meshes get the shard_map variant
    (per-device kernels), mirroring
    :func:`make_train_step`."""
    if mesh is not None and mesh.devices.size > 1:
        from mgr_tpu.parallel import sharding as shard_lib

        axes = shard_lib.shardmap_axes(mesh)
        if axes is not None:
            from jax.sharding import PartitionSpec as P

            from mgr_tpu.ops import dispatch

            data_axis, model_axis = axes

            def local_eval(params: Params, batch):
                ctx = (
                    dispatch.direction_shard(model_axis)
                    if model_axis is not None else dispatch.shard_local()
                )
                with ctx:
                    loss = _loss_from_batch(
                        model, params, batch, train=False, rng=None
                    )
                loss = jax.lax.pmean(loss, data_axis)
                if model_axis is not None:
                    loss = jax.lax.pmean(loss, model_axis)
                return loss

            return jax.jit(jax.shard_map(
                local_eval, mesh=mesh,
                in_specs=(P(), P(data_axis)), out_specs=P(),
                check_vma=False,  # pallas out_shapes carry no vma
            ))

    def step(params: Params, batch):
        return _loss_from_batch(model, params, batch, train=False, rng=None)

    return jax.jit(step)


def make_predict_step(model: ModelDef):
    """Returns step(params, inputs) -> per-frame softmax probabilities
    (B, T, C) — the sub-model the reference extracts for decoding
    (/root/reference/audio_network/sequence_decoding.py:104-105)."""

    def step(params: Params, inputs):
        logits = model.apply(params, inputs, train=False, rng=None)
        return jax.nn.softmax(logits, axis=-1)

    return jax.jit(step)


def make_decode_step(model: ModelDef, *, threshold: float,
                     trim_frames: int = 2, drop_blank: bool = False,
                     mesh=None):
    """Fused on-device predict + best-path decode.

    Returns step(params, inputs, input_lengths|None) -> (best, emit):
    (B, T') int32 argmax classes and the boolean emit mask. Fetching
    these (a few hundred KB) instead of the (B, T, C) float posteriors
    (tens of MB) keeps decoding compute-bound rather than bound by the
    device-to-host transfer.

    Decoding is embarrassingly parallel over the batch, so a pure-DP
    ``mesh`` (or DP x size-2 'model': direction-sharded TP) gets the
    same shard_map treatment as train/eval — each device decodes its
    local batch shard."""
    from mgr_tpu.ops.decoding import best_path_decode

    cfg = model.config

    def step(params: Params, inputs, input_lengths=None):
        logits = model.apply(params, inputs, train=False, rng=None)
        probs = jax.nn.softmax(logits, axis=-1)
        blank = cfg.nb_classes - 1 if drop_blank else None
        return best_path_decode(
            probs, input_lengths,
            threshold=threshold, trim_frames=trim_frames, blank=blank,
        )

    if mesh is not None and mesh.devices.size > 1:
        from mgr_tpu.parallel import sharding as shard_lib

        axes = shard_lib.shardmap_axes(mesh)
        if axes is not None:
            from jax.sharding import PartitionSpec as P

            from mgr_tpu.ops import dispatch

            data_axis, model_axis = axes

            def local_step(params: Params, inputs, input_lengths):
                ctx = (
                    dispatch.direction_shard(model_axis)
                    if model_axis is not None else dispatch.shard_local()
                )
                with ctx:
                    return step(params, inputs, input_lengths)

            sharded = jax.shard_map(
                local_step, mesh=mesh,
                in_specs=(P(), P(data_axis), P(data_axis)),
                out_specs=(P(data_axis), P(data_axis)),
                check_vma=False,  # pallas out_shapes carry no vma
            )

            def mesh_step(params: Params, inputs, input_lengths=None):
                if input_lengths is None:
                    # No-masking semantics: full lengths synthesized
                    # from the ACTUAL padded time axis, not cfg.maxlen —
                    # callers may pass shorter inputs (ADVICE r2).
                    leaves = jax.tree.leaves(inputs)
                    input_lengths = jnp.full(
                        (leaves[0].shape[0],), leaves[0].shape[1],
                        jnp.int32,
                    )
                return sharded(params, inputs, input_lengths)

            return jax.jit(mesh_step)

    return jax.jit(step, static_argnames=())
