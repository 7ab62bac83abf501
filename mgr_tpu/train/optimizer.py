"""Keras-parity optimizer stack on optax.

Reference semantics reproduced exactly:
  * Adam(lr=1e-4, clipvalue=0.5) — element-wise GRADIENT value clipping
    before the Adam moments (speech_lstm_ctc_words.py:115-116).
  * Keras `decay`: lr_t = lr / (1 + decay * step) — inverse-time decay
    applied per update (skeletal_lstm_ctc.py:374-376, decay=1e-5).
  * Keras epsilon default 1e-7 (not optax's 1e-8).
  * maxnorm(3) kernel constraint — Keras applies constraints as a
    projection AFTER the weight update, per output column (axis 0 of the
    fused (F, 4H) kernel). Implemented as :func:`apply_maxnorm` over the
    gate-blocked layout: norm over the fan-in axis for each (gate,
    hidden) column. Only LSTM input kernels carry the constraint in the
    reference (kernel_constraint=maxnorm(3), recurrent and dense do not).
  * Layer freezing (late fusion) — gradients for frozen leaves are
    zeroed, replacing the reference's Bidirectional-freeze workaround
    (multimodal.py:33-55).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import optax

from mgr_tpu.core.config import OptimizerConfig

Params = Dict[str, Any]


def keras_adam(cfg: OptimizerConfig) -> optax.GradientTransformation:
    def neg_decayed_lr(step):
        return -cfg.learning_rate / (1.0 + cfg.decay * step)

    tx = optax.chain(
        optax.clip(cfg.clipvalue),  # element-wise |g| <= clipvalue
        optax.scale_by_adam(b1=cfg.beta1, b2=cfg.beta2, eps=cfg.eps),
        optax.scale_by_schedule(neg_decayed_lr),
    )
    if cfg.skip_nonfinite:
        # Drop (zero) any update containing non-finite values and leave
        # the Adam moments untouched, so one transient bf16 overflow
        # cannot poison the run (see OptimizerConfig.skip_nonfinite).
        tx = optax.apply_if_finite(tx, cfg.skip_nonfinite)
    return tx


def freeze_mask_grads(grads: Params, trainable: Params) -> Params:
    """Zero gradients of frozen leaves (trainable=False)."""
    return jax.tree.map(
        lambda g, t: g if t else jnp.zeros_like(g), grads, trainable
    )


def _is_constrained_kernel(path) -> bool:
    """LSTM input kernels 'W' under a blstm/fusion subtree carry
    maxnorm(3); recurrent kernels 'U', biases, dense and conv do not."""
    names = [getattr(p, "key", None) for p in path]
    return names[-1] == "W" and any(
        isinstance(n, str) and (n.startswith("blstm") or n == "fusion")
        for n in names
    )


def apply_maxnorm(params: Params, max_value: Optional[float]) -> Params:
    """Project constrained kernels to column norm <= max_value.

    Gate-blocked kernel W (D, F, 4, H): the Keras fused kernel column is
    the fan-in (F) slice for one (direction, gate, hidden unit), so the
    norm reduces over axis 1."""
    if max_value is None:
        return params

    def proj(path, w):
        if not _is_constrained_kernel(path):
            return w
        norms = jnp.sqrt(
            jnp.sum(jnp.square(w), axis=1, keepdims=True) + 1e-12
        )
        scale = jnp.minimum(1.0, max_value / norms)
        return w * scale

    return jax.tree_util.tree_map_with_path(proj, params)


def plateau_from_config(cfg) -> "ReduceLROnPlateau | None":
    """Build the plateau controller a PipelineConfig describes (or None).

    Shared by fit() and by chunked drivers (curriculum_bench's
    wall-clock-to-accuracy loop) that must keep ONE controller alive
    across several fit() calls: constructing a fresh controller per
    chunk resets lr_scale to 1.0 at every chunk boundary, catapulting
    the loss back up the escape ladder (measured round 5: the speech
    stage sawtoothed 16 -> 38 -> 17 every 400 epochs and the 1e-4
    persistence that breaks CTC blank-floor plateaus never
    accumulated)."""
    if cfg.reduce_lr_factor is None:
        return None
    return ReduceLROnPlateau(
        cfg.reduce_lr_factor, cfg.reduce_lr_patience,
        cfg.reduce_lr_min, cfg.optimizer.learning_rate,
        min_delta=cfg.reduce_lr_min_delta,
        cooldown=cfg.reduce_lr_cooldown,
    )


class ReduceLROnPlateau:
    """Host-side LR controller matching keras.callbacks.ReduceLROnPlateau
    (factor/patience/min_lr/cooldown as in rgb_network/cnn_lstm.py:
    439-444, which monitors 'loss' — the TRAIN loss — with cooldown=2).

    Tracked as a multiplicative scale the train step consumes, so the
    jitted computation never recompiles on LR change."""

    def __init__(self, factor: float, patience: int, min_lr: float,
                 base_lr: float, min_delta: float = 1e-4,
                 cooldown: int = 0):
        self.factor = factor
        self.patience = patience
        self.min_scale = min_lr / base_lr
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.best = float("inf")
        self.wait = 0
        self.scale = 1.0

    def is_pristine(self) -> bool:
        """True iff the controller has never observed a loss — the state
        a freshly constructed controller (e.g. in a restarted process)
        is in. fit(resume=True) only restores persisted plateau state
        into pristine controllers, so an in-process chunked driver's
        already-annealed controller is never clobbered by older on-disk
        state."""
        return (self.scale == 1.0 and self.best == float("inf")
                and self.wait == 0 and self.cooldown_counter == 0)

    def state_dict(self) -> dict:
        """JSON-serializable mutable state (persisted in the fitmeta
        sidecar so a crash-resume continues at the annealed LR instead
        of re-catapulting to the base LR — measured round 5: a process
        kill + resume at scale 1.0 threw a skeletal run from loss 1.09
        back to 9.6 with val divergence)."""
        return {"scale": self.scale, "best": self.best,
                "wait": self.wait,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, d: dict) -> None:
        self.scale = float(d["scale"])
        self.best = float(d["best"])
        self.wait = int(d["wait"])
        self.cooldown_counter = int(d["cooldown_counter"])

    def update(self, monitored: float) -> float:
        # Keras cooldown semantics: for `cooldown` updates after a
        # reduction, patience does not accumulate (wait pinned to 0),
        # so the controller cannot re-fire back-to-back while the run
        # adjusts to the new LR.
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        # Improvements below min_delta do not reset patience — a run
        # that descends continuously but negligibly still anneals
        # (keras min_delta semantics; default 1e-4 matches keras).
        if monitored < self.best - self.min_delta:
            self.best = monitored
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.cooldown_counter = self.cooldown
                self.wait = 0
        return self.scale
