"""Typed configuration system with per-pipeline presets.

Replaces the reference's hard-coded module constants and interactive
``raw_input`` prompts (see /root/reference/audio_network/speech_lstm_ctc_words.py:139-149,
/root/reference/rgb_network/cnn_lstm.py:28-38) with frozen dataclasses.
The canonical hyperparameters below are the reference's operating points,
preserved as defaults so parity runs reproduce its regime:

  batch 2 (reference single-GPU ceiling; we default much larger),
  maxlen 1900, audio feats 39, skeletal feats 20, image 60x60,
  classes 44 (speech words) / 22 (gestures), label caps 150/28/35,
  Adam lr 1e-4 + clipvalue 0.5 (+ decay 1e-5 where the reference uses it),
  dropout 0.4-0.6, GaussianNoise sigma 0.5, epochs <=500, patience 20.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout.

    Axes: data (DP, batch), model (TP, LSTM hidden blocks), time (SP —
    the time axis of inputs/projections shards for the pointwise and
    conv stages; XLA all-gathers before the serial recurrence, which is
    the honest treatment of an RNN's time axis, SURVEY.md §5.7)."""

    data: int = 1
    model: int = 1
    time: int = 1
    # Axis names used across the codebase for sharding annotations.
    data_axis: str = "data"
    model_axis: str = "model"
    time_axis: str = "time"

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.time


@dataclass(frozen=True)
class OptimizerConfig:
    """Adam with element-wise value clipping, inverse-time decay, and
    Keras-style maxnorm kernel constraints.

    Mirrors the reference: Adam(lr=1e-4, clipvalue=0.5) at
    speech_lstm_ctc_words.py:115-116; decay=1e-5 for the skeletal and
    fusion stages (skeletal_lstm_ctc.py:374-376)."""

    learning_rate: float = 1e-4
    clipvalue: float = 0.5
    decay: float = 0.0  # Keras `decay`: lr_t = lr / (1 + decay * step)
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-7  # Keras 2.x default epsilon
    maxnorm: Optional[float] = 3.0  # kernel max-norm constraint (None = off)
    # Gradient accumulation: the train step splits its batch into
    # `accum_steps` microbatches and scans over them, so activation
    # memory is O(batch/accum_steps) — effective batch can exceed the
    # single-device memory ceiling. Gradients average across
    # microbatches; one optimizer update per step.
    accum_steps: int = 1
    # Skip parameter updates whose gradients are non-finite
    # (optax.apply_if_finite; the value bounds consecutive skips). bf16
    # training at aggressive large-batch LRs can hit a transient
    # overflow that makes ONE loss NaN — without the guard that single
    # step poisons the Adam state and the run never recovers (measured
    # round 3: skeletal pretrain NaN'd at epoch ~3165 and stayed NaN).
    # 0 disables — the default, because the wrapper changes the
    # opt-state tree layout and thus checkpoint compatibility.
    skip_nonfinite: int = 0


@dataclass(frozen=True)
class EncoderConfig:
    """One residual BLSTM encoder block: GaussianNoise -> BiLSTM x depth
    -> residual add of the last two layers -> dropout.

    The five reference pipelines all share this shape with different
    widths/rates (speech_lstm_ctc_words.py:53-83, skeletal_lstm_ctc.py:303-338,
    early_multimodal.py:348-374, cnn_lstm.py:301-330)."""

    hidden: int = 500
    depth: int = 2
    input_noise: float = 0.5  # GaussianNoise stddev (train only)
    dropout: Tuple[float, ...] = (0.4, 0.5)  # per-layer input dropout
    output_dropout: float = 0.5  # dropout after the residual add
    residual: bool = True
    # Keras-exact per-gate input dropout masks (4 masks, constant over
    # time). Default False uses one shared mask per layer, which keeps
    # the input projection a single large matmul; set True for
    # strict parity with keras.layers.LSTM(dropout=...).
    per_gate_dropout: bool = False


@dataclass(frozen=True)
class CNNConfig:
    """TimeDistributed conv frontend for the RGB stream.

    Three conv+maxpool blocks, 16@5x5 / 32@5x5 / 48@4x4, as in
    rgb_network/cnn_lstm.py:261-295."""

    channels: Tuple[int, ...] = (16, 32, 48)
    kernel_sizes: Tuple[int, ...] = (5, 5, 4)
    pool_sizes: Tuple[int, ...] = (2, 2, 2)
    img_dim: int = 60
    # Rematerialize the conv frontend in the backward pass: the
    # (B*T, 56, 56, 16)-scale conv activations dominate RGB residual
    # memory; jax.checkpoint trades one
    # extra conv forward for them, lifting the batch ceiling.
    remat: bool = True


@dataclass(frozen=True)
class CTCConfig:
    """CTC loss/decode conventions shared by every pipeline.

    blank = nb_classes - 1 (data_generator.py:42); labels padded with -1
    (data_generator.py:217-220); the first `trim_frames` RNN outputs are
    dropped before the loss ("the first couple outputs of the RNN tend
    to be garbage", audio_network/losses.py:9-11) and input_length is
    padded_len - trim_frames (data_generator.py:223)."""

    trim_frames: int = 2
    # True = reproduce the reference exactly: CTC runs over the padded
    # length (1900 - 2) regardless of the true sequence length.
    # False = mask to true lengths (usually trains better).
    padded_length_parity: bool = True


@dataclass(frozen=True)
class PipelineConfig:
    """Everything needed to build + train one of the five pipelines."""

    name: str = "speech"
    # --- data geometry -------------------------------------------------
    maxlen: int = 1900
    num_feats: int = 39
    nb_classes: int = 44
    max_label_len: int = 150
    downsample: int = 1  # temporal stride applied at featurization
    # --- model ----------------------------------------------------------
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    cnn: Optional[CNNConfig] = None  # RGB only
    ctc: CTCConfig = field(default_factory=CTCConfig)
    # Late fusion: names of the pretrained uni-modal stages to load+freeze.
    fusion_sources: Tuple[str, ...] = ()
    # Opt-in CTC blank-dominance mitigation: initialize the output
    # head's BLANK-logit bias to this value (reference-parity default
    # 0.0 — zero bias like keras Dense). A negative value (-2..-4)
    # counteracts the early all-blank basin on dense-content corpora:
    # the CTC alignment posterior is ~99% blank, so gradient descent
    # raises blank's logit first and label spikes must then outgrow it
    # (measured round 3: fusion head held at blank 0.995/frame with
    # spread label mass for 15k+ steps).
    head_blank_bias: float = 0.0
    # Late fusion: unfreeze the grafted encoders (end-to-end fine-tune).
    # The reference NEVER unfreezes (multimodal.py:33-55 keeps the
    # pretrained Bidirectional layers non-trainable), so False is the
    # parity default; True is a framework extension for a final
    # fine-tune leg after the frozen-head stage (PARITY.md).
    finetune_encoders: bool = False
    fusion_hidden: int = 100  # trainable fusion BLSTM width (multimodal.py:159-168)
    # Fusion-stage regularization; defaults are the reference's
    # (multimodal.py:164 dropout=0.5, :171-173 Dropout(0.5)).
    fusion_dropout: float = 0.5
    fusion_output_dropout: float = 0.5
    # Second input stream (early/late fusion): (num_feats, noise sigma).
    second_stream_feats: int = 0
    second_stream_noise: float = 0.0
    # --- training --------------------------------------------------------
    batch_size: int = 32  # per-replica; reference ceiling was 2 on a GTX 1060
    epochs: int = 500
    patience: int = 20
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    reduce_lr_factor: Optional[float] = None  # RGB: 0.5/patience 7/min 5e-5
    reduce_lr_patience: int = 7
    reduce_lr_min: float = 5e-5
    # Improvement below min_delta does NOT reset patience (keras-parity
    # default 1e-4). Raise it when a run can descend continuously but
    # too slowly to matter — measured failure mode: a fusion grind
    # improving ~1e-3/window resets patience forever and the anneal
    # never fires (CLAUDE.md round-3 findings).
    reduce_lr_min_delta: float = 1e-4
    # Keras cooldown: updates after a reduction during which patience
    # does not accumulate (reference: cnn_lstm.py:444 cooldown=2).
    reduce_lr_cooldown: int = 0
    # Which loss drives the plateau controller — INDEPENDENT of fit()'s
    # best-checkpoint/early-stop monitor. The reference's only wired
    # ReduceLROnPlateau monitors 'loss', i.e. the TRAIN loss
    # (cnn_lstm.py:439), so "train" is the parity default; "monitor"
    # follows fit(monitor=...) instead (the pre-round-4 behavior).
    reduce_lr_monitor: str = "train"
    seed: int = 47  # reference weight-init seed (speech_lstm_ctc_words.py:44)
    split_seed: int = 10  # reference split seed (data_generator.py:72)
    val_split: float = 0.2
    # --- numerics ---------------------------------------------------------
    compute_dtype: str = "bfloat16"  # matmul dtype; params/state stay f32
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw: Any) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "PipelineConfig":
        raw = json.loads(text)
        return _pipeline_from_dict(raw)


def _pipeline_from_dict(raw: Dict[str, Any]) -> PipelineConfig:
    raw = dict(raw)
    if raw.get("encoder") is not None:
        enc = dict(raw["encoder"])
        enc["dropout"] = tuple(enc["dropout"])
        raw["encoder"] = EncoderConfig(**enc)
    if raw.get("cnn") is not None:
        cnn = dict(raw["cnn"])
        for k in ("channels", "kernel_sizes", "pool_sizes"):
            cnn[k] = tuple(cnn[k])
        raw["cnn"] = CNNConfig(**cnn)
    if raw.get("ctc") is not None:
        raw["ctc"] = CTCConfig(**raw["ctc"])
    if raw.get("optimizer") is not None:
        raw["optimizer"] = OptimizerConfig(**raw["optimizer"])
    if raw.get("mesh") is not None:
        raw["mesh"] = MeshConfig(**raw["mesh"])
    raw["fusion_sources"] = tuple(raw.get("fusion_sources", ()))
    return PipelineConfig(**raw)


# ---------------------------------------------------------------------------
# Presets: the five reference pipelines.
# ---------------------------------------------------------------------------

def speech() -> PipelineConfig:
    """Word-level speech BLSTM+CTC (speech_lstm_ctc_words.py:32-134).

    39-d MFCC, x5 temporal downsample, BiLSTM(500)x2, 44 word classes."""
    return PipelineConfig(
        name="speech",
        maxlen=1900,
        num_feats=39,
        nb_classes=44,
        max_label_len=150,
        downsample=5,
        encoder=EncoderConfig(hidden=500, depth=2, input_noise=0.5,
                              dropout=(0.4, 0.5), output_dropout=0.5),
    )


def skeletal() -> PipelineConfig:
    """Skeletal BLSTM+CTC (skeletal_lstm_ctc.py:296-394).

    20 kinematic feats, BiLSTM(300)x2 dropout 0.6, 22 gesture classes,
    Adam decay 1e-5, label cap 28."""
    return PipelineConfig(
        name="skeletal",
        maxlen=1900,
        num_feats=20,
        nb_classes=22,
        max_label_len=28,
        encoder=EncoderConfig(hidden=300, depth=2, input_noise=0.5,
                              dropout=(0.6, 0.6), output_dropout=0.6),
        optimizer=OptimizerConfig(decay=1e-5),
    )


def rgb() -> PipelineConfig:
    """RGB CNN-LSTM (cnn_lstm.py:251-375).

    (T,60,60,1) video, 3 conv blocks, BiLSTM(512)x2, 22 classes,
    ReduceLROnPlateau(0.5, patience 7, min 5e-5)."""
    return PipelineConfig(
        name="rgb",
        maxlen=1900,
        num_feats=60 * 60,  # flattened frame; the CNN consumes (60, 60, 1)
        nb_classes=22,
        max_label_len=28,
        encoder=EncoderConfig(hidden=512, depth=2, input_noise=0.0,
                              dropout=(0.0, 0.0), output_dropout=0.0),
        cnn=CNNConfig(),
        reduce_lr_factor=0.5,
        reduce_lr_cooldown=2,  # cnn_lstm.py:444
        batch_size=8,
    )


def early_fusion() -> PipelineConfig:
    """Early feature-level fusion (early_multimodal.py:321-424).

    Audio 39 + skeletal 20 concatenated on the channel axis -> BiLSTM(500)x2
    dropout 0.4, 22 classes, label cap 35."""
    return PipelineConfig(
        name="early_fusion",
        maxlen=1900,
        num_feats=39,
        second_stream_feats=20,
        second_stream_noise=0.5,
        nb_classes=22,
        max_label_len=35,
        downsample=5,
        encoder=EncoderConfig(hidden=500, depth=2, input_noise=0.5,
                              dropout=(0.4, 0.4), output_dropout=0.4),
    )


def late_fusion() -> PipelineConfig:
    """Late multimodal fusion with frozen pretrained encoders
    (multimodal.py:58-215).

    Speech encoder (noise 0.5) + skeletal encoder (noise 0.0), both frozen,
    residual streams concatenated (1000-d + 600-d) -> trainable BiLSTM(100)
    -> Dense(22). Adam decay 1e-5, label cap 35."""
    return PipelineConfig(
        name="late_fusion",
        maxlen=1900,
        num_feats=39,
        second_stream_feats=20,
        second_stream_noise=0.0,
        nb_classes=22,
        max_label_len=35,
        downsample=5,
        encoder=EncoderConfig(hidden=500, depth=2, input_noise=0.5,
                              dropout=(0.0, 0.0), output_dropout=0.5),
        fusion_sources=("speech", "skeletal"),
        fusion_hidden=100,
        optimizer=OptimizerConfig(decay=1e-5),
    )


PRESETS = {
    "speech": speech,
    "skeletal": skeletal,
    "rgb": rgb,
    "early_fusion": early_fusion,
    "late_fusion": late_fusion,
}


def get_preset(name: str, **overrides: Any) -> PipelineConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown pipeline {name!r}; choose from {sorted(PRESETS)}")
    cfg = PRESETS[name]()
    return cfg.replace(**overrides) if overrides else cfg


def parse_stage_table(raw: str, stage: str, default=None):
    """Parse the campaign-env grammar shared by the MGR_TPU_* per-stage
    knobs (BLANK_BIAS / TARGET / ACC_TARGET tables): a bare float
    applies to every stage, ``"name:val,name:val"`` names stages
    explicitly. Returns ``default`` when ``raw`` is empty or the stage
    is absent. One implementation for every campaign driver — three
    hand-rolled copies had already drifted (review r5 finding)."""
    if not raw:
        return default
    if ":" not in raw:
        return float(raw)
    for part in raw.split(","):
        name, _, val = part.partition(":")
        if name.strip() == stage and val.strip():
            return float(val)
    return default
