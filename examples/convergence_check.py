"""Production-path convergence check on the GPU.

The CPU test suite proves the f32 XLA paths learn
(tests/test_evaluate.py); this script proves the PRODUCTION path does —
bf16 compute, the Triton CTC kernel, full 1900-frame padded
geometry, reference-parity semantics (padded_length_parity, 2-frame
trim, per-gate dropout, maxnorm(3), GaussianNoise, Adam decay; see
/root/reference/audio_network/{data_generator.py:223, losses.py:9-11},
speech_lstm_ctc_words.py:42-44,115-116) — by near-memorizing separable
synthetic corpora in the reference's on-disk formats for BOTH uni-modal
pipelines and reporting decoded token accuracy.

Run on a GPU: `python examples/convergence_check.py`. Prints one JSON
line. Budget note: at this 5%-content / 95%-padding geometry the
1898-frame CTC lattice takes a while to escape the all-blank basin —
skeletal needed 1000 epochs to reach ~1.0 train accuracy where 400 were
not enough (measured 0.0), on the accelerator this code was first
built for; not yet measured on the GPU.
`MGR_TPU_CONV_{FILES,EPOCHS,MAXLEN,BATCH,LR,ONLY}` override.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mgr_tpu.core import config as cfglib
from mgr_tpu.data import datasets, synthetic
from mgr_tpu.decode.evaluate import evaluate_accuracy
from mgr_tpu.models import build_model
from mgr_tpu.train.loop import fit

N_FILES = int(os.environ.get("MGR_TPU_CONV_FILES", "96"))
EPOCHS = int(os.environ.get("MGR_TPU_CONV_EPOCHS", "400"))
MAXLEN = int(os.environ.get("MGR_TPU_CONV_MAXLEN", "1900"))
BATCH = int(os.environ.get("MGR_TPU_CONV_BATCH", "32"))
LR = float(os.environ.get("MGR_TPU_CONV_LR", "3e-3"))
# "" runs speech+skeletal; each pipeline name runs that stage alone:
# speech | skeletal | late_fusion | early_fusion | rgb
ONLY = os.environ.get("MGR_TPU_CONV_ONLY", "")
# CPU smoke knob only (tests/test_examples.py): shrinks every hidden
# width so the full fusion path (pretrain-resume -> graft -> anneal)
# runs in seconds on the 1-CPU host. The real check always runs at the
# production widths (scale 1).
HIDDEN_SCALE = float(os.environ.get("MGR_TPU_CONV_HIDDEN_SCALE", "1"))
# Host-sync cadence (fit(sync_every=...)): sub-second epochs at
# per-epoch sync mean several host round-trips per second, each of
# which drains the device queue. 10 cuts them 10x at a 10-epoch
# best-state granularity — irrelevant here, the eval gate measures the
# slots.
SYNC = int(os.environ.get("MGR_TPU_CONV_SYNC", "10"))
# Persistent corpus root: generators skip regeneration on repeat runs.
REUSE = bool(os.environ.get("MGR_TPU_CONV_ROOT", ""))
# MGR_TPU_CONV_GUARD=1: skip non-finite updates
# (OptimizerConfig.skip_nonfinite) in EVERY stage. Off by default
# because the optax wrapper changes the opt-state checkpoint layout —
# a guarded run can only resume guarded checkpoints (and vice versa).
# Measured need (round 3, /tmp/conv_wd6/skeletal_metrics.jsonl): the
# unguarded skeletal pretrain at 5e-4 went NaN at ~ep 3200 and the NaN
# poisoned params permanently — one bad batch ends an hours-long run.
GUARD = int(os.environ.get("MGR_TPU_CONV_GUARD", "0") or 0)
# MGR_TPU_CONV_PLATEAU="factor:patience:min_lr[:min_delta]" (or "1" for the default
# 0.5:50:3e-4): ReduceLROnPlateau on the monitored TRAIN loss in every
# stage. The dense-corpus skeletal pretrain OSCILLATES at the fixed
# big-batch escape LR 3e-3 (train loss 9-31 for 1900+ epochs) but
# converges when annealed — the self-annealing schedule subsumes the
# hand-tuned _LR2/_EPOCHS2 legs.
_PLATEAU = os.environ.get("MGR_TPU_CONV_PLATEAU", "")
if _PLATEAU in ("1", "true"):
    _PLATEAU = "0.5:50:3e-4"
PLATEAU = (
    tuple(float(x) for x in _PLATEAU.split(":")) if _PLATEAU else None
)


def _opt(lr: float) -> "cfglib.OptimizerConfig":
    return cfglib.OptimizerConfig(
        learning_rate=lr, decay=1e-5, maxnorm=3.0,
        skip_nonfinite=100 if GUARD else 0,
    )


def _scaled(hidden: int) -> int:
    return max(4, int(hidden * HIDDEN_SCALE))


def _plateau_fields() -> dict:
    factor, patience, min_lr = PLATEAU[:3]
    fields = {
        "reduce_lr_factor": factor,
        "reduce_lr_patience": int(patience),
        "reduce_lr_min": min_lr,
    }
    # Optional 4th field: min_delta — improvements smaller than this do
    # not reset patience (see reduce_lr_min_delta; measured round-3
    # fusion grind improves ~1e-3/window, above the keras default 1e-4,
    # so the anneal never fires without raising it).
    if len(PLATEAU) > 3:
        fields["reduce_lr_min_delta"] = PLATEAU[3]
    return fields


def _pretrain_blank_bias(stage: str) -> float:
    raw = os.environ.get("MGR_TPU_CONV_PRETRAIN_BLANK_BIAS", "")
    if not raw:
        return 0.0
    if ":" not in raw:
        return float(raw)
    table = dict(kv.split(":") for kv in raw.split(","))
    return float(table.get(stage, 0) or 0)


def _pretrain_ladder(stage: str) -> list:
    """Per-stage pretrain LR ladder: MGR_TPU_CONV_PRETRAIN_LADDER=
    "skeletal:3e-4x5000+1e-4x8000" — '+'-separated legs of LRxTOTAL
    (cumulative epoch target, so resumed invocations are idempotent),
    ';'-separated stages. Supersedes the single _PRETRAIN_LR2/_EPOCHS2
    leg for stages it names. Motivation (round-4 fusion_leg1): the
    dense-corpus skeletal pretrain ground at loss 9.15 for the whole
    1000-epoch 3e-4 leg; the round-3 calibration says ~2000 epochs of
    low-LR persistence (1e-4) is what breaks this plateau (7.7 -> 3.6),
    so the recipe needs MULTIPLE anneal legs, not one."""
    raw = os.environ.get("MGR_TPU_CONV_PRETRAIN_LADDER", "")
    if not raw:
        return []
    for part in raw.split(";"):
        name, _, legs = part.partition(":")
        if name.strip() != stage or not legs:
            continue
        # Validate eagerly: a malformed leg must fail AT STARTUP with a
        # named culprit, not crash hours into a run on int('')
        # (ADVICE r4). Descending totals would silently no-op legs.
        out = []
        for leg in legs.split("+"):
            lr, sep, total = leg.partition("x")
            if not sep or not lr.strip() or not total.strip():
                raise SystemExit(
                    f"MGR_TPU_CONV_PRETRAIN_LADDER: leg '{leg}' of stage "
                    f"'{stage}' is not LRxTOTAL (e.g. '1e-4x8000')"
                )
            try:
                out.append((float(lr), int(total)))
            except ValueError as e:
                raise SystemExit(
                    f"MGR_TPU_CONV_PRETRAIN_LADDER: leg '{leg}' of stage "
                    f"'{stage}': {e}"
                ) from None
        totals = [t for _, t in out]
        if totals != sorted(totals):
            raise SystemExit(
                f"MGR_TPU_CONV_PRETRAIN_LADDER: stage '{stage}' totals "
                f"{totals} must be ascending (cumulative epoch targets; "
                f"a descending leg silently no-ops)"
            )
        return out
    return []


def _parity_overrides(cfg, hidden):
    """Production widths + parity semantics; regularization rates scaled
    down for a small synthetic corpus (the reference's 0.5-0.6 rates are
    sized for ~400 real files)."""
    cfg = cfg.replace(
        maxlen=MAXLEN, batch_size=BATCH,
        encoder=cfglib.EncoderConfig(
            hidden=_scaled(hidden), depth=2, input_noise=0.05,
            dropout=(0.02, 0.02), output_dropout=0.02,
            per_gate_dropout=True,
        ),
        optimizer=_opt(LR),
        patience=10_000,
        # MGR_TPU_CONV_PRETRAIN_BLANK_BIAS: CTC blank-dominance
        # mitigation for the UNI-MODAL stages (head_blank_bias, an
        # init-time knob — only effective for fresh heads, i.e. runs
        # without an existing checkpoint). "-3" applies to every
        # uni-modal stage; "skeletal:-3" (comma-separated table) per
        # stage. Round-3 evidence: the ChaLearn-density skeletal
        # pretrain oscillates at its blank floor at 3e-3 and the
        # plateau controller anneals it INTO the floor; the biased head
        # is the measured escape lever at tiny scale (CLAUDE.md
        # round-3 fusion findings).
        head_blank_bias=_pretrain_blank_bias(cfg.name),
        **(_plateau_fields() if PLATEAU else {}),
    )
    assert cfg.ctc.padded_length_parity and cfg.ctc.trim_frames == 2
    assert cfg.compute_dtype == "bfloat16", "must run the production dtype"
    return cfg


def _run(name, cfg, ds):
    # monitor="train" + keep_best_state: on a memorization corpus val
    # loss rises monotonically once the train split is fit, so best-val
    # selection would return the LEAST-trained state; best-train is also
    # robust to late-training divergence of the final state (measured in
    # round 2: speech at lr 3e-3 hit loss 0.006 then blew up ~ep 950).
    model = build_model(cfg)
    t0 = time.time()
    res = fit(model, ds, workdir=None, epochs=EPOCHS,
              monitor="train", keep_best_state=True, sync_every=SYNC)
    wall = time.time() - t0
    best = res.best_state if res.best_state is not None else res.state
    train_acc = evaluate_accuracy(model, best.params, ds,
                                  train_split=True)
    return {
        "train_accuracy": round(train_acc["accuracy"], 4),
        "train_wer": round(train_acc["wer"], 4),
        "epochs": res.epochs_run,
        "wall_s": round(wall, 1),
        "best_train_loss": round(res.best_val_loss, 3),
    }


def _run_fusion(root):
    """The flagship configuration: pretrain both uni-modal encoders
    (briefly — they only seed the frozen transfer), graft them into the
    late-fusion model exactly as the curriculum does (multimodal.py's
    frozen-Bidirectional transfer), and train the fusion stage on the
    production path. Both synthetic streams encode the SAME gesture
    sequences per file id, like the real dataset."""
    import dataclasses

    from mgr_tpu.core import checkpoint as ckpt_lib
    from mgr_tpu.core import prng
    from mgr_tpu.train.curriculum import build_fusion_with_pretrained
    from mgr_tpu.train.step import create_train_state

    # Persist pretrained encoders across invocations (they cost ~25 min
    # on the chip) — set MGR_TPU_CONV_WORKDIR to reuse; corpora are
    # seed-deterministic so the datasets match.
    workdir = os.environ.get("MGR_TPU_CONV_WORKDIR") or os.path.join(
        root, "fusion_wd"
    )
    os.makedirs(workdir, exist_ok=True)

    # ChaLearn-density corpus: up to 20 gestures/sample at ~90 skeletal
    # frames each (~20 fps), so content fills most of the 1900-frame
    # window like the real data (each ChaLearn session has 8-20
    # gestures). Measured: a 4-label/96-frame corpus (95% padding) holds
    # the frozen-encoder fusion head in the CTC all-blank basin for
    # thousands of epochs — a synthetic-geometry artifact the real task
    # does not have, and the uni-modal stages escape only because their
    # encoders are trainable.
    fusion_fpl = int(os.environ.get("MGR_TPU_CONV_FUSION_FPL", "90"))
    fusion_max_labels = int(
        os.environ.get("MGR_TPU_CONV_FUSION_LABELS", "20")
    )
    sk_csv, sk_labels, labels = synthetic.make_skeletal_dataset(
        root, n_files=N_FILES, frames_per_label=fusion_fpl,
        max_labels=fusion_max_labels, seed=4, reuse=REUSE,
    )
    # Audio at 5x the skeletal frame rate: after the pipeline's x5
    # downsample both streams advance through the SAME gesture at the
    # same frame index, like the real dataset (shared session clock).
    # A mismatched rate (150 -> 30 post-downsample vs skeletal's 24)
    # makes the streams assert DIFFERENT gestures at the same frame —
    # measured: with perfect (1.0 / 0.997) frozen encoders that ceiling
    # held fusion at train loss ~3 with 0.0 argmax accuracy.
    audio_dir, _, _ = synthetic.make_audio_dataset(
        root, n_files=N_FILES, n_classes=22,
        frames_per_label=5 * fusion_fpl, seed=0, labels=labels,
        reuse=REUSE,
    )

    # Full budget for the encoders too: the fusion head is trained on
    # FROZEN encoder features, so under-pretrained encoders (especially
    # skeletal, which needs ~1000 epochs to escape the all-blank basin
    # at this padding ratio) starve it. Override via
    # MGR_TPU_CONV_PRETRAIN.
    pretrain_epochs = int(os.environ.get("MGR_TPU_CONV_PRETRAIN", "0")) \
        or EPOCHS
    # LR-anneal legs for the PRETRAINS (MGR_TPU_CONV_PRETRAIN_LR2 /
    # _PRETRAIN_EPOCHS2), mirroring the fusion-stage anneal below.
    # Measured (round 3, /tmp/fusion_r3e.log): at the ChaLearn-density
    # corpus the skeletal BiLSTM(300)x2 at the big-batch escape LR 3e-3
    # OSCILLATES at train loss 9-31 for 1900 epochs (grad norms ~10,
    # one excursion to 31) — an LR floor, not a capacity limit — which
    # starves the frozen-encoder fusion stage (encoder train accuracy
    # 0.186; fusion then plateaus at ~1 nat/label). The same two-phase
    # schedule that fixes fusion (escape at 3e-3, anneal to converge)
    # is what the pretrains need.
    pretrain_lr2 = float(
        os.environ.get("MGR_TPU_CONV_PRETRAIN_LR2", "0") or 0
    )
    pretrain_epochs2 = int(
        os.environ.get("MGR_TPU_CONV_PRETRAIN_EPOCHS2", "0") or 0
    )
    sp_cfg = _parity_overrides(cfglib.get_preset("speech"), 500)
    sk_cfg = _parity_overrides(cfglib.get_preset("skeletal"), 300)
    from mgr_tpu.core import checkpoint as _ck

    encoder_quality = {}
    for name, cfg, ds in (
        ("speech", sp_cfg,
         datasets.build_audio_dataset(audio_dir, sk_labels, sp_cfg)),
        ("skeletal", sk_cfg,
         datasets.build_skeletal_dataset(sk_csv, sk_labels, sk_cfg)),
    ):
        # monitor="train": the "best" slot must hold the
        # best-TRAIN state — best-val on a memorization corpus is
        # the blank-basin state (round-2 failure mode: fusion froze
        # encoders grafted from exactly that slot).
        # checkpoint_every: serializing ~100 MB trees per
        # sub-second epoch would dominate the run.
        # resume=True makes the pretrain idempotent AND restartable:
        # fit() derives start_epoch from the checkpointed step, so a
        # killed run continues where it left off, and a finished one
        # returns immediately (start_epoch >= epochs).
        fit(build_model(cfg), ds, workdir=workdir, resume=True,
            epochs=pretrain_epochs, checkpoint_every=100,
            monitor="train", sync_every=SYNC)
        ladder = _pretrain_ladder(name) or (
            [(pretrain_lr2, pretrain_epochs + pretrain_epochs2)]
            if pretrain_lr2 > 0 and pretrain_epochs2 > 0 else []
        )
        for leg_lr, leg_total in ladder:
            cfg2 = cfg.replace(optimizer=_opt(leg_lr))
            fit(build_model(cfg2), ds, workdir=workdir, resume=True,
                epochs=leg_total,
                checkpoint_every=100, monitor="train", sync_every=SYNC)
        # Gate the graft on measured encoder quality: a fusion head on
        # frozen garbage features cannot converge, so prove the inputs.
        from mgr_tpu.train.loop import load_params_for_eval

        enc_model = build_model(cfg)
        enc_params = load_params_for_eval(enc_model, workdir, slot="best")
        acc = evaluate_accuracy(enc_model, enc_params, ds,
                                train_split=True)
        encoder_quality[name] = round(acc["accuracy"], 4)

    # MGR_TPU_CONV_REQUIRE_ENC: abort BEFORE spending fusion-stage chip
    # time when a pretrained encoder is below this decoded-accuracy
    # floor — a frozen-feature head on garbage features cannot converge
    # (round-4 fusion_leg1: skeletal encoder 0.1386 -> fusion 0.0 after
    # 3000 epochs; the 20 device-minutes were known-wasted at graft time).
    require_enc = float(
        os.environ.get("MGR_TPU_CONV_REQUIRE_ENC", "0") or 0
    )
    if require_enc and min(encoder_quality.values()) < require_enc:
        print(json.dumps({
            "metric": "production_path_convergence",
            "aborted": "encoder_below_floor",
            "require_enc": require_enc,
            "encoder_train_accuracy": encoder_quality,
        }))
        sys.exit(3)

    lf = cfglib.get_preset("late_fusion")
    # MGR_TPU_CONV_FUSION_BATCH: batch size for the FUSION stage only
    # (pretrains keep MGR_TPU_CONV_BATCH so their resume geometry is
    # stable). The reference trains this stage at batch 2
    # (multimodal.py:213) — small-batch gradient noise is part of its
    # convergence recipe, which the big-batch escape-LR recipe did not
    # replicate (legs 3-4 stalled at the blank floor at B=32).
    fusion_batch = int(
        os.environ.get("MGR_TPU_CONV_FUSION_BATCH", "") or BATCH
    )
    if fusion_batch <= 0:
        # An explicit "0" is truthy as a string but crashes the batcher
        # (same class as the round-4d truthy-"0" default bug) — fall
        # back to the corpus batch size.
        fusion_batch = BATCH
    lf_cfg = lf.replace(
        maxlen=MAXLEN, batch_size=fusion_batch,
        fusion_hidden=_scaled(lf.fusion_hidden),
        encoder=dataclasses.replace(
            lf.encoder, input_noise=0.05, output_dropout=0.02,
            per_gate_dropout=True,
        ),
        # Regularization rates scaled down like the uni-modal stages
        # (the reference's 0.5s are sized for the real 400-file corpus);
        # the parity-critical maxnorm/trim/padded-length semantics stay.
        fusion_dropout=0.02,
        fusion_output_dropout=0.02,
        optimizer=_opt(LR),
        patience=10_000,
        # MGR_TPU_CONV_BLANK_BIAS: opt-in CTC blank-dominance mitigation
        # (PipelineConfig.head_blank_bias) — only effective for a FRESH
        # fusion head (it is an init-time bias), i.e. without RESUME.
        head_blank_bias=float(
            os.environ.get("MGR_TPU_CONV_BLANK_BIAS", "0") or 0
        ),
        **(_plateau_fields() if PLATEAU else {}),
    )
    resume_fusion = (
        os.environ.get("MGR_TPU_CONV_RESUME") == "1"
        and ckpt_lib.has_checkpoint(workdir, "late_fusion", "latest")
    )
    fusion_model, grafted = build_fusion_with_pretrained(
        workdir, lf_cfg, {"speech": sp_cfg, "skeletal": sk_cfg},
    )
    if not resume_fusion:
        # Seed the latest slot with the grafted params (fresh fusion
        # training); with MGR_TPU_CONV_RESUME=1 an existing fusion
        # checkpoint continues instead.
        state = create_train_state(fusion_model, prng.root_key(lf_cfg.seed))
        state = state._replace(params=grafted)
        ckpt_lib.save_checkpoint(workdir, lf_cfg.name, state, slot="latest")

    fusion_ds = datasets.build_late_fusion_dataset(
        audio_dir, sk_csv, sk_labels, lf_cfg,
    )
    model = fusion_model
    t0 = time.time()
    res = fit(model, fusion_ds, workdir=workdir, resume=True,
              epochs=EPOCHS, checkpoint_every=100,
              monitor="train", keep_best_state=True, sync_every=SYNC)
    # Optional LR-anneal leg (MGR_TPU_CONV_LR2 / _EPOCHS2): continue
    # from the latest checkpoint at a lower LR — the big-batch escape
    # LR (3e-3 vs the reference's 1e-4) leaves an oscillation floor
    # around loss ~4.5 once the head is out of the blank basin.
    lr2 = float(os.environ.get("MGR_TPU_CONV_LR2", "0") or 0)
    epochs2 = int(os.environ.get("MGR_TPU_CONV_EPOCHS2", "0") or 0)
    # MGR_TPU_CONV_FINETUNE=1: the anneal leg runs with UNFROZEN
    # encoders (PipelineConfig.finetune_encoders, a framework extension
    # — the reference always freezes). Intended as the final leg after
    # the frozen-head stage: every trainable stack at this geometry
    # converges (speech/skeletal/early_fusion/rgb rows), while the
    # frozen big-batch head stalls at the blank floor (legs 3-4).
    finetune = os.environ.get("MGR_TPU_CONV_FINETUNE") == "1"
    if lr2 > 0 and epochs2 > 0:
        from mgr_tpu.models import build_model as _bm

        lf_cfg2 = lf_cfg.replace(optimizer=_opt(lr2),
                                 finetune_encoders=finetune)
        model = _bm(lf_cfg2,
                    source_configs={"speech": sp_cfg, "skeletal": sk_cfg})
        res = fit(model, fusion_ds, workdir=workdir, resume=True,
                  epochs=EPOCHS + epochs2, checkpoint_every=100,
                  monitor="train", keep_best_state=True,
                  sync_every=SYNC)
    wall = time.time() - t0
    best = res.best_state if res.best_state is not None else res.state
    acc = evaluate_accuracy(model, best.params, fusion_ds,
                            train_split=True)
    # Threshold-0 probe: the production decode (multimodal
    # sequence_decoding.py convention) keeps only frames whose peak
    # softmax exceeds 0.5; argmax-only accuracy separates "wrong
    # structure" from "right structure, not yet confident".
    import dataclasses as _dc

    from mgr_tpu.decode.decoder import DECODE_SPECS

    acc0 = evaluate_accuracy(
        model, best.params, fusion_ds, train_split=True,
        spec=_dc.replace(DECODE_SPECS["late_fusion"], threshold=0.0,
                         drop_blank=True),
    )
    return {
        "train_accuracy": round(acc["accuracy"], 4),
        "train_wer": round(acc["wer"], 4),
        "train_accuracy_no_threshold": round(acc0["accuracy"], 4),
        "encoder_train_accuracy": encoder_quality,
        "epochs": EPOCHS,
        "anneal_epochs": epochs2 if (lr2 > 0 and epochs2 > 0) else 0,
        # Report what actually RAN: with MGR_TPU_CONV_FINETUNE=1 but no
        # anneal leg configured, no finetuning happened (ADVICE r4 —
        # campaign harvests grep these JSON lines).
        "finetune_encoders": bool(finetune and lr2 > 0 and epochs2 > 0),
        "pretrain_epochs": pretrain_epochs,
        "wall_s": round(wall, 1),
        "best_train_loss": round(res.best_val_loss, 3),
    }


def _run_early_fusion(root):
    """Early feature-level fusion on the production path: monolithic
    labeled audio (x5 downsample) + skeletal stream, BiLSTM(500)x2 over
    the 59-feat concat (early_multimodal.py:321-424)."""
    sk_csv, _, labels = synthetic.make_skeletal_dataset(
        root, n_files=N_FILES, frames_per_label=24, max_labels=4, seed=4,
        reuse=REUSE,
    )
    # Audio rides at x5 the skeletal frame rate pre-downsample.
    audio_csv = synthetic.make_monolithic_audio_dataset(
        root, labels, frames_per_label=120, seed=2, reuse=REUSE,
    )
    cfg = _parity_overrides(cfglib.get_preset("early_fusion"), 500)
    cfg = cfg.replace(second_stream_noise=0.05)
    ds = datasets.build_early_fusion_dataset(audio_csv, sk_csv, cfg)
    return _run("early_fusion", cfg, ds)


def _run_rgb(root):
    """RGB CNN-LSTM on the production path (bf16 conv frontend + Pallas
    BLSTM, cnn_lstm.py:251-375). Smaller geometry than the uni-modal
    stages: the point is that the conv-VJP/bf16/Pallas path LEARNS, not
    scale."""
    maxlen = int(os.environ.get("MGR_TPU_CONV_RGB_MAXLEN", "80"))
    files = int(os.environ.get("MGR_TPU_CONV_RGB_FILES", "48"))
    data_dir, label_file, _ = synthetic.make_rgb_dataset(
        root, n_files=files, frames_per_label=16, max_labels=4, seed=3,
        reuse=REUSE,
    )
    import dataclasses as _dc

    rgb_preset = cfglib.get_preset("rgb")
    cfg = rgb_preset.replace(
        maxlen=maxlen,
        encoder=_dc.replace(
            rgb_preset.encoder, hidden=_scaled(rgb_preset.encoder.hidden)
        ),
        batch_size=int(os.environ.get("MGR_TPU_CONV_RGB_BATCH", "8")),
        optimizer=cfglib.OptimizerConfig(
            learning_rate=float(
                os.environ.get("MGR_TPU_CONV_RGB_LR", "1e-3")
            ),
            maxnorm=3.0,
            skip_nonfinite=100 if GUARD else 0,
        ),
        patience=10_000,
        **(_plateau_fields() if PLATEAU else {}),
    )
    assert cfg.compute_dtype == "bfloat16"
    ds = datasets.build_rgb_dataset(data_dir, label_file, cfg)
    return _run("rgb", cfg, ds)


def main() -> None:
    import contextlib

    out = {}
    # MGR_TPU_CONV_ROOT: persistent corpus root. The generators are
    # seed-deterministic and sentinel-gated (synthetic._reuse_sentinel),
    # so repeat invocations (LR-ladder legs, resumed campaigns) skip the
    # multi-GB corpus regeneration entirely.
    persist = os.environ.get("MGR_TPU_CONV_ROOT", "")
    if persist:
        os.makedirs(persist, exist_ok=True)
        ctx = contextlib.nullcontext(persist)
    else:
        ctx = tempfile.TemporaryDirectory()
    with ctx as root:
        if ONLY in ("", "skeletal"):
            sk_csv, sk_labels, _ = synthetic.make_skeletal_dataset(
                root, n_files=N_FILES, frames_per_label=24, max_labels=4,
                seed=4, reuse=REUSE,
            )
            sk_cfg = _parity_overrides(cfglib.get_preset("skeletal"), 300)
            out["skeletal"] = _run(
                "skeletal", sk_cfg,
                datasets.build_skeletal_dataset(sk_csv, sk_labels, sk_cfg),
            )

        if ONLY in ("", "speech"):
            audio_dir, audio_labels, _ = synthetic.make_audio_dataset(
                os.path.join(root, "a"), n_files=N_FILES, n_classes=20,
                frames_per_label=150, max_labels=4, seed=0, reuse=REUSE,
            )
            sp_cfg = _parity_overrides(cfglib.get_preset("speech"), 500)
            out["speech"] = _run(
                "speech", sp_cfg,
                datasets.build_audio_dataset(audio_dir, audio_labels, sp_cfg),
            )

        if ONLY == "late_fusion":
            out["late_fusion"] = _run_fusion(root)

        if ONLY == "early_fusion":
            out["early_fusion"] = _run_early_fusion(root)

        if ONLY == "rgb":
            out["rgb"] = _run_rgb(root)

    print(json.dumps({
        "metric": "production_path_convergence",
        "geometry": {"maxlen": MAXLEN, "files": N_FILES,
                     "dtype": "bfloat16+pallas"},
        **out,
    }))


if __name__ == "__main__":
    main()
