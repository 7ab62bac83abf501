"""Held-out (generalization) accuracy check on the production path.

Every accuracy row before round 5 was TRAIN accuracy on memorization
corpora; the reference's actual quality-control loop — best-VAL
checkpoint + EarlyStopping (speech_lstm_ctc_words.py:167-178,
ModelCheckpoint save_best_only on val_loss + EarlyStopping patience) —
had only been exercised mechanically. This script
drives that loop end-to-end and reports HELD-OUT decoded accuracy:

  * corpus: the synthetic generators' shared generative process — every
    class has a fixed signature vector (synthetic.py::_class_signature)
    and every FILE is a fresh noise draw around it, so unseen files are
    decodable exactly iff the model learned the class structure rather
    than the training files;
  * split: the reference's seeded 80/20 file split
    (data_generator.py:72 semantics via PipelineConfig.split_seed);
  * selection: fit(monitor="val") + EarlyStopping(patience) keeping the
    best-val state — the reference's loop, not best-train;
  * metric: decoded token accuracy on the VAL split from the best-val
    state (mgr_tpu.decode.evaluate), plus the train split for the gap.

Run on a GPU: `python examples/generalization_check.py`. Prints one
JSON line.
`MGR_TPU_GEN_{FILES,EPOCHS,MAXLEN,BATCH,LR,ONLY,PATIENCE,...}` override
— see the knobs below. CPU smoke: tests/test_examples.py.
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

# 200 files -> 160 train / 40 val at the reference's 0.2 split: enough
# fresh noise draws per class (22 classes x ~14 labels/file) that
# memorizing the train files is strictly worse on val than learning the
# class signatures.
N_FILES = int(os.environ.get("MGR_TPU_GEN_FILES", "200"))
EPOCHS = int(os.environ.get("MGR_TPU_GEN_EPOCHS", "2000"))
MAXLEN = int(os.environ.get("MGR_TPU_GEN_MAXLEN", "1900"))
BATCH = int(os.environ.get("MGR_TPU_GEN_BATCH", "32"))
LR = float(os.environ.get("MGR_TPU_GEN_LR", "3e-3"))
# speech | skeletal (comma-separated for both; default both)
ONLY = os.environ.get("MGR_TPU_GEN_ONLY", "speech,skeletal")
HIDDEN_SCALE = float(os.environ.get("MGR_TPU_GEN_HIDDEN_SCALE", "1"))
SYNC = int(os.environ.get("MGR_TPU_GEN_SYNC", "10"))
# EarlyStopping patience — counts VAL WINDOWS when SYNC > 1 (the val
# pass only exists on sync epochs, train/loop.py), so the default 20
# windows = 200 epochs at SYNC=10, mirroring the reference's
# EarlyStopping(patience=20) at its ~10x smaller epoch granularity.
PATIENCE = int(os.environ.get("MGR_TPU_GEN_PATIENCE", "20"))
ROOT = os.environ.get("MGR_TPU_GEN_ROOT", "")
# Persistent checkpoint dir so a crash mid-stage RESUMES instead of
# restarting a multi-hour run. Defaults to
# <ROOT>/workdir whenever a persistent ROOT is given; "" (no ROOT, the
# CPU smokes) keeps the no-checkpoint behavior.
WORKDIR = os.environ.get("MGR_TPU_GEN_WORKDIR", "") or (
    os.path.join(ROOT, "workdir") if ROOT else ""
)
GUARD = int(os.environ.get("MGR_TPU_GEN_GUARD", "0") or 0)
# ChaLearn content density (8-20 gestures x ~90 skeletal frames) — the
# geometry every round-3/4 campaign used; 95%-padding corpora sit in
# the CTC all-blank basin for thousands of epochs (CLAUDE.md).
FPL = int(os.environ.get("MGR_TPU_GEN_FPL", "90"))
MAX_LABELS = int(os.environ.get("MGR_TPU_GEN_LABELS", "20"))
# Content-density floor: ChaLearn files carry 8-20 gestures; drawing
# k=1..20 uniform leaves ~50% padding on average and measurably pins
# the skeletal stack in the blank basin (r5d: frozen flat at 8.97).
MIN_LABELS = int(os.environ.get("MGR_TPU_GEN_MIN_LABELS", "1") or 1)
# Pretrain-quality gate for the fusion path (convergence_check's
# REQUIRE_ENC pattern): abort rc=3 before the fusion stage when an
# encoder's TRAIN accuracy is below the floor — a frozen head on
# garbage features wastes a 40-min leg (round-4 lesson).
REQUIRE_ENC = float(os.environ.get("MGR_TPU_GEN_REQUIRE_ENC", "0") or 0)
# Blank-dominance mitigation per stage ("skeletal:-3" table or a bare
# float for all) — measured unlock for skeletal-family CTC stacks and
# for the frozen-feature fusion head (PARITY.md opt-in knobs).
_BIAS = os.environ.get("MGR_TPU_GEN_BLANK_BIAS",
                       "skeletal:-3,late_fusion:-3")
# Frozen fusion head under reference dynamics (multimodal.py:206-213,
# batch 2 / constant 1e-4): B=8 is the measured equivalent (round-5
# fusion_b8). Epochs default to the global ceiling.
FUSION_BATCH = int(os.environ.get("MGR_TPU_GEN_FUSION_BATCH", "8") or 8)
FUSION_LR = float(os.environ.get("MGR_TPU_GEN_FUSION_LR", "1e-4"))
FUSION_EPOCHS = int(os.environ.get("MGR_TPU_GEN_FUSION_EPOCHS", "0") or 0)
# ReduceLROnPlateau per stage: "skeletal:0.5/15/1e-4" =
# factor/patience/min_lr following the monitored TRAIN loss
# (cfg.reduce_lr_monitor default) — the measured remedy for the
# skeletal 3e-3 oscillation floor (curriculum_bench measured mode
# reached 0.9962 train in 400 epochs with exactly this anneal, where
# the constant-LR generalization run early-stopped at val 0.119).
_RLR = os.environ.get("MGR_TPU_GEN_RLR", "")
# Per-stage regularization tables (bare float or "stage:val,..."):
# the defaults reproduce the round-5 speech row (0.1 everywhere).
# Measured (r5c): skeletal at dropout 0.1 + per-gate + noise 0.1 pins
# the blank-floor plateau and the anneal freezes it there (loss flat
# at 9.125), while the 1cmd-curriculum recipe (dropout 0.02, noise
# 0.05) escapes by epoch ~100 at the same geometry — regularization
# strength is the lever that decides whether the biased skeletal
# stack can leave the basin at all.
_DROPOUT = os.environ.get("MGR_TPU_GEN_DROPOUT", "")
_NOISE = os.environ.get("MGR_TPU_GEN_NOISE", "")
_PERGATE = os.environ.get("MGR_TPU_GEN_PERGATE", "")


def _blank_bias(stage: str) -> float:
    return cfglib.parse_stage_table(_BIAS, stage, default=0.0) or 0.0


def _rlr(stage: str) -> dict:
    if not _RLR:
        return {}
    spec = None
    for part in _RLR.split(","):
        name, _, val = part.partition(":")
        if name.strip() == stage and val.strip():
            spec = val.strip()
    if spec is None:
        return {}
    fields = spec.split("/")
    if len(fields) != 3:
        raise SystemExit(
            f"MGR_TPU_GEN_RLR entry for '{stage}' must be "
            f"factor/patience/min_lr, got '{spec}'")
    return {
        "reduce_lr_factor": float(fields[0]),
        "reduce_lr_patience": int(fields[1]),
        "reduce_lr_min": float(fields[2]),
    }


def _opt(lr: float) -> "cfglib.OptimizerConfig":
    return cfglib.OptimizerConfig(
        learning_rate=lr, decay=1e-5, maxnorm=3.0,
        skip_nonfinite=100 if GUARD else 0,
    )


def _cfg(name: str, hidden: int) -> "cfglib.PipelineConfig":
    drop = cfglib.parse_stage_table(_DROPOUT, name, default=0.1)
    noise = cfglib.parse_stage_table(_NOISE, name, default=0.1)
    pergate = bool(cfglib.parse_stage_table(_PERGATE, name, default=1.0))
    cfg = cfglib.get_preset(name)
    cfg = cfg.replace(
        maxlen=MAXLEN, batch_size=BATCH,
        encoder=cfglib.EncoderConfig(
            hidden=max(4, int(hidden * HIDDEN_SCALE)), depth=2,
            # Regularization actually matters here (unlike the
            # memorization checks): input noise + dropout push the
            # encoder toward the class signatures rather than file
            # identities. Rates still scaled below the reference's
            # 0.4-0.6 (sized for real 400-file ChaLearn data), and
            # per-stage tunable (_DROPOUT/_NOISE/_PERGATE) because the
            # skeletal stack's basin escape is regularization-bound.
            input_noise=noise, dropout=(drop, drop), output_dropout=drop,
            per_gate_dropout=pergate,
        ),
        optimizer=_opt(LR),
        patience=PATIENCE,
        head_blank_bias=_blank_bias(name),
        **_rlr(name),
    )
    assert cfg.ctc.padded_length_parity and cfg.ctc.trim_frames == 2
    return cfg


def _run(name: str, cfg, ds, *, workdir: str = "", epochs: int = 0,
         source_configs=None) -> dict:
    workdir = workdir or WORKDIR
    epochs = epochs or EPOCHS
    model = build_model(cfg, source_configs=source_configs)
    t0 = time.time()
    if workdir:
        os.makedirs(workdir, exist_ok=True)
    # The reference's quality-control loop: monitor the VAL loss,
    # early-stop on patience, keep the best-val state for decode.
    # With a persistent WORKDIR the run checkpoints and resumes (a
    # crash restart continues from `latest`; the `best` SLOT holds the
    # best-val state across restarts, which the decode below prefers
    # over the in-memory best of the final leg only).
    res = fit(model, ds, workdir=workdir or None, epochs=epochs,
              resume=bool(workdir), checkpoint_every=100,
              monitor="val", keep_best_state=True, sync_every=SYNC)
    wall = time.time() - t0
    best = res.best_state if res.best_state is not None else res.state
    best_params = best.params
    if workdir:
        from mgr_tpu.train.loop import load_params_for_eval

        try:
            best_params = load_params_for_eval(model, workdir, slot="best")
        except Exception:
            pass  # no best slot written yet — fall back to in-memory
    val = evaluate_accuracy(model, best_params, ds, train_split=False)
    train = evaluate_accuracy(model, best_params, ds, train_split=True)
    return {
        "val_accuracy": round(val["accuracy"], 4),
        "val_wer": round(val["wer"], 4),
        "train_accuracy": round(train["accuracy"], 4),
        "generalization_gap": round(
            train["accuracy"] - val["accuracy"], 4
        ),
        "epochs_run": res.epochs_run,
        "early_stopped": res.epochs_run < epochs,
        "best_val_loss": round(res.best_val_loss, 3),
        "wall_s": round(wall, 1),
    }


def _late_fusion_stage(root: str, reuse: bool, out: dict) -> None:
    """HELD-OUT accuracy for the flagship capability: the full frozen-
    encoder curriculum under the reference's quality-control loop.

    Both streams share label sequences and a clock (audio at 5x the
    skeletal frame rate pre-downsample, convergence_check pattern);
    encoders pretrain with fit(monitor='val') on the SHARED train
    split, the best-VAL encoder states are grafted and frozen
    (multimodal.py:58-148 semantics), and the fusion head trains under
    reference dynamics (small batch, constant 1e-4, blank-biased fresh
    head). The reported val_accuracy is decoded on files NO stage ever
    trained on — the closest available proxy for the reference's
    held-out 94% ChaLearn headline (README.md:30)."""
    from mgr_tpu.core import checkpoint as ckpt_lib
    from mgr_tpu.core import prng
    from mgr_tpu.train.curriculum import build_fusion_with_pretrained
    from mgr_tpu.train.step import create_train_state

    fus_root = os.path.join(root, "fusion")
    os.makedirs(fus_root, exist_ok=True)
    # The graft needs checkpoints: without a persistent ROOT, keep the
    # whole stage's workdir inside the run's tempdir.
    wd = WORKDIR or os.path.join(fus_root, "workdir")
    sk_csv, sk_lab, labels = synthetic.make_skeletal_dataset(
        fus_root, n_files=N_FILES, n_classes=22,
        frames_per_label=FPL, max_labels=MAX_LABELS, seed=12,
        reuse=reuse, min_labels=MIN_LABELS,
    )
    audio_dir, _, _ = synthetic.make_audio_dataset(
        fus_root, n_files=N_FILES, n_classes=22,
        frames_per_label=5 * FPL, max_labels=MAX_LABELS, seed=11,
        labels=labels, reuse=reuse,
    )
    cfg_sp = _cfg("speech", 500)
    cfg_sk = _cfg("skeletal", 300)
    pretrain_ds = (
        ("speech", cfg_sp,
         lambda: datasets.build_audio_dataset(audio_dir, sk_lab, cfg_sp)),
        ("skeletal", cfg_sk,
         lambda: datasets.build_skeletal_dataset(sk_csv, sk_lab, cfg_sk)),
    )
    for name, cfg, make_ds in pretrain_ds:
        # Sentinel per pretrain: a relaunch after a fusion-stage crash
        # must not spend patience-worth of extra epochs re-entering a
        # converged pretrain.
        sent = os.path.join(root, f"pretrain_{name}.json") if ROOT else ""
        if sent and os.path.exists(sent):
            with open(sent) as f:
                out[f"pretrain_{name}"] = json.load(f)
            continue
        row = _run(name, cfg, make_ds(), workdir=wd)
        out[f"pretrain_{name}"] = row
        print(json.dumps({"stage": f"pretrain_{name}", **row}),
              flush=True)
        if sent:
            with open(sent, "w") as f:
                json.dump(row, f)
    if REQUIRE_ENC:
        for name in ("speech", "skeletal"):
            acc = out[f"pretrain_{name}"]["train_accuracy"]
            if acc < REQUIRE_ENC:
                print(json.dumps({
                    "metric": "heldout_generalization",
                    "aborted": f"pretrain_{name} train accuracy "
                               f"{acc} < REQUIRE_ENC {REQUIRE_ENC}",
                    **out,
                }), flush=True)
                # Drop the failing pretrain's sentinel so a requeue
                # retrains it instead of re-aborting on the cached row.
                sent = os.path.join(root, f"pretrain_{name}.json")
                if ROOT and os.path.exists(sent):
                    os.remove(sent)
                sys.exit(3)
    lf_cfg = cfglib.get_preset("late_fusion").replace(
        maxlen=MAXLEN, batch_size=FUSION_BATCH,
        optimizer=_opt(FUSION_LR),
        patience=PATIENCE,
        head_blank_bias=_blank_bias("late_fusion"),
        # Moderate regularization, like the uni-modal stages here
        # (the reference's 0.5s are sized for real 400-file ChaLearn).
        fusion_dropout=0.1, fusion_output_dropout=0.1,
        **_rlr("late_fusion"),
    )
    srcs = {"speech": cfg_sp, "skeletal": cfg_sk}
    ds_lf = datasets.build_late_fusion_dataset(
        audio_dir, sk_csv, sk_lab, lf_cfg
    )
    # Graft the best-VAL encoder states (the QC loop's selection) and
    # seed the fusion stage's `latest` slot — unless a relaunch already
    # has fusion progress there (curriculum_bench pattern).
    if not ckpt_lib.has_checkpoint(wd, lf_cfg.name, "latest"):
        model, grafted = build_fusion_with_pretrained(
            wd, lf_cfg, srcs, slot="best",
        )
        state = create_train_state(model, prng.root_key(lf_cfg.seed))
        state = state._replace(params=grafted)
        ckpt_lib.save_checkpoint(wd, lf_cfg.name, state, slot="latest")
    out["late_fusion"] = _run(
        "late_fusion", lf_cfg, ds_lf, workdir=wd,
        epochs=FUSION_EPOCHS, source_configs=srcs,
    )
    print(json.dumps({"stage": "late_fusion", **out["late_fusion"]}),
          flush=True)


def main() -> int:
    stages = [s.strip() for s in ONLY.split(",") if s.strip()]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = ROOT or tmp
        os.makedirs(root, exist_ok=True)
        reuse = bool(ROOT)
        if "speech" in stages:
            # Audio rides at 5x the skeletal frame rate pre-downsample
            # (the pipeline's x5 stride), like the real dataset.
            audio_dir, lab, _ = synthetic.make_audio_dataset(
                root, n_files=N_FILES, n_classes=22,
                frames_per_label=5 * FPL, max_labels=MAX_LABELS,
                seed=11, reuse=reuse, min_labels=MIN_LABELS,
            )
            cfg = _cfg("speech", 500)
            ds = datasets.build_audio_dataset(audio_dir, lab, cfg)
            out["speech"] = _run("speech", cfg, ds)
            print(json.dumps({"stage": "speech", **out["speech"]}),
                  flush=True)
        if "skeletal" in stages:
            sk_csv, sk_lab, _ = synthetic.make_skeletal_dataset(
                root, n_files=N_FILES, n_classes=22,
                frames_per_label=FPL, max_labels=MAX_LABELS,
                seed=12, reuse=reuse, min_labels=MIN_LABELS,
            )
            cfg = _cfg("skeletal", 300)
            ds = datasets.build_skeletal_dataset(sk_csv, sk_lab, cfg)
            out["skeletal"] = _run("skeletal", cfg, ds)
            print(json.dumps({"stage": "skeletal", **out["skeletal"]}),
                  flush=True)
        if "late_fusion" in stages:
            _late_fusion_stage(root, reuse, out)
    print(json.dumps({
        "metric": "heldout_generalization",
        "n_files": N_FILES,
        "val_split": 0.2,
        "maxlen": MAXLEN,
        **{k: v for k, v in out.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
