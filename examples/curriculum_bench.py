"""Full three-stage curriculum wall-clock at ChaLearn scale on the GPU.

Measures the end-to-end training time of the reference's complete
recipe (speech -> skeletal -> late fusion with frozen grafted encoders,
/root/reference/README.md:32-53) at the reference's dataset geometry:

  * ~400 train / ~300 val sequences per stage (ChaLearn 2013 splits:
    gather_skeletal.py:21 splits at file id 403; the mixer then moves 95
    val files into train, util/mix_data.py:24-32 — we use 400/300),
  * padded length 1900 frames, 39-d audio / 20-d skeletal features,
  * full reference models: BiLSTM(500)x2 speech, BiLSTM(300)x2 skeletal,
    frozen-encoder fusion with BiLSTM(100), CTC over 44 / 22 classes.

The reference trains this schedule in ~100 hours on a GTX 1060 at
batch 2 (README.md:55). Here each stage is a production `fit()` over a
device-resident corpus at batch 128 with the Triton CTC kernel. Feature content is synthetic (timings do not
depend on values); per-epoch wall time is taken from fit()'s own epoch
records, steady state = median over epochs >= 2 (epochs 0-1 carry jit
compilation). The projection multiplies steady-state epoch time by the
reference's 500-epoch ceiling (speech_lstm_ctc_words.py:146) — an upper
bound, since EarlyStopping(patience 20) typically fires much earlier.

Run: `python examples/curriculum_bench.py`. Prints one JSON line. Not
yet measured on the GPU.

MGR_TPU_CB_MEASURED=1 switches from the 12-epoch timing sample to the
real thing: every stage runs to the full 500-epoch ceiling on a
LEARNABLE class-signature corpus, the best-train state of each stage is
decoded and scored, and the JSON reports measured end-to-end wall-clock
alongside the projection.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mgr_tpu.core import config as cfglib
from mgr_tpu.data.batcher import Batcher
from mgr_tpu.models import build_model
from mgr_tpu.train.loop import fit

# Scale knobs (env-overridable so the smoke test can run this on CPU
# with toy geometry; defaults are the real ChaLearn-scale benchmark).
N_TRAIN = int(os.environ.get("MGR_TPU_CB_NTRAIN", "400"))
N_VAL = int(os.environ.get("MGR_TPU_CB_NVAL", "300"))
# MEASURED=1: run every stage to the full 500-epoch reference ceiling
# and decode it — the end-to-end measurement, not a projection
# Default mode stays the short timing run.
MEASURED = os.environ.get("MGR_TPU_CB_MEASURED") == "1"
EPOCHS = int(
    os.environ.get("MGR_TPU_CB_EPOCHS", "500" if MEASURED else "12")
)  # short mode: epochs 0-1 = compile
MAXLEN = int(os.environ.get("MGR_TPU_CB_MAXLEN", "0")) or None
BATCH = int(os.environ.get("MGR_TPU_CB_BATCH", "0")) or None
HIDDEN_SCALE = float(os.environ.get("MGR_TPU_CB_HIDDEN_SCALE", "1"))
# Measured mode trains with a large-batch LR (batch 128 vs the
# reference's 2; at the reference's 1e-4 the ~1500 big-batch updates of
# a 500-epoch run cannot escape the CTC all-blank basin — linear LR
# scaling is the standard remedy). Short mode never reads this.
LR = float(os.environ.get("MGR_TPU_CB_LR", "3e-3"))
# Host-sync cadence (fit(sync_every=...)). Default 1 keeps per-epoch
# wall fidelity for the projection; raise it to cut host round-trips (epoch_s then amortizes each window's wall
# over its epochs_in_record).
SYNC_EVERY = int(os.environ.get("MGR_TPU_CB_SYNC_EVERY", "1"))
# MGR_TPU_CB_TARGET="speech:0.5,skeletal:0.5,late_fusion:1.0" (or one
# float for every stage): measured mode stops each stage as soon as its
# monitored train loss drops below the target and reports wall-clock to
# target — the honest unit of comparison against the reference. A
# 500-EPOCH ceiling is not step parity: the reference's epoch was ~200
# batch-2 steps (400 files), so its ceiling is ~100k updates, while 500
# big-batch epochs are 1.5k-6k updates; fixed-epoch comparisons starve
# the dense corpus (measured round 3: 0.0 accuracy at the ceiling).
_TARGET = os.environ.get("MGR_TPU_CB_TARGET", "")
# MGR_TPU_CB_ACC_TARGET="0.9" or "speech:0.95,skeletal:0.95,
# late_fusion:0.9": measured mode stops each stage when its DECODED
# train token accuracy reaches the target — the metric the reference's
# 94% headline is stated in, and the honest stop condition (a loss
# target can be met by the blank floor while argmax decodes nothing —
# measured round 3). The stage runs in MGR_TPU_CB_ACC_EVERY-epoch
# chunks with a decode+score between chunks (eval wall-clock counts:
# the reference would also have to decode to know it is done).
_ACC_TARGET = os.environ.get("MGR_TPU_CB_ACC_TARGET", "")
ACC_EVERY = int(os.environ.get("MGR_TPU_CB_ACC_EVERY", "100"))
# MGR_TPU_CB_FINETUNE_EPOCHS: if the late-fusion stage misses its
# accuracy target within EPOCHS under the reference-parity FROZEN
# recipe, continue up to this many extra epochs with the encoders
# UNFROZEN (PipelineConfig.finetune_encoders, PARITY.md opt-in knob) at
# MGR_TPU_CB_FINETUNE_LR. Measured rationale: every trainable stack at
# production geometry converges while the frozen big-batch head stalls
# at the CTC blank floor (round-4 legs 3-4).
FT_EPOCHS = int(os.environ.get("MGR_TPU_CB_FINETUNE_EPOCHS", "0") or 0)
FT_LR = float(os.environ.get("MGR_TPU_CB_FINETUNE_LR", "3e-4"))
# Fresh-head CTC blank-bias (the measured unlock for frozen-feature
# heads, PARITY.md opt-in knobs): "-3" applies to the late_fusion stage
# only; "skeletal:-3,late_fusion:-3" tables name stages explicitly.
_BLANK_BIAS = os.environ.get("MGR_TPU_CB_BLANK_BIAS", "")
# MGR_TPU_CB_WORKDIR: persistent checkpoint dir — a crash mid-run
# (the round-4d curriculum stage died on a FAILED_PRECONDITION hours in)
# can then RESUME on relaunch instead of restarting: completed stages
# return immediately (fit derives start_epoch from the checkpointed
# step) and the in-flight stage continues from its `latest` slot. The
# corpora are in-memory and seed-deterministic, so a restart sees
# identical data. Default: a throwaway tempdir (prior behavior).
WORKDIR = os.environ.get("MGR_TPU_CB_WORKDIR", "")


def _parse_stage_table(raw: str, stage: str):
    # One shared implementation for the per-stage env grammar
    # (mgr_tpu.core.config.parse_stage_table; review r5 finding).
    return cfglib.parse_stage_table(raw, stage)


def _target_for(stage: str):
    return _parse_stage_table(_TARGET, stage)


def _acc_target_for(stage: str):
    return _parse_stage_table(_ACC_TARGET, stage)


REF_EPOCH_CEILING = 500
REF_TOTAL_HOURS = 100.0


def _make_batcher(cfg, *, n_labels: int, seed: int) -> Batcher:
    """In-memory corpus at reference geometry for one pipeline.

    Features are class-signature signals (mgr_tpu.data.synthetic), so
    the corpus is LEARNABLE — timing is unaffected vs pure noise, and
    measured mode can report real decode accuracy at the end."""
    from mgr_tpu.data.synthetic import _class_signal

    rng = np.random.default_rng(seed)
    n = N_TRAIN + N_VAL
    T = cfg.maxlen
    labels = np.full((n, cfg.max_label_len), -1, np.int32)
    seqs = rng.integers(1, cfg.nb_classes - 1, size=(n, n_labels))
    labels[:, :n_labels] = seqs
    frames_per = max(T // n_labels - 4, 1)

    def stream(F, srng):
        x = np.zeros((n, T, F), np.float32)
        for i in range(n):
            sig = _class_signal(srng, seqs[i], frames_per, F)[:T]
            x[i, : sig.shape[0]] = sig
        return x

    if cfg.second_stream_feats:
        feats = (
            stream(cfg.num_feats, rng),
            stream(cfg.second_stream_feats, rng),
        )
    else:
        feats = stream(cfg.num_feats, rng)
    return Batcher(
        features=feats,
        labels=labels,
        label_lengths=np.full((n,), n_labels, np.int32),
        input_lengths=np.full((n,), T - cfg.ctc.trim_frames, np.int32),
        file_ids=list(range(n)),
        train_ids=list(range(N_TRAIN)),
        val_ids=list(range(N_TRAIN, n)),
    )


def _bench_stage(cfg, data, workdir, *, resume=False, source_configs=None):
    # source_configs: the SCALED speech/skeletal stage configs used at
    # graft time — without them build_model falls back to the full-size
    # presets, so the grafted encoders would run under reference-scale
    # dropout (0.4/0.5) instead of the measured-mode 0.02 (ADVICE r4).
    model = build_model(cfg, source_configs=source_configs)
    t0 = time.time()
    # checkpoint_every: per-epoch ~100 MB serialization would be a cost
    # the steady-state epoch timing does not see (ADVICE r2) — throttle
    # it so as_run_s and epoch_s describe the same configuration.
    # Measured mode monitors TRAIN loss: these are memorization corpora
    # (val files are unseen random sequences), so best-val selection
    # would return the least-trained state.
    target = _target_for(cfg.name) if MEASURED else None
    acc_target = _acc_target_for(cfg.name) if MEASURED else None

    # ONE plateau controller for the whole stage: the chunked accuracy
    # loop calls fit() repeatedly, and a per-call controller resets
    # lr_scale to 1.0 at every chunk boundary — the run re-catapults to
    # the base LR and the 1e-4 persistence that breaks CTC blank-floor
    # plateaus never accumulates (measured round 5: the speech stage
    # sawtoothed 16 -> 38 -> 17 every 400 epochs this way).
    from mgr_tpu.train import optimizer as opt_lib

    plateau_ctl = opt_lib.plateau_from_config(cfg)

    def _fit(up_to, resume_now):
        return fit(
            model, data, workdir=workdir, epochs=up_to, resume=resume_now,
            checkpoint_every=100,
            monitor="train" if MEASURED else "val",
            keep_best_state=MEASURED,
            sync_every=SYNC_EVERY,
            stop_below=target,
            plateau_controller=plateau_ctl,
        )

    acc_probe = None
    finetuned_epochs = 0
    if acc_target is None:
        result = _fit(EPOCHS, resume)
    else:
        # Wall-clock-to-accuracy: run in ACC_EVERY-epoch chunks and
        # decode+score the chunk's best state between chunks, stopping
        # at the target. The eval passes count toward wall-clock (the
        # reference, too, only knows it converged by decoding).
        from mgr_tpu.decode.evaluate import evaluate_accuracy as _ev

        def _acc_chunks(start, until, resume_now):
            nonlocal acc_probe
            done, res = start, None
            while done < until:
                up_to = min(done + ACC_EVERY, until)
                res = _fit(up_to, resume_now or done > start)
                done = up_to
                probe_state = res.best_state if res.best_state \
                    is not None else res.state
                acc_probe = _ev(model, probe_state.params, data,
                                train_split=True)["accuracy"]
                print(f"[{cfg.name}] acc probe @ep{done}: "
                      f"{acc_probe:.4f} (target {acc_target})",
                      flush=True)
                if acc_probe >= acc_target:
                    break
            if res is None:
                # Zero chunks ran (until <= start: e.g. a restarted
                # queue whose checkpoint is already at/past EPOCHS) —
                # fall back to one fit so result/history always exist.
                res = _fit(until, resume_now)
            return res

        result = _acc_chunks(0, EPOCHS, resume)
        if (acc_probe is not None and acc_probe < acc_target
                and FT_EPOCHS > 0 and cfg.fusion_sources):
            # Finetune continuation: unfreeze the grafted encoders for
            # up to FT_EPOCHS more (the frozen-parity recipe had its
            # full EPOCHS budget first; this leg is recorded in the
            # output so the headline states the recipe honestly).
            import dataclasses as _dc

            cfg_ft = cfg.replace(
                finetune_encoders=True,
                optimizer=_dc.replace(cfg.optimizer,
                                      learning_rate=FT_LR),
            )
            model = build_model(cfg_ft, source_configs=source_configs)
            # Fresh controller for the finetune leg: it trains at its
            # own base LR (FT_LR), so the frozen leg's annealed scale
            # must not carry over.
            plateau_ctl = opt_lib.plateau_from_config(cfg_ft)
            epochs_before = int(result.state.step) // max(
                data.num_batches(cfg.batch_size, train=True), 1
            )
            result = _acc_chunks(epochs_before,
                                 epochs_before + FT_EPOCHS, True)
            finetuned_epochs = (int(result.state.step) // max(
                data.num_batches(cfg.batch_size, train=True), 1
            )) - epochs_before
    wall = time.time() - t0
    steady = result.history[2:] or result.history
    # At sync_every>1 each record covers a window; amortize its wall
    # over the epochs it contains. An immediate-return resume (already
    # at the epoch target) has no history — report 0 rather than crash.
    epoch_s = statistics.median(
        rec["wall_s"] / rec.get("epochs_in_record", 1) for rec in steady
    ) if steady else 0.0
    out = {
        "epoch_s": round(epoch_s, 3),
        "as_run_s": round(wall, 1),
        "projected_500ep_s": round(epoch_s * REF_EPOCH_CEILING, 1),
    }
    if MEASURED:
        from mgr_tpu.decode.evaluate import evaluate_accuracy

        best = result.best_state if result.best_state is not None \
            else result.state
        acc = evaluate_accuracy(model, best.params, data, train_split=True)
        # Total epochs this stage ran in THIS process: under the
        # chunked accuracy loop, result.epochs_run covers only the last
        # chunk; the checkpointed step is the cross-chunk truth.
        out["epochs_run"] = int(result.state.step) // max(
            data.num_batches(cfg.batch_size, train=True), 1
        )
        out["train_accuracy"] = round(acc["accuracy"], 4)
        out["train_wer"] = round(acc["wer"], 4)
        out["best_train_loss"] = round(result.best_val_loss, 3)
        if target is not None:
            out["target_loss"] = target
            out["reached_target"] = bool(result.best_val_loss < target)
        if acc_target is not None:
            out["target_accuracy"] = acc_target
            out["reached_accuracy_target"] = bool(
                acc_probe is not None and acc_probe >= acc_target
            )
            if finetuned_epochs:
                out["finetune_epochs"] = finetuned_epochs
                out["finetune_lr"] = FT_LR
        # The graft must see the best-train state, not wherever the
        # 500th epoch happened to land (late-run divergence is real at
        # large-batch LR — measured in round 2).
        if workdir:
            from mgr_tpu.core import checkpoint as ckpt_lib

            ckpt_lib.save_checkpoint(workdir, cfg.name, best, slot="best")
    return out


def main() -> None:
    import tempfile

    # Reference hyperparameters, batch raised well past the reference's
    # batch-2 ceiling (its GPU memory wall, rgb_network/cnn_lstm.py:121).
    # patience lifted so the timing run is never cut short on synthetic
    # (unlearnable) features.
    def scaled(name, batch):
        # Per-stage overrides: the round-5 measured recipe is
        # HETEROGENEOUS — trainable encoders escape at big-batch 3e-3
        # while the frozen fusion head needs small-batch constant 1e-4
        # (round 5: B=8/1e-4 → 0.9027 where B=128/3e-3
        # oscillated at ~19 indefinitely). Tables use the shared
        # parse_stage_table grammar, e.g.
        #   MGR_TPU_CB_STAGE_BATCH="late_fusion:8"
        #   MGR_TPU_CB_STAGE_LR="late_fusion:1e-4"
        stage_batch = _parse_stage_table(
            os.environ.get("MGR_TPU_CB_STAGE_BATCH", ""), name
        )
        stage_lr = _parse_stage_table(
            os.environ.get("MGR_TPU_CB_STAGE_LR", ""), name
        )
        cfg = cfglib.get_preset(name).replace(
            batch_size=int(stage_batch) if stage_batch else (BATCH or batch),
            patience=EPOCHS + 1,
        )
        if MEASURED:
            import dataclasses

            # Large-batch LR + regularization scaled down for the
            # synthetic memorization corpora (as in
            # convergence_check.py); maxnorm/trim/padded-length
            # parity semantics stay.
            cfg = cfg.replace(
                optimizer=dataclasses.replace(
                    cfg.optimizer, learning_rate=stage_lr or LR
                ),
                encoder=dataclasses.replace(
                    cfg.encoder, input_noise=0.05,
                    dropout=tuple(0.02 for _ in cfg.encoder.dropout),
                    output_dropout=0.02,
                ),
                fusion_dropout=0.02,
                fusion_output_dropout=0.02,
                # Anneal the big-batch escape LR once train loss hits
                # its oscillation floor (ReduceLROnPlateau on the
                # monitored=train loss): at a content-dense corpus the
                # skeletal stage bounces at 3e-3 indefinitely
                # (measured round 3); the reference's own mechanism
                # (cnn_lstm.py:439-444) is the remedy.
                reduce_lr_factor=0.5,
                reduce_lr_patience=15,
                reduce_lr_min=1e-4,
            )
            bias = (
                _parse_stage_table(_BLANK_BIAS, name)
                if ":" in _BLANK_BIAS
                else (float(_BLANK_BIAS or 0)
                      if name == "late_fusion" else None)
            )
            if bias:
                # Fresh-head blank-bias: the measured unlock for the
                # frozen-feature fusion head's all-blank basin
                # (PARITY.md opt-in knobs; init-time only).
                cfg = cfg.replace(head_blank_bias=bias)
        if MAXLEN:
            cfg = cfg.replace(maxlen=MAXLEN)
        if HIDDEN_SCALE != 1:
            import dataclasses
            enc = dataclasses.replace(
                cfg.encoder, hidden=max(4, int(cfg.encoder.hidden * HIDDEN_SCALE))
            )
            cfg = cfg.replace(
                encoder=enc,
                fusion_hidden=max(4, int(cfg.fusion_hidden * HIDDEN_SCALE)),
            )
        return cfg

    stages = {
        "speech": scaled("speech", 128),
        "skeletal": scaled("skeletal", 128),
        "late_fusion": scaled("late_fusion", 64),
    }
    label_counts = {"speech": 20, "skeletal": 10, "late_fusion": 10}

    out = {}
    import contextlib

    if WORKDIR:
        os.makedirs(WORKDIR, exist_ok=True)
        # Geometry fingerprint: fit()'s own num_train_batches refusal
        # misses same-ratio changes (e.g. NTRAIN 400->200 with BATCH
        # 128->64 keeps batches/epoch equal while the data differs), so
        # pin the corpus-defining knobs to the workdir explicitly.
        fp = {"n_train": N_TRAIN, "n_val": N_VAL, "maxlen": MAXLEN,
              "batch": BATCH, "hidden_scale": HIDDEN_SCALE, "lr": LR}
        fp_path = os.path.join(WORKDIR, "cb_fingerprint.json")
        if os.path.exists(fp_path):
            with open(fp_path) as f:
                old = json.load(f)
            if old != fp:
                raise SystemExit(
                    f"MGR_TPU_CB_WORKDIR={WORKDIR} was written with "
                    f"different geometry {old} (this run: {fp}) — "
                    f"resuming would silently skip or corrupt stages; "
                    f"relaunch with the original env or a fresh workdir"
                )
        else:
            with open(fp_path, "w") as f:
                json.dump(fp, f)
        ctx = contextlib.nullcontext(WORKDIR)
    else:
        ctx = tempfile.TemporaryDirectory()
    with ctx as workdir:
        from mgr_tpu.core import checkpoint as ckpt_lib

        for i, (name, cfg) in enumerate(stages.items()):
            data = _make_batcher(cfg, n_labels=label_counts[name], seed=i)
            if name == "late_fusion":
                # Graft the just-trained encoders exactly as the
                # curriculum does (train/curriculum.py::run_curriculum).
                from mgr_tpu.core import prng
                from mgr_tpu.train.curriculum import (
                    build_fusion_with_pretrained,
                )
                from mgr_tpu.train.step import create_train_state

                srcs = {k: stages[k] for k in ("speech", "skeletal")}
                # On a persistent-workdir RELAUNCH, a late_fusion
                # checkpoint means the graft already happened — seeding
                # `latest` again would wipe the fusion progress.
                if not ckpt_lib.has_checkpoint(workdir, cfg.name,
                                               "latest"):
                    fusion_model, grafted = build_fusion_with_pretrained(
                        workdir, cfg, srcs,
                    )
                    state = create_train_state(
                        fusion_model, prng.root_key(cfg.seed)
                    )
                    state = state._replace(params=grafted)
                    ckpt_lib.save_checkpoint(workdir, cfg.name, state,
                                             slot="latest")
                out[name] = _bench_stage(cfg, data, workdir, resume=True,
                                         source_configs=srcs)
            else:
                # fit(resume=True) is a no-op without a checkpoint, so
                # resuming is safe whenever the workdir persists.
                out[name] = _bench_stage(cfg, data, workdir,
                                         resume=bool(WORKDIR))

    total_projected = sum(s["projected_500ep_s"] for s in out.values())
    result = {
        "metric": "curriculum_wall_clock",
        "measured": MEASURED,
        "stages": out,
        "projected_500ep_total_s": round(total_projected, 1),
        "projected_500ep_total_min": round(total_projected / 60.0, 1),
        "reference_hours": REF_TOTAL_HOURS,
        # A fully-resumed relaunch (every stage already at its epoch
        # target) has no steady-state windows: projected totals are 0
        # and the speedup is undefined — report null, don't crash.
        "speedup_vs_reference": round(
            REF_TOTAL_HOURS * 3600.0 / total_projected, 1
        ) if total_projected > 0 else None,
    }
    if MEASURED:
        total = sum(s["as_run_s"] for s in out.values())
        result["measured_total_s"] = round(total, 1)
        result["measured_total_min"] = round(total / 60.0, 1)
        result["measured_speedup_vs_reference"] = round(
            REF_TOTAL_HOURS * 3600.0 / total, 1
        )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
