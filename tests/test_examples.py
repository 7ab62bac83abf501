"""Smoke tests: the examples/ scripts run end-to-end in a fresh
subprocess (catches import/path bugs the in-process suite can't)."""

import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # fresh-subprocess smokes, 1-5 min each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, env_extra, *args):
    env = dict(os.environ)
    env.update(env_extra)
    # Match the suite's CPU backend in the child process: override the
    # ambient platform, so a smoke never lands on an accelerator.
    env["JAX_PLATFORMS"] = env_extra.get("JAX_PLATFORMS", "cpu")
    env.pop("XLA_FLAGS", None)
    # Generous timeout: this box has ONE cpu — a concurrently running
    # job can triple the subprocess's wall time.
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script), *args],
        capture_output=True, text=True, env=env, cwd="/", timeout=1800,
    )


def test_synthetic_end_to_end_smoke(tmp_path):
    r = _run("synthetic_end_to_end.py",
             {"MGR_TPU_EXAMPLE_EPOCHS": "2"}, str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "MLF scoring:" in r.stdout


def test_curriculum_bench_smoke():
    r = _run("curriculum_bench.py", {
        "MGR_TPU_CB_NTRAIN": "4", "MGR_TPU_CB_NVAL": "2",
        "MGR_TPU_CB_EPOCHS": "2", "MGR_TPU_CB_MAXLEN": "16",
        "MGR_TPU_CB_BATCH": "2", "MGR_TPU_CB_HIDDEN_SCALE": "0.02",
    })
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["metric"] == "curriculum_wall_clock"
    assert set(out["stages"]) == {"speech", "skeletal", "late_fusion"}
    for stage in out["stages"].values():
        assert stage["epoch_s"] > 0


_CONV_TOY = {
    # Toy geometry for the convergence-check script: the REAL check runs
    # at production widths on the chip; these exercise the exact code
    # paths (pretrain-resume, graft, anneal leg, rgb/early-fusion
    # stages) on the CPU backend.
    "MGR_TPU_CONV_HIDDEN_SCALE": "0.02",
    "MGR_TPU_CONV_FILES": "6",
    "MGR_TPU_CONV_EPOCHS": "2",
    "MGR_TPU_CONV_MAXLEN": "64",
    "MGR_TPU_CONV_BATCH": "2",
}


def test_convergence_check_late_fusion_smoke():
    """Full fusion chain incl. the LR-anneal leg and the idempotent
    resume=True pretrains (the round-3 headline path). Speech uses the
    single-leg _PRETRAIN_LR2/_EPOCHS2 fallback while skeletal takes the
    round-4 multi-leg LADDER — both anneal paths in one run."""
    r = _run("convergence_check.py", {
        **_CONV_TOY,
        "MGR_TPU_CONV_ONLY": "late_fusion",
        "MGR_TPU_CONV_PRETRAIN": "2",
        "MGR_TPU_CONV_PRETRAIN_LR2": "1e-3",
        "MGR_TPU_CONV_PRETRAIN_EPOCHS2": "1",
        "MGR_TPU_CONV_PRETRAIN_LADDER": "skeletal:1e-3x3+5e-4x4",
        "MGR_TPU_CONV_PRETRAIN_BLANK_BIAS": "skeletal:-3",
        "MGR_TPU_CONV_FUSION_FPL": "4",
        "MGR_TPU_CONV_FUSION_LABELS": "3",
        "MGR_TPU_CONV_LR2": "1e-3",
        "MGR_TPU_CONV_EPOCHS2": "1",
        # Round-4d knobs: the anneal leg fine-tunes the encoders
        # end-to-end, and the fusion stage runs at its own batch size
        # (the reference trains it at batch 2, multimodal.py:213).
        "MGR_TPU_CONV_FINETUNE": "1",
        "MGR_TPU_CONV_FUSION_BATCH": "3",
        # The measured dense-corpus recipe: non-finite guard +
        # self-annealing plateau schedule in every stage.
        "MGR_TPU_CONV_GUARD": "1",
        "MGR_TPU_CONV_PLATEAU": "0.5:2:1e-4:1e-3",
        # Opt-in blank-bias init (covers the env parse + model knob).
        "MGR_TPU_CONV_BLANK_BIAS": "-2.0",
    })
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    lf = out["late_fusion"]
    assert lf["anneal_epochs"] == 1
    assert lf["finetune_encoders"] is True
    assert set(lf["encoder_train_accuracy"]) == {"speech", "skeletal"}
    assert "train_accuracy_no_threshold" in lf


def test_convergence_check_fusion_default_batch(tmp_path):
    """The fusion stage must run when MGR_TPU_CONV_FUSION_BATCH is
    UNSET (regression: a truthy-\"0\" default parsed to batch_size=0 and
    crashed the batcher — the round-4d fusion_ft chip stage died on
    it while every smoke set the knob explicitly)."""
    r = _run("convergence_check.py", {
        **_CONV_TOY,
        "MGR_TPU_CONV_ONLY": "late_fusion",
        "MGR_TPU_CONV_PRETRAIN": "2",
        "MGR_TPU_CONV_FUSION_FPL": "4",
        "MGR_TPU_CONV_FUSION_LABELS": "3",
        "MGR_TPU_CONV_ROOT": str(tmp_path),
    })
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert "train_accuracy" in out["late_fusion"]


def test_convergence_check_encoder_gate(tmp_path):
    """MGR_TPU_CONV_REQUIRE_ENC aborts before the fusion stage when a
    pretrained encoder decodes below the floor (round-4 fusion_leg1:
    a 0.1386 skeletal encoder burned 20 chip-minutes on a head that
    could not converge). An impossible floor must trip the gate."""
    r = _run("convergence_check.py", {
        **_CONV_TOY,
        "MGR_TPU_CONV_ONLY": "late_fusion",
        "MGR_TPU_CONV_PRETRAIN": "2",
        "MGR_TPU_CONV_FUSION_FPL": "4",
        "MGR_TPU_CONV_FUSION_LABELS": "3",
        "MGR_TPU_CONV_REQUIRE_ENC": "1.1",
        "MGR_TPU_CONV_ROOT": str(tmp_path),
    })
    assert r.returncode == 3, (r.returncode, r.stderr[-2000:])
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["aborted"] == "encoder_below_floor"
    assert set(out["encoder_train_accuracy"]) == {"speech", "skeletal"}


def test_convergence_check_rgb_smoke():
    r = _run("convergence_check.py", {
        **_CONV_TOY,
        "MGR_TPU_CONV_ONLY": "rgb",
        "MGR_TPU_CONV_RGB_MAXLEN": "16",
        "MGR_TPU_CONV_RGB_FILES": "4",
        "MGR_TPU_CONV_RGB_BATCH": "2",
    })
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert "train_accuracy" in out["rgb"]


def test_convergence_check_early_fusion_smoke():
    r = _run("convergence_check.py",
             {**_CONV_TOY, "MGR_TPU_CONV_ONLY": "early_fusion"})
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert "train_accuracy" in out["early_fusion"]


def test_skeletal_bias_ab_smoke(tmp_path):
    """Both arms of the blank-bias A/B run end-to-end at toy geometry
    (the real A/B runs at the BASELINE.md round-4 defaults)."""
    for arm, bias in (("biased", -2.0), ("unbiased", 0.0)):
        r = _run("skeletal_bias_ab.py", {
            "MGR_TPU_AB_FILES": "4", "MGR_TPU_AB_MAXLEN": "32",
            "MGR_TPU_AB_FPL": "6", "MGR_TPU_AB_LABELS": "3",
            "MGR_TPU_AB_SCALE": "0.02", "MGR_TPU_AB_BATCH": "2",
            "MGR_TPU_AB_EPOCHS1": "2", "MGR_TPU_AB_EPOCHS2": "1",
            "MGR_TPU_AB_BIAS": str(bias),
            "MGR_TPU_AB_ROOT": str(tmp_path / "corpus"),
            "MGR_TPU_AB_WORKDIR": str(tmp_path / f"wd_{arm}"),
        }, arm)
        assert r.returncode == 0, r.stderr[-2000:]
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["arm"] == arm
        assert out["head_blank_bias"] == bias
        assert "train_accuracy" in out


def test_curriculum_bench_measured_smoke():
    """Measured mode: 500-epoch ceiling runs with per-stage decode
    accuracy (toy geometry here; the real run happens on the chip)."""
    r = _run("curriculum_bench.py", {
        "MGR_TPU_CB_NTRAIN": "4", "MGR_TPU_CB_NVAL": "2",
        "MGR_TPU_CB_EPOCHS": "2", "MGR_TPU_CB_MAXLEN": "16",
        "MGR_TPU_CB_BATCH": "2", "MGR_TPU_CB_HIDDEN_SCALE": "0.02",
        "MGR_TPU_CB_MEASURED": "1",
        # Exercise the chunked wall-clock-to-accuracy path: chunk size
        # 1 epoch, target 0 (met by the first probe) for speech, no
        # target for the others.
        "MGR_TPU_CB_ACC_TARGET": "speech:0.0,late_fusion:2.0",
        "MGR_TPU_CB_ACC_EVERY": "1",
        "MGR_TPU_CB_BLANK_BIAS": "-3",
        # Impossible late_fusion target (2.0) forces the finetune
        # continuation: 1 extra epoch with unfrozen encoders at 3e-4
        # (exercises the mid-stage model rebuild + resume).
        "MGR_TPU_CB_FINETUNE_EPOCHS": "1",
    })
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["measured"] is True
    assert out["measured_total_s"] > 0
    for stage in out["stages"].values():
        assert "train_accuracy" in stage and "epochs_run" in stage
    assert out["stages"]["speech"]["reached_accuracy_target"] is True
    assert out["stages"]["speech"]["epochs_run"] == 1  # stopped at probe
    lf = out["stages"]["late_fusion"]
    assert lf["reached_accuracy_target"] is False
    assert lf["finetune_epochs"] == 1
    assert lf["epochs_run"] == 3  # 2 frozen + 1 finetune


def test_generalization_fusion_smoke():
    """The FULL frozen-encoder curriculum under the quality-control
    loop: shared-label two-stream corpus, best-VAL encoder graft,
    frozen fusion head, held-out decode. Toy geometry — the real row
    is measured on the chip."""
    r = _run("generalization_check.py", {
        "MGR_TPU_GEN_FILES": "10",
        "MGR_TPU_GEN_EPOCHS": "3",
        "MGR_TPU_GEN_MAXLEN": "64",
        "MGR_TPU_GEN_BATCH": "2",
        "MGR_TPU_GEN_FPL": "6",
        "MGR_TPU_GEN_LABELS": "3",
        "MGR_TPU_GEN_HIDDEN_SCALE": "0.02",
        "MGR_TPU_GEN_SYNC": "1",
        "MGR_TPU_GEN_PATIENCE": "2",
        "MGR_TPU_GEN_ONLY": "late_fusion",
        "MGR_TPU_GEN_FUSION_BATCH": "2",
        "MGR_TPU_GEN_RLR": "late_fusion:0.5/1/1e-5",
    })
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["metric"] == "heldout_generalization"
    for stage in ("pretrain_speech", "pretrain_skeletal", "late_fusion"):
        row = out[stage]
        assert {"val_accuracy", "val_wer", "train_accuracy",
                "generalization_gap", "early_stopped",
                "best_val_loss"} <= set(row)
        assert row["epochs_run"] <= 3


def test_generalization_check_smoke():
    """The reference's quality-control loop driven end-to-end: seeded
    80/20 file split, fit(monitor='val') + EarlyStopping, best-val
    state decoded on the HELD-OUT split (VERDICT r4 item 4). Toy
    geometry — the real row is measured on the chip."""
    r = _run("generalization_check.py", {
        "MGR_TPU_GEN_FILES": "10",
        "MGR_TPU_GEN_EPOCHS": "3",
        "MGR_TPU_GEN_MAXLEN": "64",
        "MGR_TPU_GEN_BATCH": "2",
        "MGR_TPU_GEN_FPL": "6",
        "MGR_TPU_GEN_LABELS": "3",
        "MGR_TPU_GEN_HIDDEN_SCALE": "0.02",
        "MGR_TPU_GEN_SYNC": "1",
        "MGR_TPU_GEN_PATIENCE": "2",
    })
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["metric"] == "heldout_generalization"
    for stage in ("speech", "skeletal"):
        row = out[stage]
        assert {"val_accuracy", "val_wer", "train_accuracy",
                "generalization_gap", "early_stopped",
                "best_val_loss"} <= set(row)
        assert row["epochs_run"] <= 3
