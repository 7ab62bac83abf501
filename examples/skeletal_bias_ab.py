"""Skeletal-pretrain blank-bias A/B at ChaLearn content density (CPU).

The round-3/4 campaigns found that a TRAINABLE skeletal encoder
(reference stage: skeletal_network/skeletal_lstm_ctc.py:271-424) at
ChaLearn content density (8-20 gestures x ~90 skeletal frames filling
most of the padded window) oscillates at its CTC all-blank floor at the
big-batch escape LR, and that `PipelineConfig.head_blank_bias` (an
init-time knob, PARITY.md opt-in table) is the measured unlock. This
script is the regenerable A/B: both arms run the IDENTICAL recipe —
constant LR1 for EPOCHS1, then an LR2 anneal leg to EPOCHS1+EPOCHS2,
monitor=train, non-finite guard on — differing only in the bias.

Measured (round 4, defaults below, one arm per invocation on the 1-CPU
host, ~3.5 h each): biased (-3) train token accuracy 0.7817 vs the
unbiased control's 0.0.

Usage:
  JAX_PLATFORMS=cpu python examples/skeletal_bias_ab.py {biased|unbiased}

Knobs: MGR_TPU_AB_{FILES,MAXLEN,FPL,LABELS,SCALE,BATCH,LR1,LR2,EPOCHS1,
EPOCHS2,BIAS,ROOT,WORKDIR}.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mgr_tpu.core import config as cfglib
from mgr_tpu.data import datasets, synthetic
from mgr_tpu.decode.evaluate import evaluate_accuracy
from mgr_tpu.models import build_model
from mgr_tpu.train.loop import fit, load_params_for_eval

ARM = sys.argv[1] if len(sys.argv) > 1 else "unbiased"
assert ARM in ("biased", "unbiased"), ARM
BIAS = float(os.environ.get("MGR_TPU_AB_BIAS", "-3") or 0) \
    if ARM == "biased" else 0.0

FILES = int(os.environ.get("MGR_TPU_AB_FILES", "40"))
MAXLEN = int(os.environ.get("MGR_TPU_AB_MAXLEN", "800"))
FPL = int(os.environ.get("MGR_TPU_AB_FPL", "90"))
LABELS = int(os.environ.get("MGR_TPU_AB_LABELS", "8"))
SCALE = float(os.environ.get("MGR_TPU_AB_SCALE", "0.08"))
BATCH = int(os.environ.get("MGR_TPU_AB_BATCH", "32"))
LR1 = float(os.environ.get("MGR_TPU_AB_LR1", "3e-3"))
LR2 = float(os.environ.get("MGR_TPU_AB_LR2", "3e-4"))
EPOCHS1 = int(os.environ.get("MGR_TPU_AB_EPOCHS1", "2000"))
EPOCHS2 = int(os.environ.get("MGR_TPU_AB_EPOCHS2", "1000"))
ROOT = os.environ.get("MGR_TPU_AB_ROOT", "/tmp/skel_ab_corpus")
WORKDIR = os.environ.get("MGR_TPU_AB_WORKDIR", f"/tmp/skel_ab_wd_{ARM}")


def _opt(lr: float) -> "cfglib.OptimizerConfig":
    return cfglib.OptimizerConfig(
        learning_rate=lr, decay=1e-5, maxnorm=3.0, skip_nonfinite=100,
    )


def main() -> None:
    os.makedirs(ROOT, exist_ok=True)
    sk_csv, sk_labels, _ = synthetic.make_skeletal_dataset(
        ROOT, n_files=FILES, frames_per_label=FPL, max_labels=LABELS,
        seed=4, reuse=True,
    )

    cfg = cfglib.get_preset("skeletal").replace(
        maxlen=MAXLEN, batch_size=BATCH,
        encoder=cfglib.EncoderConfig(
            hidden=max(4, int(300 * SCALE)), depth=2, input_noise=0.05,
            dropout=(0.02, 0.02), output_dropout=0.02,
            per_gate_dropout=True,
        ),
        optimizer=_opt(LR1),
        patience=10_000,
        head_blank_bias=BIAS,
    )
    ds = datasets.build_skeletal_dataset(sk_csv, sk_labels, cfg)

    os.makedirs(WORKDIR, exist_ok=True)
    t0 = time.time()
    # resume=True: a killed arm continues from its last checkpoint.
    fit(build_model(cfg), ds, workdir=WORKDIR, resume=True,
        epochs=EPOCHS1, checkpoint_every=100, monitor="train",
        sync_every=10)
    cfg2 = cfg.replace(optimizer=_opt(LR2))
    res = fit(build_model(cfg2), ds, workdir=WORKDIR, resume=True,
              epochs=EPOCHS1 + EPOCHS2, checkpoint_every=100,
              monitor="train", keep_best_state=True, sync_every=10)
    wall = time.time() - t0

    model = build_model(cfg2)
    params = load_params_for_eval(model, WORKDIR, slot="best")
    acc = evaluate_accuracy(model, params, ds, train_split=True)
    print(json.dumps({
        "metric": "skeletal_bias_ab",
        "arm": ARM,
        "head_blank_bias": BIAS,
        "geometry": {"files": FILES, "maxlen": MAXLEN,
                     "frames_per_label": FPL, "max_labels": LABELS,
                     "hidden_scale": SCALE},
        "train_accuracy": round(acc["accuracy"], 4),
        "train_wer": round(acc["wer"], 4),
        "best_train_loss": round(res.best_val_loss, 3),
        "wall_s": round(wall, 1),
    }))


if __name__ == "__main__":
    main()
