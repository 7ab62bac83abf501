"""End-to-end walkthrough on synthetic ChaLearn-format data.

Generates a toy corpus in the reference's on-disk layout, trains the
skeletal pipeline, decodes to an HTK MLF, and scores it — the full
train -> decode -> score loop in ~2 minutes on CPU, no dataset needed.

    python examples/synthetic_end_to_end.py [workdir]
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mgr_tpu.core import config as cfglib
from mgr_tpu.data import datasets, synthetic, vocab
from mgr_tpu.decode import Decoder, mlf, read_mlf, score_sequences
from mgr_tpu.decode.evaluate import evaluate_accuracy
from mgr_tpu.train.loop import fit
from mgr_tpu.models import build_model


def main(workdir=None):
    workdir = workdir or tempfile.mkdtemp(prefix="mgr_tpu_example_")
    print(f"workdir: {workdir}")

    # 1) Synthetic corpus in the reference's format: a monolithic
    #    skeletal CSV (20 kinematic features + file_number) and an
    #    Id,Sequence label CSV.
    csv_path, label_file, labels = synthetic.make_skeletal_dataset(
        workdir, n_files=8, frames_per_label=25, max_labels=2, seed=4
    )

    # 2) A scaled-down skeletal preset (the full preset's 1900-frame /
    #    BiLSTM(300) geometry is overkill for a toy corpus).
    cfg = cfglib.get_preset("skeletal").replace(
        maxlen=64, batch_size=2, compute_dtype="float32",
        encoder=cfglib.EncoderConfig(hidden=16, depth=2, input_noise=0.1,
                                     dropout=(0.1, 0.1),
                                     output_dropout=0.1),
        optimizer=cfglib.OptimizerConfig(learning_rate=1e-2),
        patience=1000,
        ctc=cfglib.CTCConfig(padded_length_parity=False),
    )
    data = datasets.build_skeletal_dataset(csv_path, label_file, cfg)

    # 3) Train (early stopping, best/latest checkpoints, metrics JSONL).
    model = build_model(cfg)
    epochs = int(os.environ.get("MGR_TPU_EXAMPLE_EPOCHS", "300"))
    result = fit(model, data, workdir=workdir, epochs=epochs)
    print(f"trained {result.epochs_run} epochs, "
          f"best val loss {result.best_val_loss:.3f}")

    # 4) Decode the validation split to an HTK MLF.
    dec = Decoder.for_model(model, result.state.params, "skeletal")
    decoded = dec.decode_batches(
        data.epoch(cfg.batch_size, train=False), use_lengths=True
    )
    mlf_path = f"{workdir}/sk_ctc_recout.mlf"
    dec.write_mlf(mlf_path, decoded)
    print(f"wrote {mlf_path}")

    # 5) Score against ground truth, both via MLFs and in-framework.
    refs_path = f"{workdir}/refs.mlf"
    mlf.write_mlf(refs_path, [
        (mlf.entry_name(fid), [vocab.GESTURE_CODES[c] for c in seq])
        for fid, seq in labels.items()
    ])
    metrics = score_sequences(read_mlf(refs_path), read_mlf(mlf_path),
                              ignore_missing=True)
    print("MLF scoring:", json.dumps(metrics))
    print("in-framework train-split accuracy:", json.dumps(
        evaluate_accuracy(model, result.state.params, data,
                          train_split=True, use_lengths=True)
    ))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
