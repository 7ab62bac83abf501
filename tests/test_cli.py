"""CLI: train -> decode -> score end-to-end on synthetic data, plus the
prep utilities."""

import json
import os

import numpy as np
import pytest

from mgr_tpu.cli.main import main as cli_main
from mgr_tpu.data import synthetic


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    sk_csv, sk_labels, labels = synthetic.make_skeletal_dataset(
        root, n_files=6, frames_per_label=20, seed=1
    )
    return dict(root=root, sk_csv=sk_csv, sk_labels=sk_labels, labels=labels)


def test_train_and_decode_skeletal(corpus, tmp_path, capsys, monkeypatch):
    workdir = str(tmp_path / "runs")
    # Shrink the preset via CLI-adjacent knobs: patch the preset for speed.
    from mgr_tpu.core import config as cfglib

    small = cfglib.get_preset("skeletal").replace(
        maxlen=32, batch_size=2, compute_dtype="float32",
        encoder=cfglib.EncoderConfig(hidden=4, depth=2, input_noise=0.1,
                                     dropout=(0.1, 0.1), output_dropout=0.1),
    )
    monkeypatch.setitem(cfglib.PRESETS, "skeletal", lambda: small)

    rc = cli_main([
        "train", "skeletal",
        "--skeletal-csv", corpus["sk_csv"],
        "--labels", corpus["sk_labels"],
        "--workdir", workdir,
        "--epochs", "1",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["best_val_loss"])
    assert os.path.exists(os.path.join(workdir, "skeletal_best.npz"))
    assert os.path.exists(os.path.join(workdir, "skeletal_config.json"))

    mlf_out = str(tmp_path / "sk.mlf")
    rc = cli_main([
        "decode", "skeletal",
        "--workdir", workdir,
        "--skeletal-csv", corpus["sk_csv"],
        "--labels", corpus["sk_labels"],
        "--out", mlf_out,
    ])
    assert rc == 0
    dec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert dec["decoded"] >= 1 and os.path.exists(mlf_out)

    # Build a reference MLF from the ground truth and score.
    from mgr_tpu.data import vocab
    from mgr_tpu.decode import mlf as mlf_lib

    refs_path = str(tmp_path / "refs.mlf")
    entries = [
        (mlf_lib.entry_name(fid),
         [vocab.GESTURE_CODES[c] for c in seq])
        for fid, seq in corpus["labels"].items()
    ]
    mlf_lib.write_mlf(refs_path, entries)
    rc = cli_main(["score", refs_path, mlf_out, "--partial"])
    assert rc == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "accuracy" in metrics and np.isfinite(metrics["accuracy"])


def test_train_accum_steps_and_lr_flags(corpus, tmp_path, capsys,
                                        monkeypatch):
    workdir = str(tmp_path / "runs")
    from mgr_tpu.core import config as cfglib

    small = cfglib.get_preset("skeletal").replace(
        maxlen=32, batch_size=2, compute_dtype="float32",
        encoder=cfglib.EncoderConfig(hidden=4, depth=2, input_noise=0.1,
                                     dropout=(0.1, 0.1), output_dropout=0.1),
    )
    monkeypatch.setitem(cfglib.PRESETS, "skeletal", lambda: small)

    rc = cli_main([
        "train", "skeletal",
        "--skeletal-csv", corpus["sk_csv"],
        "--labels", corpus["sk_labels"],
        "--workdir", workdir,
        "--epochs", "1",
        "--accum-steps", "2",
        "--lr", "1e-3",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["best_val_loss"])
    saved = json.load(open(os.path.join(workdir, "skeletal_config.json")))
    assert saved["optimizer"]["accum_steps"] == 2
    assert saved["optimizer"]["learning_rate"] == 1e-3


def test_mix_command(tmp_path, capsys):
    import pandas as pd

    # Build monolithic train/val audio + skeletal + labels.
    rng = np.random.default_rng(0)

    def mono_audio(ids, path):
        rows = []
        for fid in ids:
            x = rng.normal(size=(6, 39)).astype(np.float32)
            fcol = np.full((6, 1), fid, np.float32)
            rows.append(np.concatenate([x, fcol], axis=1))
        header = ",".join(str(i) for i in range(39)) + ",file_number"
        np.savetxt(path, np.concatenate(rows), delimiter=",",
                   header=header, comments="", fmt="%.4f")

    def mono_skel(ids, path):
        from mgr_tpu.data.formats import SKELETAL_FEATURES

        rows = []
        for fid in ids:
            x = rng.normal(size=(4, 20)).astype(np.float32)
            fcol = np.full((4, 1), fid, np.float32)
            rows.append(np.concatenate([x, fcol], axis=1))
        header = ",".join(SKELETAL_FEATURES) + ",file_number"
        np.savetxt(path, np.concatenate(rows), delimiter=",",
                   header=header, comments="", fmt="%.4f")

    train_ids, val_ids = list(range(1, 11)), list(range(401, 421))
    at, av = str(tmp_path / "a_train.csv"), str(tmp_path / "a_val.csv")
    st, sv = str(tmp_path / "s_train.csv"), str(tmp_path / "s_val.csv")
    mono_audio(train_ids, at)
    mono_audio(val_ids, av)
    mono_skel(train_ids, st)
    mono_skel(val_ids, sv)
    lt, lv = str(tmp_path / "l_train.csv"), str(tmp_path / "l_val.csv")
    synthetic.write_label_csv(lt, {i: [1, 2] for i in train_ids})
    synthetic.write_label_csv(lv, {i: [3] for i in val_ids})

    out_root = str(tmp_path / "mixed")
    rc = cli_main([
        "mix", "--audio-train", at, "--audio-val", av,
        "--skeletal-train", st, "--skeletal-val", sv,
        "--train-labels", lt, "--val-labels", lv,
        "--out-root", out_root, "--n-moved", "5",
    ])
    assert rc == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["moved"] == 5 and info["kept"] == 15

    # Consistency: moved ids appear in train labels, train audio dir, and
    # the mixed skeletal training CSV.
    train_labels = pd.read_csv(os.path.join(out_root, "training.csv"))
    assert len(train_labels) == 10 + 5
    train_audio_files = os.listdir(os.path.join(out_root, "train_audio"))
    assert len(train_audio_files) == 15
    val_audio_files = os.listdir(os.path.join(out_root, "val_audio"))
    assert len(val_audio_files) == 15
    mixed_sk = pd.read_csv(
        os.path.join(out_root, "Training_set_skeletal.csv")
    )
    assert mixed_sk["file_number"].nunique() == 15


def test_prepare_skeletal_command(tmp_path, capsys):
    raw_dir = tmp_path / "raw"
    raw_dir.mkdir()
    rng = np.random.default_rng(0)
    from mgr_tpu.data.skeletal_pipeline import KINECT_COLUMNS

    for fid in (1, 2, 405):
        T = 12
        cols = {"frame": np.arange(T)}
        for col in KINECT_COLUMNS:
            xs = rng.integers(0, 640, size=T)
            ys = rng.integers(0, 480, size=T)
            cols[col] = [f"[{x} {y}]" for x, y in zip(xs, ys)]
        import pandas as pd

        pd.DataFrame(cols).to_csv(raw_dir / f"Sample{fid:05d}_skel.csv",
                                  index=False)

    out_csv = str(tmp_path / "train_sk.csv")
    val_csv = str(tmp_path / "val_sk.csv")
    rc = cli_main([
        "prepare-skeletal", "--raw-dir", str(raw_dir),
        "--out-csv", out_csv, "--val-csv", val_csv, "--split-at", "403",
    ])
    assert rc == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["videos"] == 3

    import pandas as pd

    train_df = pd.read_csv(out_csv)
    val_df = pd.read_csv(val_csv)
    assert set(train_df["file_number"]) == {1, 2}
    assert set(val_df["file_number"]) == {405}
    from mgr_tpu.data.formats import SKELETAL_FEATURES

    assert list(train_df.columns) == list(SKELETAL_FEATURES) + ["file_number"]


def test_prepare_audio_command(tmp_path, capsys):
    import wave as wave_mod

    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    for fid in (3, 8):
        samples = (3000 * rng.standard_normal(16000)).astype(np.int16)
        with wave_mod.open(str(wav_dir / f"Sample{fid:05d}_audio.wav"),
                           "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(samples.tobytes())

    out_dir = str(tmp_path / "feat")
    rc = cli_main([
        "prepare-audio", "--wav-dir", str(wav_dir), "--out-dir", out_dir,
    ])
    assert rc == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["files"] == 2

    from mgr_tpu.data import formats

    feats = formats.load_audio_file_csv(os.path.join(out_dir, "audio_3.csv"))
    # 1 s @ 25ms/10ms -> 98 frames, 39 features
    assert feats.shape == (98, 39)
    assert np.isfinite(feats).all()


def test_prepare_rgb_command(tmp_path, capsys):
    import pandas as pd

    from mgr_tpu.data.skeletal_pipeline import KINECT_COLUMNS

    video_dir = tmp_path / "vids"
    skel_dir = tmp_path / "skel"
    video_dir.mkdir()
    skel_dir.mkdir()
    rng = np.random.default_rng(0)
    T = 6
    for fid in (2,):
        frames = rng.integers(0, 256, size=(T, 480, 640)).astype(np.uint8)
        np.save(video_dir / f"Sample{fid:05d}_color.npy", frames)
        cols = {"frame": np.arange(T)}
        for col in KINECT_COLUMNS:
            cols[col] = [f"[{320 + i} {240 + i}]" for i in range(T)]
        pd.DataFrame(cols).to_csv(skel_dir / f"Sample{fid:05d}_skel.csv",
                                  index=False)

    out_dir = str(tmp_path / "rois")
    rc = cli_main([
        "prepare-rgb", "--video-dir", str(video_dir),
        "--skeletal-dir", str(skel_dir), "--out-dir", out_dir,
        "--img-dim", "60",
    ])
    assert rc == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["videos"] == 1
    out = np.load(os.path.join(out_dir, "Sample00002_color.npy"))
    assert out.shape == (T, 60, 60, 1)


def test_infer_command(corpus, tmp_path, capsys, monkeypatch):
    # Train the tiny skeletal model then infer on the monolithic CSV.
    from mgr_tpu.core import config as cfglib

    small = cfglib.get_preset("skeletal").replace(
        maxlen=32, batch_size=2, compute_dtype="float32",
        encoder=cfglib.EncoderConfig(hidden=4, depth=2, input_noise=0.1,
                                     dropout=(0.1, 0.1), output_dropout=0.1),
    )
    monkeypatch.setitem(cfglib.PRESETS, "skeletal", lambda: small)
    workdir = str(tmp_path / "runs")
    rc = cli_main([
        "train", "skeletal", "--skeletal-csv", corpus["sk_csv"],
        "--labels", corpus["sk_labels"], "--workdir", workdir,
        "--epochs", "1",
    ])
    assert rc == 0
    capsys.readouterr()

    rc = cli_main([
        "infer", "skeletal", corpus["sk_csv"], "--workdir", workdir,
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "tokens" in out and isinstance(out["tokens"], list)


def test_evaluate_command(corpus, tmp_path, capsys, monkeypatch):
    from mgr_tpu.core import config as cfglib

    small = cfglib.get_preset("skeletal").replace(
        maxlen=32, batch_size=2, compute_dtype="float32",
        encoder=cfglib.EncoderConfig(hidden=4, depth=2, input_noise=0.1,
                                     dropout=(0.1, 0.1), output_dropout=0.1),
    )
    monkeypatch.setitem(cfglib.PRESETS, "skeletal", lambda: small)
    workdir = str(tmp_path / "runs")
    cli_main([
        "train", "skeletal", "--skeletal-csv", corpus["sk_csv"],
        "--labels", corpus["sk_labels"], "--workdir", workdir,
        "--epochs", "1",
    ])
    capsys.readouterr()
    rc = cli_main([
        "evaluate", "skeletal", "--workdir", workdir,
        "--skeletal-csv", corpus["sk_csv"],
        "--labels", corpus["sk_labels"],
        "--split", "train", "--true-lengths",
    ])
    assert rc == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"accuracy", "wer", "corr"} <= set(m)


def test_long_name_alias_imports():
    import multimodal_gesture_recognition_with_lstms_and_ctc_tpu as alias

    assert alias.__version__
    from multimodal_gesture_recognition_with_lstms_and_ctc_tpu.core import (
        config,
    )

    assert config.get_preset("speech").nb_classes == 44


def test_train_early_fusion_cli(corpus, tmp_path, capsys, monkeypatch):
    from mgr_tpu.core import config as cfglib

    audio_csv = synthetic.make_monolithic_audio_dataset(
        str(tmp_path), corpus["labels"], frames_per_label=150
    )
    small = cfglib.get_preset("early_fusion").replace(
        maxlen=32, batch_size=2, compute_dtype="float32",
        encoder=cfglib.EncoderConfig(hidden=4, depth=2, input_noise=0.1,
                                     dropout=(0.1, 0.1), output_dropout=0.1),
    )
    monkeypatch.setitem(cfglib.PRESETS, "early_fusion", lambda: small)
    workdir = str(tmp_path / "runs")
    rc = cli_main([
        "train", "early_fusion",
        "--audio-csv", audio_csv,
        "--skeletal-csv", corpus["sk_csv"],
        "--workdir", workdir, "--epochs", "1",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["best_val_loss"])
    assert os.path.exists(os.path.join(workdir, "early_fusion_best.npz"))


@pytest.mark.slow  # 3-stage curriculum end-to-end, ~55 s
def test_curriculum_cli(corpus, tmp_path, capsys, monkeypatch):
    """CLI `curriculum`: the full 3-stage schedule (speech -> skeletal
    -> frozen-encoder fusion) from one command, on synthetic corpora
    sharing file ids (the fusion dataset joins streams by id)."""
    from mgr_tpu.core import config as cfglib

    audio_dir, audio_labels, _ = synthetic.make_audio_dataset(
        str(tmp_path), n_files=6, frames_per_label=50, seed=0
    )

    def _small(name, **kw):
        cfg = cfglib.get_preset(name).replace(
            maxlen=32, batch_size=2, compute_dtype="float32", **kw
        )
        enc = cfglib.EncoderConfig(
            hidden=4, depth=2, input_noise=0.1,
            dropout=(0.1, 0.1), output_dropout=0.1,
        )
        return cfg.replace(encoder=enc)

    for name, kw in (("speech", {}), ("skeletal", {}),
                     ("late_fusion", {"fusion_hidden": 4})):
        small = _small(name, **kw)
        monkeypatch.setitem(cfglib.PRESETS, name, lambda s=small: s)

    workdir = str(tmp_path / "runs")
    rc = cli_main([
        "curriculum",
        "--audio-dir", audio_dir, "--audio-labels", audio_labels,
        "--skeletal-csv", corpus["sk_csv"], "--labels", corpus["sk_labels"],
        "--workdir", workdir, "--epochs", "1",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"speech", "skeletal", "late_fusion"}
    for stage in out.values():
        assert np.isfinite(stage["best_val_loss"])
    for stamp in ("speech", "skeletal", "late_fusion"):
        assert os.path.exists(
            os.path.join(workdir, f"{stamp}_best.npz")
        )


def test_train_rgb_cli(tmp_path, capsys, monkeypatch):
    from mgr_tpu.core import config as cfglib

    data_dir, label_file, _ = synthetic.make_rgb_dataset(
        str(tmp_path), n_files=4, img_dim=36, frames_per_label=4
    )
    small = cfglib.get_preset("rgb").replace(
        maxlen=8, batch_size=2, compute_dtype="float32",
        encoder=cfglib.EncoderConfig(hidden=4, depth=2, input_noise=0.0,
                                     dropout=(0.0, 0.0), output_dropout=0.0),
        cnn=cfglib.CNNConfig(img_dim=36, channels=(2, 3, 4),
                             kernel_sizes=(5, 5, 4), pool_sizes=(2, 2, 2)),
    )
    monkeypatch.setitem(cfglib.PRESETS, "rgb", lambda: small)
    workdir = str(tmp_path / "runs")
    rc = cli_main([
        "train", "rgb", "--data-dir", data_dir, "--labels", label_file,
        "--workdir", workdir, "--epochs", "1",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["best_val_loss"])
    # ReduceLROnPlateau preset is wired (rgb sets reduce_lr_factor).
    assert small.reduce_lr_factor == 0.5


def test_decode_with_beam(corpus, tmp_path, capsys, monkeypatch):
    from mgr_tpu.core import config as cfglib

    small = cfglib.get_preset("skeletal").replace(
        maxlen=32, batch_size=2, compute_dtype="float32",
        encoder=cfglib.EncoderConfig(hidden=4, depth=2, input_noise=0.1,
                                     dropout=(0.1, 0.1), output_dropout=0.1),
    )
    monkeypatch.setitem(cfglib.PRESETS, "skeletal", lambda: small)
    workdir = str(tmp_path / "runs")
    cli_main([
        "train", "skeletal", "--skeletal-csv", corpus["sk_csv"],
        "--labels", corpus["sk_labels"], "--workdir", workdir,
        "--epochs", "1",
    ])
    capsys.readouterr()
    out_mlf = str(tmp_path / "beam.mlf")
    rc = cli_main([
        "decode", "skeletal", "--workdir", workdir,
        "--skeletal-csv", corpus["sk_csv"],
        "--labels", corpus["sk_labels"],
        "--out", out_mlf, "--beam", "4", "--true-lengths",
    ])
    assert rc == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["decoded"] >= 1 and os.path.exists(out_mlf)
