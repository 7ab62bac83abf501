"""Data pipeline: formats, split parity, batchers, all five builders."""

import os
import random

import numpy as np
import pytest

from mgr_tpu.core import config as cfglib
from mgr_tpu.data import batcher, datasets, formats, synthetic


@pytest.fixture(scope="module")
def audio_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio")
    return synthetic.make_audio_dataset(str(root), n_files=8, seed=0)


@pytest.fixture(scope="module")
def skeletal_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("skel")
    return synthetic.make_skeletal_dataset(str(root), n_files=8, seed=1)


def _cfg(name, **kw):
    over = dict(maxlen=64, batch_size=2, compute_dtype="float32")
    over.update(kw)
    return cfglib.get_preset(name).replace(**over)


def test_reference_split_matches_stdlib_semantics():
    files = list(range(100))
    train, val = batcher.reference_split(files, 0.2, 2, seed=10)
    # Re-derive with the exact reference code shape.
    ref = list(range(100))
    random.seed(10)
    random.shuffle(ref)
    sp = int(len(ref) * 0.8)
    rtrain, rval = ref[:sp], ref[sp:]
    assert train == rtrain[: len(train)] and val == rval[: len(val)]
    assert len(train) % 2 == 0 and len(val) % 2 == 0
    # Deterministic across calls.
    train2, val2 = batcher.reference_split(files, 0.2, 2, seed=10)
    assert train == train2 and val == val2


def test_pad_or_truncate():
    x = np.ones((5, 3), np.float32)
    padded, tl = batcher.pad_or_truncate(x, 8)
    assert padded.shape == (8, 3) and tl == 5
    assert (padded[5:] == 0).all()
    trunc, tl2 = batcher.pad_or_truncate(x, 4)
    assert trunc.shape == (4, 3) and tl2 == 4


def test_prepare_labels_blank_fallback_and_expansion():
    lab, n = batcher.prepare_labels([], 5, blank=21)
    assert n == 1 and lab[0] == 21 and (lab[1:] == -1).all()
    lab, n = batcher.prepare_labels([2], 5, blank=43, expand_words=True)
    assert n == 2 and lab[0] == 2 and lab[1] == 3  # "Vieni qui"


def test_audio_dataset_build_and_epoch(audio_fixture):
    data_dir, label_file, labels = audio_fixture
    cfg = _cfg("speech")
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    assert ds.num_batches(2, train=True) >= 1
    ids, b = next(ds.epoch(2, train=True))
    assert b["inputs"].shape == (2, 64, 39)
    assert b["labels"].shape == (2, cfg.max_label_len)
    # padded-length parity: input_length == maxlen - trim
    assert (b["input_length"] == 64 - 2).all()
    # word expansion happened: label ids live in the 44-word space
    assert b["labels"].max() < 44
    # file features downsampled x5: synthetic 60 frames/label -> 12
    fid = ids[0]
    raw = formats.load_audio_file_csv(
        f"{data_dir}/audio_{fid}.csv"
    )
    assert np.allclose(
        b["inputs"][0, : len(raw[::5])], raw[::5][:64], atol=1e-5
    )


def test_audio_true_length_mode(audio_fixture):
    data_dir, label_file, _ = audio_fixture
    cfg = _cfg("speech", ctc=cfglib.CTCConfig(padded_length_parity=False))
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    _, b = next(ds.epoch(2, train=True))
    assert (b["input_length"] <= 64 - 2).all()
    assert (b["input_length"] > 0).all()


def test_skeletal_dataset_zscore_and_labels(skeletal_fixture):
    csv_path, label_file, labels = skeletal_fixture
    cfg = _cfg("skeletal")
    ds = datasets.build_skeletal_dataset(csv_path, label_file, cfg)
    feats = formats.load_skeletal_csv(csv_path, normalize=True)
    allx = np.concatenate(list(feats.values()))
    np.testing.assert_allclose(allx.mean(0), 0.0, atol=1e-4)
    np.testing.assert_allclose(allx.std(0), 1.0, atol=1e-4)
    _, b = next(ds.epoch(2, train=True))
    assert b["inputs"].shape == (2, 64, 20)
    assert b["labels"].max() < 22


def test_early_fusion_dataset(tmp_path, skeletal_fixture):
    csv_path, label_file, labels = skeletal_fixture
    audio_csv = synthetic.make_monolithic_audio_dataset(
        str(tmp_path), labels, frames_per_label=200
    )
    cfg = _cfg("early_fusion")
    ds = datasets.build_early_fusion_dataset(audio_csv, csv_path, cfg)
    ids, b = next(ds.epoch(2, train=True))
    assert b["inputs"].shape == (2, 64, 39)
    assert b["inputs2"].shape == (2, 64, 20)
    # Frame-label derivation: unique nonzero codes in order.
    for j, fid in enumerate(ids):
        want = []
        for v in labels[fid]:
            if v != 0 and v not in want:
                want.append(v)
        n = int(b["label_length"][j])
        assert b["labels"][j, :n].tolist() == want


def test_late_fusion_dataset(tmp_path, skeletal_fixture):
    sk_csv, sk_labels_file, sk_labels = skeletal_fixture
    # Build matching per-file audio for the same ids.
    data_dir, _, _ = synthetic.make_audio_dataset(
        str(tmp_path), n_files=len(sk_labels), seed=0
    )
    cfg = _cfg("late_fusion")
    ds = datasets.build_late_fusion_dataset(
        data_dir, sk_csv, sk_labels_file, cfg
    )
    ids, b = next(ds.epoch(2, train=True))
    assert b["inputs"].shape == (2, 64, 39)
    assert b["inputs2"].shape == (2, 64, 20)


def test_late_fusion_final_mode_dummy_labels(tmp_path, skeletal_fixture):
    sk_csv, sk_labels_file, sk_labels = skeletal_fixture
    data_dir, _, _ = synthetic.make_audio_dataset(
        str(tmp_path), n_files=len(sk_labels), seed=0
    )
    cfg = _cfg("late_fusion")
    ds = datasets.build_late_fusion_dataset(
        data_dir, sk_csv, sk_labels_file, cfg, mode="final"
    )
    assert ds.train_ids == []
    _, b = next(ds.epoch(2, train=False))
    # final mode: single blank label per sequence
    assert (b["label_length"] == 1).all()
    assert (b["labels"][:, 0] == cfg.nb_classes - 1).all()


def test_rgb_dataset_lazy(tmp_path):
    data_dir, label_file, labels = synthetic.make_rgb_dataset(
        str(tmp_path), n_files=4, img_dim=12
    )
    cfg = _cfg(
        "rgb", maxlen=16,
        cnn=cfglib.CNNConfig(img_dim=12, channels=(2, 2, 2),
                             kernel_sizes=(3, 3, 2), pool_sizes=(1, 1, 1)),
    )
    ds = datasets.build_rgb_dataset(data_dir, label_file, cfg)
    ids, b = next(ds.epoch(2, train=True))
    assert b["inputs"].shape == (2, 16, 12, 12, 1)
    # normalization (x-128)/255 -> range within [-0.51, 0.5]
    assert b["inputs"].min() >= -0.51 and b["inputs"].max() <= 0.5


def test_epoch_shuffle_changes_order(audio_fixture):
    data_dir, label_file, _ = audio_fixture
    cfg = _cfg("speech")
    ds = datasets.build_audio_dataset(data_dir, label_file, cfg)
    order1 = [ids for ids, _ in ds.epoch(2, train=True, shuffle_seed=1)]
    order2 = [ids for ids, _ in ds.epoch(2, train=True, shuffle_seed=2)]
    order1b = [ids for ids, _ in ds.epoch(2, train=True, shuffle_seed=1)]
    assert order1 == order1b
    assert order1 != order2 or len(order1) <= 1


def test_labels_pipeline(tmp_path):
    from mgr_tpu.data import labels_pipeline as lp

    d = tmp_path / "labels"
    d.mkdir()
    (d / "Sample00007_data_labels.csv").write_text(
        "vattene 1 5 1 20\nok 1 25 1 40\n"
    )
    (d / "Sample00008_data_labels.csv").write_text("basta 1 3 1 9\n")

    entries = lp.parse_label_file(str(d / "Sample00007_data_labels.csv"))
    assert entries == [("vattene", 5, 20), ("ok", 25, 40)]

    labs = lp.frame_labels(50, entries)
    assert labs[5] == 0 and labs[6] == 1 and labs[20] == 1
    assert labs[21] == 0 and labs[26] == 11 and labs[40] == 11
    assert labs[41] == 0

    inactive = np.zeros(50)
    inactive[26:] = 1
    labs2 = lp.frame_labels(50, entries, inactive)
    assert labs2[6] == 1 and labs2[30] == 0

    assert lp.sequence_labels(entries) == [1, 11]

    out_csv = str(tmp_path / "training.csv")
    labels = lp.build_label_csv(str(d), out_csv)
    assert labels == {7: [1, 11], 8: [13]}
    from mgr_tpu.data.formats import load_label_csv

    assert load_label_csv(out_csv) == labels


def test_audio_dataset_cache_roundtrip(audio_fixture, tmp_path):
    data_dir, label_file, _ = audio_fixture
    cfg = _cfg("speech")
    cache = str(tmp_path / "cache")
    a = datasets.build_audio_dataset(data_dir, label_file, cfg,
                                     cache_dir=cache)
    import os as _os

    files = [f for f in _os.listdir(cache) if f.endswith(".npz")]
    assert len(files) == 1
    b = datasets.build_audio_dataset(data_dir, label_file, cfg,
                                     cache_dir=cache)
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.train_ids == b.train_ids and a.val_ids == b.val_ids
    # Geometry change -> different cache entry.
    cfg2 = cfg.replace(maxlen=32)
    datasets.build_audio_dataset(data_dir, label_file, cfg2,
                                 cache_dir=cache)
    assert len([f for f in _os.listdir(cache) if f.endswith(".npz")]) == 2


def test_synthetic_reuse_skips_regeneration(tmp_path):
    """reuse=True: a completed identical run is not rewritten (the
    convergence check's MGR_TPU_CONV_ROOT persistence); changed knobs
    regenerate."""
    import os as _os
    import time as _time

    from mgr_tpu.data import synthetic

    root = str(tmp_path)
    d1, lf1, labs1 = synthetic.make_audio_dataset(
        root, n_files=3, frames_per_label=6, seed=0, reuse=True)
    path = _os.path.join(d1, "audio_1.csv")
    m0 = _os.path.getmtime(path)
    _time.sleep(0.05)
    d2, lf2, labs2 = synthetic.make_audio_dataset(
        root, n_files=3, frames_per_label=6, seed=0, reuse=True)
    assert (d1, lf1) == (d2, lf2) and labs1 == labs2
    assert _os.path.getmtime(path) == m0  # not rewritten
    # A different knob regenerates (new sentinel).
    synthetic.make_audio_dataset(
        root, n_files=3, frames_per_label=7, seed=0, reuse=True)
    assert _os.path.getmtime(path) > m0
    # reuse=False (default) always rewrites.
    skc = str(tmp_path / "sk")
    _os.makedirs(skc)
    c1, l1, sl1 = synthetic.make_skeletal_dataset(
        skc, n_files=3, frames_per_label=6, seed=1, reuse=True)
    ms = _os.path.getmtime(c1)
    _time.sleep(0.05)
    c2, _, sl2 = synthetic.make_skeletal_dataset(
        skc, n_files=3, frames_per_label=6, seed=1, reuse=True)
    assert sl1 == sl2 and _os.path.getmtime(c2) == ms


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


@pytest.mark.parametrize("kind", ["labels", "mono_audio", "skeletal",
                                  "mixer", "kinect"])
def test_csv_readers_without_pandas(tmp_path, kind):
    """The csv/numpy readers keep the reference formats' semantics:
    empty sequences, headerless monolithic audio, skeletal columns by
    name in any order with float file ids, first-appearance file order,
    row moves between splits, and quoted joint cells."""
    from mgr_tpu.data import formats, mixer
    from mgr_tpu.data.skeletal_pipeline import parse_kinect_csv

    if kind == "labels":
        p = _write(tmp_path / "l.csv", "Id,Sequence\n3,1 4 2\n7,\n\n5,9\n")
        assert formats.load_label_csv(p) == {3: [1, 4, 2], 7: [], 5: [9]}
    elif kind == "mono_audio":
        rows = [[float(i + j) for j in range(39)] + [fid, lab]
                for i, (fid, lab) in enumerate([(8, 1), (8, 2), (2, 5)])]
        p = _write(tmp_path / "a.csv", "\n".join(
            ",".join(f"{v:g}" for v in r) for r in rows) + "\n")
        out = formats.load_monolithic_audio_csv(p, normalize=False)
        assert list(out) == [8, 2]
        np.testing.assert_array_equal(out[8][1], [1, 2])
        assert out[8][0].shape == (2, 39) and out[8][0].dtype == np.float32
        np.testing.assert_array_equal(out[2][0][0], np.arange(2, 41))
    elif kind == "skeletal":
        cols = ["file_number"] + list(reversed(formats.SKELETAL_FEATURES))
        body = [[4.0] + list(range(20)), [1.0] + list(range(20, 40)),
                [4.0] + list(range(40, 60))]
        p = _write(tmp_path / "s.csv", ",".join(cols) + "\n" + "\n".join(
            ",".join(str(v) for v in r) for r in body) + "\n")
        out = formats.load_skeletal_csv(p, normalize=False)
        assert list(out) == [4, 1]
        # Columns come back in SKELETAL_FEATURES order.
        np.testing.assert_array_equal(out[1][0], np.arange(39, 19, -1))
        assert out[4].shape == (2, 20)
    elif kind == "mixer":
        tr = _write(tmp_path / "tr.csv", "Id,Sequence\n1,2 3\n")
        va = _write(tmp_path / "va.csv", "Sequence,Id\n4,2\n5 6,3.0\n,4\n")
        mixer.mix_label_csvs(tr, va, [3, 4], str(tmp_path / "o_tr.csv"),
                             str(tmp_path / "o_va.csv"))
        assert formats.load_label_csv(tmp_path / "o_tr.csv") == {
            1: [2, 3], 3: [5, 6], 4: []}
        assert formats.load_label_csv(tmp_path / "o_va.csv") == {2: [4]}
    else:
        from mgr_tpu.data.skeletal_pipeline import KINECT_COLUMNS

        cols = list(KINECT_COLUMNS)
        p = _write(tmp_path / "k.csv", ",".join(cols) + "\n" + "\n".join(
            ",".join(f'"[{10 * r + i} {700 if i == 0 else i}]"'
                     for i in range(len(cols))) for r in range(2)) + "\n")
        joints = parse_kinect_csv(p)
        first = joints[KINECT_COLUMNS[cols[0]]]
        # y >= 480 falls back to the frame centre's 240.
        np.testing.assert_array_equal(first, [[0, 240], [10, 240]])


def test_main_path_imports_without_optional_packages():
    """The trainer, CLI and benchmark import with flax, orbax and pandas
    blocked: none of them is installed on the GPU machine."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('flax', 'orbax', 'pandas'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import mgr_tpu.train.loop, mgr_tpu.cli.main, mgr_tpu.data.mixer\n"
        "import mgr_tpu.data.skeletal_pipeline, bench, chip_smoke\n"
        "print('ok')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=repo, env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
