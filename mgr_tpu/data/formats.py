"""On-disk data contracts, matching the reference's file formats exactly.

  * per-file audio CSVs ``audio_<id>.csv``: header row; 39 MFCC feature
    columns; a ``file_number`` column; optionally columns '39'/'40'
    (file id / frame label) which are dropped
    (/root/reference/audio_network/data_generator.py:54-55, 183-185).
  * monolithic labeled audio CSV (early fusion): NO header; cols 0-38
    features, col 39 file number, col 40 per-frame label
    (/root/reference/early_fusion/early_multimodal.py:83-88, 218-220).
  * monolithic skeletal CSV: header; 20 kinematic feature columns by
    name + ``file_number`` (skeletal_lstm_ctc.py:74-77).
  * label CSVs: header ``Id,Sequence`` where Sequence is a
    space-separated class-id string (data_generator.py:201-202).
  * per-video ``.npy``: (T, 60, 60, 1) uint8-ish arrays named
    ``Sample#####_*.npy`` — the file id is chars [6:11]
    (rgb_network/cnn_lstm.py:150, roi_extraction.py:74-78).
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, Iterable, List, Tuple

import numpy as np

# The 20 model features, in the exact column order the reference selects
# (skeletal_lstm_ctc.py:74-77).
SKELETAL_FEATURES: Tuple[str, ...] = (
    "lh_v", "rh_v", "le_v", "re_v", "lh_dist_rp", "rh_dist_rp",
    "lh_hip_d", "rh_hip_d", "le_hip_d", "re_hip_d", "lh_shc_d", "rh_shc_d",
    "le_shc_d", "re_shc_d", "lh_hip_ang", "rh_hip_ang", "lh_shc_ang",
    "rh_shc_ang", "lh_el_ang", "rh_el_ang",
)

NUM_AUDIO_FEATS = 39


def zscore(x: np.ndarray) -> np.ndarray:
    """Column-wise zero-mean unit-variance (sklearn preprocessing.scale
    semantics: population std, ddof=0; skeletal_lstm_ctc.py:116-134)."""
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    return (x - mean) / std


def read_csv(path: str | os.PathLike) -> Tuple[List[str], List[List[str]]]:
    """Header row and body rows of a CSV, as text (blank lines dropped)."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        return [], []
    return rows[0], rows[1:]


def write_csv(path: str | os.PathLike, header: List[str],
              rows: Iterable[List[str]]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def unique_in_order(values: Iterable) -> list:
    """Distinct values in first-appearance order (pandas ``unique``)."""
    return list(dict.fromkeys(values))


def numeric_id(cell: str) -> int:
    """A file-id cell as int ('7' and '7.0' both give 7)."""
    return int(float(cell))


def load_numeric_columns(
    path: str | os.PathLike, header: bool = True
) -> Tuple[List[str], np.ndarray]:
    """(column names, (rows, cols) float64 body) of an all-numeric CSV."""
    names: List[str] = []
    if header:
        with open(path, newline="") as f:
            names = next(csv.reader(f))
    body = np.loadtxt(path, delimiter=",", skiprows=1 if header else 0,
                      dtype=np.float64, ndmin=2)
    return names, body


def load_label_csv(path: str | os.PathLike) -> Dict[int, List[int]]:
    """``Id,Sequence`` -> {file_id: [class ids]}. Empty/missing sequences
    map to []."""
    header, rows = read_csv(path)
    i_id, i_seq = header.index("Id"), header.index("Sequence")
    out: Dict[int, List[int]] = {}
    for row in rows:
        seq = row[i_seq] if i_seq < len(row) else ""
        out[numeric_id(row[i_id])] = [int(x) for x in seq.split()]
    return out


def list_audio_files(data_dir: str | os.PathLike) -> List[int]:
    """Sorted numeric ids of ``audio_<id>.csv`` files
    (data_generator.py:68-69)."""
    ids = []
    for name in os.listdir(data_dir):
        m = re.findall(r"audio_(\d+)\.csv", name)
        if m:
            ids.append(int(m[0]))
    return sorted(ids)


def load_audio_file_csv(path: str | os.PathLike) -> np.ndarray:
    """One per-file audio CSV -> (T, 39) float32 feature matrix.

    Parses the numeric body with the native fastcsv library when
    available (mgr_tpu/native/fastcsv.cpp) — this is the highest-count
    load in the corpus (one file per utterance)."""
    from mgr_tpu.data import fastcsv

    with open(path) as f:
        header = f.readline().strip().split(",")
    keep = [
        i for i, name in enumerate(header)
        if name not in ("file_number", "39", "40")
    ]
    mat = fastcsv.load_numeric_csv(str(path), skip_header=True)
    x = np.ascontiguousarray(mat[:, keep], dtype=np.float32)
    if x.shape[1] != NUM_AUDIO_FEATS:
        raise ValueError(
            f"{path}: expected {NUM_AUDIO_FEATS} feature cols, got {x.shape[1]}"
        )
    return x


def load_monolithic_audio_csv(
    path: str | os.PathLike, normalize: bool = True
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Headerless labeled audio CSV -> {file_id: (feats (T,39), frame_labels
    (T,))}. Features are optionally z-scored over the WHOLE corpus before
    splitting by file (early_multimodal.py:88-92)."""
    _, body = load_numeric_columns(path, header=False)
    feats = body[:, :NUM_AUDIO_FEATS].astype(np.float32)
    if normalize:
        feats = zscore(feats)
    file_nums = body[:, NUM_AUDIO_FEATS]
    frame_labels = body[:, NUM_AUDIO_FEATS + 1].astype(np.int32)
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for fid in unique_in_order(file_nums):
        m = file_nums == fid
        out[int(fid)] = (feats[m], frame_labels[m])
    return out


def load_skeletal_csv(
    path: str | os.PathLike, normalize: bool = True
) -> Dict[int, np.ndarray]:
    """Monolithic skeletal CSV -> {file_id: (T, 20) float32}, z-scored
    over the whole corpus first (skeletal_lstm_ctc.py:116-134)."""
    names, body = load_numeric_columns(path)
    feats = body[:, [names.index(c) for c in SKELETAL_FEATURES]].astype(
        np.float32)
    if normalize:
        feats = zscore(feats)
    file_nums = body[:, names.index("file_number")]
    out: Dict[int, np.ndarray] = {}
    for fid in unique_in_order(file_nums):
        out[int(fid)] = feats[file_nums == fid]
    return out


def list_video_files(data_dir: str | os.PathLike) -> List[str]:
    """Sorted .npy file names (string sort, matching cnn_lstm.py:83)."""
    return sorted(n for n in os.listdir(data_dir) if n.endswith(".npy"))


def video_file_id(name: str) -> int:
    """'Sample00007_color.npy' -> 7 (cnn_lstm.py:150: file[6:11])."""
    return int(name[6:11])


def load_video_npy(path: str | os.PathLike) -> np.ndarray:
    """(T, H, W, 1) float32 frames."""
    x = np.load(path).astype(np.float32)
    if x.ndim == 3:
        x = x[..., None]
    return x
