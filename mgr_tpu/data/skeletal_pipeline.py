"""Offline skeletal feature pipeline — raw Kinect CSVs to the monolithic
model CSV, replacing the reference's three stage scripts (SURVEY.md §3.4):

  stage 1: per-video activity features
           (/root/reference/skeletal_network/extract_activity_feats.py:12-45)
  stage 2: gather into train/val monolithic CSVs, split at file id 403
           (/root/reference/skeletal_network/gather_skeletal.py:10-54)
  stage 3: vectorized velocities/accels/distances/angles
           (/root/reference/skeletal_network/skeletal_feature_extraction.py:271-299)

Raw Kinect per-video CSV format (load_skeleton.py:26-59): one header row,
joint columns holding "[x y]" strings for hip_center, shoulder_center,
left/right shoulder/elbow/wrist/hand; out-of-range coords snap to frame
center (x>=640 -> 320, y>=480 -> 240).

The compute itself is mgr_tpu.ops.kinematics (jnp) — all three stages
collapse into one vectorized pass per video.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mgr_tpu.data.formats import SKELETAL_FEATURES

# Raw CSV column name -> short joint key.
KINECT_COLUMNS = {
    "hip_center": "hip",
    "shoulder_center": "shc",
    "left_shoulder": "ls",
    "left_elbow": "le",
    "left_wrist": "lw",
    "left_hand": "lh",
    "right_shoulder": "rs",
    "right_elbow": "re",
    "right_wrist": "rw",
    "right_hand": "rh",
}

_PAIR_RE = re.compile(r"\[?\s*(-?\d+)\s+(-?\d+)\s*\]?")


def _parse_pair_column(values: Sequence[str]) -> np.ndarray:
    """Column of "[x y]" strings -> (T, 2) float32 with Kinect clipping
    (load_skeleton.py:5-20)."""
    out = np.zeros((len(values), 2), np.float32)
    for i, v in enumerate(values):
        m = _PAIR_RE.search(str(v))
        if not m:
            raise ValueError(f"unparseable joint cell {v!r}")
        x, y = int(m.group(1)), int(m.group(2))
        if x >= 640:
            x = 320
        if y >= 480:
            y = 240
        out[i] = (x, y)
    return out


def parse_kinect_csv(path: str) -> Dict[str, np.ndarray]:
    """Raw per-video CSV -> {joint: (T, 2)} tracks."""
    from mgr_tpu.data.formats import read_csv

    header, rows = read_csv(path)
    joints = {}
    for col, key in KINECT_COLUMNS.items():
        i = header.index(col)
        joints[key] = _parse_pair_column([r[i] for r in rows])
    return joints


def video_features(joints: Dict[str, np.ndarray]) -> np.ndarray:
    """One video's (T, 20) model features (column order =
    formats.SKELETAL_FEATURES)."""
    import jax.numpy as jnp

    from mgr_tpu.ops.kinematics import skeletal_features

    jj = {k: jnp.asarray(v) for k, v in joints.items()}
    return np.asarray(skeletal_features(jj))


def extract_directory(
    raw_dir: str,
    out_csv: str,
    *,
    file_pattern: str = r"Sample(\d+)",
    split_at: Optional[int] = None,
    val_csv: Optional[str] = None,
) -> List[int]:
    """Run the whole pipeline over a directory of raw Kinect CSVs and
    write the monolithic feature CSV(s).

    ``split_at`` reproduces stage 2's train/val boundary at file number
    403 (gather_skeletal.py:21,36): ids < split_at go to ``out_csv``,
    the rest to ``val_csv``. Videos whose skeleton fails to parse are
    skipped, matching the reference's silent skip
    (extract_activity_feats.py:35-38) but logged."""
    rows_train: List[np.ndarray] = []
    rows_val: List[np.ndarray] = []
    ids: List[int] = []
    for name in sorted(os.listdir(raw_dir)):
        if not name.endswith(".csv"):
            continue
        m = re.search(file_pattern, name)
        if not m:
            continue
        fid = int(m.group(1))
        try:
            joints = parse_kinect_csv(os.path.join(raw_dir, name))
            feats = video_features(joints)
        except Exception as e:  # noqa: BLE001 — reference skips bad videos
            print(f"skipping {name}: {type(e).__name__}: {e}")
            continue
        fcol = np.full((feats.shape[0], 1), fid, np.float32)
        row = np.concatenate([feats, fcol], axis=1)
        if split_at is not None and fid >= split_at:
            rows_val.append(row)
        else:
            rows_train.append(row)
        ids.append(fid)

    header = ",".join(SKELETAL_FEATURES) + ",file_number"

    def _write(path: str, rows: List[np.ndarray]) -> None:
        if not rows:
            return
        np.savetxt(path, np.concatenate(rows, axis=0), delimiter=",",
                   header=header, comments="", fmt="%.6f")

    _write(out_csv, rows_train)
    if split_at is not None and val_csv:
        _write(val_csv, rows_val)
    return ids
