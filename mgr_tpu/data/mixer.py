"""Dataset mixer — re-design of /root/reference/util/mix_data.py:18-178.

Moves a deterministic sample of validation files into the training set,
consistently across the audio, skeletal, and label streams, and explodes
monolithic audio CSVs into the per-file layout the loaders consume.

Determinism note: the reference samples indices with Python 2's
``random.seed(10); random.sample(xrange(n), 95)`` (mix_data.py:27-28).
Python 3's ``random.sample`` draws a different sequence for the same
seed, so we replicate the reference's *mechanism* (seeded sample of 95
index positions, sorted) with Python 3 semantics and document the
deviation — the exact Py2 draw is unrecoverable without a Py2 runtime.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Sequence, Tuple

from mgr_tpu.data.formats import (numeric_id, read_csv, unique_in_order,
                                   write_csv)


def sample_validation_files(
    val_file_list: Sequence[int], n_moved: int = 95, seed: int = 10
) -> Tuple[List[int], List[int]]:
    """Pick ``n_moved`` validation files to move into training
    (mix_data.py:18-32). Returns (moved_to_train, kept_in_val)."""
    rng = random.Random(seed)
    n = len(val_file_list)
    n_moved = min(n_moved, n)
    idx = sorted(rng.sample(range(n), n_moved))
    moved = [val_file_list[i] for i in idx]
    kept = sorted(set(val_file_list) - set(moved))
    return moved, kept


def _split_rows(path: str, id_col: str, moved: Sequence[int],
                header: List[str] | None = None):
    """(header, rows of ``moved`` ids, other rows) of a CSV; rows are
    reordered to ``header``'s columns when one is given."""
    own, rows = read_csv(path)
    if header is not None and own != header:
        order = [own.index(c) for c in header]
        rows = [[r[i] for i in order] for r in rows]
        own = header
    i = own.index(id_col)
    moved = set(moved)
    hit = [r for r in rows if numeric_id(r[i]) in moved]
    rest = [r for r in rows if numeric_id(r[i]) not in moved]
    return own, hit, rest


def _append_moved(
    train_csv: str, val_csv: str, moved: Sequence[int],
    out_train: str, out_val: str, id_col: str,
) -> None:
    header, train_rows = read_csv(train_csv)
    _, hit, rest = _split_rows(val_csv, id_col, moved, header)
    write_csv(out_train, header, train_rows + hit)
    write_csv(out_val, header, rest)


def mix_frame_datasets(
    train_csv: str, val_csv: str, moved: Sequence[int],
    out_train: str, out_val: str, id_col: str = "file_number",
) -> None:
    """Move rows of ``moved`` file ids from the validation CSV into the
    training CSV (mix_data.py:35-56), writing the two new sets."""
    _append_moved(train_csv, val_csv, moved, out_train, out_val, id_col)


def mix_label_csvs(
    train_labels_csv: str, val_labels_csv: str, moved: Sequence[int],
    out_train: str, out_val: str,
) -> None:
    """Same move for the Id/Sequence label CSVs (mix_data.py:87-104)."""
    _append_moved(train_labels_csv, val_labels_csv, moved, out_train,
                  out_val, "Id")


def _file_ids(path: str) -> List[int]:
    header, rows = read_csv(path)
    i = header.index("file_number")
    return unique_in_order(numeric_id(r[i]) for r in rows)


def explode_audio_csv(
    monolithic_csv: str, out_dir: str,
    file_list: Sequence[int] | None = None,
) -> List[int]:
    """Split a monolithic audio CSV into per-file ``audio_<id>.csv``
    (mix_data.py:59-84, 107-125). Returns the ids written."""
    os.makedirs(out_dir, exist_ok=True)
    header, rows = read_csv(monolithic_csv)
    i = header.index("file_number")
    by_id: Dict[int, list] = {}
    for r in rows:
        by_id.setdefault(numeric_id(r[i]), []).append(r)
    ids = list(file_list) if file_list is not None else list(by_id)
    for fid in ids:
        write_csv(os.path.join(out_dir, f"audio_{fid}.csv"), header,
                  by_id.get(int(fid), []))
    return ids


def mix_all(
    *,
    audio_train_csv: str,
    audio_val_csv: str,
    skeletal_train_csv: str,
    skeletal_val_csv: str,
    train_labels_csv: str,
    val_labels_csv: str,
    out_root: str,
    n_moved: int = 95,
    seed: int = 10,
) -> Dict[str, object]:
    """Full mix_data.py main routine (mix_data.py:130-178): sample 95 val
    files, merge them into training across labels/audio/skeletal, and
    explode the per-file audio directories."""
    os.makedirs(out_root, exist_ok=True)
    val_ids = _file_ids(audio_val_csv)
    moved, kept = sample_validation_files(val_ids, n_moved, seed)

    mix_label_csvs(
        train_labels_csv, val_labels_csv, moved,
        os.path.join(out_root, "training.csv"),
        os.path.join(out_root, "validation.csv"),
    )

    train_ids = _file_ids(audio_train_csv)
    train_dir = os.path.join(out_root, "train_audio")
    val_dir = os.path.join(out_root, "val_audio")
    explode_audio_csv(audio_train_csv, train_dir, train_ids)
    explode_audio_csv(audio_val_csv, train_dir, moved)
    explode_audio_csv(audio_val_csv, val_dir, kept)

    mix_frame_datasets(
        skeletal_train_csv, skeletal_val_csv, moved,
        os.path.join(out_root, "Training_set_skeletal.csv"),
        os.path.join(out_root, "Validation_set_skeletal.csv"),
    )
    return {"moved": moved, "kept": kept, "train_ids": train_ids}
