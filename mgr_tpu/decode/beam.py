"""CTC prefix beam search (host-side).

The reference only ships best-path decoding; beam search is the standard
upgrade (SURVEY.md §7.6 "optional beam search") and shares the same CTC
conventions (blank = C-1). Log-space prefix beam search over the
per-frame posteriors: each beam tracks p_blank / p_non_blank endings so
repeats merge correctly through blanks.

This runs on host over (T, C) numpy posteriors — decoding is a tiny
fraction of pipeline time (one pass over ~400 utterances), so clarity
beats a device kernel here; the heavy part (the model forward) is
already batched on the device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NEG_INF = -math.inf


def _lse(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log1p(math.exp(-abs(a - b)))


def ctc_beam_search(
    probs: np.ndarray,
    beam_width: int = 10,
    blank: Optional[int] = None,
    prune_logp: float = -12.0,
) -> List[Tuple[Tuple[int, ...], float]]:
    """(T, C) posteriors -> top beams [(label tuple, log prob)].

    ``prune_logp`` skips classes below exp(prune_logp) per frame — the
    usual width/per-frame pruning pair.
    """
    T, C = probs.shape
    if blank is None:
        blank = C - 1
    log_probs = np.log(np.maximum(probs, 1e-30))

    # prefix -> (logp ending in blank, logp ending in non-blank)
    beams: Dict[Tuple[int, ...], Tuple[float, float]] = {
        (): (0.0, NEG_INF)
    }
    for t in range(T):
        frame = log_probs[t]
        cand = np.nonzero(frame >= prune_logp)[0]
        if cand.size == 0:
            cand = np.array([int(frame.argmax())])
        new: Dict[Tuple[int, ...], Tuple[float, float]] = {}

        def acc(prefix, pb, pnb):
            old_pb, old_pnb = new.get(prefix, (NEG_INF, NEG_INF))
            new[prefix] = (_lse(old_pb, pb), _lse(old_pnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            total = _lse(pb, pnb)
            last = prefix[-1] if prefix else None
            for k in cand:
                lp = float(frame[k])
                if k == blank:
                    acc(prefix, total + lp, NEG_INF)
                elif k == last:
                    # Repeat: extends only the blank-ended mass; the
                    # non-blank-ended mass collapses onto the same prefix.
                    acc(prefix + (int(k),), NEG_INF, pb + lp)
                    acc(prefix, NEG_INF, pnb + lp)
                else:
                    acc(prefix + (int(k),), NEG_INF, total + lp)

        ranked = sorted(
            new.items(), key=lambda kv: _lse(*kv[1]), reverse=True
        )
        beams = dict(ranked[:beam_width])

    out = [
        (prefix, _lse(pb, pnb)) for prefix, (pb, pnb) in beams.items()
    ]
    out.sort(key=lambda x: x[1], reverse=True)
    return out


def beam_decode_batch(
    probs: np.ndarray,
    input_lengths: Optional[Sequence[int]] = None,
    *,
    beam_width: int = 10,
    blank: Optional[int] = None,
    trim_frames: int = 0,
) -> List[List[int]]:
    """(B, T, C) posteriors -> best beam label sequence per utterance.

    Applies the reference's leading-frame trim before searching,
    mirroring the best-path decoders (sequence_decoding.py:41-42)."""
    out = []
    for b in range(probs.shape[0]):
        p = probs[b, trim_frames:]
        if input_lengths is not None:
            p = p[: max(int(input_lengths[b]), 1)]
        beams = ctc_beam_search(p, beam_width=beam_width, blank=blank)
        out.append(list(beams[0][0]) if beams else [])
    return out
