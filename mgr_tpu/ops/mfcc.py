"""In-graph MFCC featurizer — replaces the external HTK HCopy stage.

Implements the reference's exact HTK configuration
(/root/reference/config_HCopy:1-13, README.md:35):
  TARGETKIND MFCC_0 (12 cepstra + C0), 25 ms window / 10 ms step,
  Hamming window, pre-emphasis 0.97, 26 mel filterbank channels,
  cep-liftering 22; plus delta and delta-delta appended for the final
  39-dim feature vector.

HTK-specific conventions honored (they differ from librosa/python_speech_features):
  * pre-emphasis is applied WITHIN each frame (s[n] -= k*s[n-1], s[0]
    scaled by (1-k)), after framing;
  * the filterbank sums MAGNITUDE spectrum (not power);
  * mel filters are triangular IN THE MEL DOMAIN between uniformly
    mel-spaced centers from 0 to Nyquist (HSigP.c loChan/loWt — not the
    Hz-domain triangles librosa builds);
  * DCT-II with sqrt(2/N) scaling; C0 = sqrt(2/N) * sum(log mel)
    appended after c1..c12 (HTK MFCC_0 ordering);
  * liftering c_j *= 1 + (L/2) sin(pi j / L);
  * deltas use the standard HTK regression window (DELTAWINDOW 2) with
    edge replication.

Everything is jnp and jit-able: framing is one gather, the filterbank
and DCT are (T, K) @ (K, M) matmuls in full float32 precision.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class MFCCConfig:
    sample_rate: int = 16000
    frame_ms: float = 25.0  # WINDOWSIZE 250000 (100 ns units)
    step_ms: float = 10.0  # TARGETRATE 100000
    preemphasis: float = 0.97  # PREEMCOEF
    num_filters: int = 26  # NUMCHANS
    num_ceps: int = 12  # NUMCEPS
    lifter: int = 22  # CEPLIFTER
    delta_window: int = 2  # HTK DELTAWINDOW default
    fft_size: int = 512

    @property
    def frame_len(self) -> int:
        return int(round(self.sample_rate * self.frame_ms / 1000.0))

    @property
    def frame_step(self) -> int:
        return int(round(self.sample_rate * self.step_ms / 1000.0))


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def _mel_filterbank(cfg: MFCCConfig) -> np.ndarray:
    """(fft_size//2 + 1, num_filters) triangular filters (host constant).

    HTK-exact: triangles are linear in the MEL domain (HSigP.c's
    loChan/loWt scatter interpolates each FFT bin's mel value between
    uniformly mel-spaced channel centers), NOT in Hz as librosa /
    python_speech_features build them — the two differ by a few percent
    per filter. Channel centers sit at c * melmax / (P + 1),
    c = 1..P+1, with mlo = 0; HTK's bin range klo=2..khi=N/2 (1-based)
    excludes DC and Nyquist, both of which get zero weight here anyway
    (the triangles vanish at mel 0 and melmax)."""
    n_bins = cfg.fft_size // 2 + 1
    P = cfg.num_filters
    mhi = _hz_to_mel(cfg.sample_rate / 2.0)
    # cf[0] = mlo = 0; cf[1..P] channel centers; cf[P+1] = mhi boundary.
    cf = np.arange(P + 2) * (mhi / (P + 1))
    bin_mels = _hz_to_mel(
        np.arange(n_bins) * cfg.sample_rate / cfg.fft_size
    )
    fb = np.zeros((n_bins, P), np.float32)
    for m in range(1, P + 1):
        lo, mid, hi = cf[m - 1], cf[m], cf[m + 1]
        up = (bin_mels - lo) / (mid - lo)
        down = (hi - bin_mels) / (hi - mid)
        fb[:, m - 1] = np.maximum(0.0, np.minimum(up, down))
    return fb


@functools.lru_cache(maxsize=8)
def _dct_matrix(num_filters: int, num_ceps: int) -> np.ndarray:
    """(num_filters, num_ceps + 1) DCT-II incl. row 0 for C0 (HTK
    sqrt(2/N) scaling)."""
    i = np.arange(num_filters) + 0.5
    j = np.arange(num_ceps + 1)
    mat = np.cos(np.pi * np.outer(i, j) / num_filters)
    return (np.sqrt(2.0 / num_filters) * mat).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _lifter_weights(num_ceps: int, lifter: int) -> np.ndarray:
    j = np.arange(1, num_ceps + 1)
    return (1.0 + (lifter / 2.0) * np.sin(np.pi * j / lifter)).astype(
        np.float32
    )


def frame_signal(signal: jax.Array, cfg: MFCCConfig) -> jax.Array:
    """(S,) -> (T, frame_len) frames at the HTK step."""
    flen, step = cfg.frame_len, cfg.frame_step
    n_frames = max(1 + (signal.shape[0] - flen) // step, 1)
    idx = (
        jnp.arange(n_frames)[:, None] * step + jnp.arange(flen)[None, :]
    )
    return signal[jnp.clip(idx, 0, signal.shape[0] - 1)]


def static_mfcc(signal: jax.Array, cfg: MFCCConfig = MFCCConfig()) -> jax.Array:
    """(S,) waveform -> (T, num_ceps + 1) [c1..c12, c0] static features."""
    frames = frame_signal(signal.astype(jnp.float32), cfg)
    # HTK in-frame pre-emphasis.
    pre = jnp.concatenate(
        [
            frames[:, :1] * (1.0 - cfg.preemphasis),
            frames[:, 1:] - cfg.preemphasis * frames[:, :-1],
        ],
        axis=1,
    )
    window = jnp.asarray(np.hamming(cfg.frame_len).astype(np.float32))
    windowed = pre * window[None, :]
    spec = jnp.abs(jnp.fft.rfft(windowed, n=cfg.fft_size, axis=1))
    fb = jnp.asarray(_mel_filterbank(cfg))
    hi = jax.lax.Precision.HIGHEST
    # HTK floors filterbank outputs
    mel = jnp.maximum(jnp.matmul(spec, fb, precision=hi), 1.0)
    log_mel = jnp.log(mel)
    dct = jnp.asarray(_dct_matrix(cfg.num_filters, cfg.num_ceps))
    ceps = jnp.matmul(log_mel, dct, precision=hi)  # (T, num_ceps + 1), C0 first
    c0 = ceps[:, :1]
    cc = ceps[:, 1:] * jnp.asarray(_lifter_weights(cfg.num_ceps, cfg.lifter))
    # HTK MFCC_0 ordering: c1..c12 then C0.
    return jnp.concatenate([cc, c0], axis=1)


def deltas(feats: jax.Array, window: int = 2) -> jax.Array:
    """HTK regression deltas with edge replication:
    d_t = sum_th th*(c_{t+th} - c_{t-th}) / (2 * sum th^2)."""
    T = feats.shape[0]
    denom = 2.0 * sum(th * th for th in range(1, window + 1))
    out = jnp.zeros_like(feats)
    for th in range(1, window + 1):
        fwd = feats[jnp.clip(jnp.arange(T) + th, 0, T - 1)]
        bwd = feats[jnp.clip(jnp.arange(T) - th, 0, T - 1)]
        out = out + th * (fwd - bwd)
    return out / denom


def mfcc_39(signal: jax.Array, cfg: MFCCConfig = MFCCConfig()) -> jax.Array:
    """(S,) waveform -> (T, 39): statics + delta + delta-delta — the
    reference's full audio feature vector (README.md:35)."""
    static = static_mfcc(signal, cfg)
    d1 = deltas(static, cfg.delta_window)
    d2 = deltas(d1, cfg.delta_window)
    return jnp.concatenate([static, d1, d2], axis=1)


def batch_mfcc_39(
    signals: jax.Array, cfg: MFCCConfig = MFCCConfig()
) -> jax.Array:
    """(B, S) equal-length waveforms -> (B, T, 39) via vmap."""
    return jax.vmap(lambda s: mfcc_39(s, cfg))(signals)
