"""Benchmark: per-pipeline train + decode throughput on one GPU.

Default benches the flagship speech BLSTM+CTC and prints ONE JSON line;
primary metric first:
  {"metric": "train_seqs_per_sec_per_device", "value": N, "unit": "seq/s",
   "vs_baseline": N, "spread": {...}, "decode_seqs_per_sec_per_device": N,
   "decode_spread": {...}, "pipeline": "speech", "device": {...}}

`--pipeline {speech,skeletal,rgb,early_fusion,late_fusion}` benches any
of the five reference pipelines with the same harness. `--batch`
overrides the per-pipeline default.

Baseline derivation: the reference trains the full 3-stage system in
~100 h on a GTX 1060 at batch 2 over ~1900-frame padded sequences — an
implied train throughput of roughly 1.5 sequences/sec (SURVEY.md §6
"implied throughput floor"). vs_baseline is measured seq/s divided by
that 1.5 seq/s floor.

Methodology: the REAL train step at reference geometry — the full
preset model (e.g. BiLSTM(500)x2 over 1900 frames, 44-way CTC, Adam +
clip + maxnorm for speech) — on synthetic data, jitted once, on ONE
device. REPEATS x TIMED_STEPS steps, each repeat closed by
``jax.block_until_ready``; the value reported is the MEDIAN repeat,
with the min/max spread. The decode benchmark times the fused
predict+best-path step (make_decode_step, at the pipeline's reference
threshold) the same way.

The script measures the GPU: it exits non-zero when JAX finds none,
unless ``JAX_PLATFORMS=cpu`` was set explicitly (a CPU smoke of the
harness, whose numbers are not device metrics). Every line it prints
names the platform, device kind and the number of devices measured.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REFERENCE_SEQS_PER_SEC = 1.5
WARMUP_STEPS = 2
TIMED_STEPS = 10
REPEATS = 3


def _device_record() -> dict:
    """The measured device, or exit when no GPU backs this run."""
    dev = jax.devices()[0]
    if dev.platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        sys.exit(f"bench: no GPU found (JAX platform {dev.platform!r}); "
                 f"set JAX_PLATFORMS=cpu to smoke-test the harness on CPU")
    # The steps below run unsharded, on device 0 only.
    return {"platform": dev.platform, "kind": dev.device_kind, "count": 1}


# Per-pipeline defaults: batch size and the reference decode threshold
# (decode/decoder.py::DECODE_SPECS).
PIPELINES = {
    "speech": {"batch": 128, "threshold": 0.75},
    "skeletal": {"batch": 128, "threshold": 0.5},
    "rgb": {"batch": 16, "threshold": 0.0},
    "early_fusion": {"batch": 128, "threshold": 0.97},
    "late_fusion": {"batch": 64, "threshold": 0.5},
}


def _make_batch(cfg, B):
    rng = np.random.default_rng(0)
    T = cfg.maxlen

    def stream(F):
        return jnp.asarray(
            rng.standard_normal((B, T, F)).astype(np.float32)
        )

    if cfg.cnn is not None:
        d = cfg.cnn.img_dim
        inputs = jnp.asarray(
            rng.standard_normal((B, T, d, d, 1)).astype(np.float32)
        )
    else:
        inputs = stream(cfg.num_feats)
    batch = {
        "inputs": inputs,
        "labels": jnp.asarray(
            np.pad(
                rng.integers(1, cfg.nb_classes - 1, size=(B, 8)),
                ((0, 0), (0, cfg.max_label_len - 8)),
                constant_values=-1,
            ).astype(np.int32)
        ),
        "input_length": jnp.full((B,), T - cfg.ctc.trim_frames, jnp.int32),
        "label_length": jnp.full((B,), 8, jnp.int32),
    }
    if cfg.second_stream_feats:
        batch["inputs2"] = stream(cfg.second_stream_feats)
    return batch


def _bench_train(cfg, model, B):
    from mgr_tpu.core import prng
    from mgr_tpu.train import create_train_state, make_train_step

    state = create_train_state(model, prng.root_key(cfg.seed))
    step = make_train_step(model)
    batch = _make_batch(cfg, B)
    key = jax.random.key(0)

    for i in range(WARMUP_STEPS):
        state, metrics = step(state, batch, jax.random.fold_in(key, i), 1.0)
    jax.block_until_ready(metrics)

    rates = []
    for r in range(REPEATS):
        t0 = time.perf_counter()
        for i in range(TIMED_STEPS):
            state, metrics = step(
                state, batch,
                jax.random.fold_in(key, 100 + r * TIMED_STEPS + i), 1.0,
            )
        jax.block_until_ready(metrics)
        rates.append(B * TIMED_STEPS / (time.perf_counter() - t0))
    return rates


def _bench_decode(cfg, model, params, B, threshold):
    from mgr_tpu.train.step import make_decode_step

    step = make_decode_step(model, threshold=threshold, trim_frames=2)
    batch = _make_batch(cfg, B)
    inputs = (
        (batch["inputs"], batch["inputs2"])
        if "inputs2" in batch
        else batch["inputs"]
    )
    lengths = jnp.full((B,), cfg.maxlen, jnp.int32)

    jax.block_until_ready(step(params, inputs, lengths))

    rates = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            out = step(params, inputs, lengths)
        jax.block_until_ready(out)
        rates.append(B * TIMED_STEPS / (time.perf_counter() - t0))
    return rates


def _bench_latency(cfg, model, params, threshold, calls=20):
    """Single-utterance serving latency: B=1 fused predict+best-path,
    per-call wall-clock in ms, each call closed by block_until_ready."""
    from mgr_tpu.train.step import make_decode_step

    step = make_decode_step(model, threshold=threshold, trim_frames=2)
    batch = _make_batch(cfg, 1)
    inputs = (
        (batch["inputs"], batch["inputs2"])
        if "inputs2" in batch
        else batch["inputs"]
    )
    lengths = jnp.full((1,), cfg.maxlen, jnp.int32)

    jax.block_until_ready(step(params, inputs, lengths))  # compile

    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(step(params, inputs, lengths))
        times.append((time.perf_counter() - t0) * 1000.0)
    return sorted(times)


def main(argv=None) -> None:
    from mgr_tpu.core.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = _device_record()

    from mgr_tpu.core import config as cfglib
    from mgr_tpu.core import prng
    from mgr_tpu.models import build_model
    from mgr_tpu.train import create_train_state

    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", default="speech",
                    choices=sorted(PIPELINES))
    ap.add_argument("--batch", type=int, default=0,
                    help="override the pipeline's default batch")
    ap.add_argument("--no-cnn-remat", action="store_true",
                    help="rgb A/B: disable the conv-frontend remat")
    ap.add_argument("--latency", action="store_true",
                    help="serving mode: B=1 fused-decode latency in ms")
    ap.add_argument("--maxlen", type=int, default=0,
                    help="override sequence length (smoke testing)")
    args = ap.parse_args(argv)
    spec = PIPELINES[args.pipeline]
    B = args.batch or spec["batch"]

    cfg = cfglib.get_preset(args.pipeline).replace(batch_size=B)
    if args.maxlen:
        cfg = cfg.replace(maxlen=args.maxlen)
    if args.no_cnn_remat and cfg.cnn is not None:
        import dataclasses

        cfg = cfg.replace(cnn=dataclasses.replace(cfg.cnn, remat=False))
    model = build_model(cfg)

    if args.latency:
        params = create_train_state(
            model, prng.root_key(cfg.seed)).params
        times = _bench_latency(cfg, model, params, spec["threshold"])
        med = statistics.median(times)
        # Reference implied decode latency: ~2 seq/s on the GTX 1060
        # (SURVEY.md §6) -> ~500 ms/utterance.
        print(json.dumps({
            "metric": "decode_latency_ms",
            "value": round(med, 2),
            "unit": "ms",
            "vs_baseline": round(500.0 / med, 2),
            "spread": {"min": round(times[0], 2),
                       "max": round(times[-1], 2),
                       "calls": len(times)},
            "pipeline": args.pipeline,
            "batch": 1,
            "device": device,
        }))
        return

    train_rates = sorted(_bench_train(cfg, model, B))
    params = create_train_state(model, prng.root_key(cfg.seed)).params
    decode_rates = sorted(
        _bench_decode(cfg, model, params, B, spec["threshold"]))

    value = statistics.median(train_rates)
    dec_value = statistics.median(decode_rates)
    payload = {
        "metric": "train_seqs_per_sec_per_device",
        "value": round(value, 3),
        "unit": "seq/s",
        "vs_baseline": round(value / REFERENCE_SEQS_PER_SEC, 2),
        "spread": {
            "min": round(train_rates[0], 3),
            "max": round(train_rates[-1], 3),
            "repeats": REPEATS,
        },
        "decode_seqs_per_sec_per_device": round(dec_value, 3),
        "decode_spread": {
            "min": round(decode_rates[0], 3),
            "max": round(decode_rates[-1], 3),
        },
        "pipeline": args.pipeline,
        "batch": B,
        "device": device,
    }
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
