"""On-card smoke test: the speech BLSTM+CTC trainer end to end on a GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # four cards: the mesh phase only

One card, in order:
  1. card     — the card's name and power limit (``nvidia-smi``, run in a
                child that does not import JAX) and JAX's device kind;
  2. train    — ``mgr_tpu.cli.main train speech`` in this process at the
                published widths (BLSTM(500)x2, maxlen 1900, 39 features,
                44 classes, labels up to 150) on a synthetic corpus that
                ``make_audio_dataset`` writes from a seed; per-step
                losses must be finite;
  3. decode   — ``decode speech`` on the checkpoint just written, then
                ``score`` of the MLF against the corpus labels;
  4. kernels  — the Triton CTC kernel against the plain lax.scan CTC at
                speech width (loss and gradient, float64 truth beside
                both), then timings: kernel against plain, forward plus
                backward, and the whole speech train step with each.

``--four`` runs only a speech-width train step on a DP=4 mesh and on a
DP2 x TP2 mesh and the mesh decode step, each against the single-device
step on the same rows.

One process drives the cards. Any failed check raises, so the script
exits non-zero and never prints its last line, which is exactly
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Without a GPU it exits 1 at once and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# CTC kernel acceptance at speech width (float32 inputs). The loss is
# compared relative to the plain scan. For the gradient, both float32
# paths are held to a float64 run of the plain scan: over ~1,900 serial
# log-space steps each float32 recursion drifts from the truth by far
# more than 1e-4 on its own, so the kernel's gradient error may be at
# most GRAD_ERR_FACTOR times the plain float32 path's, and never needs
# to beat GRAD_ABS_FLOOR.
LOSS_RTOL = 1e-4
GRAD_ABS_FLOOR = 1e-4
GRAD_ERR_FACTOR = 2.0
# Mesh steps against one device (--four): loss relative, post-step
# parameter checksum relative; decode must match exactly.
MESH_LOSS_RTOL = 1e-4
MESH_CSUM_RTOL = 1e-5


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    """``name, power.limit`` of every card, read without JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def timed(fn, *args, reps: int = 5):
    """(median, min, max) milliseconds of ``fn(*args)`` after one warm
    call; each call ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), min(ts), max(ts)


def fmt_ms(t) -> str:
    return f"median {t[0]:.3f} ms (min {t[1]:.3f}, max {t[2]:.3f})"


# ---------------------------------------------------------------------------
# 2-3. Train, decode and score through the CLI.
# ---------------------------------------------------------------------------

def train_decode_score(root: str, *, batch: int = 32, n_files: int = 48,
                       epochs: int = 3, seed: int = 0) -> dict:
    """CLI train -> decode -> score of the speech preset on a synthetic
    corpus. Returns the losses and the score."""
    import jax
    import numpy as np

    from mgr_tpu.cli.main import main as cli_main
    from mgr_tpu.core import config as cfglib
    from mgr_tpu.data import synthetic, vocab
    from mgr_tpu.decode import mlf as mlf_lib

    cfg = cfglib.get_preset("speech")
    # Gesture-class label files; the speech dataset expands each gesture
    # into its words (44 word classes).
    data_dir, label_file, labels = synthetic.make_audio_dataset(
        os.path.join(root, "data"), n_files=n_files,
        n_classes=vocab.NUM_GESTURE_CLASSES,
        frames_per_label=50 * cfg.downsample, max_labels=12, min_labels=6,
        seed=seed,
    )
    workdir = os.path.join(root, "runs")
    rc = cli_main(["train", "speech", "--data-dir", data_dir,
                   "--labels", label_file, "--workdir", workdir,
                   "--epochs", str(epochs), "--batch-size", str(batch)])
    if rc != 0:
        raise RuntimeError(f"train exited {rc}")
    with open(os.path.join(workdir, "speech_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    losses = [r["train_loss"] for r in recs]
    log("train", f"widths: BLSTM({cfg.encoder.hidden})x{cfg.encoder.depth}, "
        f"maxlen {cfg.maxlen}, {cfg.num_feats} feats, {cfg.nb_classes} "
        f"classes, labels <= {cfg.max_label_len}; batch {batch}, "
        f"{n_files} files, {epochs} epochs of one step")
    log("train", f"per-step losses: {losses}")
    if len(losses) != epochs or not all(np.isfinite(losses)):
        raise RuntimeError(f"train losses not finite: {losses}")
    dev = jax.devices()[0]
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    log("train", f"{dev} peak_bytes_in_use {peak}")
    if dev.platform == "gpu" and not peak:
        raise RuntimeError("no device memory in use after training")

    mlf_out = os.path.join(root, "speech.mlf")
    rc = cli_main(["decode", "speech", "--workdir", workdir, "--dataset",
                   "val", "--data-dir", data_dir, "--labels", label_file,
                   "--out", mlf_out])
    if rc != 0 or not os.path.exists(mlf_out):
        raise RuntimeError(f"decode exited {rc}")
    hyps = mlf_lib.read_mlf(mlf_out)
    refs_path = os.path.join(root, "refs.mlf")
    mlf_lib.write_mlf(refs_path, [
        (mlf_lib.entry_name(fid, "_audio"),
         [vocab.WORDS[w] for w in vocab.class_seq_to_word_seq(seq)])
        for fid, seq in labels.items()
    ])
    from mgr_tpu.decode import read_mlf, score_sequences

    score = score_sequences(read_mlf(refs_path), hyps, ignore_missing=True)
    rc = cli_main(["score", refs_path, mlf_out, "--partial"])
    if rc != 0:
        raise RuntimeError(f"score exited {rc}")
    n_tokens = sum(len(v) for v in hyps.values())
    log("decode", f"MLF {len(hyps)} utterances, {n_tokens} tokens; "
        f"score {json.dumps(score)}")
    if not hyps:
        raise RuntimeError("decode wrote an empty MLF")
    return {"losses": losses, "score": score}


# ---------------------------------------------------------------------------
# 4. Kernels: the Triton CTC kernel against the plain scan.
# ---------------------------------------------------------------------------

def ctc_problem(B: int, T: int, K: int, N: int, seed: int = 0):
    """Time-major logits and padded labels with edge rows: a full-length
    label, an empty one, one label, repeats, and short inputs."""
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, B, K)).astype(np.float32)
    lab_len = rng.integers(1, N + 1, size=B)
    lab_len[:4] = [N, 0, 1, N // 2]
    labels = np.full((B, N), -1, np.int32)
    for b in range(B):
        labels[b, :lab_len[b]] = rng.integers(0, K - 1, size=lab_len[b])
    labels[min(5, B - 1), :5] = [3, 3, 3, 1, 1]
    lab_len[min(5, B - 1)] = max(lab_len[min(5, B - 1)], 5)
    in_len = np.full((B,), T, np.int32)
    in_len[::3] = rng.integers(min(2 * N + 2, T), T + 1,
                               size=len(in_len[::3]))
    return tuple(jnp.asarray(a) for a in (logits, labels, in_len, lab_len))


def check_ctc_kernel(B=128, T=1898, K=44, N=150, *, interpret=False,
                     reps=5) -> dict:
    """Kernel vs plain CTC at one width: loss, d loss / d logits, and
    the forward+backward times. Raises when out of tolerance."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mgr_tpu.ops import ctc as ctc_lib
    from mgr_tpu.ops import pallas_kernels as pk

    logits, labels, in_len, lab_len = ctc_problem(B, T, K, N)

    def kernel(lg):
        lp = jax.nn.log_softmax(lg, axis=-1)
        return pk.pallas_ctc_loss(lp, labels, in_len, lab_len,
                                  time_major=True, interpret=interpret)

    def plain(lg):
        lp = jax.nn.log_softmax(lg, axis=-1)
        return ctc_lib.ctc_loss(lp, labels, in_len, lab_len, backend="xla",
                                time_major=True)

    def vg(fn):
        return jax.jit(jax.value_and_grad(lambda lg: fn(lg).sum()))

    with jax.default_matmul_precision("highest"):
        l_k, g_k = vg(kernel)(logits)
        l_x, g_x = vg(plain)(logits)
        per_k = jax.jit(kernel)(logits)
        per_x = jax.jit(plain)(logits)
        with jax.enable_x64(True):
            l_64, g_64 = vg(plain)(logits.astype(jnp.float64))
    g_k, g_x, g_64 = (np.asarray(g, np.float64) for g in (g_k, g_x, g_64))
    per_k, per_x = np.asarray(per_k), np.asarray(per_x)
    if not (np.all(np.isfinite(per_k)) and np.all(np.isfinite(g_k))):
        raise RuntimeError("CTC kernel produced non-finite values")
    loss_rel = float(np.max(np.abs(per_k - per_x) / np.abs(per_x)))
    err_k = float(np.max(np.abs(g_k - g_64)))
    err_x = float(np.max(np.abs(g_x - g_64)))
    kx = float(np.max(np.abs(g_k - g_x)))
    grad_tol = max(GRAD_ABS_FLOOR, GRAD_ERR_FACTOR * err_x)
    out = {"shape": (B, T, K, N), "loss_rel_err": loss_rel,
           "grad_err_kernel_vs_f64": err_k, "grad_err_plain_vs_f64": err_x,
           "grad_kernel_vs_plain": kx, "grad_tol": grad_tol,
           "loss_sum": (float(l_k), float(l_x), float(l_64))}
    log("kernels", f"CTC B={B} T={T} K={K} N={N} (state width "
        f"{pk.state_width(N)}): loss max rel err vs plain {loss_rel:.3e} "
        f"(tol {LOSS_RTOL:g})")
    log("kernels", f"CTC d loss/d logits max abs err vs float64: kernel "
        f"{err_k:.3e}, plain float32 {err_x:.3e} (tol max({GRAD_ABS_FLOOR:g}"
        f", {GRAD_ERR_FACTOR:g} x plain) = {grad_tol:.3e}); kernel vs plain "
        f"{kx:.3e}")
    if loss_rel > LOSS_RTOL or err_k > grad_tol:
        raise RuntimeError(f"CTC kernel out of tolerance: {out}")
    if not interpret:
        out["fwd_bwd_kernel_ms"] = timed(vg(kernel), logits, reps=reps)
        out["fwd_bwd_plain_ms"] = timed(vg(plain), logits, reps=reps)
        log("kernels", "CTC forward+backward: kernel "
            f"{fmt_ms(out['fwd_bwd_kernel_ms'])}; plain scan with autodiff "
            f"{fmt_ms(out['fwd_bwd_plain_ms'])}")
    return out


def speech_batch(cfg, B: int, seed: int = 0) -> dict:
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    n_lab = rng.integers(20, cfg.max_label_len + 1, size=B)
    labels = np.full((B, cfg.max_label_len), -1, np.int32)
    for b in range(B):
        labels[b, :n_lab[b]] = rng.integers(0, cfg.nb_classes - 1,
                                            size=n_lab[b])
    return {
        "inputs": jnp.asarray(rng.standard_normal(
            (B, cfg.maxlen, cfg.num_feats)).astype(np.float32)),
        "labels": jnp.asarray(labels),
        "input_length": jnp.full((B,), cfg.maxlen - cfg.ctc.trim_frames,
                                 jnp.int32),
        "label_length": jnp.asarray(n_lab.astype(np.int32)),
    }


def time_train_steps(B: int = 32, reps: int = 5, cfg=None) -> dict:
    """The speech train step with the CTC kernel (dispatch "auto") and
    with the plain scan ("xla"): memory analysis and step times."""
    import jax

    from mgr_tpu.core import config as cfglib
    from mgr_tpu.core import prng
    from mgr_tpu.models import build_model
    from mgr_tpu.ops import dispatch
    from mgr_tpu.train import create_train_state, make_train_step

    cfg = (cfg or cfglib.get_preset("speech")).replace(batch_size=B)
    model = build_model(cfg)
    batch = speech_batch(cfg, B)
    key = jax.random.key(1)
    dev = jax.devices()[0]
    out = {}
    for mode in ("auto", "xla"):
        dispatch.set_mode(mode)
        try:
            state = create_train_state(model, prng.root_key(0))
            step = make_train_step(model)
            compiled = step.lower(state, batch, key, 1.0).compile()
            if mode == "auto":
                log("kernels", f"train step B={B} memory_analysis "
                    f"{compiled.memory_analysis()}")
            state, m = compiled(state, batch, key, 1.0)
            loss0 = float(m["loss"])
            where = {d for leaf in jax.tree.leaves(state.params)
                     for d in leaf.devices()}
            if where != {dev}:
                raise RuntimeError(f"params live on {where}, not {dev}")

            def run(st):
                return compiled(st, batch, key, 1.0)

            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                state, m = run(state)
                jax.block_until_ready(m)
                ts.append((time.perf_counter() - t0) * 1e3)
            ms = (statistics.median(ts), min(ts), max(ts))
        finally:
            dispatch.set_mode("auto")
        name = "kernel" if mode == "auto" else "plain"
        out[name] = {"ms": ms, "first_loss": loss0}
        log("kernels", f"speech train step B={B}, CTC {name}: {fmt_ms(ms)}, "
            f"first loss {loss0:.4f}, params on {dev}")
        if not math.isfinite(loss0):
            raise RuntimeError(f"non-finite train loss with CTC {name}")
    return out


# ---------------------------------------------------------------------------
# --four: mesh steps against one device.
# ---------------------------------------------------------------------------

def mesh_check(n_dev: int = 4, B: int = 32, cfg=None) -> dict:
    """DP=n and DP(n/2) x TP2 train steps, and the DP mesh decode, each
    against the single-device step on the same rows."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mgr_tpu.core import config as cfglib
    from mgr_tpu.core import prng
    from mgr_tpu.models import build_model
    from mgr_tpu.parallel import make_mesh, shard_batch, shard_params
    from mgr_tpu.train import create_train_state, make_train_step
    from mgr_tpu.train.step import make_decode_step

    if len(jax.devices()) < n_dev:
        raise RuntimeError(f"need {n_dev} devices, have {jax.devices()}")
    base = cfg or cfglib.get_preset("speech")
    # Noise and dropout off: the shard_map step decorrelates their masks
    # across data shards, so agreement is defined without them. float32
    # compute at "highest" precision keeps the argmax decode exact.
    enc = cfglib.EncoderConfig(hidden=base.encoder.hidden,
                               depth=base.encoder.depth, input_noise=0.0,
                               dropout=(0.0, 0.0), output_dropout=0.0)
    base = base.replace(batch_size=B, encoder=enc, compute_dtype="float32")
    batch = speech_batch(base, B, seed=3)
    key = jax.random.key(5)

    def checksum(params) -> float:
        return float(sum(jnp.sum(jnp.abs(leaf.astype(jnp.float32)))
                         for leaf in jax.tree.leaves(params)))

    def run(cfg_x, mesh):
        model = build_model(cfg_x)
        state = create_train_state(model, prng.root_key(0))
        b = batch
        if mesh is not None:
            state = state._replace(params=shard_params(state.params, mesh))
            b = shard_batch(batch, mesh)
        state, m = make_train_step(model, mesh=mesh)(state, b, key, 1.0)
        return model, state, float(m["loss"]), checksum(state.params), b

    out = {}
    with jax.default_matmul_precision("highest"):
        model_1, state_1, loss_1, csum_1, _ = run(base, None)
        log("four", f"single device: loss {loss_1:.6f}, params checksum "
            f"{csum_1:.6f}")
        for name, mcfg in (
            (f"DP={n_dev}", cfglib.MeshConfig(data=n_dev)),
            (f"DP{n_dev // 2}xTP2", cfglib.MeshConfig(data=n_dev // 2,
                                                      model=2)),
        ):
            mesh = make_mesh(mcfg)
            _, state_m, loss_m, csum_m, b_m = run(base.replace(mesh=mcfg),
                                                  mesh)
            d_loss = abs(loss_m - loss_1) / max(abs(loss_1), 1.0)
            d_csum = abs(csum_m - csum_1) / max(abs(csum_1), 1.0)
            devs = sorted(d.id for d in b_m["inputs"].sharding.device_set)
            pdevs = {d.id for leaf in jax.tree.leaves(state_m.params)
                     for d in leaf.sharding.device_set}
            log("four", f"{name}: loss {loss_m:.6f} (rel diff {d_loss:.3e}, "
                f"tol {MESH_LOSS_RTOL:g}), params checksum {csum_m:.6f} "
                f"(rel diff {d_csum:.3e}, tol {MESH_CSUM_RTOL:g}); batch on "
                f"devices {devs}, params on {sorted(pdevs)}")
            if d_loss > MESH_LOSS_RTOL or d_csum > MESH_CSUM_RTOL:
                raise RuntimeError(f"{name} diverges from one device")
            if len(devs) != n_dev or len(pdevs) != n_dev:
                raise RuntimeError(f"{name} did not spread over {n_dev} "
                                   f"devices: batch {devs}, params {pdevs}")
            out[name] = {"loss": loss_m, "d_loss": d_loss, "d_csum": d_csum}

        mesh = make_mesh(cfglib.MeshConfig(data=n_dev))
        params_1 = state_1.params
        # Threshold 0: every frame's argmax counts, so the comparison
        # covers all of them, not only confident ones.
        best_1, emit_1 = make_decode_step(
            model_1, threshold=0.0, trim_frames=2)(
                params_1, batch["inputs"], batch["input_length"])
        b_m = shard_batch(batch, mesh)
        step_m = make_decode_step(model_1, threshold=0.0, trim_frames=2,
                                  mesh=mesh)
        best_m, emit_m = step_m(shard_params(params_1, mesh),
                                b_m["inputs"], b_m["input_length"])
        n_best = int(np.sum(np.asarray(best_m) != np.asarray(best_1)))
        n_emit = int(np.sum(np.asarray(emit_m) != np.asarray(emit_1)))
        log("four", f"DP={n_dev} decode: {n_best} argmax and {n_emit} emit "
            f"mismatches against one device over {best_1.size} frames "
            f"({int(np.sum(np.asarray(emit_1)))} emitted)")
        if n_best or n_emit:
            raise RuntimeError("mesh decode differs from one device")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in jax.devices()[:n_dev]]
    log("four", f"peak_bytes_in_use per device: {peaks}")
    if jax.devices()[0].platform == "gpu" and not all(peaks):
        raise RuntimeError(f"a device held no memory: {peaks}")
    out["decode_mismatches"] = n_best + n_emit
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform!r} "
              f"({dev.device_kind})", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from mgr_tpu.core.compile_cache import enable_compile_cache

    log("card", f"compile cache {enable_compile_cache()}")
    log("card", "nvidia-smi --query-gpu=name,power.limit:")
    print(card_line(), flush=True)
    log("card", f"JAX: {len(jax.devices())} x {dev.platform} "
        f"{dev.device_kind}")

    if args.four:
        mesh_check(4)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
            train_decode_score(root)
        check_ctc_kernel()
        time_train_steps()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
