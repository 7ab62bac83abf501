"""mgr-tpu CLI — non-interactive replacements for the reference's
script + raw_input entry points (SURVEY.md §5.6).

    python -m mgr_tpu.cli.main train speech --data-dir ... --labels ...
    python -m mgr_tpu.cli.main curriculum --audio-dir ... --skeletal-csv ...
    python -m mgr_tpu.cli.main decode late_fusion --workdir ... --out x.mlf
    python -m mgr_tpu.cli.main prepare-skeletal --raw-dir ... --out-csv ...
    python -m mgr_tpu.cli.main mix --audio-train ... --out-root ...
    python -m mgr_tpu.cli.main score refs.mlf hyps.mlf
    python -m mgr_tpu.cli.main bench
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional


def _add_common_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--workdir", default="runs")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint (replaces the "
                        "reference's raw_input('Load previous model?'))")
    p.add_argument("--mesh", default=None,
                   help="DATAxMODEL[xTIME] device mesh, e.g. 4x2 or 2x2x2")
    p.add_argument("--true-lengths", action="store_true",
                   help="mask CTC to true sequence lengths instead of the "
                        "reference's padded-length convention")
    p.add_argument("--compute-dtype", default=None,
                   choices=["bfloat16", "float32"])
    p.add_argument("--trace-dir", default=None,
                   help="capture a jax.profiler device trace of training")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans (numerics sanitizer)")
    p.add_argument("--async-checkpoints", action="store_true",
                   help="write checkpoints from a background thread")
    p.add_argument("--cache-dir", default=None,
                   help="persist featurized corpora (.npz) across runs")
    p.add_argument("--accum-steps", type=int, default=None,
                   help="gradient-accumulation microbatches per step: "
                        "activation memory drops to batch/accum-steps, so "
                        "effective batch can exceed the device memory "
                        "ceiling")
    p.add_argument("--lr", type=float, default=None,
                   help="override the preset learning rate")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="write checkpoints every N epochs (the true best "
                        "state is retained in memory and still flushed); "
                        "raise when per-epoch ~100MB serialization would "
                        "dwarf sub-second epochs")
    p.add_argument("--monitor", choices=("val", "train"), default="val",
                   help="loss that drives the best checkpoint and early "
                        "stopping; 'train' suits memorization/diagnostic "
                        "corpora where val loss only rises")


def _config_for(args, name: str):
    from mgr_tpu.core import config as cfglib

    cfg = cfglib.get_preset(name)
    over = {}
    if args.batch_size:
        over["batch_size"] = args.batch_size
    if getattr(args, "true_lengths", False):
        over["ctc"] = cfglib.CTCConfig(padded_length_parity=False)
    import dataclasses as _dc
    opt_over = {}
    accum = getattr(args, "accum_steps", None)
    if accum is not None:
        if accum < 1:
            raise SystemExit(f"--accum-steps must be >= 1, got {accum}")
        opt_over["accum_steps"] = accum
    lr = getattr(args, "lr", None)
    if lr is not None:
        if lr <= 0:
            raise SystemExit(f"--lr must be > 0, got {lr}")
        opt_over["learning_rate"] = lr
    if opt_over:
        over["optimizer"] = _dc.replace(cfg.optimizer, **opt_over)
    if getattr(args, "compute_dtype", None):
        over["compute_dtype"] = args.compute_dtype
    if getattr(args, "mesh", None):
        parts = [int(x) for x in args.mesh.lower().split("x")]
        d, m = parts[0], parts[1] if len(parts) > 1 else 1
        t = parts[2] if len(parts) > 2 else 1
        over["mesh"] = cfglib.MeshConfig(data=d, model=m, time=t)
    return cfg.replace(**over) if over else cfg


def _mesh_for(cfg):
    from mgr_tpu.parallel import make_mesh

    if cfg.mesh.num_devices <= 1:
        return None
    return make_mesh(cfg.mesh)


def _build_dataset(name: str, cfg, args, mode: str = "train"):
    from mgr_tpu.data import datasets

    if name == "speech":
        return datasets.build_audio_dataset(
            args.data_dir, args.labels, cfg, mode=mode,
            cache_dir=getattr(args, "cache_dir", None),
        )
    if name == "skeletal":
        return datasets.build_skeletal_dataset(
            args.skeletal_csv, args.labels, cfg, mode=mode
        )
    if name == "rgb":
        return datasets.build_rgb_dataset(
            args.data_dir, args.labels, cfg, mode=mode
        )
    if name == "early_fusion":
        return datasets.build_early_fusion_dataset(
            args.audio_csv, args.skeletal_csv, cfg, mode=mode
        )
    if name == "late_fusion":
        return datasets.build_late_fusion_dataset(
            args.audio_dir, args.skeletal_csv, args.labels, cfg, mode=mode
        )
    raise KeyError(name)


def cmd_train(args) -> int:
    from mgr_tpu.core import tracing
    from mgr_tpu.models import build_model
    from mgr_tpu.train.loop import fit

    if args.debug_nans:
        tracing.debug_nans(True)

    cfg = _config_for(args, args.pipeline)
    data = _build_dataset(args.pipeline, cfg, args)
    if args.pipeline == "late_fusion" and not args.from_scratch:
        from mgr_tpu.core import checkpoint as ckpt_lib
        from mgr_tpu.core import prng
        from mgr_tpu.train.curriculum import build_fusion_with_pretrained
        from mgr_tpu.train.step import create_train_state

        model, grafted = build_fusion_with_pretrained(args.workdir, cfg)
        if not args.resume:
            state = create_train_state(model, prng.root_key(cfg.seed))
            state = state._replace(params=grafted)
            ckpt_lib.save_checkpoint(args.workdir, cfg.name, state,
                                     slot="latest")
        with tracing.trace(args.trace_dir):
            res = fit(model, data, workdir=args.workdir,
                      mesh=_mesh_for(cfg), resume=True, epochs=args.epochs,
                      async_checkpoints=args.async_checkpoints,
                      checkpoint_every=args.checkpoint_every,
                      monitor=args.monitor)
    else:
        model = build_model(cfg)
        with tracing.trace(args.trace_dir):
            res = fit(model, data, workdir=args.workdir,
                      mesh=_mesh_for(cfg), resume=args.resume,
                      epochs=args.epochs,
                      async_checkpoints=args.async_checkpoints,
                      checkpoint_every=args.checkpoint_every,
                      monitor=args.monitor)
    print(json.dumps({
        "pipeline": args.pipeline,
        "best_val_loss": res.best_val_loss,
        "epochs_run": res.epochs_run,
    }))
    return 0


def cmd_curriculum(args) -> int:
    from mgr_tpu.core import config as cfglib
    from mgr_tpu.data import datasets
    from mgr_tpu.train.curriculum import run_curriculum

    cfgs = {
        "speech": _config_for(args, "speech"),
        "skeletal": _config_for(args, "skeletal"),
        "late_fusion": _config_for(args, "late_fusion"),
    }
    speech_ds = datasets.build_audio_dataset(
        args.audio_dir, args.audio_labels, cfgs["speech"]
    )
    skeletal_ds = datasets.build_skeletal_dataset(
        args.skeletal_csv, args.labels, cfgs["skeletal"]
    )
    fusion_ds = datasets.build_late_fusion_dataset(
        args.audio_dir, args.skeletal_csv, args.labels, cfgs["late_fusion"]
    )
    results = run_curriculum(
        speech_ds, skeletal_ds, fusion_ds, args.workdir,
        configs=cfgs, mesh=_mesh_for(cfgs["speech"]), epochs=args.epochs,
    )
    print(json.dumps({
        k: {"best_val_loss": v.best_val_loss, "epochs": v.epochs_run}
        for k, v in results.items()
    }))
    return 0


def cmd_decode(args) -> int:
    from mgr_tpu.core import checkpoint as ckpt_lib
    from mgr_tpu.decode import Decoder
    from mgr_tpu.decode.decoder import MLF_FILENAMES
    from mgr_tpu.models import build_model
    from mgr_tpu.train.loop import load_params_for_eval

    # Decode with the exact config the pipeline trained under.
    cfg = ckpt_lib.load_config(args.workdir, args.pipeline)
    data = _build_dataset(args.pipeline, cfg, args, mode=args.dataset)
    if args.pipeline == "late_fusion":
        from mgr_tpu.train.curriculum import build_fusion_with_pretrained

        model, _ = build_fusion_with_pretrained(args.workdir, cfg)
    else:
        model = build_model(cfg)
    params = load_params_for_eval(model, args.workdir, slot=args.slot)
    if args.beam and args.beam > 1:
        import numpy as np

        from mgr_tpu.data import vocab as vocab_lib
        from mgr_tpu.decode.beam import beam_decode_batch
        from mgr_tpu.decode.decoder import DECODE_SPECS
        from mgr_tpu.train.step import make_predict_step

        spec = DECODE_SPECS[args.pipeline]
        predict = make_predict_step(model)
        results = []
        for ids, batch in data.epoch(cfg.batch_size, train=False):
            inputs = (
                (batch["inputs"], batch["inputs2"])
                if "inputs2" in batch else batch["inputs"]
            )
            probs = np.asarray(predict(params, inputs))
            lengths = batch["input_length"] if args.true_lengths else None
            seqs = beam_decode_batch(
                probs, lengths, beam_width=args.beam,
                trim_frames=spec.trim_frames,
            )
            results.extend(
                (fid, [spec.vocab[i] for i in s])
                for fid, s in zip(ids, seqs)
            )
        dec = Decoder(lambda x: x, args.pipeline)  # for write_mlf only
    else:
        # The stored config may carry the TRAINING mesh; only decode
        # data-parallel when this host actually has the devices.
        import jax

        mesh = (
            _mesh_for(cfg)
            if cfg.mesh.num_devices <= len(jax.devices()) else None
        )
        dec = Decoder.for_model(model, params, args.pipeline, mesh=mesh)
        results = dec.decode_batches(
            data.epoch(cfg.batch_size, train=False),
            use_lengths=args.true_lengths,
        )
    out = args.out or MLF_FILENAMES[args.pipeline]
    dec.write_mlf(out, results)
    print(json.dumps({"decoded": len(results), "mlf": out}))
    return 0


def cmd_infer(args) -> int:
    """Single-utterance inference: one audio CSV / skeletal slice ->
    decoded tokens on stdout (the serving path)."""
    import numpy as np

    from mgr_tpu.core import checkpoint as ckpt_lib
    from mgr_tpu.data import formats
    from mgr_tpu.data.batcher import pad_or_truncate
    from mgr_tpu.decode import Decoder
    from mgr_tpu.models import build_model
    from mgr_tpu.train.loop import load_params_for_eval

    cfg = ckpt_lib.load_config(args.workdir, args.pipeline)
    if args.pipeline == "speech":
        x = formats.load_audio_file_csv(args.input)
        if cfg.downsample > 1:
            x = x[:: cfg.downsample]
    elif args.pipeline == "skeletal":
        feats = formats.load_skeletal_csv(args.input, normalize=True)
        x = next(iter(feats.values()))
    elif args.pipeline == "rgb":
        x = formats.load_video_npy(args.input)
        x = (x - 128.0) / 255.0
    else:
        raise SystemExit("infer supports speech/skeletal/rgb inputs")
    padded, true_len = pad_or_truncate(
        x.astype(np.float32), cfg.maxlen
    )
    model = build_model(cfg)
    params = load_params_for_eval(model, args.workdir, slot=args.slot)
    dec = Decoder.for_model(model, params, args.pipeline)
    batch = {
        "inputs": padded[None],
        "input_length": np.asarray(
            [true_len - cfg.ctc.trim_frames], np.int32
        ),
    }
    results = dec.decode_batches(
        iter([((0,), batch)]), use_lengths=args.true_lengths
    )
    print(json.dumps({"tokens": results[0][1]}))
    return 0


def cmd_score(args) -> int:
    from mgr_tpu.decode import read_mlf, score_sequences

    refs = read_mlf(args.refs)
    hyps = read_mlf(args.hyps)
    print(json.dumps(score_sequences(refs, hyps, ignore_missing=args.partial)))
    return 0


def cmd_evaluate(args) -> int:
    """Decode a split and score it against the dataset's own labels in
    one step (no MLF round-trip)."""
    from mgr_tpu.core import checkpoint as ckpt_lib
    from mgr_tpu.decode.evaluate import evaluate_accuracy
    from mgr_tpu.models import build_model
    from mgr_tpu.train.loop import load_params_for_eval

    cfg = ckpt_lib.load_config(args.workdir, args.pipeline)
    data = _build_dataset(args.pipeline, cfg, args, mode=args.dataset)
    if args.pipeline == "late_fusion":
        from mgr_tpu.train.curriculum import build_fusion_with_pretrained

        model, _ = build_fusion_with_pretrained(args.workdir, cfg)
    else:
        model = build_model(cfg)
    params = load_params_for_eval(model, args.workdir, slot=args.slot)
    metrics = evaluate_accuracy(
        model, params, data,
        pipeline=args.pipeline,
        train_split=args.split == "train",
        use_lengths=args.true_lengths,
    )
    print(json.dumps(metrics))
    return 0


def cmd_prepare_skeletal(args) -> int:
    from mgr_tpu.data.skeletal_pipeline import extract_directory

    ids = extract_directory(
        args.raw_dir, args.out_csv,
        split_at=args.split_at, val_csv=args.val_csv,
    )
    print(json.dumps({"videos": len(ids)}))
    return 0


def cmd_prepare_audio(args) -> int:
    from mgr_tpu.data.audio_pipeline import extract_directory

    ids = extract_directory(args.wav_dir, args.out_dir)
    print(json.dumps({"files": len(ids)}))
    return 0


def cmd_prepare_rgb(args) -> int:
    from mgr_tpu.data.rgb_pipeline import extract_directory

    ids = extract_directory(
        args.video_dir, args.skeletal_dir, args.out_dir,
        out_dim=args.img_dim,
    )
    print(json.dumps({"videos": len(ids)}))
    return 0


def cmd_mix(args) -> int:
    from mgr_tpu.data.mixer import mix_all

    info = mix_all(
        audio_train_csv=args.audio_train,
        audio_val_csv=args.audio_val,
        skeletal_train_csv=args.skeletal_train,
        skeletal_val_csv=args.skeletal_val,
        train_labels_csv=args.train_labels,
        val_labels_csv=args.val_labels,
        out_root=args.out_root,
        n_moved=args.n_moved,
    )
    print(json.dumps({"moved": len(info["moved"]), "kept": len(info["kept"])}))
    return 0


def cmd_bench(_args) -> int:
    import bench

    bench.main([])
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mgr-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="train one pipeline")
    pt.add_argument("pipeline", choices=[
        "speech", "skeletal", "rgb", "early_fusion", "late_fusion"
    ])
    pt.add_argument("--data-dir", help="per-file audio CSV dir / video dir")
    pt.add_argument("--labels", help="Id,Sequence label CSV")
    pt.add_argument("--skeletal-csv", help="monolithic skeletal CSV")
    pt.add_argument("--audio-csv", help="monolithic labeled audio CSV")
    pt.add_argument("--audio-dir", help="per-file audio dir (late fusion)")
    pt.add_argument("--from-scratch", action="store_true",
                    help="late fusion: skip loading pretrained encoders")
    _add_common_train_flags(pt)
    pt.set_defaults(fn=cmd_train)

    pc = sub.add_parser("curriculum", help="3-stage speech->skeletal->fusion")
    pc.add_argument("--audio-dir", required=True)
    pc.add_argument("--audio-labels", required=True)
    pc.add_argument("--skeletal-csv", required=True)
    pc.add_argument("--labels", required=True)
    _add_common_train_flags(pc)
    pc.set_defaults(fn=cmd_curriculum)

    pd = sub.add_parser("decode", help="decode a trained pipeline to MLF")
    pd.add_argument("pipeline", choices=[
        "speech", "skeletal", "rgb", "early_fusion", "late_fusion"
    ])
    pd.add_argument("--workdir", default="runs")
    pd.add_argument("--dataset", default="val", choices=["val", "final"])
    pd.add_argument("--slot", default="best", choices=["best", "latest"])
    pd.add_argument("--out", default=None)
    pd.add_argument("--data-dir")
    pd.add_argument("--labels")
    pd.add_argument("--skeletal-csv")
    pd.add_argument("--audio-csv")
    pd.add_argument("--audio-dir")
    pd.add_argument("--true-lengths", action="store_true")
    pd.add_argument("--beam", type=int, default=0,
                    help="prefix beam search width (0/1 = best path)")
    pd.set_defaults(fn=cmd_decode)

    pe = sub.add_parser("evaluate",
                        help="decode a split and score it in-framework")
    pe.add_argument("pipeline", choices=[
        "speech", "skeletal", "rgb", "early_fusion", "late_fusion"
    ])
    pe.add_argument("--workdir", default="runs")
    pe.add_argument("--dataset", default="train",
                    choices=["train", "val", "final"])
    pe.add_argument("--split", default="val", choices=["train", "val"],
                    help="which side of the split to score (dataset=train)")
    pe.add_argument("--slot", default="best", choices=["best", "latest"])
    pe.add_argument("--data-dir")
    pe.add_argument("--labels")
    pe.add_argument("--skeletal-csv")
    pe.add_argument("--audio-csv")
    pe.add_argument("--audio-dir")
    pe.add_argument("--true-lengths", action="store_true")
    pe.set_defaults(fn=cmd_evaluate)

    pi = sub.add_parser("infer", help="decode one utterance file")
    pi.add_argument("pipeline", choices=["speech", "skeletal", "rgb"])
    pi.add_argument("input", help="audio CSV / skeletal CSV / video npy")
    pi.add_argument("--workdir", default="runs")
    pi.add_argument("--slot", default="best", choices=["best", "latest"])
    pi.add_argument("--true-lengths", action="store_true")
    pi.set_defaults(fn=cmd_infer)

    ps = sub.add_parser("score", help="HTK-style scoring of two MLFs")
    ps.add_argument("refs")
    ps.add_argument("hyps")
    ps.add_argument("--partial", action="store_true",
                    help="ignore refs missing from hyps")
    ps.set_defaults(fn=cmd_score)

    pk = sub.add_parser("prepare-skeletal",
                        help="raw Kinect CSVs -> monolithic feature CSV")
    pk.add_argument("--raw-dir", required=True)
    pk.add_argument("--out-csv", required=True)
    pk.add_argument("--val-csv", default=None)
    pk.add_argument("--split-at", type=int, default=None,
                    help="file id boundary (reference uses 403)")
    pk.set_defaults(fn=cmd_prepare_skeletal)

    pa = sub.add_parser("prepare-audio",
                        help="WAVs -> 39-d MFCC per-file CSVs (replaces "
                             "HTK HCopy)")
    pa.add_argument("--wav-dir", required=True)
    pa.add_argument("--out-dir", required=True)
    pa.set_defaults(fn=cmd_prepare_audio)

    pr = sub.add_parser("prepare-rgb",
                        help="videos + raw Kinect CSVs -> cropped "
                             "upper-body (T,60,60,1) .npy")
    pr.add_argument("--video-dir", required=True)
    pr.add_argument("--skeletal-dir", required=True)
    pr.add_argument("--out-dir", required=True)
    pr.add_argument("--img-dim", type=int, default=60)
    pr.set_defaults(fn=cmd_prepare_rgb)

    pm = sub.add_parser("mix", help="move N val files into training "
                                    "across all streams")
    pm.add_argument("--audio-train", required=True)
    pm.add_argument("--audio-val", required=True)
    pm.add_argument("--skeletal-train", required=True)
    pm.add_argument("--skeletal-val", required=True)
    pm.add_argument("--train-labels", required=True)
    pm.add_argument("--val-labels", required=True)
    pm.add_argument("--out-root", required=True)
    pm.add_argument("--n-moved", type=int, default=95)
    pm.set_defaults(fn=cmd_mix)

    pb = sub.add_parser("bench", help="flagship training throughput")
    pb.set_defaults(fn=cmd_bench)
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    from mgr_tpu.core.compile_cache import enable_compile_cache

    enable_compile_cache()
    # Multi-host bring-up BEFORE any JAX backend use; a no-op unless a
    # coordinator is configured (JAX_COORDINATOR_ADDRESS et al.), so the
    # same CLI runs on one host or a pod slice unchanged.
    from mgr_tpu.parallel import multihost

    multihost.initialize()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
