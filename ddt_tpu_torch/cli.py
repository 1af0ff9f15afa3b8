"""Command line of the port (port of ddt_tpu/cli.py):

    python -m ddt_tpu_torch.cli train   --dataset higgs --rows 1000000 \\
        [--run-log run.jsonl] [--profile] [--status-port 0] \\
        [--xprof-dir D --xprof-rounds 2:3] [--trace-dir D]
    python -m ddt_tpu_torch.cli predict --model ens.npz --data rows.npz \\
        [--quantized int8|int4]
    python -m ddt_tpu_torch.cli inspect --model ens.npz [--tree 0]
    python -m ddt_tpu_torch.cli registry --registry R push|list|get|tag ...
    python -m ddt_tpu_torch.cli report --log run.jsonl \\
        [fleet|slo|drift|progress]
    python -m ddt_tpu_torch.cli report diff a.jsonl b.jsonl [--check]
    python -m ddt_tpu_torch.cli trace --log run.jsonl --out trace.json
    python -m ddt_tpu_torch.cli serve --model model.npz [--quantized int4]

The subcommands take the reference's flags and make its refusals, with
these differences. `--device {cuda,cpu}` (default cuda) says where the
"cuda" backend runs: `--device cuda` refuses to start without a visible
card, `--device cpu` runs the kernels' plain versions. `train
--backend {cuda,cpu}` (default cuda; the reference's "tpu" is "cuda"
here) picks the backend, "cpu" being the NumPy / native C++ oracle
(backends/cpu.CPUDevice), which needs no card. `train --fault-plan
PLAN.json` arms a fault plan for the run (before any torch.distributed
bootstrap, so its `multihost.init` seam can fire; disarmed on return),
`--straggler-repartition` acts on the straggler watchdog (a mesh run
with `--run-log`), and `--straggler-skew-threshold` is its trip point.
The flag of a field the port has not ported is absent: `--hist-impl`. A
run over several ranks (`--partitions`, `--feature-partitions`,
`--host-partitions`, `--mesh-shape`) is started by torchrun (the
rendezvous comes from its environment), inside a parallel/spawn rank
(global rank 0 writes `--out`), or by running the same command in every
process with `--multihost-coordinator host:port --multihost-processes N
--multihost-id i` (parallel/mesh.initialize_multihost over
tcp://host:port after the `--fault-plan` plan is armed, so its
`multihost.init` seam can fire; gloo on the CPU, NCCL with a card, one
card a process; every process writes its `--out`, the ensembles being
replicas, as in the reference). `predict` needs the model's bin mapper
(every model `train` saves carries one): the port scores binned rows
only. `bench` is not ported yet.

Datasets are the BASELINE configurations' seeded synthetic generators
(data/datasets.py); `--data` loads a file (data/datasets.load_file: .npz
with X and y, .csv[.gz], libsvm text).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from ddt_tpu_torch.config import LOSSES


def _positive_int(v: str) -> int:
    i = int(v)
    if i < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {i}")
    return i


def _parse_mesh_shape(v: "str | None") -> "tuple | None":
    """--mesh-shape "Pr,Pf" -> (Pr, Pf) (TrainConfig.mesh_shape)."""
    if v is None:
        return None
    parts = [p.strip() for p in str(v).split(",")]
    try:
        pr, pf = (int(p) for p in parts)
    except (TypeError, ValueError):
        raise SystemExit(
            f"--mesh-shape must be 'Pr,Pf' (two integers), got {v!r}")
    return (pr, pf)


def _need_device(cmd: str, device: str) -> None:
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"{cmd}: --device cuda but torch.cuda.is_available() is False; "
            "pass --device cpu to run the plain versions")


def _load_dataset(args, encoder=None, n_features=None):
    """(X, y, n_classes, encoder) of the named dataset, or of --data.
    `encoder` (predict) is the training-time CategoricalEncoder: the
    categorical columns are transformed with it, never refitted on the
    scoring rows. `n_features` (predict) pins a file's width to the
    model's."""
    from ddt_tpu_torch.data import datasets

    if args.data:
        X, y = datasets.load_file(
            args.data, label_col=getattr(args, "label_col", "auto"),
            normalize_labels=None if args.loss != "mse" else False,
            n_features=n_features)
        return (X, y,
                int(y.max()) + 1 if args.loss == "softmax" else 2, None)
    if args.dataset == "higgs":
        X, y = datasets.synthetic_binary(args.rows, seed=args.seed)
        return X, y, 2, None
    if args.dataset == "covertype":
        X, y = datasets.synthetic_multiclass(args.rows, seed=args.seed)
        return X, y, 7, None
    if args.dataset == "criteo":
        from ddt_tpu_torch.data.categorical import fit_categorical_encoder

        Xn, Xc, y = datasets.synthetic_ctr(args.rows, seed=args.seed)
        if encoder is None:
            encoder = fit_categorical_encoder(Xc, n_bins=args.bins)
        X = np.concatenate(
            [Xn, encoder.transform(Xc).astype(np.float32)], axis=1)
        return X, y, 2, encoder
    if args.dataset == "regression":
        X, y = datasets.synthetic_regression(args.rows, seed=args.seed)
        return X, y, 1, None
    raise SystemExit(f"unknown dataset {args.dataset!r}")


def _capture_window(args):
    """telemetry.profiler.CaptureWindow of --xprof-dir / --xprof-rounds,
    or None (a bad window exits cleanly)."""
    if not getattr(args, "xprof_dir", None):
        return None
    from ddt_tpu_torch.telemetry.profiler import CaptureWindow

    try:
        return CaptureWindow(args.xprof_dir, args.xprof_rounds)
    except ValueError as e:
        raise SystemExit(f"--xprof-rounds: {e}") from e


def _seeded_split(X, y, frac: float, seed: int):
    """The seeded held-out row split of the in-memory and streamed train
    paths: (X_train, y_train, X_val, y_val)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(y))
    k = int(len(y) * frac)
    if k < 1:
        raise SystemExit("--valid-frac holds out zero rows")
    va, tr = idx[:k], idx[k:]
    return X[tr], y[tr], X[va], y[va]


def _init_ranks(cfg) -> None:
    """A run over several ranks joins torchrun's rendezvous (its
    environment) unless this process is already a rank of a group."""
    from ddt_tpu_torch.parallel import mesh

    if cfg.world_size <= 1 or mesh.is_initialized():
        return
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        mesh.initialize_multihost("env://", int(os.environ["WORLD_SIZE"]),
                                  int(os.environ["RANK"]))


def _multihost_args(args) -> tuple | None:
    """(coordinator, processes, id) of `train --multihost-*`, checked, or
    None without them. As in the reference, a coordinator needs the
    process count (the port has no cluster auto-discovery) and an id in
    range."""
    coord = getattr(args, "multihost_coordinator", None)
    n = getattr(args, "multihost_processes", None)
    pid = getattr(args, "multihost_id", None)
    if coord is None and n is None and pid is None:
        return None
    if coord is None or n is None or pid is None:
        raise SystemExit("train: --multihost-coordinator, "
                         "--multihost-processes and --multihost-id go "
                         "together")
    if ":" not in coord:
        raise SystemExit(f"train: --multihost-coordinator must be "
                         f"host:port, got {coord!r}")
    if n < 1 or not 0 <= pid < n:
        raise SystemExit(f"train: --multihost-id {pid} is not in "
                         f"[0, {n})")
    return coord, n, pid


def _init_multihost(args) -> None:
    """`train --multihost-*`: join the process group over
    tcp://host:port (the caller armed the fault plan first)."""
    mh = _multihost_args(args)
    if mh is None:
        return
    from ddt_tpu_torch.parallel import mesh

    mesh.initialize_multihost(f"tcp://{mh[0]}", mh[1], mh[2])


def _writes_out(args) -> bool:
    """Global rank 0 writes --out; under --multihost-* every process does
    (its own path; the ensembles are replicas)."""
    return _world_rank() == 0 or _multihost_args(args) is not None


def _world_rank() -> int:
    from ddt_tpu_torch.parallel import mesh

    if not mesh.is_initialized():
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def _train_streaming(args, X, y, cfg, encoder, status=None) -> int:
    """`train --stream-chunks N | --stream-dir D`: the streamed path
    (streaming.fit_streaming). With --stream-dir the npz shards stream
    from disk; with --stream-chunks the loaded dataset is binned chunk
    by chunk into an on-disk uint8 cache and streamed back from it."""
    import shutil
    import tempfile

    from ddt_tpu_torch import api
    from ddt_tpu_torch.telemetry.events import RunLog

    if args.trace_dir is not None:
        raise SystemExit("--stream-chunks does not compose with --trace-dir")
    t0 = time.perf_counter()
    tmp_cache = None
    cache_root = args.stream_cache_dir
    if cache_root is None:
        tmp_cache = tempfile.mkdtemp(prefix="ddt_binned_")
        cache_root = tmp_cache
    window = _capture_window(args)
    run_log = RunLog.coerce(args.run_log)
    try:
        ens, history, mapper, rows, n_chunks, chunk_rows_max = \
            _stream_fit(args, X, y, cfg, cache_root, window,
                        run_log=run_log, status=status)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from e
    finally:
        if tmp_cache is not None:
            shutil.rmtree(tmp_cache, ignore_errors=True)
        if run_log is not None:
            run_log.close()
    dt = time.perf_counter() - t0
    if mapper is not None:
        api.fill_raw_thresholds(ens, mapper)
    if _writes_out(args):
        api.save_model(args.out, ens, mapper=mapper, encoder=encoder,
                       run_id=run_log.run_id if run_log else None, cfg=cfg)
    out = {
        "cmd": "train", "device": cfg.device, "rows": rows,
        "trees": ens.n_trees, "depth": cfg.max_depth,
        "streamed_chunks": n_chunks, "chunk_rows": chunk_rows_max,
        "wallclock_s": round(dt, 3), "model": args.out,
    }
    if history:
        from ddt_tpu_torch.utils.metrics import GREATER_IS_BETTER

        mk = next(k for k in history[0] if k.startswith("valid_"))
        sign = 1.0 if GREATER_IS_BETTER[mk[len("valid_"):]] else -1.0
        bi = int(np.argmax([sign * r[mk] for r in history]))
        out["best_round"] = history[bi]["round"]
        out["best_score"] = round(history[bi][mk], 6)
    if args.run_log:
        out["run_log"] = args.run_log
    if window is not None:
        out["xprof_dir"] = window.trace_dir
    print(json.dumps(out))
    return 0


def _stream_fit(args, X, y, cfg, cache_root, window=None, run_log=None,
                status=None):
    """The chunk sources and fit_streaming of _train_streaming: (ens,
    history, mapper, rows, n_chunks, chunk_rows_max)."""
    from ddt_tpu_torch.data import chunks as chunks_mod
    from ddt_tpu_torch.data.quantizer import fit_bin_mapper_streaming
    from ddt_tpu_torch.streaming import (binned_chunks, fit_streaming,
                                         validate_mapper_config)

    def _cached_binned(raw_fn, n, mapper, sub):
        """Raw chunks -> uint8 shards on disk, binned once; re-binned on
        every read with --stream-cache-dir ''."""
        if args.stream_cache_dir == "":
            return binned_chunks(raw_fn, mapper, cfg)
        return chunks_mod.write_binned_cache(
            raw_fn, n, mapper, os.path.join(cache_root, sub))

    if args.stream_dir:
        if args.stream_chunks:
            raise SystemExit(
                "--stream-dir reads its chunk count from the directory; "
                "drop --stream-chunks")
        raw = chunks_mod.directory_chunks(args.stream_dir)
        n_total = raw.n_chunks
        n_valid = 0
        if args.valid_frac > 0:
            # The last ceil(frac * n) shards are held out.
            n_valid = int(np.ceil(n_total * args.valid_frac))
            if n_valid >= n_total:
                raise SystemExit(
                    f"--valid-frac={args.valid_frac} holds out all "
                    f"{n_total} shards; nothing left to train on")
        elif args.early_stop is not None:
            raise SystemExit("--early-stop requires --valid-frac")
        n_chunks = n_total - n_valid

        def raw_train(c):
            return raw(c)

        raw_train.labels = raw.labels
        raw_train.n_features = raw.n_features

        def raw_valid(c):
            return raw(n_chunks + c)

        raw_valid.labels = lambda c: raw.labels(n_chunks + c)
        lens = [len(raw.labels(c)) for c in range(n_total)]
        rows = sum(lens[:n_chunks])
        chunk_rows_max = max(lens[:n_chunks])
        if cfg.loss == "softmax":
            ymax = max(int(raw.labels(c).max()) for c in range(n_total))
            cfg = cfg.replace(n_classes=max(cfg.n_classes, ymax + 1))
        if raw.binned:
            mapper = None
            chunk_fn, valid_chunk_fn = raw_train, (
                raw_valid if n_valid else None)
        else:
            mapper = fit_bin_mapper_streaming(
                raw_train, n_chunks, n_bins=cfg.n_bins, seed=cfg.seed,
                missing_policy=cfg.missing_policy,
                cat_features=cfg.cat_features)
            validate_mapper_config(mapper, cfg)
            chunk_fn = _cached_binned(raw_train, n_chunks, mapper, "train")
            valid_chunk_fn = (
                _cached_binned(raw_valid, n_valid, mapper, "valid")
                if n_valid else None)
    else:
        Xv = yv = None
        if args.valid_frac > 0:
            X, y, Xv, yv = _seeded_split(X, y, args.valid_frac, args.seed)
        elif args.early_stop is not None:
            raise SystemExit("--early-stop requires --valid-frac")
        n_chunks = args.stream_chunks
        rows = len(y)
        if n_chunks > rows:
            raise SystemExit(
                f"--stream-chunks={n_chunks} exceeds the row count "
                f"({rows}); empty chunks are not allowed")
        bounds = np.linspace(0, rows, n_chunks + 1).astype(np.int64)
        chunk_rows_max = int((bounds[1:] - bounds[:-1]).max())

        def raw_fn(c):
            return X[bounds[c]:bounds[c + 1]], y[bounds[c]:bounds[c + 1]]

        mapper = fit_bin_mapper_streaming(
            raw_fn, n_chunks, n_bins=cfg.n_bins, seed=cfg.seed,
            missing_policy=cfg.missing_policy,
            cat_features=cfg.cat_features)
        validate_mapper_config(mapper, cfg)
        chunk_fn = _cached_binned(raw_fn, n_chunks, mapper, "train")
        valid_chunk_fn = None
        n_valid = 0
        if Xv is not None:
            n_valid = max(1, int(np.ceil(
                len(yv) / max(1, -(-rows // n_chunks)))))
            vbounds = np.linspace(0, len(yv), n_valid + 1).astype(np.int64)

            def raw_vfn(c):
                return (Xv[vbounds[c]:vbounds[c + 1]],
                        yv[vbounds[c]:vbounds[c + 1]])

            valid_chunk_fn = _cached_binned(raw_vfn, n_valid, mapper,
                                            "valid")

    raw_cache = args.stream_device_cache
    if raw_cache == "auto":
        dev_cache: "bool | int" = True
    elif raw_cache == "off":
        dev_cache = False
    else:
        try:
            dev_cache = int(raw_cache)
        except ValueError:
            raise SystemExit(
                f"--stream-device-cache must be 'auto', 'off', or a byte "
                f"count, got {raw_cache!r}")
    history: list = []
    ens = fit_streaming(chunk_fn, n_chunks, cfg,
                        checkpoint_dir=args.checkpoint_dir,
                        checkpoint_every=args.checkpoint_every,
                        valid_chunk_fn=valid_chunk_fn,
                        n_valid_chunks=n_valid, eval_metric=args.metric,
                        early_stopping_rounds=args.early_stop,
                        history=history, device_chunk_cache=dev_cache,
                        run_log=run_log, profile=args.profile,
                        profiler_window=window, status=status)
    return ens, history, mapper, rows, n_chunks, chunk_rows_max


def _predict_streaming(args, bundle) -> int:
    """`predict --stream-dir D`: score npz shards chunk by chunk, O(chunk)
    host memory; each shard's scores land in --out (a directory) as
    scores_NNNNN.npy."""
    from ddt_tpu_torch import api
    from ddt_tpu_torch.backends import get_backend
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.data import chunks as chunks_mod
    from ddt_tpu_torch.serve.engine import TIER_IMPL
    from ddt_tpu_torch.streaming import predict_streaming

    ens = bundle.ensemble
    src = chunks_mod.directory_chunks(args.stream_dir)
    if bundle.encoder is not None and not src.binned:
        raise SystemExit(
            f"{args.model} carries a categorical encoder but the shards "
            "hold raw floats; score via the in-memory predict path, or "
            "shard data whose categorical columns are already "
            "encoder.transform'ed AND pre-binned (uint8).")
    if not src.binned and bundle.mapper is None:
        raise SystemExit(
            f"{args.model} carries no bin mapper; retrain with the "
            "current CLI (which saves the full artifact) or shard "
            "pre-binned uint8 data.")
    if src.binned and src.n_features != ens.n_features:
        raise SystemExit(
            f"shards have {src.n_features} features but the model was "
            f"trained with {ens.n_features}")
    cfg = TrainConfig(device=args.device, loss=ens.loss,
                      n_classes=max(ens.n_classes, 2),
                      predict_impl=TIER_IMPL.get(args.quantized, "auto"))
    out_dir = args.out or "scores"
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()

    def sink(c, scores):
        np.save(os.path.join(out_dir, f"scores_{c:05d}.npy"), scores)

    if src.binned:
        rows = predict_streaming(src, src.n_chunks, ens,
                                 backend=get_backend(cfg), raw=False,
                                 sink=sink)
    else:
        rows = 0
        for c in range(src.n_chunks):
            X, _ = src(c)
            scores = api.predict(ens, X, mapper=bundle.mapper, cfg=cfg)
            sink(c, scores)
            rows += len(scores)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "cmd": "predict", "device": args.device, "rows": rows,
        "trees": ens.n_trees, "streamed_chunks": src.n_chunks,
        "wallclock_s": round(dt, 3), "rows_per_sec": round(rows / dt, 1),
        "out_dir": out_dir,
    }))
    return 0


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run: cuda (the kernels; refuses to start "
                        "without a card) or cpu (their plain versions)")
    p.add_argument("--dataset",
                   choices=["higgs", "covertype", "criteo", "regression"],
                   default="higgs")
    p.add_argument("--data", default=None,
                   help="path to a dataset file: .npz with arrays X,y / "
                        ".csv[.gz] / libsvm text (overrides --dataset)")
    p.add_argument("--label-col", choices=["auto", "first", "last"],
                   default="auto",
                   help="which CSV column is the label (use 'last' for "
                        "regression CSVs: a float target defeats auto)")
    p.add_argument("--rows", type=int, default=100_000)
    p.add_argument("--bins", type=int, default=255)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--loss", choices=LOSSES, default=None,
                   help="default: inferred from the dataset")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ddt_tpu_torch",
        description="distributed GBDT on PyTorch and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    tp = sub.add_parser("train", help="train an ensemble")
    _add_common(tp)
    tp.add_argument("--trees", type=int, default=100)
    tp.add_argument("--depth", type=int, default=6)
    tp.add_argument("--lr", type=float, default=0.1)
    tp.add_argument("--partitions", type=int, default=1,
                    help="row partitions (one rank each)")
    tp.add_argument("--feature-partitions", type=int, default=1,
                    help="column partitions; partitions x "
                         "feature-partitions ranks")
    tp.add_argument("--host-partitions", type=int, default=1,
                    help="hosts axis: row shards span host-partitions x "
                         "partitions")
    tp.add_argument("--mesh-shape", default=None, metavar="Pr,Pf",
                    help="2D (rows x features) mesh shape, e.g. 4,2: "
                         "--partitions Pr --feature-partitions Pf in one "
                         "flag (TrainConfig.mesh_shape)")
    tp.add_argument("--missing", choices=["zero", "learn"], default="zero",
                    help="NaN policy: zero = bin 0; learn = reserved NaN "
                         "bin + learned per-split default direction")
    tp.add_argument("--cat-splits", choices=["ordinal", "onehot"],
                    default="ordinal",
                    help="categorical split type for the criteo config's "
                         "encoded columns: ordinal (bin<=t) or onehot "
                         "(one-vs-rest, bin==k)")
    tp.add_argument("--profile", action="store_true",
                    help="per-phase time breakdown (runs the granular "
                         "loop: rounds are slower than unprofiled)")
    tp.add_argument("--trace-dir", default=None,
                    help="capture a torch.profiler trace of the whole "
                         "fit here (trace.json; ranges carry the same "
                         "ddt:<phase> names as the run log's phases)")
    tp.add_argument("--xprof-dir", default=None,
                    help="capture a torch.profiler trace around the "
                         "--xprof-rounds window only; it lands in "
                         "<dir>/run_<run_id>/trace.json and the run "
                         "manifest names it")
    tp.add_argument("--xprof-rounds", default="2:3",
                    help="1-based inclusive round window LO:HI for "
                         "--xprof-dir (default 2:3: round 1's builds and "
                         "graph capture stay out)")
    tp.add_argument("--run-log", default=None,
                    help="write the JSONL run log here (manifest, rounds, "
                         "phase timings, cost events, counters; render "
                         "with `report`)")
    tp.add_argument("--status-port", type=int, default=None,
                    help="serve a read-only status daemon on "
                         "127.0.0.1:<port> for the run (0 = ephemeral; the "
                         "bound port is printed as a statusd JSON line "
                         "first): GET /healthz, /metrics, /debug/rounds")
    tp.add_argument("--subsample", type=float, default=1.0,
                    help="row fraction per boosting round (bagging)")
    tp.add_argument("--colsample-bytree", type=float, default=1.0,
                    help="feature fraction per tree")
    tp.add_argument("--fused-block-rounds", type=_positive_int, default=100,
                    help="max boosting rounds per fused block (>= 1)")
    tp.add_argument("--hist-subtraction", default="auto",
                    choices=["auto", "on", "off"],
                    help="sibling subtraction in the level loop "
                         "(TrainConfig.hist_subtraction)")
    tp.add_argument("--split-comms", default="auto",
                    choices=["auto", "allreduce", "reduce_scatter"],
                    help="split-finding collective (parallel/comms.py); "
                         "auto = reduce_scatter under row partitions")
    tp.add_argument("--hist-comms-dtype", default="f32",
                    choices=["f32", "bf16", "int32_fixed"],
                    help="histogram collective wire dtype")
    tp.add_argument("--hist-comms-slabs", type=int, default=0,
                    help="feature slabs of the pipelined histogram "
                         "collective; 0 = auto (1 on the cards), 1 = off")
    tp.add_argument("--grad-dtype", default="f32",
                    choices=["f32", "int16", "int8"],
                    help="quantized-gradient training (int32 histograms)")
    tp.add_argument("--stream-chunks", type=int, default=0,
                    help="train through the streamed path with the "
                         "dataset cut into this many chunks")
    tp.add_argument("--stream-dir", default=None,
                    help="train out of core from a directory of npz "
                         "chunk shards (chunk_00000.npz ... with X, y; "
                         "data.chunks.shard_file); overrides "
                         "--dataset/--data")
    tp.add_argument("--stream-cache-dir", default=None,
                    help="directory of the streamed path's uint8 binned "
                         "chunk cache (default: a temp dir removed after "
                         "training; '' re-bins chunks on every read)")
    tp.add_argument("--stream-device-cache", default="auto",
                    help="device chunk cache of the streamed path: 'auto', "
                         "'off', or a byte budget")
    tp.add_argument("--config", default=None,
                    help="YAML/JSON file of TrainConfig fields; the file "
                         "wins over the flags for the fields it names")
    tp.add_argument("--out", default="ensemble.npz")
    tp.add_argument("--checkpoint-dir", default=None)
    tp.add_argument("--checkpoint-every", type=_positive_int, default=25,
                    help="write a checkpoint every K boosting rounds (>= 1)")
    tp.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: CUDADevice on --device; cpu: the NumPy / "
                         "native C++ oracle (the CPU baseline; no card)")
    tp.add_argument("--fault-plan", default=None,
                    help="JSON fault-injection plan: fires named faults at "
                         "the real seams (torn checkpoint write, stream-read "
                         "IOError, bootstrap timeout, histogram OOM, tree "
                         "fetch, straggler delay) deterministically; no "
                         "plan: each seam is one global read")
    tp.add_argument("--multihost-coordinator", default=None,
                    metavar="HOST:PORT",
                    help="the rendezvous of a run over several processes: "
                         "run the SAME command in each, with "
                         "--multihost-processes and its --multihost-id; "
                         "every process writes --out (the ensembles are "
                         "replicas)")
    tp.add_argument("--multihost-processes", type=int, default=None,
                    help="total process count for --multihost-coordinator")
    tp.add_argument("--multihost-id", type=int, default=None,
                    help="this process's id in [0, multihost-processes)")
    tp.add_argument("--straggler-repartition", action="store_true",
                    help="act on the straggler watchdog: rotate the row "
                         "shards at the next checkpoint boundary when one "
                         "rank persistently straggles (a mesh run with "
                         "--run-log; the model is unchanged)")
    tp.add_argument("--straggler-skew-threshold", type=float, default=2.0,
                    help="watchdog trip point: a rank's round time over "
                         "the median of the others (> 1.0)")
    tp.add_argument("--valid-frac", type=float, default=0.0,
                    help="hold out this fraction as a validation set")
    tp.add_argument("--metric", default=None,
                    help="validation metric (auc/accuracy/rmse/logloss)")
    tp.add_argument("--early-stop", type=int, default=None,
                    help="stop after this many rounds without improvement")

    pp = sub.add_parser("predict", help="score a batch with a saved model")
    _add_common(pp)
    pp.add_argument("--model", required=True)
    pp.add_argument("--quantized", nargs="?", const="int8", default=None,
                    choices=["int8", "int4"],
                    help="score through the quantized LUT tiers: bare "
                         "flag = int8 (K4), 'int4' = the int4 tier (K5)")
    pp.add_argument("--partitions", type=int, default=1,
                    help="row-shard the batch over this many cards of "
                         "this process (f32 tier)")
    pp.add_argument("--out", default=None,
                    help="write scores to this .npy (with --stream-dir: "
                         "a directory of scores_NNNNN.npy files)")
    pp.add_argument("--stream-dir", default=None,
                    help="score a directory of npz chunk shards out of "
                         "core; overrides --dataset/--data")

    sv = sub.add_parser(
        "serve",
        help="persistent low-latency scoring server: a model resident on "
             "the device, admission-batched request coalescing, "
             "zero-downtime hot swap, serve_latency telemetry")
    sv.add_argument("--model", default=None,
                    help="model to serve: an api.save_model .npz path, "
                         "or (with --registry) a registry reference "
                         "(name, name@version, name@tag or digest); hot "
                         "swap later via POST /swap. Required unless a "
                         "fleet is configured with --models/"
                         "--fleet-config")
    sv.add_argument("--models", default=None,
                    help="fleet mode: comma-separated entries, each "
                         "ref[:key=value]*, e.g. "
                         "'a@prod,b@canary:weight=3,c@v2:tier=int4'. "
                         "Keys: name, weight, tier, max_batch, raw, "
                         "slo_p99_ms, drift, shadow_of")
    sv.add_argument("--fleet-config", default=None,
                    help="fleet mode: JSON fleet config file "
                         "({\"models\": [{name, ref, weight, tier, "
                         "max_batch, raw, slo_p99_ms}, ...]}); combines "
                         "with --models")
    sv.add_argument("--max-resident", type=_positive_int, default=None,
                    help="fleet LRU budget: at most this many models "
                         "resident at once (default: all)")
    sv.add_argument("--registry", default=None,
                    help="registry root directory: resolve --model, "
                         "fleet refs and /swap bodies as registry "
                         "references")
    sv.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the models score: cuda (the kernels; "
                         "refuses to start without a card) or cpu (their "
                         "plain versions)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8199,
                    help="HTTP port (0 = ephemeral; printed on stdout)")
    sv.add_argument("--max-wait-ms", type=float, default=1.0,
                    help="admission window: how long a request may wait "
                         "for company before its micro-batch dispatches")
    sv.add_argument("--max-batch", type=_positive_int, default=256,
                    help="largest micro-batch (rows); batches pad to a "
                         "power-of-two bucket ladder up to this")
    sv.add_argument("--quantized", nargs="?", const="int8", default=None,
                    choices=["int8", "int4"],
                    help="serve through the quantized LUT tiers: bare "
                         "flag = int8, 'int4' = the int4 tier")
    sv.add_argument("--raw", action="store_true",
                    help="return raw margins instead of probabilities")
    sv.add_argument("--no-express-lane", action="store_true",
                    help="disable the express lane (single-row requests "
                         "at an empty queue dispatch at once; on by "
                         "default)")
    sv.add_argument("--no-request-traces", action="store_true",
                    help="disable per-request traces (X-DDT-Timing, the "
                         "/debug/requests ring, serve_trace flushes); a "
                         "client-supplied trace id is still echoed")
    sv.add_argument("--run-log", default=None,
                    help="JSONL run log for serve_latency, hot_swap, "
                         "artifact and fleet events")

    rg = sub.add_parser(
        "registry",
        help="digest-addressed model registry: export servable "
             "artifacts, version them by name, restore them anywhere")
    rg.add_argument("--registry", required=True,
                    help="registry root directory (created on first push)")
    rgsub = rg.add_subparsers(dest="registry_cmd", required=True)
    rpu = rgsub.add_parser(
        "push", help="export a model's servable artifact and publish it")
    rpu.add_argument("--model", required=True,
                     help="api.save_model .npz to export")
    rpu.add_argument("--name", default=None,
                     help="version the artifact under this name (omit "
                          "for an anonymous digest-only push)")
    rpu.add_argument("--tag", default=None,
                     help="also point this tag at the pushed version")
    rpu.add_argument("--max-batch", type=_positive_int, default=256,
                     help="largest serving micro-batch: the artifact's "
                          "bucket ladder covers powers of two up to this")
    rpu.add_argument("--quantize", nargs="?", const="int8", default=None,
                     choices=["int8", "int4"],
                     help="also carry the quantized tables: bare flag = "
                          "int8, 'int4' = the int4 tier")
    rpu.add_argument("--run-log", default=None,
                     help="append an `artifact` push event to this JSONL "
                          "run log")
    rls = rgsub.add_parser("list", help="inventory: names, versions, tags")
    rls.add_argument("--name", default=None, help="limit to one name")
    rls.add_argument("--json", action="store_true")
    rgt = rgsub.add_parser(
        "get", help="resolve + integrity-check a reference, print its "
                    "manifest")
    rgt.add_argument("ref", help="digest | name | name@version | name@tag")
    rtg = rgsub.add_parser("tag", help="point a tag at a version")
    rtg.add_argument("ref", help="name@version (or name for latest)")
    rtg.add_argument("tag", help="tag to set (non-numeric)")

    rp = sub.add_parser("report",
                        help="render a run summary from a JSONL run log "
                             "(train --run-log), or diff two logs")
    rp.add_argument("--log", action="append",
                    help="run log path; repeat for a multi-host run's "
                         "per-host logs (merged by run id)")
    rp.add_argument("--json", action="store_true",
                    help="emit the summary as one JSON object")
    rp.add_argument("--slowest", type=_positive_int, default=5,
                    help="how many slowest rounds to list")
    rsub = rp.add_subparsers(dest="report_cmd")
    rsub.add_parser("fleet", help="the fleet rollup only (fails on a log "
                                  "with no fleet data)")
    rsub.add_parser("slo", help="the SLO rollup only (fails on a log with "
                                "no SLO data)")
    rsub.add_parser("drift", help="the drift rollup only (fails on a log "
                                  "with no drift data)")
    rsub.add_parser("progress", help="the training-progress rollup from "
                                     "heartbeats (fails on a log without "
                                     "them)")
    dp = rsub.add_parser(
        "diff", help="align two run logs by phase and counter and flag "
                     "adverse excursions")
    dp.add_argument("log_a", help="baseline run log (A)")
    dp.add_argument("log_b", help="current run log (B)")
    dp.add_argument("--json", action="store_true",
                    help="emit the diff as one JSON object")
    dp.add_argument("--threshold", type=float, default=None,
                    help="adverse relative excursion that flags "
                         "(default 0.20)")
    dp.add_argument("--abs-floor-ms", type=float, default=None,
                    help="absolute per-phase floor below which moves "
                         "never flag (default 50 ms)")
    dp.add_argument("--check", action="store_true",
                    help="exit 1 when any excursion is flagged")

    xp = sub.add_parser("trace",
                        help="export a run log as Chrome trace-event JSON "
                             "(ui.perfetto.dev): round slices, instant "
                             "markers")
    xp.add_argument("--log", required=True, action="append",
                    help="run-log path; repeat for per-host logs of one "
                         "run (merged before export)")
    xp.add_argument("--out", default="trace.json",
                    help="output trace path (default trace.json)")

    ip = sub.add_parser("inspect", help="summarize a saved ensemble")
    ip.add_argument("--model", required=True)
    ip.add_argument("--tree", type=int, default=None,
                    help="also print this tree's structure")
    ip.add_argument("--importance", choices=["split", "gain"],
                    default="gain")
    return ap


def _train(args) -> int:
    from ddt_tpu_torch import api
    from ddt_tpu_torch.config import TrainConfig, load_config_file

    file_cfg = None
    if args.config:
        try:
            file_cfg = load_config_file(args.config)
        except (OSError, ValueError) as e:
            raise SystemExit(f"--config: {e}") from e
        # The fields that feed the dataset's loading apply before it.
        for key, attr in (("n_bins", "bins"), ("seed", "seed"),
                          ("loss", "loss"), ("device", "device")):
            if key in file_cfg:
                setattr(args, attr, file_cfg[key])
    if args.backend == "cuda":
        _need_device("train", args.device)
    if args.stream_dir:
        X = y = encoder = None
        n_classes = 2
    else:
        X, y, n_classes, encoder = _load_dataset(args)
    loss = args.loss or (
        "softmax" if args.dataset == "covertype"
        else "mse" if args.dataset == "regression" else "logloss")
    cat_features: tuple = ()
    if (args.dataset == "criteo" and args.cat_splits == "onehot"
            and not args.data and not args.stream_dir):
        # datasets.synthetic_ctr: 13 numeric columns, then the encoder's.
        cat_features = tuple(range(13, X.shape[1]))
    try:
        cfg = TrainConfig(
            n_trees=args.trees, max_depth=args.depth, n_bins=args.bins,
            learning_rate=args.lr, loss=loss,
            n_classes=n_classes if loss == "softmax" else 2,
            device=args.device, n_partitions=args.partitions,
            feature_partitions=args.feature_partitions,
            host_partitions=args.host_partitions,
            mesh_shape=_parse_mesh_shape(args.mesh_shape),
            subsample=args.subsample,
            colsample_bytree=args.colsample_bytree, seed=args.seed,
            hist_subtraction=args.hist_subtraction,
            split_comms=args.split_comms,
            hist_comms_dtype=args.hist_comms_dtype,
            hist_comms_slabs=args.hist_comms_slabs,
            grad_dtype=args.grad_dtype, missing_policy=args.missing,
            cat_features=cat_features,
            fused_block_rounds=args.fused_block_rounds,
            backend=args.backend, fault_plan=args.fault_plan,
            straggler_repartition=args.straggler_repartition,
            straggler_skew_threshold=args.straggler_skew_threshold)
        if file_cfg is not None:
            cfg = cfg.replace(**file_cfg)
    except ValueError as e:
        raise SystemExit(f"train: {e}") from e
    from ddt_tpu_torch.robustness import faultplan

    plan = None
    if cfg.fault_plan:
        # Armed before the rendezvous, so its multihost.init seam can
        # fire; the trainers find it active and leave it alone.
        try:
            plan = faultplan.load_plan(cfg.fault_plan)
        except (OSError, ValueError) as e:
            raise SystemExit(f"--fault-plan: {e}") from e
    prev = faultplan.activate(plan) if plan is not None else None
    try:
        _init_multihost(args)
        return _train_run(args, X, y, cfg, encoder)
    finally:
        if plan is not None:
            faultplan.deactivate(prev)


def _train_run(args, X, y, cfg, encoder) -> int:
    _init_ranks(cfg)
    # The status daemon is imported only with --status-port: without it
    # the trainers' hooks are `is not None` tests.
    status = daemon = None
    if args.status_port is not None:
        from ddt_tpu_torch.telemetry.statusd import (TrainStatus,
                                                     start_statusd)

        status = TrainStatus()
        daemon = start_statusd(status, port=args.status_port)
        print(json.dumps({"statusd": {"host": daemon.host,
                                      "port": daemon.port}}), flush=True)
    try:
        if args.stream_chunks > 0 or args.stream_dir:
            return _train_streaming(args, X, y, cfg, encoder, status=status)
        return _train_in_memory(args, X, y, cfg, encoder, status)
    finally:
        if daemon is not None:
            daemon.close()


def _train_in_memory(args, X, y, cfg, encoder, status) -> int:
    from ddt_tpu_torch import api

    eval_set = None
    if args.valid_frac > 0:
        X, y, Xv, yv = _seeded_split(X, y, args.valid_frac, args.seed)
        eval_set = (Xv, yv)
    t0 = time.perf_counter()
    trace_ctx = contextlib.nullcontext()
    if args.trace_dir:
        from ddt_tpu_torch.utils.profiling import trace

        trace_ctx = trace(args.trace_dir)
    window = _capture_window(args)
    try:
        with trace_ctx:
            res = api.train(
                X, y, cfg, checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every, eval_set=eval_set,
                eval_metric=args.metric,
                early_stopping_rounds=args.early_stop,
                profile=args.profile, run_log=args.run_log,
                profiler_window=window, status=status)
    except ValueError as e:
        if "process group" in str(e):
            raise SystemExit(f"train: {e}; start the ranks with torchrun "
                             "(one process a card)") from e
        raise
    dt = time.perf_counter() - t0
    if _writes_out(args):
        api.save_model(args.out, res.ensemble, mapper=res.mapper,
                       encoder=encoder, run_id=res.run_id, cfg=cfg)
    out = {
        "cmd": "train", "device": cfg.device, "rows": len(y),
        "trees": res.ensemble.n_trees, "depth": cfg.max_depth,
        "wallclock_s": round(dt, 3),
        "final_train_loss": next(
            (r["train_loss"] for r in reversed(res.history)
             if r.get("train_loss") is not None), None),
        "model": args.out,
    }
    if res.best_score is not None:
        out["best_round"] = res.best_round + 1
        out["best_score"] = round(res.best_score, 6)
    if args.run_log:
        out["run_log"] = args.run_log
    if res.run_id is not None:
        out["run_id"] = res.run_id
    if window is not None:
        out["xprof_dir"] = window.trace_dir
    print(json.dumps(out))
    return 0


def _predict(args) -> int:
    from ddt_tpu_torch import api
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.serve.engine import TIER_IMPL

    _need_device("predict", args.device)
    bundle = api.load_model(args.model)
    ens = bundle.ensemble
    if args.stream_dir:
        return _predict_streaming(args, bundle)
    if args.dataset == "criteo" and not args.data \
            and bundle.encoder is None:
        raise SystemExit(
            f"{args.model} carries no categorical encoder; retrain the "
            "criteo config with the current CLI (which saves it): "
            "refusing to refit an encoder on scoring data.")
    if bundle.mapper is None:
        raise SystemExit(
            f"{args.model} carries no bin mapper; retrain with the current "
            "CLI (which saves the full artifact) or predict on pre-binned "
            "data through the API.")
    X, y, _, _ = _load_dataset(args, encoder=bundle.encoder,
                               n_features=ens.n_features)
    if args.partitions > 1 and args.quantized is not None:
        raise SystemExit("predict: --partitions scores at the f32 tier; "
                         "drop --quantized")
    t0 = time.perf_counter()
    if args.partitions > 1:
        scores = api.predict(ens, X, mapper=bundle.mapper,
                             device=args.device,
                             n_partitions=args.partitions)
    else:
        cfg = TrainConfig(device=args.device, loss=ens.loss,
                          n_classes=max(ens.n_classes, 2),
                          predict_impl=TIER_IMPL.get(args.quantized, "auto"))
        scores = api.predict(ens, X, mapper=bundle.mapper, cfg=cfg)
    dt = time.perf_counter() - t0
    if args.out:
        np.save(args.out, scores)
    print(json.dumps({
        "cmd": "predict", "device": args.device, "rows": len(X),
        "trees": ens.n_trees, "quantized": args.quantized,
        "wallclock_s": round(dt, 3), "rows_per_sec": round(len(X) / dt, 1),
    }))
    return 0


def _registry(args) -> int:
    from ddt_tpu_torch import api
    from ddt_tpu_torch.registry import IntegrityError, Registry, \
        RegistryError

    reg = Registry(args.registry)
    try:
        if args.registry_cmd == "push":
            from ddt_tpu_torch.registry.loader import push_servable

            bundle = api.load_model(args.model)
            out = push_servable(
                reg, bundle, name=args.name, tag=args.tag,
                max_batch=args.max_batch, quantize=args.quantize,
                run_log=args.run_log)
            print(json.dumps({"cmd": "registry_push", "model": args.model,
                              **out}))
            return 0
        if args.registry_cmd == "list":
            inv = reg.list(name=args.name)
            if args.json:
                print(json.dumps(inv))
                return 0
            for name, idx in sorted(inv["names"].items()):
                for v in idx["versions"]:
                    vt = [t for t, tv in idx["tags"].items()
                          if tv == v["version"]]
                    print(f"{name}@{v['version']}  {v['digest']}"
                          + (f"  run_id={v['run_id']}"
                             if v.get("run_id") else "")
                          + ("  quantized" if v.get("quantized") else "")
                          + (f"  [{', '.join(vt)}]" if vt else ""))
            for d in inv["anonymous"]:
                print(f"(anonymous)  {d}")
            return 0
        if args.registry_cmd == "get":
            art_dir, man, digest = reg.get(args.ref)
            print(json.dumps({
                "cmd": "registry_get", "ref": args.ref, "digest": digest,
                "path": art_dir,
                "manifest": {k: v for k, v in man.items() if k != "files"},
                "n_files": len(man["files"]),
            }))
            return 0
        print(json.dumps({"cmd": "registry_tag",
                          **reg.tag(args.ref, args.tag)}))
        return 0
    except (RegistryError, IntegrityError, OSError) as e:
        raise SystemExit(f"registry {args.registry_cmd}: {e}") from e


_ROLLUPS = {"fleet": "render_fleet", "slo": "render_slo",
            "drift": "render_drift", "progress": "render_progress"}


def _report(args, ap) -> int:
    from ddt_tpu_torch.telemetry import merge as tele_merge
    from ddt_tpu_torch.telemetry import report as tele_report

    sub = getattr(args, "report_cmd", None)
    if sub == "diff":
        from ddt_tpu_torch.telemetry import diffing

        try:
            sa = tele_report.summarize(tele_report.read_events(args.log_a))
            sb = tele_report.summarize(tele_report.read_events(args.log_b))
            kw = {}
            if args.threshold is not None:
                kw["threshold"] = args.threshold
            if args.abs_floor_ms is not None:
                kw["abs_floor_ms"] = args.abs_floor_ms
            d = diffing.diff_summaries(sa, sb, **kw)
            out_text = (json.dumps(d) if args.json
                        else diffing.render_diff(d, args.log_a, args.log_b))
        except (OSError, ValueError, TypeError, KeyError) as e:
            raise SystemExit(f"report diff: {e}") from e
        print(out_text)
        return 1 if (args.check and d["flagged"]) else 0
    if not args.log:
        ap.error("report requires --log (or the `diff A B` form)")
    try:
        events = tele_merge.merge_paths(args.log)
        summary = tele_report.summarize(events, slowest=args.slowest)
        if sub in _ROLLUPS:
            # Each rollup raises on a log without its data.
            out_text = getattr(tele_report, _ROLLUPS[sub])(summary)
            if args.json:
                out_text = json.dumps(summary[sub])
        else:
            out_text = (json.dumps(summary) if args.json
                        else tele_report.render(summary))
    except (OSError, ValueError, TypeError, KeyError) as e:
        raise SystemExit(f"report: {e}") from e
    print(out_text)
    return 0


def _trace(args) -> int:
    from ddt_tpu_torch.telemetry import merge as tele_merge
    from ddt_tpu_torch.telemetry import perfetto as tele_perfetto

    try:
        events = tele_merge.merge_paths(args.log)
        n = tele_perfetto.write_trace(events, args.out)
    except (OSError, ValueError, TypeError, KeyError) as e:
        raise SystemExit(f"trace: {e}") from e
    print(json.dumps({"cmd": "trace", "logs": args.log,
                      "events": len(events), "trace_events": n,
                      "out": args.out}))
    return 0


def _inspect(args, ap) -> int:
    from ddt_tpu_torch.models.tree import TreeEnsemble

    ens = TreeEnsemble.load(args.model)
    if args.tree is not None and not (0 <= args.tree < ens.n_trees):
        ap.error(f"--tree must be in [0, {ens.n_trees}), got {args.tree}")
    kind = args.importance
    imp = ens.feature_importances(kind=kind)
    if kind == "gain" and not imp.any():
        print("# no recorded gains (model predates gain recording); "
              "showing split-count importance", file=sys.stderr)
        kind = "split"
        imp = ens.feature_importances(kind="split")
    top = np.argsort(imp)[::-1][:10]
    print(json.dumps({
        "cmd": "inspect", "model": args.model, "n_trees": ens.n_trees,
        "max_depth": ens.max_depth, "n_features": ens.n_features,
        "loss": ens.loss, "n_classes": ens.n_classes,
        "learning_rate": ens.learning_rate, "base_score": ens.base_score,
        "n_splits": int(((~ens.is_leaf) & (ens.feature >= 0)).sum()),
        "has_raw_thresholds": bool(ens.has_raw_thresholds),
        f"top_features_by_{kind}": {
            int(f): round(float(imp[f]), 5) for f in top if imp[f] > 0},
    }))
    if args.tree is not None:
        print(ens.dump_text(args.tree))
    return 0


def _serve_fleet(args) -> int:
    from ddt_tpu_torch.registry import RegistryError
    from ddt_tpu_torch.serve import control as fleet_control
    from ddt_tpu_torch.serve.http import serve_forever

    try:
        specs = []
        if args.fleet_config:
            specs += fleet_control.load_fleet_config(args.fleet_config)
        if args.models:
            specs += fleet_control.parse_models_arg(args.models)
        engine = fleet_control.build_fleet(
            specs, registry=args.registry, device=args.device,
            max_wait_ms=args.max_wait_ms, max_resident=args.max_resident,
            run_log=args.run_log, express_lane=not args.no_express_lane,
            request_traces=not args.no_request_traces)
    except (fleet_control.FleetConfigError, RegistryError, ValueError,
            OSError) as e:
        raise SystemExit(f"serve fleet: {e}") from e
    print(json.dumps({
        "cmd": "serve", "fleet": True,
        "models": {s.name: {"ref": s.ref, "weight": s.weight,
                            "tier": s.tier, "max_batch": s.max_batch}
                   for s in specs},
        "max_resident": args.max_resident, "host": args.host,
        "port": args.port, "max_wait_ms": args.max_wait_ms,
        "express_lane": not args.no_express_lane,
        "registry": args.registry, "device": args.device,
    }), flush=True)
    serve_forever(engine, host=args.host, port=args.port)
    return 0


def _serve(args) -> int:
    from ddt_tpu_torch import api
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.serve.engine import TIER_IMPL, ServeEngine
    from ddt_tpu_torch.serve.http import serve_forever

    fleet = bool(args.models or args.fleet_config)
    if fleet and args.model is not None:
        raise SystemExit(
            "serve: --model conflicts with --models/--fleet-config (put "
            "it in the fleet instead)")
    if fleet and (args.quantized is not None or args.raw
                  or args.max_batch != 256):
        raise SystemExit(
            "serve: --quantized/--raw/--max-batch apply to single-model "
            "servers; fleets set them per entry (tier= / raw= / "
            "max_batch= in --models or the fleet config)")
    if not fleet and args.model is None:
        raise SystemExit(
            "serve: --model is required (or configure a fleet with "
            "--models/--fleet-config)")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "serve: --device cuda but torch.cuda.is_available() is False; "
            "pass --device cpu to serve through the plain versions")
    if fleet:
        return _serve_fleet(args)
    mode = "file"
    digest = None
    if args.registry is not None and not os.path.exists(args.model):
        from ddt_tpu_torch.registry import RegistryError
        from ddt_tpu_torch.registry import loader as reg_loader
        from ddt_tpu_torch.telemetry.events import RunLog

        # One RunLog for the server's life: the loader's artifact event
        # and the engine's events share it (one monotonic seq); the
        # engine closes it at shutdown.
        run_log = RunLog.coerce(args.run_log)
        try:
            report = reg_loader.load_servable(
                args.registry, args.model,
                # Flag absent: the engine serves f32 even from a
                # quantized artifact (None would follow the artifact).
                quantize=args.quantized or False, raw=args.raw,
                device=args.device, run_log=run_log)
        except (RegistryError, ValueError, OSError) as e:
            raise SystemExit(f"serve --registry: {e}") from e
        servable = report.model
        mode, digest = report.mode, report.digest
        cfg = TrainConfig(
            device=args.device, loss=servable.ens.loss,
            n_classes=max(servable.ens.n_classes, 2),
            predict_impl=TIER_IMPL.get(args.quantized, "auto"))
        engine = ServeEngine(
            servable, cfg, backend=servable.backend,
            max_wait_ms=args.max_wait_ms, max_batch=servable.buckets[-1],
            quantize=args.quantized, raw=args.raw, run_log=run_log,
            express_lane=not args.no_express_lane,
            request_traces=not args.no_request_traces)
    else:
        bundle = api.load_model(args.model)
        cfg = TrainConfig(
            device=args.device, loss=bundle.ensemble.loss,
            n_classes=max(bundle.ensemble.n_classes, 2),
            predict_impl=TIER_IMPL.get(args.quantized, "auto"))
        engine = ServeEngine(
            bundle, cfg, max_wait_ms=args.max_wait_ms,
            max_batch=args.max_batch, quantize=args.quantized,
            raw=args.raw, run_log=args.run_log,
            express_lane=not args.no_express_lane,
            request_traces=not args.no_request_traces)
    engine.registry_root = args.registry
    print(json.dumps({
        "cmd": "serve", "model": args.model,
        "model_token": engine.model_token, "quantized": args.quantized,
        "host": args.host, "port": args.port,
        "max_wait_ms": args.max_wait_ms, "max_batch": engine.buckets[-1],
        "express_lane": not args.no_express_lane,
        "registry": args.registry, "mode": mode,
        "artifact_digest": digest, "device": args.device,
    }), flush=True)
    serve_forever(engine, host=args.host, port=args.port)
    return 0


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.cmd == "train":
        return _train(args)
    if args.cmd == "predict":
        return _predict(args)
    if args.cmd == "registry":
        return _registry(args)
    if args.cmd == "report":
        return _report(args, ap)
    if args.cmd == "trace":
        return _trace(args)
    if args.cmd == "inspect":
        return _inspect(args, ap)
    return _serve(args)


if __name__ == "__main__":
    sys.exit(main())
