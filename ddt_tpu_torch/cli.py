"""Command line of the port: the `serve` subcommand (port of ddt_tpu/cli.py's
`serve`, its flags and refusals).

    python -m ddt_tpu_torch.cli serve --model model.npz [--quantized int4]
    python -m ddt_tpu_torch.cli serve --registry R --model name@version
    python -m ddt_tpu_torch.cli serve --registry R --models a@1,b@2:weight=3 \\
        [--max-resident 2] [--fleet-config fleet.json]

Single-model mode serves one ServeEngine (a model file, or with
--registry a registry reference restored by registry/loader); fleet mode
(--models / --fleet-config) serves a FleetEngine built by
serve/control.build_fleet. Both run serve/http.serve_forever and print
one JSON line describing what serves before they listen.

`--device {cuda,cpu}` (default cuda) stands where the reference has
`--backend`: the port's TrainConfig has no backend field. On a machine
without a visible card, `--device cuda` refuses to start; `--device cpu`
serves through the kernels' plain versions. The CLI's other subcommands
(train, predict, registry, bench, report, trace, inspect) are not ported
yet.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import torch


def _positive_int(v: str) -> int:
    i = int(v)
    if i < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {i}")
    return i


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ddt_tpu_torch",
        description="GBDT serving on PyTorch and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
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
    return ap


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
    args = build_parser().parse_args(argv)
    return _serve(args)


if __name__ == "__main__":
    sys.exit(main())
