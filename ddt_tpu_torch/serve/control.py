"""Fleet control plane: declarative config and registry-backed loading
(port of ddt_tpu/serve/control.py: `FleetSpec`, `parse_models_arg`,
`load_fleet_config`, `validate_specs`, `resolve_specs`, `make_loader`,
`build_fleet`).

- parse the two fleet config surfaces into `FleetSpec`s: the CLI's
  `--models a@prod,b@canary:weight=3` shorthand and the `--fleet-config
  fleet.json` file ({"models": [{"name", "ref", "weight", "tier",
  "max_batch", "raw", "slo_p99_ms", "shadow_of", "drift"}, ...]} or a
  bare list), with the reference's errors, word for word, on duplicate
  names, unknown keys and malformed values;
- resolve every reference at boot (the registry's name index, or a
  model file on disk), so an unknown ref fails `cli serve`, not the
  first request;
- load: `make_loader` builds the callable FleetEngine calls on handler
  threads, over the port's registry/loader.load_servable and
  api.load_model.

This module does file I/O by design; FleetEngine calls the loader only on
caller threads with no fleet lock held.
"""

from __future__ import annotations

import dataclasses
import json
import os

from ddt_tpu_torch.serve.engine import TIER_IMPL, normalize_quantize
from ddt_tpu_torch.serve.fleet import FleetEngine
from ddt_tpu_torch.telemetry.events import RunLog


class FleetConfigError(ValueError):
    """Malformed fleet configuration (duplicate name, unknown key,
    unresolvable reference, bad value) — always loud, always at boot
    or at the control-plane call, never at dispatch time."""


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """One fleet member, fully declarative: the registry reference (or
    artifact path), its dispatch weight, serving tier, and admission
    ladder. `tier=None` FOLLOWS the artifact (a quantized export serves
    its exported tier, an f32 export serves f32) — mixed-tier fleets
    come free from mixed artifacts."""

    name: str
    ref: str
    weight: float = 1.0
    tier: "str | None" = None
    max_batch: int = 256
    raw: bool = False
    #: per-request p99 latency objective in ms; None means
    #: no SLO: no burn-rate tracking, no slo_breach events, and the
    #: health/metrics payloads stay byte-identical to pre-SLO output.
    slo_p99_ms: "float | None" = None
    #: champion this model shadows: a challenger scores the champion's
    #: dispatched batches off the response path (serve/drift.py
    #: ShadowScorer). The shadow stays a normal fleet
    #: member (residency, direct requests by name) but receives none of
    #: the champion's traffic on the response path. None = not a shadow.
    shadow_of: "str | None" = None
    #: drift tracking tri-state: None auto-enables when the
    #: artifact carries a training reference histogram
    #: (mapper.ref_counts); True REQUIRES one (a reference-less artifact
    #: is a FleetConfigError at load, never a quiet no-op); False
    #: disables tracking even when a reference is present.
    drift: "bool | None" = None

    def __post_init__(self):
        if not self.name:
            raise FleetConfigError("fleet entry has an empty name")
        if self.weight <= 0:
            raise FleetConfigError(
                f"model {self.name!r}: weight must be > 0, got "
                f"{self.weight}")
        if self.max_batch < 1:
            raise FleetConfigError(
                f"model {self.name!r}: max_batch must be >= 1, got "
                f"{self.max_batch}")
        if self.slo_p99_ms is not None and self.slo_p99_ms <= 0:
            raise FleetConfigError(
                f"model {self.name!r}: slo_p99_ms must be > 0, got "
                f"{self.slo_p99_ms}")
        if self.shadow_of is not None and self.shadow_of == self.name:
            raise FleetConfigError(
                f"model {self.name!r}: cannot shadow itself")


_SPEC_KEYS = {"name", "ref", "model", "weight", "tier", "max_batch",
              "raw", "slo_p99_ms", "shadow_of", "drift"}


def _default_name(ref: str) -> str:
    """`a@prod` -> `a`; a file path -> its stem (`/x/model_b.npz` ->
    `model_b`)."""
    base = ref.split("@", 1)[0]
    if os.sep in base or base.endswith(".npz"):
        base = os.path.splitext(os.path.basename(base))[0]
    return base


def _coerce_bool(v, where: str, key: str) -> bool:
    """Strict flag parsing for the string surfaces (`--models
    m:raw=false` and POST /models JSON strings): bool('false') is True,
    so a naive cast would make every spelling ENABLE the flag."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off", ""):
        return False
    raise FleetConfigError(
        f"{where}: {key} must be a boolean (true/false), got {v!r}")


def coerce_spec(d: dict, where: str) -> FleetSpec:
    unknown = set(d) - _SPEC_KEYS
    if unknown:
        raise FleetConfigError(
            f"{where}: unknown fleet entry key(s) "
            f"{', '.join(sorted(unknown))} (have: "
            f"{', '.join(sorted(_SPEC_KEYS - {'model'}))})")
    ref = d.get("ref") or d.get("model")
    if not ref:
        raise FleetConfigError(f"{where}: fleet entry needs a 'ref' "
                               "(registry reference or artifact path)")
    tier = d.get("tier")
    try:
        tier = normalize_quantize(tier) if tier is not None else None
    except ValueError as e:
        raise FleetConfigError(f"{where}: {e}") from e
    slo = d.get("slo_p99_ms")
    if slo is not None:
        # Loud junk rejection at parse time: "fast", "", "5ms" all land
        # here — float('5ms') raising late would blame the wrong layer.
        try:
            slo = float(slo)
        except (TypeError, ValueError):
            raise FleetConfigError(
                f"{where}: slo_p99_ms must be a positive number of "
                f"milliseconds, got {d.get('slo_p99_ms')!r}") from None
    drift = d.get("drift")
    if drift is not None:
        drift = _coerce_bool(drift, where, "drift")
    shadow_of = d.get("shadow_of")
    try:
        return FleetSpec(
            name=str(d.get("name") or _default_name(str(ref))),
            ref=str(ref),
            weight=float(d.get("weight", 1.0)),
            tier=tier,
            max_batch=int(d.get("max_batch", 256)),
            raw=_coerce_bool(d.get("raw", False), where, "raw"),
            slo_p99_ms=slo,
            shadow_of=(str(shadow_of) if shadow_of else None),
            drift=drift)
    except (TypeError, ValueError) as e:
        raise FleetConfigError(f"{where}: {e}") from e


def parse_models_arg(arg: str) -> "list[FleetSpec]":
    """`--models` shorthand: comma-separated entries, each
    `ref[:key=value]*` — e.g. `a@prod,b@canary:weight=3,
    c@v2:tier=int4:max_batch=64:name=tiny`. The ref's name part (before
    `@`) is the model name unless `name=` overrides it."""
    specs = []
    for i, entry in enumerate(s.strip() for s in arg.split(",")):
        if not entry:
            raise FleetConfigError(
                f"--models entry {i} is empty (stray comma?)")
        parts = entry.split(":")
        d: dict = {"ref": parts[0]}
        for kv in parts[1:]:
            if "=" not in kv:
                raise FleetConfigError(
                    f"--models entry {parts[0]!r}: expected key=value "
                    f"after ':', got {kv!r}")
            k, v = kv.split("=", 1)
            d[k.strip()] = v.strip()
        specs.append(coerce_spec(d, f"--models entry {parts[0]!r}"))
    return specs


def load_fleet_config(path: str) -> "list[FleetSpec]":
    """`--fleet-config` file: JSON — either {"models": [...]} (extra
    top-level keys refused loudly) or a bare list of entries."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise FleetConfigError(f"fleet config {path}: {e}") from e
    if isinstance(doc, dict):
        unknown = set(doc) - {"models"}
        if unknown:
            raise FleetConfigError(
                f"fleet config {path}: unknown top-level key(s) "
                f"{', '.join(sorted(unknown))} (expected 'models')")
        entries = doc.get("models")
    else:
        entries = doc
    if not isinstance(entries, list) or not entries:
        raise FleetConfigError(
            f"fleet config {path}: 'models' must be a non-empty list")
    out = []
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            raise FleetConfigError(
                f"fleet config {path}: entry {i} must be an object")
        out.append(coerce_spec(e, f"{path} entry {i}"))
    return out


def validate_specs(specs: "list[FleetSpec]") -> "list[FleetSpec]":
    if not specs:
        raise FleetConfigError(
            "fleet has no models (pass --models and/or --fleet-config)")
    seen: dict = {}
    for s in specs:
        if s.name in seen:
            raise FleetConfigError(
                f"duplicate model name {s.name!r} "
                f"({seen[s.name].ref!r} vs {s.ref!r}); give one of "
                "them an explicit name=")
        seen[s.name] = s
    # Shadow topology: every challenger names a champion in
    # THIS fleet, and chains are refused — a shadow of a shadow would
    # compare against scores that were themselves off-path samples.
    for s in specs:
        if s.shadow_of is None:
            continue
        champ = seen.get(s.shadow_of)
        if champ is None:
            raise FleetConfigError(
                f"model {s.name!r}: shadow_of={s.shadow_of!r} names no "
                f"model in this fleet (have: "
                f"{', '.join(sorted(seen))})")
        if champ.shadow_of is not None:
            raise FleetConfigError(
                f"model {s.name!r}: shadow_of={s.shadow_of!r} is itself "
                f"a shadow (of {champ.shadow_of!r}); shadow chains are "
                "not supported")
    challengers: dict = {}
    for s in specs:
        if s.shadow_of is None:
            continue
        prev = challengers.setdefault(s.shadow_of, s.name)
        if prev != s.name:
            raise FleetConfigError(
                f"model {s.shadow_of!r} has two challengers "
                f"({prev!r} and {s.name!r}); one challenger per "
                "champion")
    return specs


def resolve_specs(specs, registry_root: "str | None") -> dict:
    """Resolve every ref at boot — {name: digest | "file"} — so unknown
    references fail the command, not the first request. Registry refs
    need `registry_root`; artifact paths just need to exist."""
    out = {}
    for spec in specs:
        if os.path.exists(spec.ref):
            out[spec.name] = "file"
            continue
        if registry_root is None:
            raise FleetConfigError(
                f"model {spec.name!r}: ref {spec.ref!r} is not a file, "
                "and no --registry was given so registry references "
                "cannot resolve")
        from ddt_tpu_torch.registry import Registry, RegistryError

        try:
            out[spec.name] = Registry(registry_root).resolve(spec.ref)
        except RegistryError as e:
            raise FleetConfigError(
                f"model {spec.name!r}: {e}") from e
    return out


def make_loader(registry_root: "str | None", device: str = "cuda",
                run_log=None):
    """The FleetEngine `loader(spec)` callable: a registry reference
    restores through registry/loader.load_servable (its `artifact` event
    goes to the shared run log), a file path builds a plain ServableModel
    from api.load_model. Either scores on `device`'s backend ("cuda" by
    default, "cpu" for the plain versions). Runs on a caller or handler
    thread, never the dispatcher."""

    def loader(spec: FleetSpec):
        if os.path.exists(spec.ref):
            from ddt_tpu_torch import api
            from ddt_tpu_torch.backends import get_backend
            from ddt_tpu_torch.config import TrainConfig
            from ddt_tpu_torch.serve.engine import (ServableModel,
                                                    default_buckets)

            bundle = api.load_model(spec.ref)
            cfg = TrainConfig(
                device=device, loss=bundle.ensemble.loss,
                n_classes=max(bundle.ensemble.n_classes, 2),
                predict_impl=TIER_IMPL.get(spec.tier, "auto"))
            return ServableModel(
                bundle, get_backend(cfg), quantize=spec.tier,
                buckets=default_buckets(spec.max_batch), raw=spec.raw)
        if registry_root is None:
            raise FleetConfigError(
                f"model {spec.name!r}: ref {spec.ref!r} is not a file "
                "and this fleet has no registry")
        from ddt_tpu_torch.registry import loader as reg_loader

        report = reg_loader.load_servable(
            registry_root, spec.ref, quantize=spec.tier, raw=spec.raw,
            device=device, run_log=run_log)
        return report.model

    return loader


def build_fleet(specs, *, registry: "str | None" = None,
                device: str = "cuda", max_wait_ms: float = 1.0,
                max_resident: "int | None" = None, run_log=None,
                express_lane: bool = True, preload: bool = True,
                request_traces: bool = True) -> FleetEngine:
    """Specs -> a running FleetEngine: validate, resolve every ref
    loudly, build the loader over the registry, and (by default) make the
    first `max_resident` models resident so boot-time failures are
    boot-time errors. One RunLog is shared by the loader's artifact
    events and the engine's serving events (one monotonic seq)."""
    run_log = RunLog.coerce(run_log)
    specs = validate_specs(list(specs))
    resolve_specs(specs, registry)
    engine = FleetEngine(
        specs, make_loader(registry, device, run_log=run_log),
        max_wait_ms=max_wait_ms, max_resident=max_resident,
        run_log=run_log, express_lane=express_lane,
        request_traces=request_traces)
    if preload:
        budget = len(specs) if max_resident is None else max_resident
        try:
            for spec in specs[:budget]:
                engine.n_features_for(spec.name)   # load + warm, loudly
        except BaseException:
            engine.close()                         # don't leak the thread
            raise
    return engine
