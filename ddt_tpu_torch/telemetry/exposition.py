"""Prometheus text-exposition primitives (port of
ddt_tpu/telemetry/exposition.py, copied: the port imports nothing of the
reference).

The writer helpers (`_esc`, `_num`, `render_counters`) and the parser
used by tests and chip_smoke (`parse_exposition`) of every `/metrics`
endpoint of the port (serve/metrics.py). The same dialect as the
reference's, so a scrape of either package parses with either parser
into the same series. Format: the Prometheus text exposition, version
0.0.4. Rendering never mutates the counters it is handed.

No HTTP, no locks, no engine imports: callers collect the snapshots and
this module only formats.
"""

from __future__ import annotations

#: the Content-Type a /metrics endpoint sends (serve/http.py):
#: Prometheus scrapers key on the version token.
EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _esc(label: str) -> str:
    """Escape a label value per the exposition format."""
    return (str(label).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _num(v) -> str:
    """Format a sample value: integers bare, floats as-is."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def render_counters(counters: dict) -> "list[str]":
    """Process counters -> one ``ddt_<name>_total`` series each."""
    out = []
    for key in sorted(counters):
        v = counters[key]
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        name = f"ddt_{key}_total"
        out.append(f"# TYPE {name} counter")
        out.append(f"{name} {_num(v)}")
    return out


def parse_exposition(text: str) -> dict:
    """Inverse of the renderers for tests and the smoke harness:
    {series_name: {frozenset(label items) or (): value}}. Tolerates
    comments and blank lines; not a general openmetrics parser."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value = line.rpartition(" ")
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            labels = {}
            for item in rest.rstrip("}").split(","):
                if not item:
                    continue
                k, _, v = item.partition("=")
                labels[k] = v.strip('"')
            key = frozenset(labels.items())
        else:
            name, key = name_part, ()
        out.setdefault(name, {})[key] = float(value)
    return out
