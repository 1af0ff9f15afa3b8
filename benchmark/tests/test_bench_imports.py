"""What a run loads: never JAX or the JAX package (top-level names
compared whole), and the reference nothing of the program."""

import subprocess
import sys
import types

from benchmark.core import harness

from .conftest import ROOT

PROBE = """
import sys
sys.path.insert(0, {root!r})
from benchmark.core import harness
for w in {cells!r}:
    cell = harness.resolve(w)
    for m in cell.per_layer:
        harness.load_module(harness.BENCH / "layers" / (m["name"] + ".py"),
                            "probe_" + m["name"].replace(".", "_"))
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.strip().split(","))


def test_a_runs_modules_hold_no_jax():
    cells = ["higgs.train", "higgs.score", "criteo.train4", "covtype.train"]
    mods = _loaded(PROBE.format(root=str(ROOT), cells=cells))
    assert "ddt_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = _loaded(f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                   "import benchmark.reference.gbdt; "
                   "print(','.join({m.split('.')[0] for m in sys.modules}))")
    assert not mods & {"ddt_tpu_torch", "ddt_tpu", "jax"}


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ddt_tpu_torch_x", types.ModuleType("x"))
    assert "ddt_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("j"))
    assert harness.forbidden_modules() == ["jax"]
