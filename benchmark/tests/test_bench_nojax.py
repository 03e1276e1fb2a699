"""Nothing the benchmark runs loads JAX or the JAX package: the check at
the start of a run and once its window has closed, by whole top-level
names, so the port (``tike_tpu_torch``) passes."""

import json
import subprocess
import sys

import tiny

SCRIPT = """
import json, sys
sys.path[:0] = [{here!r}, {root!r}]
import run, tike_tpu_torch.ptycho
for w in {cells!r}:
    spec = run.load_spec(w)
print(json.dumps(run.forbidden_modules()))
"""


def _cells():
    return [w["name"] for w in json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def test_harness_and_cells_load_no_jax():
    code = SCRIPT.format(here=str(tiny.HERE), root=str(tiny.ROOT), cells=_cells())
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    import run

    for name in ("jax", "jaxlib.xla_client", "flax", "tike_tpu.ptycho"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "tike_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert set(run.forbidden_modules()) >= {"jax", "jaxlib", "flax", "tike_tpu"}
    assert "tike_tpu_torch_extra" not in run.forbidden_modules()
    assert "jaxtyping" not in run.forbidden_modules()


def test_a_run_refuses_forbidden_modules(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "jax", object())
    assert run.main(["--workload", _cells()[0], "--seed", "1", "--seconds", "1"]) == 4


def test_reference_imports_nothing_of_the_program():
    for path in (tiny.HERE / "reference").glob("*.py"):
        text = path.read_text()
        for word in ("tike_tpu", "import jax", "from jax"):
            assert word not in text, (path, word)
