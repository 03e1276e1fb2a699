"""The port's documentation, examples and scripts, checked on the CPU.

Each check that imports the port's modules runs in a fresh interpreter:
with ``--dist loadfile`` a worker has already imported other files'
submodules, which then show up as attributes of their package
(``tests/test_torch_namespaces.py``).

- ``scripts/torch/gen_api_docs.py`` run anew gives ``docs/torch/api/``
  byte for byte, and every public name of every namespace of
  ``tests/test_torch_namespaces.py::NAMESPACES`` appears in those pages;
- every dotted ``tike_tpu_torch.`` name in ``docs/torch/*.md`` and in the
  README's port section resolves;
- no file under ``examples/torch/`` or ``scripts/torch/`` imports ``jax``,
  ``tike_tpu``, ``bench`` or ``bench_all`` (read with ``ast``);
- no example or script writes to a path that git tracks: every output
  file it names by default is one that ``.gitignore`` lists, and none is
  an output of the JAX package's examples and scripts;
- each example and script parses its command line as a script.
"""

import ast
import fnmatch
import json
import pathlib
import re
import subprocess
import sys

import pytest

from .test_torch_namespaces import NAMESPACES

ROOT = pathlib.Path(__file__).resolve().parents[1]
API = ROOT / "docs" / "torch" / "api"
FILES = sorted((ROOT / "examples" / "torch").glob("*.py")) + sorted(
    (ROOT / "scripts" / "torch").glob("*.py")
)
# The JAX package's examples and scripts write these, which git tracks.
REFERENCE_OUTPUTS = {"ptycho_example.png", "LONGAXIS.md", "scan_trajectories.png"}
OUTPUT_SUFFIXES = (".png", ".md", ".json", ".npz", ".txt", ".csv", ".h5")
DOTTED = re.compile(r"tike_tpu_torch(?:\.[A-Za-z_][A-Za-z0-9_]*)+")

_PUBLIC = """
import importlib, json, sys, types
module = importlib.import_module("tike_tpu_torch" + sys.argv[1])
print(json.dumps(sorted(
    name for name in dir(module) if not name.startswith("_")
    and (callable(getattr(module, name)) or isinstance(getattr(module, name), types.ModuleType))
)))
"""

_RESOLVE = """
import importlib, json, sys
missing = []
for name in json.loads(sys.stdin.read()):
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:k]))
        except ImportError:
            continue
        try:
            for part in parts[k:]:
                obj = getattr(obj, part)
        except AttributeError:
            missing.append(name)
        break
    else:
        missing.append(name)
print(json.dumps(missing))
"""


def _run(args, **kwargs):
    return subprocess.run([sys.executable, *args], cwd=ROOT, text=True, capture_output=True,
                          timeout=300, **kwargs)


def test_api_pages_match_a_fresh_run(tmp_path):
    run = _run(["scripts/torch/gen_api_docs.py", "--out", str(tmp_path)])
    assert run.returncode == 0, run.stderr
    fresh = sorted(p.name for p in tmp_path.iterdir())
    assert fresh == sorted(p.name for p in API.iterdir())
    for name in fresh:
        assert (tmp_path / name).read_bytes() == (API / name).read_bytes(), name


def test_every_public_name_is_in_the_api_pages():
    text = "\n".join(p.read_text() for p in API.glob("*.md"))
    words = set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", text))
    runs = {ns: subprocess.Popen([sys.executable, "-c", _PUBLIC, ns], cwd=ROOT, text=True,
                                 stdout=subprocess.PIPE) for ns in NAMESPACES}
    for ns, run in runs.items():
        out, _ = run.communicate(timeout=300)
        assert run.returncode == 0, ns
        names = json.loads(out)
        assert names, ns
        missing = sorted(set(names) - words)
        assert not missing, f"tike_tpu_torch{ns}: {missing} not in docs/torch/api"


def _readme_port_section() -> str:
    text = (ROOT / "README.md").read_text()
    start = text.index("## PyTorch port (`tike_tpu_torch`)")
    end = text.find("\n## ", start + 1)
    return text[start:] if end < 0 else text[start:end]


def test_dotted_names_in_the_guides_resolve():
    texts = {p.name: p.read_text() for p in (ROOT / "docs" / "torch").glob("*.md")}
    texts["README.md (port section)"] = _readme_port_section()
    assert {"README.md", "MIGRATING.md", "ptycho.md", "lamino.md", "align.md", "admm.md",
            "parallel.md"} <= set(texts)
    names = sorted({m.group(0) for text in texts.values() for m in DOTTED.finditer(text)})
    assert len(names) > 20
    run = _run(["-c", _RESOLVE], input=json.dumps(names))
    assert run.returncode == 0, run.stderr
    assert json.loads(run.stdout) == []


def _imports(tree) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {alias.name for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: f"{p.parent.parent.name}/{p.name}")
def test_examples_and_scripts_import_neither_jax_nor_tike_tpu(path):
    assert len(FILES) == 9
    for name in _imports(ast.parse(path.read_text())):
        top = name.split(".")[0]
        assert top not in {"jax", "jaxlib", "tike_tpu", "bench", "bench_all"}, (path.name, name)


def _named_outputs(path) -> set:
    """The file names an example or script spells out, its docstrings left
    out."""
    tree = ast.parse(path.read_text())
    docstrings = {
        id(node.body[0].value) for node in ast.walk(tree)
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and node.body
        and isinstance(node.body[0], ast.Expr) and isinstance(node.body[0].value, ast.Constant)
    }
    return {
        node.value for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
        and id(node) not in docstrings and node.value.endswith(OUTPUT_SUFFIXES)
        and " " not in node.value
    }


def test_examples_and_scripts_write_no_tracked_path():
    ignored = [line.strip() for line in (ROOT / ".gitignore").read_text().splitlines()
               if line.strip() and not line.startswith("#")]
    outputs = {}
    for path in FILES:
        if path.name == "gen_api_docs.py":  # writes docs/torch/api, held by the test above
            continue
        for name in _named_outputs(path):
            outputs[name] = path.name
    assert {"ptycho_example_torch.png", "scan_trajectories_torch.png"} <= set(outputs)
    for name, owner in outputs.items():
        assert name not in REFERENCE_OUTPUTS, (owner, name)
        assert any(fnmatch.fnmatch(name, pattern) for pattern in ignored), (owner, name)


def test_examples_and_scripts_parse_their_command_line():
    runs = {path.name: subprocess.Popen([sys.executable, str(path), "--help"], cwd=ROOT,
                                        text=True, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE) for path in FILES}
    for name, run in runs.items():
        out, err = run.communicate(timeout=300)
        assert run.returncode == 0, (name, err)
        assert "--device" in out or name == "gen_api_docs.py", name
