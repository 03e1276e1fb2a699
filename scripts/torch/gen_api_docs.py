#!/usr/bin/env python
"""Generate docs/torch/api/*.md from the docstrings of tike_tpu_torch.

The port's counterpart of ``scripts/gen_api_docs.py``: the same renderer
(module, function and class docstrings into plain markdown, one page per
subsystem) over the port's modules, with the port's own additions (the
kernel builds, the converters from ``tike_tpu``, the profiler, the
multi-process layout and host streaming), and each module's public
non-callable names (dtypes, constants, counters) listed too. It needs no
card. Regenerate after API changes:

    python scripts/torch/gen_api_docs.py [--out DIR]
"""

import argparse
import ast
import dataclasses
import importlib
import inspect
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

OUT = os.path.join("docs", "torch", "api")

# Public modules, grouped into one page per subsystem.
PAGES = {
    "ptycho": [
        "tike_tpu_torch.ptycho.ptycho",
        "tike_tpu_torch.ptycho.solvers.options",
        "tike_tpu_torch.ptycho.solvers.rpie",
        "tike_tpu_torch.ptycho.solvers.lstsq",
        "tike_tpu_torch.ptycho.solvers.epoch",
        "tike_tpu_torch.ptycho.object",
        "tike_tpu_torch.ptycho.probe",
        "tike_tpu_torch.ptycho.position",
        "tike_tpu_torch.ptycho.exitwave",
        "tike_tpu_torch.ptycho.io",
        "tike_tpu_torch.ptycho.fresnel",
        "tike_tpu_torch.ptycho.learn",
        "tike_tpu_torch.ptycho.stream",
    ],
    "lamino": [
        "tike_tpu_torch.lamino.lamino",
        "tike_tpu_torch.lamino.bucket",
        "tike_tpu_torch.lamino.solvers.cgrad",
        "tike_tpu_torch.lamino.solvers.cgls",
        "tike_tpu_torch.lamino.solvers.bucket",
    ],
    "align": [
        "tike_tpu_torch.align.align",
        "tike_tpu_torch.align.solvers.cross_correlation",
        "tike_tpu_torch.align.solvers.farneback",
    ],
    "admm": ["tike_tpu_torch.admm"],
    "operators": [
        "tike_tpu_torch.ops.patch",
        "tike_tpu_torch.ops.ptycho",
        "tike_tpu_torch.ops.propagation",
        "tike_tpu_torch.ops.objective",
        "tike_tpu_torch.ops.usfft",
        "tike_tpu_torch.ops.lamino",
        "tike_tpu_torch.ops.bucket",
        "tike_tpu_torch.ops.flow",
        "tike_tpu_torch.ops.interp",
        "tike_tpu_torch.ops.rotate",
        "tike_tpu_torch.ops.shift",
        "tike_tpu_torch.ops.pad",
        "tike_tpu_torch.ops.alignment",
    ],
    "parallel": [
        "tike_tpu_torch.parallel",
        "tike_tpu_torch.parallel.striped",
        "tike_tpu_torch.parallel.halo",
        "tike_tpu_torch.parallel.distributed",
        "tike_tpu_torch.cluster",
    ],
    "support": [
        "tike_tpu_torch.opt",
        "tike_tpu_torch.trace",
        "tike_tpu_torch.linalg",
        "tike_tpu_torch.scan",
        "tike_tpu_torch.trajectory",
        "tike_tpu_torch.constants",
        "tike_tpu_torch.precision",
        "tike_tpu_torch.random",
        "tike_tpu_torch.checkpoint",
        "tike_tpu_torch.view",
        "tike_tpu_torch.utils.ndimage",
        "tike_tpu_torch.convert",
    ],
    "kernels": [
        "tike_tpu_torch.kernels",
        "tike_tpu_torch.profile_epoch",
        "tike_tpu_torch.toolchain_probe",
        "tike_tpu_torch.kernel_sweep",
    ],
}

PAGE_TITLES = {
    "ptycho": "Ptychography (`tike_tpu_torch.ptycho`)",
    "lamino": "Laminography (`tike_tpu_torch.lamino`)",
    "align": "Alignment (`tike_tpu_torch.align`)",
    "admm": "Joint ptycho-tomography ADMM (`tike_tpu_torch.admm`)",
    "operators": "Operators (`tike_tpu_torch.ops`)",
    "parallel": "Parallelism (`tike_tpu_torch.parallel`)",
    "support": "Support utilities",
    "kernels": "Kernels, profiling and toolchain checks",
}

GENERATED = [
    "*Generated from docstrings by `scripts/torch/gen_api_docs.py`;",
    "do not edit by hand.*",
    "",
]


def _assigned(mod) -> set:
    """The names that ``mod``'s own top-level statements assign."""
    names = set()
    for node in ast.parse(inspect.getsource(mod)).body:
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign) else [])
        for target in targets:
            for leaf in ast.walk(target):
                if isinstance(leaf, ast.Name):
                    names.add(leaf.id)
    return names


def _public_members(mod):
    """``(functions and classes, other names)`` of ``mod``: its ``__all__``,
    or else the names defined in it (re-exports are left to their own
    module's page)."""
    names = getattr(mod, "__all__", None)
    declared = names is not None
    if not declared:
        names = [n for n in vars(mod) if not n.startswith("_")]
    assigned = _assigned(mod)
    out, data = [], []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        if inspect.isfunction(obj) or inspect.isclass(obj):
            owner = getattr(obj, "__module__", None)
            if declared or owner == mod.__name__:
                out.append((n, obj))
            elif n in assigned:  # an alias, such as precision.floating
                data.append((n, obj))
        elif declared or n in assigned:
            data.append((n, obj))
    return out, data


def _signature(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj):
    d = inspect.getdoc(obj)
    return d.strip() if d else ""


_PLAIN = (bool, int, float, complex, str)


def _short(value) -> str:
    """A plain value's repr, else its type's name: a path, an object's
    address or a function's repr would change from run to run. An alias
    of a class or function gives its qualified name."""
    if inspect.isclass(value) or inspect.isfunction(value):
        return f"`{value.__module__}.{value.__qualname__}`"
    plain = isinstance(value, _PLAIN) or (
        isinstance(value, tuple) and all(isinstance(v, _PLAIN) for v in value)
    )
    if not plain and type(value).__module__ == "torch" and type(value).__name__ == "dtype":
        plain = True
    text = " ".join(repr(value).split())
    if not plain or os.sep in text:
        return f"({type(value).__name__})"
    return f"`{text}`" if len(text) <= 60 else f"`{text[:57]}...`"


def _stable(line: str) -> str:
    """``line`` without object addresses or the checkout's own path."""
    return re.sub(r" at 0x[0-9a-f]+", "", line).replace(ROOT + os.sep, "")


def _render_class(name, cls):
    lines = [f"### `{name}{_signature(cls)}`", ""]
    doc = _doc(cls)
    if doc:
        lines += [doc, ""]
    if dataclasses.is_dataclass(cls):
        lines.append("| field | default |")
        lines.append("|---|---|")
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                default = repr(f.default)
            elif f.default_factory is not dataclasses.MISSING:  # type: ignore
                default = f"{getattr(f.default_factory, '__name__', '...')}()"
            else:
                default = "(required)"
            if len(default) > 40:
                default = default[:37] + "..."
            lines.append(f"| `{f.name}` | `{default}` |")
        lines.append("")
    for mname, meth in inspect.getmembers(cls, inspect.isfunction):
        if mname.startswith("_"):
            continue
        if meth.__qualname__.split(".")[0] != cls.__name__:
            continue
        mdoc = _doc(meth)
        first = mdoc.splitlines()[0] if mdoc else ""
        lines.append(f"- **`.{mname}{_signature(meth)}`** — {first}")
    if lines[-1] != "":
        lines.append("")
    return lines


def _render_module(modname):
    mod = importlib.import_module(modname)
    lines = [f"## `{modname}`", ""]
    doc = _doc(mod)
    if doc:
        lines += [doc, ""]
    members, data = _public_members(mod)
    if data:
        lines += [f"- `{name}` = {_short(value)}" for name, value in data] + [""]
    for name, obj in members:
        if inspect.isclass(obj):
            lines += _render_class(name, obj)
        else:
            lines.append(f"### `{name}{_signature(obj)}`")
            lines.append("")
            fdoc = _doc(obj)
            if fdoc:
                lines += [fdoc, ""]
    return lines


def render(outdir) -> list:
    """Write every page and the index into ``outdir``; returns the paths."""
    os.makedirs(outdir, exist_ok=True)
    index = [
        "# API reference of `tike_tpu_torch`",
        "",
        "Generated from docstrings by `scripts/torch/gen_api_docs.py`; do not",
        "edit by hand. Guides live one directory up (`docs/torch/*.md`).",
        "",
    ]
    paths = []
    for page, modules in PAGES.items():
        lines = [f"# {PAGE_TITLES[page]}", ""] + GENERATED
        for m in modules:
            lines += _render_module(m)
        path = os.path.join(outdir, f"{page}.md")
        with open(path, "w") as f:
            f.write("\n".join(_stable(line) for line in lines).rstrip() + "\n")
        index.append(f"- [{PAGE_TITLES[page]}]({page}.md)")
        paths.append(path)
    path = os.path.join(outdir, "README.md")
    with open(path, "w") as f:
        f.write("\n".join(index) + "\n")
    return paths + [path]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(ROOT, OUT),
                        help=f"output directory (default: {OUT} of the checkout)")
    args = parser.parse_args(argv)
    for path in render(args.out):
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
