"""Shared helpers of the tests of the port's examples and scripts
(``examples/torch/``, ``scripts/torch/``), for the CPU parity tests and
``chip_smoke.py`` alike: no JAX here.

The examples and scripts are files, not modules of a package, so they are
loaded by path, as ``tests/test_admm_quality.py`` loads
``scripts/admm_quality.py``.
"""

from __future__ import annotations

import importlib.util
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXAMPLES = ("scan", "align", "lamino", "ptycho", "admm")

# The examples' small sizes: the card against the CPU in chip_smoke.py's
# phase 24a, and the CPU tests against tike_tpu. cgrad and the Bucket
# solver take one CG step an outer iteration, where no line-search trial is
# a tie (ROADMAP.md section 3), and the Bucket angles lie 0.1 rad off the
# ties of its cells (tests/test_torch_bucket.py). The ptycho example's
# first 65 patterns make 5 compact batches of 13: no batch is padded, so
# tike_tpu's padded slots drop no eigen-weight update (ROADMAP.md section 3).
SMALL_ALIGN = dict(n=2, size=32)
SMALL_LAMINO = dict(n=16, ntheta=8, num_iter=3, cg_iter=1, bucket_iter=2, theta_shift=0.1)
SMALL_PTYCHO = dict(patterns=65, rpie_iter=2, lsqml_iter=2)
SMALL_ADMM = dict(n=16, P=8, T=4, NPOS=40, num_iter=2)


def load(kind: str, name: str):
    """The module of ``examples/torch/<name>.py`` (``kind`` "examples")
    or ``scripts/torch/<name>.py`` (``kind`` "scripts"), loaded by path
    under the name ``<kind>_torch_<name>``."""
    path = os.path.join(ROOT, kind, "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{kind}_torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reference(kind: str, name: str):
    """The module of the JAX package's ``examples/<name>.py`` or
    ``scripts/<name>.py``, loaded by path (it imports JAX)."""
    path = os.path.join(ROOT, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{kind}_jax_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Recorder:
    """Stands for a module: each function it hands out calls the module's
    and appends ``(name, result)`` to :attr:`calls`."""

    def __init__(self, module):
        self._module = module
        self.calls = []

    def __getattr__(self, name):
        function = getattr(self._module, name)

        def recorded(*args, **kwargs):
            result = function(*args, **kwargs)
            self.calls.append((name, result))
            return result

        return recorded

    def results(self, name) -> list:
        return [result for called, result in self.calls if called == name]
