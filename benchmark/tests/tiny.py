"""A cell's spec cut to a size the CPU runs in seconds, for the
benchmark's own tests: the same files, the sizes overridden."""

import copy
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402

TINY = {"n_patterns": 48, "detector": 16, "probe": 16, "object": 64}


def spec(workload: str) -> dict:
    s = run.load_spec(workload)
    s = dict(s, config=copy.deepcopy(s["config"]), traffic=copy.deepcopy(s["traffic"]))
    s["config"].update(TINY)
    s["traffic"]["options"]["num_batch"] = 4
    return s
