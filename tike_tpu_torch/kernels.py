"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, then loaded with
:mod:`ctypes`. The build happens at first use, never at import, into
``_build/`` beside this file, under a name keyed by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
reused within a checkout. A missing ``nvcc`` or a failed build raises.
:func:`build_all` starts one ``nvcc`` per source, all together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

# C signatures of each library's entry points: (argtypes, restype).
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "patch": {
        # (image, positions, patches, n, h, w, p, channels, stream)
        "tike_patch_fwd": ([_PTR, _PTR, _PTR] + [_INT] * 5 + [_PTR], _INT),
        # (patches, positions, initial or NULL, image, n, h, w, p, channels,
        # stream); both return a cudaError_t
        "tike_patch_adj": ([_PTR] * 4 + [_INT] * 5 + [_PTR], _INT),
    },
    "usfft": {
        # (grid, bins, order, weights, out, npoints, n, m, stream)
        "tike_kb_gather": ([_PTR] * 5 + [_LL, _INT, _INT, _PTR], _INT),
        # (values, bins, order, bin_start, weights, grid, npoints, n, m, stream)
        "tike_kb_scatter": ([_PTR] * 6 + [_LL, _INT, _INT, _PTR], _INT),
    },
    "probe": {
        # (x, o, count, stream)
        "tike_probe_trivial": ([_PTR, _PTR, _INT, _PTR], _INT),
        # (x, o, planes, rows, cols, stream)
        "tike_probe_gridded": ([_PTR, _PTR] + [_INT] * 3 + [_PTR], _INT),
        # (idx, x, o, planes, plane, stream)
        "tike_probe_prefetch": ([_PTR] * 3 + [_INT] * 2 + [_PTR], _INT),
        # (x, o, pitch, stream)
        "tike_probe_static_dma": ([_PTR, _PTR, _INT, _PTR], _INT),
        # (corners, big, o, planes, rows, width, stream)
        "tike_probe_dynamic_dma": ([_PTR] * 3 + [_INT] * 3 + [_PTR], _INT),
        # (corners or NULL, big, o, planes, rows, width, stream)
        "tike_probe_element": ([_PTR] * 3 + [_INT] * 3 + [_PTR], _INT),
        # (probe, planes, extent, stream): measurement only, the launch floor
        "tike_probe_empty": ([_INT] * 3 + [_PTR], _INT),
    },
}

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict[str, dict] = {}
"""Per library: ``seconds`` spent building (0.0 if reused), ``path`` of
the shared library, and the compiler's ``log`` (register and spill counts
from ``-Xptxas=-v``)."""


def find_nvcc() -> str:
    """Return the path of ``nvcc``: on PATH, else under CUDA_HOME."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc was not found on PATH or under CUDA_HOME; the CUDA "
            "toolkit is required to build the tike_tpu_torch kernels."
        )
    return nvcc


def library_path(name: str) -> Path:
    """Where the built library for ``csrc/<name>.cu`` lives."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names) -> dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` whose keyed library does not exist
    yet, one ``nvcc`` per source, all started together."""
    targets = {name: library_path(name) for name in names}
    jobs = {}
    try:
        for name, target in targets.items():
            if target.exists():
                BUILD_INFO[name] = {"seconds": 0.0, "path": str(target), "log": ""}
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs[name] = [tmp, time.perf_counter(), None]  # cleaned up below
            jobs[name][2] = subprocess.Popen(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        for name, (tmp, start, proc) in jobs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build csrc/{name}.cu "
                    f"(exit {proc.returncode}):\n{err}"
                )
            os.replace(tmp, targets[name])
            BUILD_INFO[name] = {
                "seconds": time.perf_counter() - start,
                "path": str(targets[name]),
                "log": out + err,
            }
    finally:
        for tmp, _, proc in jobs.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return targets


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the keyed library already exists."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``; cached per process."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build(name)))
    for fn_name, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    _LOADED[name] = lib
    return lib
