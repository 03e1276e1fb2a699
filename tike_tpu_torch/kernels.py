"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, then loaded with
:mod:`ctypes`. The build happens at first use, never at import, into
``_build/`` beside this file, under a name keyed by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
reused within a checkout. A missing ``nvcc`` or a failed build raises.
:func:`build_all` starts one ``nvcc`` per source, all together.
:class:`CardCounter` keeps the counts that kernels add to on the card.
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

import torch

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
_PTR, _INT, _LL, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "patch": {
        # (image, positions, patches, n, h, w, p, channels, stream)
        "tike_patch_fwd": ([_PTR, _PTR, _PTR] + [_INT] * 5 + [_PTR], _INT),
        # (patches, positions, initial or NULL, image, n, h, w, p, channels,
        # stream); both return a cudaError_t
        "tike_patch_adj": ([_PTR] * 4 + [_INT] * 5 + [_PTR], _INT),
    },
    "usfft": {
        # (grid, rows, cols, order, weights, out, npoints, n, m, stream)
        "tike_kb_gather": ([_PTR] * 6 + [_LL, _INT, _INT, _PTR], _INT),
        # (values, cols, order, row_start, weights, grid, npoints, n, m, stream)
        "tike_kb_scatter": ([_PTR] * 6 + [_LL, _INT, _INT, _PTR], _INT),
    },
    # The Gaussian window's gather and scatter.
    "usfft_gaussian": {
        # (grid, rows, cols, order, weights, out, npoints, n, m, stream)
        "tike_gaussian_gather": ([_PTR] * 6 + [_LL, _INT, _INT, _PTR], _INT),
        # (values, cols, order, row_start, weights, block table, blocks,
        # grid, npoints, n, m, stream)
        "tike_gaussian_scatter": ([_PTR] * 6 + [_INT, _PTR, _LL, _INT, _INT, _PTR], _INT),
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
    "bucket": {
        # (u, grid or NULL, table, planes, outside, offsets (host), voxels,
        # angles, n, precision, weight, pitch, window_cells, x0, rows, stream)
        "tike_bucket_fwd": ([_PTR] * 6 + [_LL] + [_INT] * 3 + [_FLOAT] + [_INT] * 4 + [_PTR], _INT),
        # (planes, grid or NULL, table, out, outside, offsets (host), voxels,
        # angles, n, precision, weight, pitch, window_cells, x0, rows, stream)
        "tike_bucket_adj": ([_PTR] * 6 + [_LL] + [_INT] * 3 + [_FLOAT] + [_INT] * 4 + [_PTR], _INT),
    },
    "interp": {
        # (image, points, out, images, npoints, h, w, m, shared_points,
        # channels, cval_re, cval_im, stream)
        "tike_lanczos_fwd": ([_PTR] * 3 + [_INT, _LL] + [_INT] * 5 + [_FLOAT] * 2 + [_PTR], _INT),
        # (values, points, grid (zeroed), fallback count, images, npoints, h,
        # w, m, shared_points, channels, stream)
        "tike_lanczos_adj": ([_PTR] * 4 + [_INT, _LL] + [_INT] * 5 + [_PTR], _INT),
    },
    # The Lanczos kernels' first form, a yardstick no path runs.
    "interp_first_form": {
        # (image, points, out, images, npoints, h, w, m, shared_points,
        # channels, cval_re, cval_im, stream)
        "tike_lanczos_first_form_fwd": (
            [_PTR] * 3 + [_INT, _LL] + [_INT] * 5 + [_FLOAT] * 2 + [_PTR], _INT
        ),
        # (values, points, grid (zeroed), images, npoints, h, w, m,
        # shared_points, channels, stream)
        "tike_lanczos_first_form_adj": ([_PTR] * 3 + [_INT, _LL] + [_INT] * 5 + [_PTR], _INT),
    },
    # The Bucket kernels' first form, a yardstick no path runs.
    "bucket_first_form": {
        # (u, grid or NULL, table (T x 8), planes, voxels, angles, n,
        # precision, weight, stream)
        "tike_bucket_first_form_fwd": ([_PTR] * 4 + [_LL] + [_INT] * 3 + [_FLOAT, _PTR], _INT),
        # (planes, grid or NULL, table (T x 8), out, voxels, angles, n,
        # precision, weight, stream)
        "tike_bucket_first_form_adj": ([_PTR] * 4 + [_LL] + [_INT] * 3 + [_FLOAT, _PTR], _INT),
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
                # Keep what the build that made it recorded, if it was this process's.
                BUILD_INFO.setdefault(name, {"seconds": 0.0, "path": str(target), "log": ""})
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


class CardCounter:
    """A count that kernels keep on the card: ``slots`` int64 per CUDA
    device, which the kernels add to as unsigned 64-bit integers (spread
    over several slots so that warps do not all add to one address) and
    which read as their sum. A device named ``cuda`` without an index is the
    current one, as for a tensor made there."""

    def __init__(self, slots: int = 1):
        self.slots = slots
        self._tensors: dict[torch.device, torch.Tensor] = {}

    @staticmethod
    def device_key(device) -> torch.device:
        """``device`` as the counter files it: with its index filled in."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device

    def tensor(self, device) -> torch.Tensor:
        """The slots on ``device`` for a kernel to add to, made at first use."""
        key = self.device_key(device)
        counter = self._tensors.get(key)
        if counter is None:
            counter = self._tensors[key] = torch.zeros(self.slots, dtype=torch.int64, device=key)
        return counter

    def read(self, device) -> int:
        """The count on ``device`` since its last :meth:`reset`, 0 where no
        kernel has added to it. Waits for the card."""
        counter = self._tensors.get(self.device_key(device))
        return 0 if counter is None else int(counter.sum().item())

    def reset(self, device) -> None:
        """Set the count on ``device`` to 0."""
        counter = self._tensors.get(self.device_key(device))
        if counter is not None:
            counter.zero_()
