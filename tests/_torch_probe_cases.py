"""Cases of the feature probes (``tike_tpu_torch/toolchain_probe.py``), shared
by ``tests/test_torch_probe.py`` (CPU, plain versions),
``tests/test_torch_probe_cuda.py`` (the card), ``chip_smoke.py``'s phase 12
and ``python -m tike_tpu_torch.kernel_sweep --source probe``. No JAX.

The element kernel reads each window row from its start rounded down to 16
bytes (the ``lead``, 0-3 floats, is ``cx % 4``), so the corners here give
every lead, at ``big``'s first and last rows and columns. The gridded and
prefetch kernels move float4s only where every band starts on 16 bytes, and
4-byte values otherwise; their odd shapes here take either path and end in a
short band. Beside each probe's library yardstick, :func:`floor_call`
launches ``csrc/probe.cu``'s empty kernel at the probe's own grid.
"""

import numpy as np
import torch

from tike_tpu_torch import kernels
from tike_tpu_torch import toolchain_probe as tp

LEADS = (0, 1, 2, 3)


def edge_corners(shape, lead: int) -> torch.Tensor:
    """Four (cy, cx) int32 corners of (128, 256) windows inside ``big`` of
    ``shape`` whose columns start at ``lead`` past 16 bytes: at the top
    left, at the bottom right (touching the last row, and the last column
    where the lead allows: a window of lead > 0 ends 4 - lead floats short
    of a row whose width is a multiple of 4), and two inside."""
    height, width = shape
    last_row = height - tp.ROWS
    last_col = width - tp.WINDOW_COLS - (4 - lead) % 4
    return torch.tensor(
        [
            [0, lead],
            [last_row, last_col],
            [last_row // 2, 4 * ((last_col // 3) // 4) + lead],
            [1, last_col],
        ],
        dtype=torch.int32,
    )


def random_corners(rng: np.random.Generator, shape, planes: int) -> torch.Tensor:
    """``planes`` int32 corners drawn uniformly inside ``big`` of ``shape``."""
    height, width = shape
    cy = rng.integers(0, height - tp.ROWS + 1, planes)
    cx = rng.integers(0, width - tp.WINDOW_COLS + 1, planes)
    return torch.from_numpy(np.stack([cy, cx], -1).astype(np.int32))


def random_big(rng: np.random.Generator, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)


# (height, width) of ``big``: the probes' own and a narrower, shorter one.
BIG_SHAPES = ((tp.BIG, tp.BIG), (300, 1032))


def check_windows(big: torch.Tensor, corners: torch.Tensor) -> None:
    """Raise unless ``element_prefetch`` at ``corners`` (moved to ``big``'s
    device) equals its plain version on the CPU, bit for bit."""
    got = tp.element_prefetch(corners.to(big.device), big)
    want = tp.PLAIN["element_prefetch"](corners, big.cpu())
    if got.shape != want.shape or not torch.equal(got.cpu(), want):
        raise AssertionError(
            f"element_prefetch at {corners.tolist()} on big {tuple(big.shape)} "
            "differs from its plain version"
        )


# (planes, rows, cols) of gridded's cases: one value; planes of 35 and of
# 129 x 130 floats, whose later planes start off 16 bytes (4-byte path);
# the probe's own; 1024 columns, the most a launch takes.
GRIDDED_SHAPES = ((1, 1, 1), (3, 7, 5), (tp.PLANES, tp.ROWS, tp.COLS), (2, 130, 129), (2, 4, 1024))
# Planes of prefetch's cases (each of 8 planes): the probe's, and 35 floats.
PREFETCH_PLANES = ((tp.ROWS, tp.COLS), (7, 5))
INDEX_KINDS = ("reversed", "random", "zeros")


def gridded_input(shape, kind: str, device) -> torch.Tensor:
    """``arange``-valued or standard normal (seeded by the shape) float32."""
    if kind == "arange":
        return torch.arange(int(np.prod(shape)), dtype=torch.float32, device=device).reshape(shape)
    rng = np.random.default_rng(list(shape))
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)


def prefetch_input(plane_shape, kind: str, device):
    """``(idx, x)`` for ``prefetch``: 8 random planes of ``plane_shape`` and
    an index array reversed (the probe's), random, or all zeros."""
    x = gridded_input((tp.PLANES, *plane_shape), "random", device)
    idx = {
        "reversed": np.arange(tp.PLANES)[::-1],
        "random": np.random.default_rng(1).integers(0, tp.PLANES, tp.PLANES),
        "zeros": np.zeros(tp.PLANES),
    }[kind]
    return torch.tensor(idx.astype(np.int32), device=device), x


def check_same(name: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Raise unless ``got`` equals ``want`` (on the CPU) bit for bit."""
    if got.shape != want.shape or not torch.equal(got.cpu(), want):
        raise AssertionError(f"{name} {what} differs from its plain version")


def check_odd_shapes(device) -> None:
    """Raise unless ``gridded`` and ``prefetch`` on ``device`` equal their
    plain versions on the CPU, bit for bit, at every case above."""
    for shape in GRIDDED_SHAPES:
        for kind in ("arange", "random"):
            x = gridded_input(shape, kind, device)
            check_same("gridded", tp.gridded(x), tp.PLAIN["gridded"](x.cpu()), f"at {shape}, {kind}")
    for plane_shape in PREFETCH_PLANES:
        for kind in INDEX_KINDS:
            idx, x = prefetch_input(plane_shape, kind, device)
            check_same("prefetch", tp.prefetch(idx, x), tp.PLAIN["prefetch"](idx.cpu(), x.cpu()),
                       f"on planes {plane_shape}, {kind} indices")


def _launch_extent(name: str, inp: dict) -> tuple:
    """(planes, extent) of probe ``name``'s launch on ``inp``, as
    ``csrc/probe.cu``'s ``launch_of`` takes them."""
    x = inp["x"]
    return {
        "gridded": (x.shape[0], x.shape[1]),
        "prefetch": (x.shape[0], x[0].numel()),
        "dynamic_dma": (tp.PLANES, tp.ROWS),
        "element_static": (tp.PLANES, tp.ROWS),
        "element_prefetch": (tp.PLANES, tp.ROWS),
    }.get(name, (1, 0))


def floor_call(name: str, inp: dict):
    """A call that launches ``csrc/probe.cu``'s empty kernel (of the probe
    library loaded when it runs) at the grid and block of probe ``name``'s
    kernel on ``inp``: the launch floor, measurement only."""
    probe = list(tp.PROBES).index(name)
    planes, extent = _launch_extent(name, inp)

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernels.load("probe").tike_probe_empty(probe, planes, extent, stream)
        if rc != 0:
            raise RuntimeError(f"the empty kernel at {name}'s grid: CUDA error {rc}")

    return launch


LIBRARY_NAMES = {
    "trivial": "torch.mul",
    "gridded": "torch.mul",
    "prefetch": "two calls: torch.index_select, then add_",
    "static_dma": "clone of a view",
    "dynamic_dma": "clone of a strided view",
    "element_static": "torch.mul of a strided view",
    "element_prefetch": "torch.mul of a strided view",
}


def library_calls(inp: dict) -> dict:
    """PyTorch calls per probe that compute the same output on the inputs
    of ``toolchain_probe.inputs`` (``LIBRARY_NAMES``): one call, but two for
    ``prefetch``, ``torch.index_select`` then ``add_``, as no single call
    gathers planes and adds. The yardsticks of ``chip_smoke.py`` and the
    sweep."""
    x0, x, big = inp["x"][0], inp["x"], inp["big"]
    rows, cols, width = tp.ROWS, tp.WINDOW_COLS, big.shape[1]

    def windows(offset, step):
        return big.as_strided((tp.PLANES, rows, cols), (step, width, 1), offset)

    return {
        "trivial": lambda: torch.mul(x0, 2.0),
        "gridded": lambda: torch.mul(x, 2.0),
        "prefetch": lambda: torch.index_select(x, 0, inp["idx"]).add_(1.0),
        "static_dma": lambda: x0[0:rows, 0 : tp.COLS].clone(),
        "dynamic_dma": lambda: windows(0, 8 * width + 16).clone(),
        "element_static": lambda: torch.mul(windows(0, 8 * width + 16), 2.0),
        "element_prefetch": lambda: torch.mul(windows(3 * width + 5, 9 * width + 17), 2.0),
    }
