"""Cases of the window probes (``tike_tpu_torch/toolchain_probe.py``), shared
by ``tests/test_torch_probe.py`` (CPU, plain versions),
``tests/test_torch_probe_cuda.py`` (the card), ``chip_smoke.py``'s phase 12
and ``python -m tike_tpu_torch.kernel_sweep --source probe``. No JAX.

The element kernel reads each window row from its start rounded down to 16
bytes (the ``lead``, 0-3 floats, is ``cx % 4``), so the corners here give
every lead, at ``big``'s first and last rows and columns.
"""

import numpy as np
import torch

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


def library_calls(inp: dict) -> dict:
    """One PyTorch call per probe that computes the same output on the
    inputs of ``toolchain_probe.inputs`` (None for ``prefetch``: no single
    call does): the yardsticks of ``chip_smoke.py`` and the sweep."""
    x0, x, big = inp["x"][0], inp["x"], inp["big"]
    rows, cols, width = tp.ROWS, tp.WINDOW_COLS, big.shape[1]

    def windows(offset, step):
        return big.as_strided((tp.PLANES, rows, cols), (step, width, 1), offset)

    return {
        "trivial": lambda: torch.mul(x0, 2.0),
        "gridded": lambda: torch.mul(x, 2.0),
        "prefetch": None,
        "static_dma": lambda: x0[0:rows, 0 : tp.COLS].clone(),
        "dynamic_dma": lambda: windows(0, 8 * width + 16).clone(),
        "element_static": lambda: torch.mul(windows(0, 8 * width + 16), 2.0),
        "element_prefetch": lambda: torch.mul(windows(3 * width + 5, 9 * width + 17), 2.0),
    }
