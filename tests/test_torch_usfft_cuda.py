"""The CUDA KB kernels (``csrc/usfft.cu``) and the probe kernels
(``csrc/probe.cu``) against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and ``nvcc``, is marked ``cuda``, and
skips without a card; whether there is one is decided inside each test, so
every worker collects the same tests. On a machine with a card, from the
root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_usfft_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which this file
does not import.) The checks are those of ``chip_smoke.py``'s USFFT and
probe phases, from ``tests/_torch_usfft_cases.py``, at smaller sizes.
"""

import numpy as np
import pytest
import torch

from tike_tpu_torch import toolchain_probe
from tike_tpu_torch.ops import lamino, usfft

from . import _torch_usfft_cases as cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build csrc/usfft.cu and csrc/probe.cu)")
    return torch.device("cuda", 0)


# (volume n, eps, upsample): m = 1, 2, 4.
WINDOWS = [(32, 1e-3, 1), (16, 1e-3, 2), (16, 1e-6, 2)]


@pytest.mark.parametrize("layout", ["rows", "flat"])
@pytest.mark.parametrize("n_volume, eps, upsample", WINDOWS)
def test_kb_kernels_match_plain(card, n_volume, eps, upsample, layout):
    n, m, beta = cases.window_for(n_volume, eps, upsample)
    gen = np.random.default_rng(0)
    if layout == "rows":
        x = cases.lamino_rows(n_volume, 16, card).reshape(-1, 3)
    else:
        x = cases.flat_points(gen, 20_000, card)
    grid = cases.crandn(gen, n, n, n, device=card)
    f = cases.crandn(gen, x.shape[0], device=card)
    cases.check_kb_kernels(grid, x, f, n, m, beta, f"{layout}, m = {m}")


def test_kb_kernels_take_no_points(card):
    grid = torch.ones((8, 8, 8), dtype=torch.complex64, device=card)
    x = torch.zeros((0, 3), device=card)
    assert usfft.gather_kb_cuda(grid, x, 8, 1, 2.0).shape == (0,)
    spread = usfft.scatter_kb_cuda(torch.zeros(0, dtype=torch.complex64, device=card), x, 8, 1, 2.0)
    assert torch.count_nonzero(spread) == 0


def test_einsum_yardstick_matches_the_kernels(card):
    n, m, beta = cases.window_for(32, 1e-3, 1)
    rows = cases.lamino_rows(32, 16, card)
    gen = np.random.default_rng(1)
    grid = cases.crandn(gen, n, n, n, device=card)
    f = cases.crandn(gen, *rows.shape[:2], device=card)
    got = usfft.gather_kb_cuda(grid, rows.reshape(-1, 3), n, m, beta)
    einsum = cases.gather_rows_einsum(grid, rows, n, m, beta).reshape(-1)
    assert cases.max_rel(einsum, got) < cases.EINSUM_TOL
    got = usfft.scatter_kb_cuda(f.reshape(-1), rows.reshape(-1, 3), n, m, beta)
    assert cases.max_rel(cases.scatter_rows_einsum(f, rows, n, m, beta), got) < cases.EINSUM_TOL


def test_wrappers_count_launches_and_lamino_runs_through_them(card):
    before = dict(usfft.LAUNCHES)
    cfg = lamino.LaminoConfig(n=16, tilt=np.pi / 3, eps=1e-3, upsample=2)
    theta = cases.lamino_theta(8, card)
    u = cases.crandn(np.random.default_rng(2), 16, 16, 16, device=card)
    d = lamino.lamino_fwd(cfg, u, theta)
    lamino.lamino_adj_exact(cfg, d, theta)
    torch.cuda.synchronize()
    assert usfft.LAUNCHES["usfft_gather_kb"] == before["usfft_gather_kb"] + 1
    assert usfft.LAUNCHES["usfft_scatter_kb"] == before["usfft_scatter_kb"] + 1
    want = lamino.lamino_fwd(cfg, u.cpu(), theta.cpu())
    assert cases.max_rel(d.cpu(), want) < cases.KB_TOL


def test_probes_equal_their_plain_versions(card):
    inp = toolchain_probe.inputs(card)
    before = dict(toolchain_probe.LAUNCHES)
    outputs = toolchain_probe.run(inp)
    torch.cuda.synchronize()
    toolchain_probe.check(outputs, inp)
    assert all(toolchain_probe.LAUNCHES[k] == before[k] + 1 for k in before)


def test_dynamic_dma_refuses_unaligned_corners(card):
    inp = toolchain_probe.inputs(card)
    with pytest.raises(ValueError, match="multiples of 4"):
        toolchain_probe.dynamic_dma(inp["element_corners"], inp["big"])
