"""The element-window, static-DMA, gridded and prefetch probe kernels
(``csrc/probe.cu``) against their plain PyTorch versions
(``toolchain_probe.PLAIN``), bit for bit, on the card.

Every test here needs a CUDA card and ``nvcc``, is marked ``cuda``, and
skips without a card; whether there is one is decided inside each test, so
every worker collects the same tests. On a machine with a card, from the
root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_probe_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which this file
does not import.) The corners are those of ``tests/_torch_probe_cases.py``:
every lead (``cx % 4``) at ``big``'s first and last rows and columns; so are
gridded's odd shapes and prefetch's index arrays.
"""

import numpy as np
import pytest
import torch

from tike_tpu_torch import toolchain_probe as tp

from . import _torch_probe_cases as cases

pytestmark = pytest.mark.cuda

REDESIGNED = ("element_static", "element_prefetch", "static_dma", "gridded", "prefetch")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build csrc/probe.cu)")
    return torch.device("cuda", 0)


def _big(kind, shape, device):
    if kind == "arange":
        return torch.arange(shape[0] * shape[1], dtype=torch.float32, device=device).reshape(shape)
    return cases.random_big(np.random.default_rng(7), shape, device)


@pytest.mark.parametrize("shape", cases.BIG_SHAPES)
@pytest.mark.parametrize("lead", cases.LEADS)
def test_element_prefetch_at_every_lead_and_edge(card, lead, shape):
    for kind in ("arange", "random"):
        cases.check_windows(_big(kind, shape, card), cases.edge_corners(shape, lead))


@pytest.mark.parametrize("planes", [1, 8, 33])
def test_element_prefetch_planes(card, planes):
    rng = np.random.default_rng(planes)
    for shape in cases.BIG_SHAPES:
        cases.check_windows(_big("random", shape, card), cases.random_corners(rng, shape, planes))


@pytest.mark.parametrize("kind", ["arange", "random"])
def test_element_static_and_static_dma(card, kind):
    big = _big(kind, (tp.BIG, tp.BIG), card)
    x = _big(kind, (tp.ROWS + 5, tp.COLS + 12), card)
    for got, want in (
        (tp.element_static(big), tp.PLAIN["element_static"](big.cpu())),
        (tp.static_dma(x), tp.PLAIN["static_dma"](x.cpu())),
        (tp.static_dma(big), tp.PLAIN["static_dma"](big.cpu())),
    ):
        assert torch.equal(got.cpu(), want)


def _calls(device):
    inp = tp.inputs(device)
    inp["big"] = _big("random", tuple(inp["big"].shape), device)
    return {name: (lambda name=name: tp.FUNCTIONS[name](*tp._args(name, inp))) for name in REDESIGNED}


@pytest.mark.parametrize("name", REDESIGNED)
def test_two_launches_bitwise_equal(card, name):
    call = _calls(card)[name]
    first = call()
    second = call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("name", REDESIGNED)
def test_replayed_in_a_cuda_graph(card, name):
    inp = tp.inputs(card)
    args = tp._args(name, inp)
    unchecked = {"check_indices": False} if name in tp.INDEXED else {}
    want = tp.PLAIN[name](*[a.cpu() for a in args])
    fn = tp.FUNCTIONS[name]
    fn(*args, **unchecked)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args, **unchecked)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want)


@pytest.mark.parametrize(
    "corner", [(-1, 0), (0, -1), (tp.BIG - tp.ROWS + 1, 0), (0, tp.BIG - tp.WINDOW_COLS + 1)]
)
def test_a_window_leaving_big_is_refused_before_any_launch(card, corner):
    inp = tp.inputs(card)
    corners = inp["element_corners"].clone()
    corners[5] = torch.tensor(corner, dtype=torch.int32)
    before = dict(tp.LAUNCHES)
    with pytest.raises(ValueError, match="leave big"):
        tp.element_prefetch(corners, inp["big"])
    with pytest.raises(ValueError, match="leave big"):
        tp.element_static(inp["big"][:150])  # starts reach row 56 + 128
    assert tp.LAUNCHES == before


@pytest.mark.parametrize("shape", cases.GRIDDED_SHAPES)
def test_gridded_at_odd_shapes(card, shape):
    for kind in ("arange", "random"):
        x = cases.gridded_input(shape, kind, card)
        cases.check_same("gridded", tp.gridded(x), tp.PLAIN["gridded"](x.cpu()), f"at {shape}")


@pytest.mark.parametrize("kind", cases.INDEX_KINDS)
@pytest.mark.parametrize("plane", cases.PREFETCH_PLANES)
def test_prefetch_on_index_arrays(card, plane, kind):
    idx, x = cases.prefetch_input(plane, kind, card)
    want = tp.PLAIN["prefetch"](idx.cpu(), x.cpu())
    cases.check_same("prefetch", tp.prefetch(idx, x), want, f"on {plane}, {kind}")
    cases.check_same("prefetch", tp.prefetch(idx, x, check_indices=False), want, "unchecked")


@pytest.mark.parametrize("bad", [-1, tp.PLANES])
def test_an_out_of_range_index_is_refused_before_any_launch(card, bad):
    inp = tp.inputs(card)
    idx = inp["idx"].clone()
    idx[3] = bad
    before = dict(tp.LAUNCHES)
    with pytest.raises(ValueError, match="out of range"):
        tp.prefetch(idx, inp["x"])
    assert tp.LAUNCHES == before


def test_empty_kernel_launches_at_every_probe_grid(card):
    inp = tp.inputs(card)
    before = dict(tp.LAUNCHES)
    for name in tp.PROBES:
        cases.floor_call(name, inp)()
    torch.cuda.synchronize()
    assert tp.LAUNCHES == before
