"""The CUDA Lanczos remap kernels (``csrc/interp.cu``) against their plain
PyTorch versions, on the card.

Every test here needs a CUDA card and ``nvcc``, is marked ``cuda``, and
skips without a card; whether there is one is decided inside each test, so
every worker collects the same tests. On a machine with a card, from the
root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_interp_cuda.py -q

The checks are those of ``chip_smoke.py``'s phase 19a, from
``tests/_torch_interp_cases.py``, with its tolerances.
"""

import numpy as np
import pytest
import torch

from tike_tpu_torch.ops import interp

from . import _torch_interp_cases as cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build csrc/interp.cu)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", list(cases.CASES))
def test_kernels_match_plain(card, name):
    cases.check_lanczos_kernels(*cases.case_inputs(name, card), label=name)


def test_single_image_forms(card):
    """(H, W) images with (N, 2) points and (N,) values, as the JAX
    package's functions take them, match the batched launch."""
    images, points, values, m, cval = cases.case_inputs("m2 complex, cval", card)
    one = interp.remap_lanczos_fwd(images[1], points[1], m, cval)
    assert one.shape == points.shape[1:2]
    torch.testing.assert_close(one, interp.remap_lanczos_fwd(images, points, m, cval)[1],
                               rtol=0, atol=0)
    adj = interp.remap_lanczos_adj(values[1], points[1], m, images.shape[-2:])
    assert adj.shape == images.shape[1:]


def test_kernels_match_plain_at_the_paths_shapes(card):
    """128 images of 1024^2: the flow warp's per-image points and the
    rotation's shared points, at m = 2."""
    full = cases.full_width_inputs(card)
    values = full["images"].reshape(cases.FULL_IMAGES, -1)
    for key in ("flow", "rotate"):
        cases.check_lanczos_kernels(full["images"], full[key], values, 2, 0.0, label=key)


def test_kernels_match_the_first_form_at_the_paths_shapes(card):
    """The redesigned kernels against their first form
    (``csrc/interp_first_form.cu``) at 128 x 1024^2, m = 2, flow and
    rotation points; no adjoint warp of either falls back to tap-by-tap
    atomics."""
    full = cases.full_width_inputs(card)
    values = full["images"].reshape(cases.FULL_IMAGES, -1)
    shape = full["images"].shape[-2:]
    for key in ("flow", "rotate"):
        points = full[key]
        interp.reset_fallback_warps(card)
        for got, want, tol in (
            (interp.remap_lanczos_fwd_cuda(full["images"], points, 2),
             cases.first_form_fwd(full["images"], points, 2), cases.FWD_TOL),
            (interp.remap_lanczos_adj_cuda(values, points, 2, shape),
             cases.first_form_adj(values, points, 2, shape), cases.ADJ_TOL),
        ):
            err, rel = cases._max_rel(got, want)
            assert rel <= tol, (key, err, rel)
        assert interp.fallback_warps(card) == 0, key


def test_adjoint_falls_back_where_a_warp_spreads(card):
    """Points scattered at random over the grid: every warp's windows span
    more than its buffer, so each adds tap by tap, is counted, and the
    result still matches the plain version."""
    images, points, values, m, _ = cases.case_inputs("m2 complex, cval", card)
    h, w = images.shape[-2:]
    interp.reset_fallback_warps(card)
    got = interp.remap_lanczos_adj_cuda(values, points, m, (h, w))
    warps = images.shape[0] * -(-points.shape[-2] // 32)
    assert interp.fallback_warps(card) == warps
    err, rel = cases._max_rel(got, interp.remap_lanczos_adj_plain(values, points, m, (h, w)))
    assert rel <= cases.ADJ_TOL, (err, rel)


def test_launches_are_counted_and_refusals_raise(card):
    images, points, values, m, cval = cases.case_inputs("m1 complex", card)
    before = dict(interp.LAUNCHES)
    interp.remap_lanczos_fwd(images, points, m, cval)
    interp.remap_lanczos_adj(values, points, m, images.shape[-2:])
    assert interp.LAUNCHES["lanczos_fwd"] == before["lanczos_fwd"] + 1
    assert interp.LAUNCHES["lanczos_adj"] == before["lanczos_adj"] + 1
    with pytest.raises(ValueError):
        interp.remap_lanczos_fwd(images, points, -1)
    with pytest.raises(ValueError):
        interp.remap_lanczos_fwd(images, points[:, :, :1].contiguous(), m)
    with pytest.raises(ValueError):
        interp.remap_lanczos_fwd(images.to(torch.complex128), points, m)
    with pytest.raises(ValueError):
        interp.remap_lanczos_fwd(images, points.cpu(), m)


def test_kernels_run_in_a_cuda_graph(card):
    images, points, values, m, cval = cases.case_inputs("m2 complex, cval", card)
    want = interp.remap_lanczos_fwd_cuda(images, points, m, cval)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = interp.remap_lanczos_fwd_cuda(images, points, m, cval)
        adj = interp.remap_lanczos_adj_cuda(values, points, m, images.shape[-2:])
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool(torch.isfinite(torch.view_as_real(adj)).all())


def test_flow_takes_any_filter_size_on_the_card(card):
    """A flow warp with filter_size 20 (m = 10) runs on the card as on the
    CPU, where the plain versions take any size."""
    from tike_tpu_torch.ops import flow as tflow

    gen = np.random.default_rng(3)
    f = torch.as_tensor(
        (gen.standard_normal((2, 24, 24)) + 1j * gen.standard_normal((2, 24, 24)))
        .astype(np.complex64)
    )
    disp = cases.smooth_flow(gen, 2, 24, "cpu")
    for op in (tflow.flow_fwd, tflow.flow_adj):
        want = op(f, disp, 20, 0.2)
        got = op(f.to(card), disp.to(card), 20, 0.2).cpu()
        err, rel = cases._max_rel(got, want)
        assert rel <= cases.ADJ_TOL, (op.__name__, err, rel)
