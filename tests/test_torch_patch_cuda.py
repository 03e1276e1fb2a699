"""The CUDA patch kernels (``csrc/patch.cu``) against their plain PyTorch
versions, on the card.

Every test here needs a CUDA card and ``nvcc``, is marked ``cuda``, and
skips without a card; whether there is one is decided inside each test, so
every worker collects the same tests. On a machine with a card, from the
root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_patch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which this file
does not import.) The checks are those of ``chip_smoke.py``'s phase 3,
from ``tests/_torch_patch_cases.py``: the same edge cases, the same
tolerances, two launches bitwise equal.
"""

import pytest
import torch

from tike_tpu_torch.ops import patch

from . import _torch_patch_cases as cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build csrc/patch.cu)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", list(cases.EDGE_CASES))
def test_kernels_match_plain_on_edge_case(card, name):
    cases.check_patch_kernels(*cases.edge_case(name, card), name)


@pytest.mark.parametrize("dtype", ["complex64", "float32"])
def test_kernels_match_plain_at_main_path_shapes(card, dtype):
    image, positions, patches = cases.main_path_patch_inputs(card)
    if dtype == "float32":
        image, patches = image.real.contiguous(), torch.square(torch.abs(patches))
    cases.check_patch_kernels(image, positions, patches, cases.MAIN_P, dtype)


@pytest.mark.parametrize("name", list(cases.PATH_SHAPES))
@pytest.mark.parametrize("dtype", ["complex64", "float32"])
def test_kernels_match_plain_at_admm_and_stream_shapes(card, name, dtype):
    """16^2 windows on 64^2 (few, unevenly many windows per adjoint tile)
    and one streamed batch of 10,000 x 64^2 on 4096^2; float32 is what the
    ADMM coverage weights spread."""
    import numpy as np

    image, positions, patches, p = cases.path_shape_inputs(
        name, card, np.complex64 if dtype == "complex64" else np.float32
    )
    cases.check_patch_kernels(image, positions, patches, p, f"{name}, {dtype}")


def test_adjoint_is_bitwise_repeatable(card):
    image, positions, patches = cases.main_path_patch_inputs(card)
    shape = tuple(image.shape)
    first = patch.patch_adj_cuda(patches, positions, shape, image)
    for _ in range(3):
        again = patch.patch_adj_cuda(patches, positions, shape, image)
        assert torch.equal(torch.view_as_real(again), torch.view_as_real(first))


def test_wrappers_count_launches_and_leave_the_initial_image(card):
    image, positions, patches, p = cases.edge_case("N = 1", card)
    before = dict(patch.LAUNCHES)
    kept = image.clone()
    patch.patch_fwd(image, positions, p)
    patch.patch_adj(patches, positions, tuple(image.shape), image)
    torch.cuda.synchronize()
    assert patch.LAUNCHES["patch_fwd"] == before["patch_fwd"] + 1
    assert patch.LAUNCHES["patch_adj"] == before["patch_adj"] + 1
    assert torch.equal(torch.view_as_real(image), torch.view_as_real(kept))
