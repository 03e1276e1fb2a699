"""The CUDA kernel of the Gaussian model's far-field step
(``csrc/farplane.cu``) against its plain PyTorch version, on the card.

Every test here needs a CUDA card and ``nvcc``, is marked ``cuda``, and
skips without a card; whether there is one is decided inside each test, so
every worker collects the same tests. On a machine with a card, from the
root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_farplane_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which this file
does not import.) The cases and tolerances are
``tests/_torch_farplane_cases.py``'s.
"""

import pytest
import torch

from tike_tpu_torch.ops import objective

from . import _torch_farplane_cases as cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build csrc/farplane.cu)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", list(cases.CASES))
def test_kernel_matches_plain(card, name):
    data, farplane, mask, scaling = cases.case_inputs(name, card, b=24)
    cases.check_kernel(data, farplane, mask, scaling, name)


@pytest.mark.parametrize("mode_axes", [(1, 1), (3,)], ids=["1 mode", "3 modes"])
def test_kernel_matches_plain_at_main_path_shapes(card, mode_axes):
    data, farplane, mask = cases.inputs(
        mode_axes, cases.MAIN_D, True, b=cases.MAIN_PATTERNS, seed=1, device=card
    )
    cases.check_kernel(data, farplane, mask, 0.5, str(mode_axes))


def test_dispatch_launches_the_kernel_and_counts(card):
    data, farplane, mask, scaling = cases.case_inputs("lsqml 1 mode, unmeasured", card)
    before = objective.LAUNCHES["farplane_gaussian"]
    got = objective.gaussian_farplane(data, farplane.clone(), mask, scaling)
    want = objective.gaussian_farplane_cuda(data, farplane.clone(), mask, scaling)
    assert objective.LAUNCHES["farplane_gaussian"] == before + 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_inputs_not_contiguous_or_aligned_give_the_same_result(card):
    data, farplane, mask, scaling = cases.case_inputs("rpie 3 modes, unmeasured, s 0.5", card)
    want = objective.gaussian_farplane_cuda(data, farplane.clone(), mask, scaling)
    # Every other pattern, transposed pixels: copied by the wrapper.
    wide = torch.stack([data, data], dim=1)[:, 0]
    transposed = data.transpose(-2, -1).contiguous().transpose(-2, -1)
    for strided in (wide, transposed):
        assert not strided.is_contiguous()
        got = objective.gaussian_farplane_cuda(strided, farplane.clone(), mask, scaling)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # A farplane not contiguous: chi is written over the wrapper's copy.
    wide = torch.stack([farplane, farplane], dim=1)[:, 0]
    kept = wide.clone()
    got = objective.gaussian_farplane_cuda(data, wide, mask, scaling)
    assert torch.equal(wide, kept)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # A farplane 8 bytes past a 16-byte boundary: one pixel at a time.
    storage = torch.empty(farplane.numel() + 1, dtype=farplane.dtype, device=card)
    shifted = storage[1:].view(farplane.shape)
    shifted.copy_(farplane)
    assert shifted.data_ptr() % 16 == 8
    cost_gap, chi_gap = cases.gaps(objective.gaussian_farplane_cuda(data, shifted, mask, scaling), want)
    assert cost_gap <= cases.COST_TOL and chi_gap <= cases.CHI_TOL


def test_kernel_refuses_inputs_it_does_not_take(card):
    data, farplane, mask, scaling = cases.case_inputs("rpie 3 modes", card, b=2)
    before = objective.LAUNCHES["farplane_gaussian"]
    for args in (
        (data.double(), farplane, mask, scaling),
        (data, farplane.to(torch.complex128), mask, scaling),
        (data, farplane, mask.to(torch.uint8), scaling),
        (data[:1], farplane, mask, scaling),
        (data.cpu(), farplane, mask, scaling),
        (data, farplane, mask, torch.tensor(0.5, device=card)),
    ):
        with pytest.raises(ValueError):
            objective.gaussian_farplane(*args)
    assert objective.LAUNCHES["farplane_gaussian"] == before


def test_empty_batch_launches_nothing(card):
    data, farplane, mask, scaling = cases.case_inputs("rpie 3 modes", card, b=2)
    before = objective.LAUNCHES["farplane_gaussian"]
    costs, chi = objective.gaussian_farplane_cuda(data[:0], farplane[:0], mask, scaling)
    assert costs.shape == (0,) and chi.shape == farplane[:0].shape
    assert objective.LAUNCHES["farplane_gaussian"] == before
