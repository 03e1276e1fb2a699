"""The striped object on the card: two stripes on one card against the same
stripes on the CPU, and streamed stripes against resident ones.

Every test here needs a CUDA card and ``nvcc``, is marked ``cuda``, and
skips without a card; whether there is one is decided inside each test, so
every worker collects the same tests. On a machine with a card, from the
root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_striped_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which this file
does not import.) ``chip_smoke.py``'s phase 22 runs the same checks at
the main path's width.
"""

import numpy as np
import pytest
import torch

import tike_tpu_torch.parallel as tpar
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch.ops import patch

from . import _torch_striped_cases as C

pytestmark = pytest.mark.cuda

# The small slices' tolerance, card against CPU (chip_smoke.py's SLICE_TOL).
SLICE_TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _run(problem, solver, device, mesh, store=True, **algo):
    psi, probe, scan, data = problem
    params = C.parameters(tp, probe, C.start(psi), scan, solver, algo=algo)
    with tp.Reconstruction(data, params, device=device, random_seed=0, mesh=mesh,
                           object_sharding="striped", store_data_on_device=store) as context:
        context.iterate(3)
        return context.get_result()


@pytest.mark.parametrize("solver", ["lstsq", "rpie"])
def test_two_card_stripes_match_two_cpu_stripes(card, solver):
    problem = C.problem(n=128)
    before = dict(patch.LAUNCHES)
    got = _run(problem, solver, card, tpar.make_mesh(devices=[card] * 2))
    assert all(patch.LAUNCHES[k] > before[k] for k in patch.LAUNCHES)
    want = _run(problem, solver, "cpu", tpar.make_mesh(devices=["cpu"] * 2))
    costs = np.asarray(got.algorithm_options.costs).ravel()
    assert np.all(np.isfinite(costs)) and costs[-1] < costs[0]
    np.testing.assert_allclose(costs, np.asarray(want.algorithm_options.costs).ravel(),
                               rtol=SLICE_TOL)
    for key in ("psi", "probe"):
        a, b = getattr(got, key), getattr(want, key)
        np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())


@pytest.mark.parametrize("solver", ["lstsq", "rpie"])
def test_streamed_card_stripes_are_resident_bit_for_bit(card, solver):
    problem = C.problem(n=128)
    mesh = tpar.make_mesh(devices=[card] * 2)
    resident = _run(problem, solver, card, mesh, batch_method="wobbly_center")
    streamed = _run(problem, solver, card, mesh, store=False, batch_method="wobbly_center")
    assert streamed.algorithm_options.costs == resident.algorithm_options.costs
    for key in ("psi", "probe", "scan"):
        np.testing.assert_array_equal(getattr(streamed, key), getattr(resident, key))


def test_eight_card_stripes_with_overlapping_seams_match_the_cpu(card):
    """8 stripes of the 160-row object on the card (2 halo > hs) against
    8 CPU stripes."""
    problem = C.problem(n=128)
    got = _run(problem, "rpie", card, tpar.make_mesh(devices=[card] * 8))
    want = _run(problem, "rpie", "cpu", tpar.make_mesh(devices=["cpu"] * 8))
    for key in ("psi", "probe"):
        a, b = getattr(got, key), getattr(want, key)
        np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())
