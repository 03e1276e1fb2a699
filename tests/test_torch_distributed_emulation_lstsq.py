"""The multi-process layout in one process, against tike_tpu's: LSQML.

``Reconstruction(..., _force_stripes=2)`` on a mesh of 4 CPU shards lays
the patterns out as two processes would (``distributed.striped_batches``:
two stripes along the row coordinate, each batch's slots stripe after
stripe) and runs the same global program. tike_tpu's hook of that name on
4 of the conftest's virtual CPU devices is held to its own two-process run
by ``tests/parallel/test_distributed.py``; here the port's emulation is
held to tike_tpu's at ``_torch_parity.SLICE_TOL`` (1e-5 of the largest
value), LSQML, resident and host-streamed, on that test's problem
(``tests/parallel/_dist_worker.py``), and the port's streamed run to its
resident run bit for bit (``tests/_torch_dist_jax.py``).
"""

import pytest

from . import _torch_dist_jax as D
from .parallel._dist_worker import build_problem


@pytest.fixture(scope="module")
def runs():
    return D.emulation_runs(build_problem(), "lstsq")


@pytest.mark.parametrize("store", [True, False], ids=["resident", "streamed"])
def test_force_stripes_matches_jax(runs, store):
    D.check_emulation(runs, store)


def test_force_stripes_streamed_is_resident_bit_for_bit(runs):
    D.check_streamed_is_resident(runs)
