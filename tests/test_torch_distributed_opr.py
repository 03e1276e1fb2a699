"""``dp_lstsq_opr_pos`` of the two-process matrix (LSQML with eigen weights
and position correction under the affine regularization, the per-epoch
path) in one process of each package: the port's run of the global program
(``_force_stripes=2`` on 4 CPU shards) against tike_tpu's on 4 of the
conftest's virtual CPU devices at 1e-5, tike_tpu's unseeded affine fit
handed the port's generator (``_torch_parity.seed_jax_position_fit``). Its
own file: tike_tpu's per-epoch path compiles for longer than the others'.
"""

from . import _torch_parity as H
from ._torch_dist_jax import check_scenario_against_jax


def test_lstsq_opr_positions_matches_jax(monkeypatch):
    H.seed_jax_position_fit(monkeypatch)
    check_scenario_against_jax("dp_lstsq_opr_pos")
