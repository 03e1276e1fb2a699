"""The striped object's position correction against tike_tpu's.

LSQML position correction on a mesh of CPU shards against tike_tpu's on
``make_mesh`` of the same size (the conftest's virtual CPU devices), from
the same numpy inputs and seed: costs and fields at
``_torch_parity.SLICE_TOL`` (1e-5 of the largest value), the corrected
positions within ``POSITION_PX``, with and without position AdaM, with
the affine regularization, and with positions pinned at the object's
edges, which must stay inside the global object.
"""

import numpy as np
import pytest

import tike_tpu.ptycho as jp

import tike_tpu_torch.ptycho as tp

from . import _torch_parity as H
from . import _torch_striped_cases as C

run_both, check = C.run_both, C.check

# Corrected positions agree within this many pixels: the position step
# divides by small gradient terms, and the stripes' reductions add in
# another order than XLA's (measured up to 4.2e-4 px on 8 stripes over 3
# epochs; the single-device config 2 with position AdaM is held at 5e-4).
POSITION_PX = 5e-4


@pytest.mark.parametrize("adaptive", [False, True])
def test_striped_position_correction_matches_jax(adaptive):
    """LSQML position correction on 4 stripes from perturbed positions
    (magnitude limit 0.2, with and without position AdaM): the positions,
    their moments and the fields against tike_tpu's, and the positions
    moved within the limit."""
    psi, probe, scan, data = C.problem(n=128)
    perturbed = scan + np.random.default_rng(7).uniform(-0.5, 0.5, scan.shape).astype(
        np.float32
    )
    jparams = C.parameters(
        jp, probe, C.start(psi), perturbed, "lstsq",
        position_options=jp.PositionOptions(
            initial_scan=perturbed, update_magnitude_limit=0.2,
            use_adaptive_moment=adaptive,
        ),
    )
    got, want = run_both(data, jparams, 4)
    check(got, want, scan_px=POSITION_PX)
    moved = np.abs(got["scan"] - perturbed).max()
    # The limit bounds the step before AdaM, which rescales it.
    assert 1e-4 < moved and (adaptive or moved < 3 * 0.2 + 1.0)
    H.assert_close(got["position_momentum"], want["position_momentum"],
                   rtol=H.MOMENT_TOL, atol=H.MOMENT_TOL, scale=True)
    np.testing.assert_allclose(got["transform"], want["transform"], rtol=0, atol=1e-4)


def test_striped_position_regularization_matches_jax(monkeypatch):
    """``use_position_regularization``: one-epoch chunks with the affine
    fit applied between them, each fit seeded with ``1000 + epochs`` in
    both packages, on 4 stripes."""
    psi, probe, scan, data = C.problem(n=128)
    A = np.array([[1.004, 0.002], [-0.003, 0.998]], np.float32)
    perturbed = (
        scan @ A.T + np.random.default_rng(3).uniform(-0.3, 0.3, scan.shape)
    ).astype(np.float32)
    jparams = C.parameters(
        jp, probe, C.start(psi), perturbed, "lstsq",
        position_options=jp.PositionOptions(
            initial_scan=perturbed, use_position_regularization=True,
            update_magnitude_limit=0.2,
        ),
    )
    got, want = run_both(data, jparams, 4)
    check(got, want, scan_px=POSITION_PX)
    np.testing.assert_allclose(got["transform"], want["transform"], rtol=0, atol=1e-4)


def test_striped_positions_stay_globally_valid():
    """Positions pinned at the object's top and bottom edges, perturbed and
    corrected on 8 stripes: every result lies in the global window (the
    first stripe's upper halo and the last one's lower halo are outside
    the object), as in tike_tpu, whose result the port's matches."""
    from tike_tpu_torch.ptycho.position import check_allowed_positions

    psi, probe, scan, _ = C.problem(n=128)
    p, h = probe.shape[-1], psi.shape[-2]
    scan = scan.copy()
    scan[:12, 0] = np.linspace(1.0, 2.0, 12)
    scan[12:24, 0] = np.linspace(h - p - 2.0, h - p - 1.1, 12)
    data = tp.simulate(p, probe, scan, psi, device="cpu").astype(np.float32)
    perturbed = scan + np.random.default_rng(3).uniform(-0.7, 0.7, scan.shape).astype(
        np.float32
    )
    perturbed = np.clip(perturbed, 1.0, h - p - 0.01).astype(np.float32)
    jparams = C.parameters(
        jp, probe, C.start(psi), perturbed, "lstsq",
        position_options=jp.PositionOptions(initial_scan=perturbed),
    )
    got, want = run_both(data, jparams, 8)
    check(got, want, scan_px=POSITION_PX)
    check_allowed_positions(got["scan"], got["psi"], got["probe"].shape)
