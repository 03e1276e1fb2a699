"""tike_tpu_torch.ops.patch against tike_tpu.ops.patch (and its Pallas kernels).

The port's ``patch_fwd``/``patch_adj`` on CPU tensors run their plain
PyTorch versions; on CUDA tensors they launch ``csrc/patch.cu``, which
``chip_smoke.py`` holds against these same plain versions on the card.

Tolerances: the forward is a 4-term float32 blend in both packages
(rtol/atol 1e-5). The adjoint sums up to 4 overlapping window terms per
patch and many patches per pixel in another order than JAX's scatter or
cell-merge path (rtol/atol 1e-4, as ``tests/operators/test_patch_pallas.py``).
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tike_tpu.ops import patch as jpatch
from tike_tpu_torch.ops import patch as tpatch

from . import _torch_parity as H

HW, P, N = 96, 16, 11


def _case(kind: str, seed: int = 3):
    gen = H.rng(seed)
    pos = H.positions(gen, N, HW, HW, P)
    if kind == "integer":
        pos = np.floor(pos)
    elif kind == "edge":
        # Windows past the bottom and right edges read zeros.
        pos = np.concatenate(
            [
                pos[:7],
                np.array(
                    [
                        [HW - P / 2, HW - P / 2],
                        [HW - 1.0, 5.25],
                        [7.5, HW - 3.75],
                        [HW - P - 1.5, HW - P - 0.25],
                    ],
                    np.float32,
                ),
            ]
        ).astype(np.float32)
    return H.crandn(gen, HW, HW), pos, H.crandn(gen, len(pos), P, P)


CASES = ["fractional", "integer", "edge"]


@pytest.mark.parametrize("kind", CASES)
def test_patch_fwd_matches_jax(kind):
    image, pos, _ = _case(kind)
    want = jpatch.patch_fwd(jnp.asarray(image), jnp.asarray(pos), P)
    got = tpatch.patch_fwd(H.t(image), H.t(pos), P)
    assert got.dtype == torch.complex64
    H.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_patch_fwd_real_image_matches_jax():
    image, pos, _ = _case("fractional")
    real = image.real.copy()
    want = jpatch.patch_fwd(jnp.asarray(real), jnp.asarray(pos), P)
    got = tpatch.patch_fwd(H.t(real), H.t(pos), P)
    assert got.dtype == torch.float32
    H.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("initial", [False, True])
def test_patch_adj_matches_jax(kind, initial):
    image, pos, patches = _case(kind)
    init = image if initial else None
    got = tpatch.patch_adj(
        H.t(patches), H.t(pos), (HW, HW), None if init is None else H.t(init)
    )
    assert got.dtype == torch.complex64
    jinit = None if init is None else jnp.asarray(init)
    for oracle in (jpatch.patch_adj, jpatch.patch_adj_scatter):
        want = oracle(jnp.asarray(patches), jnp.asarray(pos), (HW, HW), jinit)
        H.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_patch_adj_dense_scan_matches_jax():
    """More windows than (128 x 128) cells: JAX takes its cell-merge path."""
    gen = H.rng(5)
    pos = H.positions(gen, 64, HW, HW, P)
    patches = H.crandn(gen, 64, P, P)
    got = tpatch.patch_adj(H.t(patches), H.t(pos), (HW, HW))
    for oracle in (jpatch.patch_adj, jpatch.patch_adj_scatter):
        want = oracle(jnp.asarray(patches), jnp.asarray(pos), (HW, HW))
        H.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_patch_adj_leaves_initial_image_unchanged():
    image, pos, patches = _case("fractional")
    init = H.t(image)
    before = init.clone()
    tpatch.patch_adj(H.t(patches), H.t(pos), (HW, HW), init)
    assert torch.equal(init, before)


@pytest.mark.parametrize("kind", CASES)
def test_patch_adjoint_property(kind):
    """<F x, y> == <x, F* y> for the port's own pair."""
    image, pos, patches = _case(kind)
    x, y = H.t(image).to(torch.complex128), H.t(patches).to(torch.complex128)
    fx = tpatch.patch_fwd_plain(x, H.t(pos), P)
    fty = tpatch.patch_adj_plain(y, H.t(pos), (HW, HW))
    lhs = torch.vdot(fx.reshape(-1), y.reshape(-1))
    rhs = torch.vdot(x.reshape(-1), fty.reshape(-1))
    assert abs(complex(lhs - rhs)) <= 1e-10 * abs(complex(lhs))


def test_patch_fwd_pallas_elem_interpret_matches_port():
    import tike_tpu.ops.patch_pallas as pp

    image, pos, _ = _case("edge")
    want = pp.patch_fwd_pallas_elem(
        jnp.asarray(image), jnp.asarray(pos), P, interpret=True
    )
    got = tpatch.patch_fwd(H.t(image), H.t(pos), P)
    H.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_patch_adj_pallas_interpret_matches_port(monkeypatch):
    import tike_tpu.ops.patch_pallas as pp
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, interpret=True, **k)
    )
    image, pos, patches = _case("fractional")
    want = pp.patch_adj_pallas(
        jnp.asarray(patches), jnp.asarray(pos), (HW, HW), jnp.asarray(image)
    )
    got = tpatch.patch_adj(H.t(patches), H.t(pos), (HW, HW), H.t(image))
    H.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_patch_adj_refuses_mismatched_initial_image(bad):
    """An initial image of another dtype or shape raises on the CPU, as it
    does in the CUDA wrapper; neither version casts it."""
    image, pos, patches = _case("fractional")
    init = H.t(image)
    init = init.to(torch.complex128) if bad == "dtype" else init[:-1]
    with pytest.raises(ValueError, match="must be torch.complex64"):
        tpatch.patch_adj(H.t(patches), H.t(pos), (HW, HW), init)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run on the CPU: they raise instead."""
    image, pos, patches = _case("fractional")
    before = dict(tpatch.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tpatch.patch_fwd_cuda(H.t(image), H.t(pos), P)
    with pytest.raises(ValueError, match="CUDA"):
        tpatch.patch_adj_cuda(H.t(patches), H.t(pos), (HW, HW))
    assert tpatch.LAUNCHES == before


def test_wrappers_check_dtype_and_layout():
    image, pos, _ = _case("fractional")
    with pytest.raises(ValueError, match="positions"):
        tpatch._check_positions(H.t(pos.astype(np.float64)), torch.device("cpu"))
    with pytest.raises(ValueError, match="positions"):
        tpatch._check_positions(H.t(pos).t(), torch.device("cpu"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from tike_tpu_torch import kernels

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.find_nvcc()


def test_import_leaves_jax_out():
    code = (
        "import sys, tike_tpu_torch, tike_tpu_torch.ptycho, "
        "tike_tpu_torch.convert, tike_tpu_torch.kernels, tike_tpu_torch.ops; "
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'tike_tpu')); "
        "assert not bad, bad"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
