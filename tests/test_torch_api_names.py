"""Public functions of tike_tpu's modules that the port's namespaces did not
list, each against its tike_tpu namesake on the same numpy inputs:
``cluster.by_scan_stripes`` and ``by_scan_grid`` (exact, numpy),
``ops.patch.patch_adj_scatter`` (the scatter-add oracle, 1e-5 relative),
``ops.bucket.bucket_cost_program`` and ``bucket_grad_program`` (1e-5, as
``tests/test_torch_bucket.py`` holds their parts) and
``ptycho.exitwave.crop_fourier_space`` (exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tike_tpu.cluster as jcluster
import tike_tpu.ops.bucket as jb
import tike_tpu.ops.patch as jpatch
import tike_tpu.ptycho.exitwave as jexit

import tike_tpu_torch.cluster as tcluster
import tike_tpu_torch.ops.bucket as tb
import tike_tpu_torch.ops.patch as tpatch
import tike_tpu_torch.ptycho.exitwave as texit

from . import _torch_bucket_cases as bucket_cases
from ._torch_parity import assert_close, crandn, positions, rng


@pytest.mark.parametrize("n, fly, axis", [(1, 1, 0), (3, 1, 0), (4, 2, 1), (5, 4, 0)])
def test_by_scan_stripes_matches_jax(n, fly, axis):
    scan = rng(1).uniform(0, 100, (96, 2))
    got = tcluster.by_scan_stripes(scan, n, fly, axis)
    want = jcluster.by_scan_stripes(scan, n, fly, axis)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.sum(got, axis=0).tolist() == [1] * len(scan)


def test_by_scan_stripes_refuses_what_jax_refuses():
    scan = rng(1).uniform(0, 100, (10, 2))
    for args, match in (((scan[0], 2), "two dimensions"), ((scan, 0), "> 0"),
                        ((scan, 2, 3), "multiple")):
        for module in (tcluster, jcluster):
            with pytest.raises(ValueError, match=match):
                module.by_scan_stripes(*args)


@pytest.mark.parametrize("shape, fly", [((1, 1), 1), ((2, 3), 1), ((3, 2), 2)])
def test_by_scan_grid_matches_jax(shape, fly):
    scan = rng(2).uniform(0, 100, (120, 2))
    got = tcluster.by_scan_grid(scan, shape, fly)
    want = jcluster.by_scan_grid(scan, shape, fly)
    assert len(got) == len(want) == shape[0] * shape[1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sorted(np.concatenate(got).tolist()) == list(range(len(scan)))


@pytest.mark.parametrize("with_image", [False, True])
def test_patch_adj_scatter_matches_jax(with_image):
    gen = rng(3)
    h, w, p = 40, 36, 8
    patches = crandn(gen, 30, p, p)
    pos = positions(gen, 30, h, w, p)
    image = crandn(gen, h, w) if with_image else None
    want = jpatch.patch_adj_scatter(
        jnp.asarray(patches), jnp.asarray(pos), (h, w),
        None if image is None else jnp.asarray(image),
    )
    got = tpatch.patch_adj_scatter(
        torch.as_tensor(patches), torch.as_tensor(pos), (h, w),
        None if image is None else torch.as_tensor(image),
    )
    assert_close(got, want, rtol=1e-5, atol=1e-5, scale=True)


def test_bucket_programs_match_jax():
    n, ntheta = 16, 8
    jcfg = jb.BucketConfig(n=n, tilt=np.pi / 3, precision=2)
    tcfg = tb.BucketConfig(n=n, tilt=np.pi / 3, precision=2)
    gen = rng(3)
    u, d = crandn(gen, n, n, n), crandn(gen, ntheta, n, n)
    th, grid = bucket_cases.theta(ntheta, 0.1).numpy(), jb.make_grid(n)
    args = (jnp.asarray(d), jnp.asarray(u), jnp.asarray(th), jnp.asarray(grid))
    targs = (torch.as_tensor(d), torch.as_tensor(u), torch.as_tensor(th))
    assert float(tb.bucket_cost_program(tcfg, *targs)) == pytest.approx(
        float(jb.bucket_cost_program(jcfg, *args)), rel=1e-5
    )
    assert_close(
        tb.bucket_grad_program(tcfg, *targs), jb.bucket_grad_program(jcfg, *args),
        rtol=1e-5, atol=1e-5, scale=True,
    )


@pytest.mark.parametrize("size, w", [(16, 8), (17, 9), (24, 24)])
def test_exitwave_crop_fourier_space_matches_jax(size, w):
    x = crandn(rng(4), 3, size, size)
    np.testing.assert_array_equal(
        texit.crop_fourier_space(x, w), jexit.crop_fourier_space(x, w)
    )
    np.testing.assert_array_equal(
        texit.crop_fourier_space(torch.as_tensor(x), w).numpy(), jexit.crop_fourier_space(x, w)
    )
