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
from . import _torch_patch_cases as cases

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
    """The port, ``chip_smoke.py`` among its users, imports neither JAX nor
    tike_tpu; nor matplotlib or h5py, which ``view`` and ``ptycho.io``
    import only when called (the card's machine has neither)."""
    code = (
        "import sys, tike_tpu_torch, tike_tpu_torch.ptycho, "
        "tike_tpu_torch.convert, tike_tpu_torch.kernels, tike_tpu_torch.ops, "
        "tike_tpu_torch.ops.usfft, tike_tpu_torch.ops.lamino, tike_tpu_torch.lamino, "
        "tike_tpu_torch.lamino.solvers, tike_tpu_torch.toolchain_probe, "
        "tike_tpu_torch.profile_epoch, tike_tpu_torch.opt, tike_tpu_torch.admm, "
        "tike_tpu_torch.constants, tike_tpu_torch.ptycho.stream, tike_tpu_torch.ops.bucket, "
        "tike_tpu_torch.lamino.bucket, tike_tpu_torch.checkpoint, tike_tpu_torch.align, "
        "tike_tpu_torch.align.solvers, tike_tpu_torch.ops.interp, tike_tpu_torch.random, "
        "tike_tpu_torch.scan, tike_tpu_torch.trajectory, tike_tpu_torch.ptycho.fresnel, "
        "tike_tpu_torch.ptycho.learn, tike_tpu_torch.ptycho.io, tike_tpu_torch.view, chip_smoke; "
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'tike_tpu', 'matplotlib', 'h5py')); "
        "assert not bad, bad"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)


@pytest.mark.parametrize(
    "dtype, initial, want",
    [
        # 1,000 x 128^2 patches + one 1500^2 image + 8,000 bytes of positions
        (torch.complex64, False, 131_072_000 + 18_000_000 + 8_000),
        (torch.float32, False, 65_536_000 + 9_000_000 + 8_000),
        (torch.complex64, True, 131_072_000 + 2 * 18_000_000 + 8_000),
    ],
)
def test_roofline_bytes_at_main_path_shapes(dtype, initial, want):
    got = tpatch.roofline_bytes(1000, 128, 1500, 1500, dtype, initial)
    assert got == want
    if dtype == torch.complex64 and not initial:
        assert got == 149_080_000


def _covering_positions(n=1000, p=128, hw=1500, seed=0):
    """n fractional positions whose windows all lie inside an hw^2 image
    and together touch every pixel: a 12 x 12 grid of windows from edge to
    edge, then random ones."""
    edge = np.linspace(0, hw - p - 1, 12)
    grid = np.stack(np.meshgrid(edge, edge, indexing="ij"), -1).reshape(-1, 2)
    grid = grid + 0.5  # corners up to hw - p - 1: the last window ends at hw - 1
    rest = H.positions(H.rng(seed), n - len(grid), hw, hw, p)
    return torch.tensor(np.concatenate([grid, rest]).astype(np.float32))


def test_chip_smoke_bound_at_main_path_shapes():
    """The bound ``chip_smoke.py`` reports beside each kernel: with every
    pixel touched and every window inside, 149.08 MB at 3.35 TB/s for
    either kernel, well above the float32 flops at 67 TFLOP/s."""
    pos = _covering_positions()
    assert tpatch.needed_values(pos, 128, 1500, 1500) == (1500 * 1500, 1000 * 128 * 128)
    for name in ("patch_fwd", "patch_adj"):
        bound = cases.roofline(name, pos, 128, (1500, 1500), torch.complex64)
        assert bound["bound_bytes"] == 149_080_000
        assert bound["bound_by"] == "bytes"
        assert bound["bound_ms"] == pytest.approx(149_080_000 / 3.35e12 * 1e3)


def test_compact_batch_bound_counts_only_what_its_windows_touch():
    """1,000 windows packed into a disc near the middle touch a fraction
    of the image: the forward's bound reads only those pixels, while the
    adjoint still writes the whole image and reads every patch value."""
    gen = H.rng(1)
    angle, radius = gen.uniform(0, 2 * np.pi, 1000), 245 * np.sqrt(gen.uniform(size=1000))
    pos = torch.tensor(
        (686 + radius[:, None] * np.stack([np.sin(angle), np.cos(angle)], -1)).astype(
            np.float32
        )
    )
    pixels, values = tpatch.needed_values(pos, 128, 1500, 1500)
    # The disc of radius 245 widened by the windows: within its bounding
    # square of (2 * 245 + 129)^2 pixels, and more than the disc itself.
    assert np.pi * 245**2 < pixels < (2 * 245 + 129) ** 2
    assert values == 1000 * 128 * 128
    fwd = cases.roofline("patch_fwd", pos, 128, (1500, 1500), torch.complex64)
    adj = cases.roofline("patch_adj", pos, 128, (1500, 1500), torch.complex64)
    assert fwd["bound_bytes"] == 131_072_000 + 8 * pixels + 8_000
    assert adj["bound_bytes"] == 149_080_000


def test_roofline_bytes_counts_what_the_data_needs():
    got = tpatch.roofline_bytes(
        1000, 128, 1500, 1500, torch.complex64, image_pixels=330_000
    )
    assert got == 131_072_000 + 330_000 * 8 + 8_000
    got = tpatch.roofline_bytes(
        1000, 128, 1500, 1500, torch.float32, True, patch_values=16_000_000
    )
    assert got == 16_000_000 * 4 + 2 * 9_000_000 + 8_000


def _needed_by_brute_force(pos, p, h, w):
    """needed_values by looping over every window pixel and patch value."""
    touched = np.zeros((h, w), bool)
    values = 0
    for y, x in np.floor(pos).astype(int):
        for i in range(p + 1):
            for j in range(p + 1):
                if 0 <= y + i < h and 0 <= x + j < w:
                    touched[y + i, x + j] = True
        rows = [i for i in range(p) if 0 <= y + i < h or 0 <= y + i + 1 < h]
        cols = [j for j in range(p) if 0 <= x + j < w or 0 <= x + j + 1 < w]
        values += len(rows) * len(cols)
    return int(touched.sum()), values


@pytest.mark.parametrize("name", ["negative corners", "windows wholly outside",
                                  "N = 0", "odd P = 37", "float32, odd W"])
def test_needed_values_match_brute_force(name):
    image, pos, _, p = cases.edge_case(name, torch.device("cpu"))
    h, w = image.shape
    got = tpatch.needed_values(pos, p, h, w)
    assert got == _needed_by_brute_force(pos.numpy(), p, h, w)


@pytest.mark.parametrize("name", ["negative corners", "windows wholly outside",
                                  "odd P = 37", "float32, odd W"])
def test_edge_cases_plain_pair_is_adjoint(name):
    """The plain versions that the kernels are held to on the card stay an
    exact adjoint pair on the kernels' edge cases (float64)."""
    image, pos, patches, p = cases.edge_case(name, torch.device("cpu"))
    wide = torch.complex128 if image.is_complex() else torch.float64
    x, y = image.to(wide), patches.to(wide)
    fx = tpatch.patch_fwd_plain(x, pos, p)
    fty = tpatch.patch_adj_plain(y, pos, tuple(image.shape))
    lhs = torch.vdot(fx.reshape(-1), y.reshape(-1))
    rhs = torch.vdot(x.reshape(-1), fty.reshape(-1))
    assert abs(complex(lhs - rhs)) <= 1e-10 * abs(complex(lhs))


@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
def test_path_shape_inputs_of_the_admm_angle(dtype):
    """The 16^2-window case the card holds the kernels to: seeded inputs of
    the stated shapes, windows inside the image, and the plain pair an
    adjoint pair on them."""
    name = next(n for n in cases.PATH_SHAPES if n.startswith("admm"))
    n, p, hw = cases.PATH_SHAPES[name]
    image, pos, patches, got_p = cases.path_shape_inputs(name, torch.device("cpu"), dtype)
    assert (got_p, tuple(image.shape), tuple(patches.shape)) == (p, (hw, hw), (n, p, p))
    assert image.dtype == patches.dtype == torch.tensor(np.zeros(1, dtype)).dtype
    assert float(pos.min()) >= 2 and float(pos.max()) <= hw - p - 3
    again = cases.path_shape_inputs(name, torch.device("cpu"), dtype)
    assert torch.equal(again[1], pos) and torch.equal(again[2], patches)
    fx = tpatch.patch_fwd_plain(image, pos, p)
    fty = tpatch.patch_adj_plain(patches, pos, (hw, hw))
    lhs = torch.vdot(fx.reshape(-1), patches.reshape(-1))
    rhs = torch.vdot(image.reshape(-1), fty.reshape(-1))
    assert abs(complex(lhs - rhs)) <= 1e-4 * abs(complex(lhs))
    assert sorted(cases.PATH_SHAPES.values()) == [(200, 16, 64), (10_000, 64, 4096)]


def test_edge_case_stack_overflows_one_tile():
    """5,000 windows on one tile, with sums that are exact in float32: more
    than the adjoint kernel's list of 1,024 holds, and any order of
    summation gives the same image."""
    image, pos, patches, p = cases.edge_case(
        "5,000 windows on one tile", torch.device("cpu")
    )
    corner = torch.floor(pos)
    covers = (corner <= 70) & (corner + p >= 70)  # pixel (70, 70)
    assert int(covers.all(dim=1).sum()) == 5000
    want = tpatch.patch_adj_plain(patches, pos, tuple(image.shape))
    order = torch.randperm(len(pos), generator=torch.Generator().manual_seed(0))
    got = tpatch.patch_adj_plain(patches[order], pos[order], tuple(image.shape))
    assert torch.equal(got, want)


@pytest.mark.parametrize("initial", [False, True])
def test_library_yardsticks_compute_the_same_function(initial):
    """``chip_smoke.py``'s library calls (``grid_sample`` and its input
    gradient) agree with the plain versions, windows past the edges
    included, to the 1e-3 relative tolerance it states."""
    image, pos, patches = _case("edge")
    image, pos, patches = H.t(image), H.t(pos), H.t(patches)
    planar, grid = cases.grid_sample_inputs(image, pos, P)
    fwd = torch.nn.functional.grid_sample(
        planar, grid, mode="bilinear", padding_mode="zeros", align_corners=True
    )
    cases.check_library(
        "patch_fwd",
        cases.planar_to_complex(fwd, (len(pos), P, P)),
        tpatch.patch_fwd_plain(image, pos, P),
    )
    grad = torch.view_as_real(patches).permute(3, 0, 1, 2).reshape(
        1, 2, len(pos) * P, P
    )
    adj = torch.ops.aten.grid_sampler_2d_backward(
        grad, planar, grid, 0, 0, True, [True, False]
    )[0]
    init = image if initial else None
    want = tpatch.patch_adj_plain(patches, pos, (HW, HW), init)
    got = cases.planar_to_complex(adj, (HW, HW)) + (0 if init is None else init)
    cases.check_library("patch_adj", got, want)


@pytest.mark.parametrize("padded", [P, P + 8, P + 9])
def test_patch_fwd_padded_matches_jax(padded):
    """The window centred at (padded - P) // 2, zeros around it."""
    images, pos, _ = _case("fractional")
    want = jpatch.patch_fwd_padded(jnp.asarray(images), jnp.asarray(pos), P, padded)
    got = tpatch.patch_fwd_padded(H.t(images), H.t(pos), P, padded)
    assert tuple(got.shape) == (N, padded, padded)
    H.assert_close(got, want, rtol=1e-5, atol=1e-5)
    pad = (padded - P) // 2
    np.testing.assert_array_equal(
        H.n(got)[:, pad : pad + P, pad : pad + P], H.n(tpatch.patch_fwd(H.t(images), H.t(pos), P))
    )


@pytest.mark.parametrize("initial", [False, True], ids=["zeros", "initial"])
def test_fourier_pair_matches_jax(initial):
    """``patch_fwd_fourier`` and ``patch_adj_fourier`` against tike_tpu's,
    and against each other: <fwd x, y> = <x, adj y>."""
    images, pos, patches = _case("fractional")
    gen = H.rng(9)
    start = H.crandn(gen, HW, HW) if initial else None
    want_fwd = jpatch.patch_fwd_fourier(jnp.asarray(images), jnp.asarray(pos), P)
    got_fwd = tpatch.patch_fwd_fourier(H.t(images), H.t(pos), P)
    H.assert_close(got_fwd, want_fwd, rtol=1e-5, atol=1e-5, scale=True)
    want_adj = jpatch.patch_adj_fourier(
        jnp.asarray(patches), jnp.asarray(pos), (HW, HW),
        None if start is None else jnp.asarray(start),
    )
    got_adj = tpatch.patch_adj_fourier(
        H.t(patches), H.t(pos), (HW, HW), None if start is None else H.t(start)
    )
    H.assert_close(got_adj, want_adj, rtol=1e-4, atol=1e-4, scale=True)
    if start is None:
        lhs = np.vdot(H.n(got_fwd), patches)
        rhs = np.vdot(images, H.n(got_adj))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-4)
