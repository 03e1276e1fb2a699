"""Bilinear patch extraction / accumulation at fractional scan positions.

Counterpart of :mod:`tike_tpu.ops.patch`. ``patch_fwd`` gathers a
(P, P) patch at each (y, x) min-corner position, blending the four
one-pixel-shifted corners of the (P+1, P+1) window at ``floor(position)``
with weights (1-fy)(1-fx), (1-fy)fx, fy(1-fx) and fy*fx. ``patch_adj`` is
its exact transpose: each patch is spread over its window with the same
weights and added into the image.

Boundary semantics follow ``tike_tpu/ops/patch.py:18-28``: pixels outside
the image read as zero in the forward and are dropped in the adjoint, so
windows may run past the bottom or right edge. Negative corners, which the
JAX package leaves undefined, read zero here; ``check_allowed_positions``
rejects them before any solver runs.

Each operator has two implementations:

- a plain PyTorch version (``patch_fwd_plain``, ``patch_adj_plain``): an
  indexed gather plus the 4-term blend, and an ``index_add_`` of the spread
  windows;
- a hand-written CUDA kernel (``csrc/patch.cu``, ``patch_fwd_cuda``,
  ``patch_adj_cuda``), which replaces the Pallas TPU kernels of
  ``tike_tpu/ops/patch_pallas.py``.

``patch_fwd`` and ``patch_adj`` dispatch on the device of the tensors they
are given: CPU tensors take the plain version, CUDA tensors launch the
kernel or raise. Nothing falls back from one to the other. The helpers
``patch_fwd_padded`` and the Fourier-shift pair ``patch_fwd_fourier`` /
``patch_adj_fourier`` run on the two.
"""

from __future__ import annotations

import typing

import torch

from .. import kernels

LAUNCHES = {"patch_fwd": 0, "patch_adj": 0}
"""How many times each CUDA kernel has been launched in this process.
Incremented only by a successful launch; callers may reset them to 0."""

_DTYPES = (torch.complex64, torch.float32)


def _split_positions(positions: torch.Tensor):
    """Split float positions into integer corners and fractional weights."""
    lo = torch.floor(positions)
    return lo.to(torch.int64), positions - lo


def _window_index(corner: torch.Tensor, p: int, h: int, w: int):
    """Flat image indices of each (P+1, P+1) window, and which lie inside."""
    span = torch.arange(p + 1, device=corner.device)
    rows = corner[:, 0:1] + span  # (N, P+1)
    cols = corner[:, 1:2] + span  # (N, P+1)
    inside = ((rows >= 0) & (rows < h))[:, :, None] & (
        (cols >= 0) & (cols < w)
    )[:, None, :]
    flat = (
        rows.clamp(0, h - 1)[:, :, None] * w + cols.clamp(0, w - 1)[:, None, :]
    )
    return flat, inside


def patch_fwd_plain(
    images: torch.Tensor, positions: torch.Tensor, patch_width: int
) -> torch.Tensor:
    """Plain PyTorch ``patch_fwd``: indexed window gather + bilinear blend.

    images (H, W) complex64 or float32; positions (N, 2) float32 (y, x)
    min-corners. Returns (N, P, P) of the images' dtype.
    """
    p = patch_width
    h, w = images.shape
    corner, frac = _split_positions(positions)
    flat, inside = _window_index(corner, p, h, w)
    win = torch.where(inside, images.reshape(-1)[flat], 0)  # (N, P+1, P+1)
    fy = frac[:, 0, None, None]
    fx = frac[:, 1, None, None]
    return (
        (1 - fy) * (1 - fx) * win[:, :-1, :-1]
        + (1 - fy) * fx * win[:, :-1, 1:]
        + fy * (1 - fx) * win[:, 1:, :-1]
        + fy * fx * win[:, 1:, 1:]
    ).to(images.dtype)


def _spread_windows(patches: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Spread (N, P, P) patches into (N, P+1, P+1) bilinear windows."""
    n, p, _ = patches.shape
    fy = frac[:, 0, None, None]
    fx = frac[:, 1, None, None]
    win = patches.new_zeros((n, p + 1, p + 1))
    win[:, :-1, :-1] += (1 - fy) * (1 - fx) * patches
    win[:, :-1, 1:] += (1 - fy) * fx * patches
    win[:, 1:, :-1] += fy * (1 - fx) * patches
    win[:, 1:, 1:] += fy * fx * patches
    return win


def patch_adj_plain(
    patches: torch.Tensor,
    positions: torch.Tensor,
    images_shape: typing.Tuple[int, int],
    images: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch ``patch_adj``: ``index_add_`` of the spread windows.

    patches (N, P, P); positions (N, 2) float32; ``images`` an optional
    (H, W) initial image of the patches' dtype, which is not modified.
    Returns (H, W) of the patches' dtype.
    """
    h, w = (int(s) for s in images_shape)
    p = patches.shape[-1]
    corner, frac = _split_positions(positions)
    win = _spread_windows(patches, frac)
    flat, inside = _window_index(corner, p, h, w)
    if images is None:
        acc = patches.new_zeros(h * w)
    else:
        _check_initial_image(images, patches, h, w)
        acc = images.reshape(-1).clone()
    # Accumulate on the float view: (H*W, 2) re/im pairs for complex input.
    _real_view(acc).index_add_(0, flat[inside], _real_view(win[inside]))
    return acc.reshape(h, w)


def patch_adj_scatter(
    patches: torch.Tensor,
    positions: torch.Tensor,
    images_shape: typing.Tuple[int, int],
    images: torch.Tensor | None = None,
) -> torch.Tensor:
    """``patch_adj`` as one scatter-add, on any device: the oracle
    formulation of :func:`tike_tpu.ops.patch.patch_adj_scatter`, which
    :func:`patch_adj_plain` computes (``index_add_``). The hand-written
    kernel behind :func:`patch_adj` is the production version."""
    return patch_adj_plain(patches, positions, images_shape, images)


def _real_view(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def _check_positions(positions: torch.Tensor, device: torch.device) -> None:
    if (
        positions.dtype != torch.float32
        or positions.dim() != 2
        or positions.shape[1] != 2
        or not positions.is_contiguous()
        or positions.device != device
        or positions.data_ptr() % 8
    ):
        raise ValueError(
            "positions must be a contiguous, 8-byte aligned (N, 2) float32 "
            f"tensor on {device}; got {positions.dtype} "
            f"{tuple(positions.shape)} on {positions.device}"
        )


def _check_field(
    name: str, x: torch.Tensor, ndim: int, device: torch.device | None = None
) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, not on {x.device}")
    if device is not None and x.device != device:
        raise ValueError(f"{name} is on {x.device}, not on {device}")
    if x.dtype not in _DTYPES or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {ndim}-D complex64 or float32 "
            f"tensor; got {x.dtype} {tuple(x.shape)} "
            f"(contiguous={x.is_contiguous()})"
        )
    if x.data_ptr() % 8:
        raise ValueError(f"{name} must be 8-byte aligned")


def _check_initial_image(
    images: torch.Tensor, patches: torch.Tensor, h: int, w: int
) -> None:
    """Both versions of ``patch_adj`` take only an (H, W) initial image of
    the patches' dtype; neither casts."""
    if tuple(images.shape) != (h, w) or images.dtype != patches.dtype:
        raise ValueError(
            f"images {images.dtype} {tuple(images.shape)} must be "
            f"{patches.dtype} {(h, w)}"
        )


def _raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def patch_fwd_cuda(
    images: torch.Tensor, positions: torch.Tensor, patch_width: int
) -> torch.Tensor:
    """Launch the CUDA ``patch_fwd`` kernel (``csrc/patch.cu``)."""
    _check_field("images", images, 2)
    _check_positions(positions, images.device)
    n = positions.shape[0]
    h, w = images.shape
    p = int(patch_width)
    out = torch.empty((n, p, p), dtype=images.dtype, device=images.device)
    lib = kernels.load("patch")
    with torch.cuda.device(images.device):
        rc = lib.tike_patch_fwd(
            images.data_ptr(),
            positions.data_ptr(),
            out.data_ptr(),
            n,
            h,
            w,
            p,
            2 if images.is_complex() else 1,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("patch_fwd", rc)
    LAUNCHES["patch_fwd"] += 1
    return out


def patch_adj_cuda(
    patches: torch.Tensor,
    positions: torch.Tensor,
    images_shape: typing.Tuple[int, int],
    images: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the CUDA ``patch_adj`` kernel (``csrc/patch.cu``).

    The kernel writes every pixel of a fresh output once: ``images`` (or
    zero) plus the spread patches, summed with no atomics in an order the
    inputs fix, so the result is the same bit for bit from run to run.
    ``images`` is read, never written.
    """
    _check_field("patches", patches, 3)
    _check_positions(positions, patches.device)
    n, p, p2 = patches.shape
    if p != p2 or positions.shape[0] != n:
        raise ValueError(
            f"patches {tuple(patches.shape)} must be (N, P, P) with "
            f"N = {positions.shape[0]} positions"
        )
    h, w = (int(s) for s in images_shape)
    if images is not None:
        _check_field("images", images, 2, patches.device)
        _check_initial_image(images, patches, h, w)
    out = torch.empty((h, w), dtype=patches.dtype, device=patches.device)
    lib = kernels.load("patch")
    with torch.cuda.device(patches.device):
        rc = lib.tike_patch_adj(
            patches.data_ptr(),
            positions.data_ptr(),
            None if images is None else images.data_ptr(),
            out.data_ptr(),
            n,
            h,
            w,
            p,
            2 if patches.is_complex() else 1,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("patch_adj", rc)
    LAUNCHES["patch_adj"] += 1
    return out


def roofline_bytes(
    n: int,
    p: int,
    h: int,
    w: int,
    dtype: torch.dtype,
    initial: bool = False,
    *,
    image_pixels: int | None = None,
    patch_values: int | None = None,
) -> int:
    """The bytes either patch operator must move at the least: the N P^2
    patch values (written by ``patch_fwd``, read by ``patch_adj``), the
    (H, W) image once (read by the one, written by the other), the (N, 2)
    float32 positions, and the initial image once more when ``patch_adj``
    starts from one.

    What a call's positions need (:func:`needed_values`) may replace the
    H W image pixels (``image_pixels``: all that ``patch_fwd`` reads) or the
    N P^2 patch values (``patch_values``: all that ``patch_adj`` reads)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    image = (h * w if image_pixels is None else image_pixels) * itemsize
    values = n * p * p if patch_values is None else patch_values
    return values * itemsize + image * (2 if initial else 1) + n * 2 * 4


def needed_values(
    positions: torch.Tensor, p: int, h: int, w: int
) -> typing.Tuple[int, int]:
    """What the windows at ``positions`` need of an (H, W) image and of
    their (N, P, P) patches: the image pixels that some (P+1)^2 window
    touches, which is all ``patch_fwd`` must read, and the patch values with
    a bilinear tap inside the image, which is all ``patch_adj`` must read.
    Counted on the positions' device."""
    corner = torch.floor(positions).to(torch.int64)
    cy, cx = corner[:, 0], corner[:, 1]
    # The union of the windows' rows [cy, cy + P] x columns [cx, cx + P],
    # clipped to the image: +1 and -1 at the corners of each, summed along
    # both axes, is how many windows cover each pixel.
    r0, r1 = cy.clamp(0, h), (cy + p + 1).clamp(0, h)
    c0, c1 = cx.clamp(0, w), (cx + p + 1).clamp(0, w)
    edges = torch.zeros((h + 1, w + 1), dtype=torch.int64, device=positions.device)
    for rows, cols, sign in ((r0, c0, 1), (r0, c1, -1), (r1, c0, -1), (r1, c1, 1)):
        edges.index_put_((rows, cols), torch.full_like(rows, sign), accumulate=True)
    pixels = int((edges.cumsum(0).cumsum(1)[:h, :w] > 0).sum())
    # Patch row i taps window rows cy + i and cy + i + 1; it is needed when
    # one of them lies in [0, H). Columns alike.
    rows = ((h - 1 - cy).clamp(max=p - 1) - (-1 - cy).clamp(min=0) + 1).clamp(min=0)
    cols = ((w - 1 - cx).clamp(max=p - 1) - (-1 - cx).clamp(min=0) + 1).clamp(min=0)
    return pixels, int((rows * cols).sum())


def patch_fwd(
    images: torch.Tensor, positions: torch.Tensor, patch_width: int
) -> torch.Tensor:
    """Extract bilinearly-interpolated square patches from an image.

    images (H, W) complex64 (or float32); positions (N, 2) float32 (y, x)
    min-corners. Returns (N, P, P). CPU tensors take the plain version;
    CUDA tensors launch the kernel.
    """
    if kernels.on_cpu(images, positions):
        return patch_fwd_plain(images, positions, patch_width)
    return patch_fwd_cuda(images, positions, patch_width)


def patch_adj(
    patches: torch.Tensor,
    positions: torch.Tensor,
    images_shape: typing.Tuple[int, int],
    images: torch.Tensor | None = None,
) -> torch.Tensor:
    """Adjoint of :func:`patch_fwd`: accumulate patches into an image.

    patches (N, P, P); positions (N, 2) float32; ``images`` an optional
    (H, W) initial image. Returns (H, W). CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if kernels.on_cpu(patches, positions, images):
        return patch_adj_plain(patches, positions, images_shape, images)
    return patch_adj_cuda(patches, positions, images_shape, images)


def patch_fwd_padded(
    images: torch.Tensor,
    positions: torch.Tensor,
    patch_width: int,
    padded_width: int,
) -> torch.Tensor:
    """Extract patches zero-padded to ``padded_width`` (the detector's).

    The P x P patch of :func:`patch_fwd` sits centred, at the offset
    ``(padded_width - patch_width) // 2``.
    """
    patches = patch_fwd(images, positions, patch_width)
    pad = (padded_width - patch_width) // 2
    if padded_width == patch_width:
        return patches
    rest = padded_width - patch_width - pad
    return torch.nn.functional.pad(patches, (pad, rest, pad, rest))


def patch_fwd_fourier(
    images: torch.Tensor,
    positions: torch.Tensor,
    patch_width: int,
) -> torch.Tensor:
    """Patch extraction with Fourier-shift sub-pixel interpolation.

    :func:`patch_fwd` at the integer corner, then the fractional part as
    a Fourier phase-ramp shift of each patch (band-limited, sinc,
    interpolation where :func:`patch_fwd` is bilinear).
    """
    from .shift import shift_adj

    lo = torch.floor(positions)
    patches = patch_fwd(images, lo, patch_width)
    return shift_adj(patches, positions - lo)


def patch_adj_fourier(
    patches: torch.Tensor,
    positions: torch.Tensor,
    images_shape: typing.Tuple[int, int],
    images: torch.Tensor | None = None,
) -> torch.Tensor:
    """Adjoint of :func:`patch_fwd_fourier`."""
    from .shift import shift_fwd

    lo = torch.floor(positions)
    return patch_adj(shift_fwd(patches, positions - lo), lo, images_shape, images)
