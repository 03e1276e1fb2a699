"""Noise-model cost functions and gradients for ptychography (PyTorch).

Counterpart of :mod:`tike_tpu.ops.objective`. Costs are means (not sums)
so values are comparable across mini-batch sizes.

:func:`gaussian_farplane` is the solvers' far-field step under the
Gaussian model, from the farplane to the exit-wave update: the intensity,
each pattern's cost over the measured pixels, the amplitude gradient and
the unmeasured pixels' scaling. CPU tensors take its plain version
(:func:`gaussian_farplane_plain`); CUDA tensors launch one hand-written
kernel (``csrc/farplane.cu``) that makes the whole step in one pass.
"""

from __future__ import annotations

import math
import numbers

import torch

from .. import kernels

LAUNCHES = {"farplane_gaussian": 0}
"""How many times the CUDA kernel has been launched in this process.
Incremented only by a successful launch; callers may reset it to 0."""


def _masked_mean_each_pattern(elem, pixel_mask):
    """Per-pattern mean over measured pixels only.

    Counterpart of ``tike_tpu.ptycho.solvers.rpie._masked_mean_each_pattern``.
    """
    w = pixel_mask.to(elem.dtype)
    return torch.sum(elem * w, dim=(-2, -1)) / torch.sum(w)


def _broadcast_scale(scale: torch.Tensor, farplane: torch.Tensor):
    """Reshape a (N, M, M) detector scale to multiply (N, ..., M, M)."""
    extra = farplane.dim() - scale.dim()
    return scale.reshape(scale.shape[0], *([1] * extra), *scale.shape[-2:])


# --- Gaussian (amplitude least-squares) model ---


def _gaussian_elem(data, intensity):
    diff = torch.sqrt(intensity) - torch.sqrt(data)
    return diff * diff


def gaussian(data, intensity):
    """Mean Gaussian-model objective over all pixels."""
    return torch.mean(_gaussian_elem(data, intensity))


def gaussian_each_pattern(data, intensity):
    """Per-pattern mean Gaussian objective. data/intensity: (N, M, M)."""
    return torch.mean(_gaussian_elem(data, intensity), dim=(-2, -1))


def gaussian_grad(data, farplane, intensity):
    """Wirtinger gradient of the Gaussian objective wrt the farplane."""
    scale = 1 - torch.sqrt(data) / (torch.sqrt(intensity) + 1e-9)
    return farplane * _broadcast_scale(scale, farplane)


# --- Poisson model ---


def _poisson_elem(data, intensity):
    return intensity - data * torch.log(intensity + 1e-9)


def poisson(data, intensity):
    """Mean Poisson-model objective over all pixels."""
    return torch.mean(_poisson_elem(data, intensity))


def poisson_each_pattern(data, intensity):
    """Per-pattern mean Poisson objective."""
    return torch.mean(_poisson_elem(data, intensity), dim=(-2, -1))


def poisson_grad(data, farplane, intensity):
    """Wirtinger gradient of the Poisson objective wrt the farplane."""
    scale = 1 - data / (intensity + 1e-9)
    return farplane * _broadcast_scale(scale, farplane)


EACH_PATTERN = {
    "gaussian": gaussian_each_pattern,
    "poisson": poisson_each_pattern,
}
ELEMENTWISE = {"gaussian": _gaussian_elem, "poisson": _poisson_elem}
GRAD = {"gaussian": gaussian_grad, "poisson": poisson_grad}
COST = {"gaussian": gaussian, "poisson": poisson}


# --- The far-field step of the Gaussian model, fused ---


def gaussian_farplane_plain(
    data: torch.Tensor,
    farplane: torch.Tensor,
    measured_pixels: torch.Tensor,
    unmeasured_pixels_scaling: float,
):
    """Plain PyTorch :func:`gaussian_farplane`: the solvers' chain of
    elementwise operations and reductions, LSQML's intensity (|farplane|^2
    summed over the mode axes) among them."""
    intensity = torch.sum(
        torch.square(torch.abs(farplane)), dim=tuple(range(1, farplane.dim() - 2))
    )
    costs = _masked_mean_each_pattern(_gaussian_elem(data, intensity), measured_pixels)
    chi = torch.where(
        measured_pixels,
        -gaussian_grad(data, farplane, intensity),
        farplane * (unmeasured_pixels_scaling - 1.0),
    )
    return costs, chi


def _check_farplane_inputs(data, farplane, measured_pixels, unmeasured_pixels_scaling):
    """What the kernel takes: types and shapes first, then one CUDA card."""
    if (
        farplane.dtype != torch.complex64
        or farplane.dim() < 3
        or 0 in farplane.shape[1:]
        or farplane.shape[-2] != farplane.shape[-1]
    ):
        raise ValueError(
            "farplane must be a (B, ..., D, D) complex64 tensor with D > 0 and "
            f"a mode on each mode axis; got {farplane.dtype} {tuple(farplane.shape)}"
        )
    b, d = farplane.shape[0], farplane.shape[-1]
    if d * d >= 2**31:
        raise ValueError(f"the kernel indexes a pattern's D^2 = {d * d} pixels in 32 bits")
    for name, x, dtype, shape in (
        ("data", data, torch.float32, (b, d, d)),
        ("measured_pixels", measured_pixels, torch.bool, (d, d)),
    ):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} {shape} for a farplane of "
                f"{tuple(farplane.shape)}; got {x.dtype} {tuple(x.shape)}"
            )
    if isinstance(unmeasured_pixels_scaling, bool) or not isinstance(
        unmeasured_pixels_scaling, numbers.Real
    ):
        raise ValueError(
            "unmeasured_pixels_scaling must be a real number held on the host; "
            f"got {type(unmeasured_pixels_scaling).__name__}"
        )
    if not farplane.is_cuda:
        raise ValueError(f"farplane must be a CUDA tensor, not on {farplane.device}")
    for name, x in (("data", data), ("measured_pixels", measured_pixels)):
        if x.device != farplane.device:
            raise ValueError(f"{name} is on {x.device}, not on {farplane.device}")


def gaussian_farplane_cuda(
    data: torch.Tensor,
    farplane: torch.Tensor,
    measured_pixels: torch.Tensor,
    unmeasured_pixels_scaling: float,
):
    """Launch the CUDA kernel of :func:`gaussian_farplane`
    (``csrc/farplane.cu``) on the current stream of the farplane's card.

    The kernel counts the measured pixels itself and sums each pattern's
    cost in a fixed order, so ``costs`` are the same bit for bit from run to
    run, and nothing is read back to the host. Inputs that are not
    contiguous are copied first. ``chi`` is written over the farplane (over
    its copy where it was not contiguous), which the caller must not read
    again.
    """
    _check_farplane_inputs(data, farplane, measured_pixels, unmeasured_pixels_scaling)
    b, d = farplane.shape[0], farplane.shape[-1]
    modes = math.prod(farplane.shape[1:-2])
    data = data.contiguous()
    mask = measured_pixels.contiguous()
    chi = farplane.contiguous()
    costs = torch.empty(b, dtype=torch.float32, device=farplane.device)
    if b == 0:
        return costs, chi
    lib = kernels.load("farplane")
    with torch.cuda.device(farplane.device):
        rc = lib.tike_farplane_gaussian(
            chi.data_ptr(),
            data.data_ptr(),
            mask.data_ptr(),
            chi.data_ptr(),
            costs.data_ptr(),
            b,
            modes,
            d * d,
            float(unmeasured_pixels_scaling) - 1.0,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"farplane_gaussian kernel launch failed with CUDA error {rc}")
    LAUNCHES["farplane_gaussian"] += 1
    return costs, chi


def gaussian_farplane(
    data: torch.Tensor,
    farplane: torch.Tensor,
    measured_pixels: torch.Tensor,
    unmeasured_pixels_scaling: float,
):
    """The far-field step of the Gaussian model: ``(costs, chi)``.

    data (B, D, D) float32 measured intensities; farplane (B, ..., D, D)
    complex64, its mode axes between; measured_pixels (D, D) bool;
    unmeasured_pixels_scaling a real number s. With ``I`` the intensity
    summed over the mode axes, ``costs`` (B,) is each pattern's mean of
    ``(sqrt(I) - sqrt(data))^2`` over the measured pixels, and ``chi``, of
    the farplane's shape, is ``-farplane * (1 - sqrt(data) / (sqrt(I) +
    1e-9))`` on measured pixels and ``farplane * (s - 1)`` elsewhere.

    CPU tensors take :func:`gaussian_farplane_plain`; CUDA tensors launch
    the kernel (:func:`gaussian_farplane_cuda`), which writes ``chi`` over
    the farplane: the farplane is not to be read after this call. Tensors
    on both raise.
    """
    if kernels.on_cpu(data, farplane, measured_pixels):
        return gaussian_farplane_plain(
            data, farplane, measured_pixels, unmeasured_pixels_scaling
        )
    return gaussian_farplane_cuda(data, farplane, measured_pixels, unmeasured_pixels_scaling)
