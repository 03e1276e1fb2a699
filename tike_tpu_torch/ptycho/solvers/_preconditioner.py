"""Object and probe preconditioners.

Counterpart of :mod:`tike_tpu.ptycho.solvers._preconditioner`, per slice:

- psi preconditioner = sum over positions of |illumination|^2 added into
  the object frame at each position: the probe at slice 0, and at slice i
  the probe propagated through slices 0 to i - 1;
- probe preconditioner = sum over positions of |object patch|^2.

Each has two exact formulations, as in the JAX package: a gather one that
runs the patch operators per position (``_psi_precond_math``,
``_probe_precond_math``), for any number of slices, and an FFT one for a
single slice that scatters bilinear point densities at integer pixels and
convolves/correlates them with full-object fields
(``_psi_precond_fft_math``, ``_probe_precond_fft_math``).
:func:`_batched_preconditioners` sums either over an epoch's padded
batches; the epochs of ``Reconstruction`` call it, and so does
:func:`update_preconditioners`, the per-epoch solver functions' public
step. :func:`fft_precond_profitable` picks between the formulations on the
fused path with the JAX package's own rule, so both packages take the same
one; multislice objects take the gather one, as in the JAX package.
:func:`update_preconditioners` takes the FFT formulation for one slice,
the JAX package's default; unlike it, the port reads no environment
variable for that choice.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.patch import patch_adj, patch_fwd
from ...ops.propagation import fresnel_fwd
from ...ops.ptycho import PtychoConfig
from ...parallel import all_reduce
from .options import PtychoParameters, _device_fields

# The (8, 128) tile the JAX gather formulation works in; only the cost
# model below reads it.
_SUB, _LANE = 8, 128


def _require_single_slice(cfg: PtychoConfig) -> None:
    """The FFT formulation is for one slice, as in the JAX package, whose
    epochs take it only then."""
    if cfg.nslices != 1:
        raise ValueError(
            "the FFT formulation of the preconditioners is single-slice; "
            f"nslices={cfg.nslices} takes the gather one"
        )


def _psi_precond_math(cfg: PtychoConfig, psi, scan, probe, mask=None):
    """Return (D, H, W) float32 sum of |illumination|^2 at each pixel.

    ``mask`` (N,) optionally zeroes padded batch slots.
    """
    n, p = scan.shape[0], cfg.probe_shape
    w = torch.ones(n, device=scan.device) if mask is None else mask
    probe_amp = torch.sum((probe[0, 0] * probe[0, 0].conj()).real, dim=0)
    slices = [
        patch_adj((probe_amp[None] * w[:, None, None]).contiguous(), scan, (cfg.nz, cfg.n))
    ]
    prop = cfg.propagator(psi.device)
    probe1 = probe[0, 0].expand(n, probe.shape[-3], p, p)
    for i in range(1, cfg.nslices):
        patches = patch_fwd(psi[i - 1], scan, p)
        probe1 = fresnel_fwd(patches[:, None] * probe1, prop)
        amp = torch.sum((probe1 * probe1.conj()).real, dim=1)  # (N, P, P)
        slices.append(patch_adj(amp * w[:, None, None], scan, (cfg.nz, cfg.n)))
    return torch.stack(slices)


def _probe_precond_math(cfg: PtychoConfig, psi, scan, mask=None):
    """Return (D, P, P) float32 sum of |object patches|^2, per slice."""
    w = torch.ones(scan.shape[0], device=scan.device) if mask is None else mask
    slices = []
    for i in range(cfg.nslices):
        patches = patch_fwd(psi[i], scan, cfg.probe_shape)
        slices.append(
            torch.sum((patches * patches.conj()).real * w[:, None, None], dim=0)
        )
    return torch.stack(slices)


def fft_precond_profitable(
    n_positions: int, probe_shape: int, nz: int, n: int
) -> bool:
    """Whether the FFT formulation is chosen over the per-position gather.

    The JAX package's cost model, kept unchanged so both packages take the
    same formulation: the gather touches one aligned (th x tw) tile per
    position, the FFT pays a few full-object FFTs. Its crossover constant
    3.0 was fitted to TPU timings and has not been refitted for this port.
    """
    th = -(-(probe_shape + _SUB) // 8) * 8
    tw = -(-(probe_shape + _LANE) // _LANE) * _LANE
    s1 = _fft_len(nz + probe_shape + 1)
    s2 = _fft_len(n + probe_shape + 1)
    return n_positions * th * tw > 3.0 * s1 * s2 * np.log2(s1 * s2)


def _fft_len(n: int) -> int:
    """Smallest 5-smooth length >= n."""
    m = n
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def _bilinear_split(scan):
    corner = torch.floor(scan)
    fy = scan[:, 0] - corner[:, 0]
    fx = scan[:, 1] - corner[:, 1]
    Y = corner[:, 0].to(torch.int64)
    X = corner[:, 1].to(torch.int64)
    return Y, X, (1 - fy, fy), (1 - fx, fx)


def _psi_precond_fft_math(cfg: PtychoConfig, scan, probe, w):
    """Single-slice psi preconditioner as density-conv-|probe|^2.

    Exactly :func:`_psi_precond_math` (by linearity of the patch adjoint):
    the same |probe|^2 is spread at every position, so the sum is the
    4-corner bilinear point density convolved with |probe|^2.
    """
    _require_single_slice(cfg)
    h, wd, p = cfg.nz, cfg.n, cfg.probe_shape
    Y, X, wy, wx = _bilinear_split(scan)
    d = torch.zeros((h + 1, wd + 1), dtype=torch.float32, device=scan.device)
    for a in (0, 1):
        for b in (0, 1):
            d.index_put_((Y + a, X + b), w * wy[a] * wx[b], accumulate=True)
    probe_amp = torch.sum((probe[0, 0] * probe[0, 0].conj()).real, dim=0)
    s = (_fft_len(h + p + 1), _fft_len(wd + p + 1))
    out = torch.fft.irfft2(
        torch.fft.rfft2(d, s=s) * torch.fft.rfft2(probe_amp, s=s), s=s
    )[:h, :wd]
    return out[None].to(torch.float32)


def _probe_precond_fft_math(cfg: PtychoConfig, psi, scan, w):
    """Single-slice probe preconditioner via 5 density-correlations.

    Expands sum_s |bilinear-interp patch_s|^2 into its 16 bilinear cross
    terms, grouped by pixel offset delta (0,0), (0,1), (1,0), (1,1) and
    (1,-1); the other half follows by conjugate symmetry.
    """
    _require_single_slice(cfg)
    h, wd, p = cfg.nz, cfg.n, cfg.probe_shape
    psi0 = psi[0]
    Y, X, wy, wx = _bilinear_split(scan)
    rho = torch.zeros(
        (5, h + 2, wd + 2), dtype=torch.float32, device=scan.device
    )
    for a in (0, 1):
        for b in (0, 1):
            rho[0].index_put_(
                (Y + a, X + b), w * (wy[a] * wx[b]) ** 2, accumulate=True
            )
    for a in (0, 1):  # delta = (0, 1)
        rho[1].index_put_(
            (Y + a, X), w * wy[a] ** 2 * wx[0] * wx[1], accumulate=True
        )
    for b in (0, 1):  # delta = (1, 0)
        rho[2].index_put_(
            (Y, X + b), w * wx[b] ** 2 * wy[0] * wy[1], accumulate=True
        )
    wq = w * wy[0] * wy[1] * wx[0] * wx[1]
    rho[3].index_put_((Y, X), wq, accumulate=True)  # delta = (1, 1)
    rho[4].index_put_((Y, X + 1), wq, accumulate=True)  # delta = (1, -1)

    def shifted(dy, dx):
        """psi0 shifted by (dy, dx), zero where the shift leaves the image."""
        out = torch.zeros_like(psi0)
        src = psi0[dy:, max(dx, 0) : wd + min(dx, 0)]
        out[: h - dy, max(-dx, 0) : wd - max(dx, 0)] = src
        return out

    # Only the real part of each correlation is used, and rho is real, so
    # take the real part of Z first and use half-spectrum real FFTs.
    Z = torch.stack(
        [
            (psi0 * psi0.conj()).real,
            (psi0 * shifted(0, 1).conj()).real,
            (psi0 * shifted(1, 0).conj()).real,
            (psi0 * shifted(1, 1).conj()).real,
            (psi0 * shifted(1, -1).conj()).real,
        ]
    ).to(torch.float32)
    s = (_fft_len(h + p + 2), _fft_len(wd + p + 2))
    corr = torch.fft.irfft2(
        torch.fft.rfft2(rho, s=s).conj() * torch.fft.rfft2(Z, s=s), s=s
    )[:, :p, :p]
    out = corr[0] + 2 * torch.sum(corr[1:], dim=0)
    return out[None].to(torch.float32)


def _batched_preconditioners(
    cfg: PtychoConfig,
    psi,
    scan,
    probe,
    batch_idx,
    batch_mask,
    *,
    use_fft: bool,
    want_psi: bool,
    want_probe: bool,
    shards=None,
):
    """Both preconditioners of the positions in the padded batches
    ``batch_idx`` (nb, L) int64 and ``batch_mask`` (nb, L) float32, in
    float32: the FFT formulation over the mask's weight at each position
    (one slice), or the gather one summed batch by batch.

    On a mesh, ``shards`` (``epoch.ShardedBatches``) holds each shard's
    slots: each shard computes its part on its device (the point weights,
    or the gather sums of its slots) and the parts are summed in mesh order
    (``parallel.all_reduce``).

    Returns ``(psi_pre (D, H, W), probe_pre (D, P, P))``; psi_pre is zeros
    unless ``want_psi``, probe_pre None unless ``want_probe``.
    """
    if shards is None:
        group = devices = [psi.device]
        idxs, masks = [batch_idx], [batch_mask]
    else:
        group, devices, idxs, masks = shards.group, shards.devices, shards.idx, shards.mask
    home = psi.device
    psi_pre = torch.zeros((cfg.nslices, cfg.nz, cfg.n), dtype=torch.float32, device=home)
    probe_pre = None
    if use_fft:
        parts = []
        for device, idx, mask in zip(devices, idxs, masks):
            w = torch.zeros(scan.shape[0], dtype=torch.float32, device=device)
            parts.append(w.index_add_(0, idx.reshape(-1), mask.reshape(-1)))
        w_all = all_reduce(parts, group)[0].to(home)
        if want_psi:
            psi_pre = _psi_precond_fft_math(cfg, scan, probe, w_all)
        if want_probe:
            probe_pre = _probe_precond_fft_math(cfg, psi, scan, w_all)
        return psi_pre, probe_pre
    parts = []
    for device, idx_s, mask_s in zip(devices, idxs, masks):
        psi_s, scan_s, probe_s = psi.to(device), scan.to(device), probe.to(device)
        psi_part = torch.zeros_like(psi_pre, device=device)
        probe_part = None
        if want_probe:
            probe_part = torch.zeros(
                (cfg.nslices, cfg.probe_shape, cfg.probe_shape), dtype=torch.float32,
                device=device,
            )
        for idx, bmask in zip(idx_s, mask_s):
            if want_psi:
                psi_part = psi_part + _psi_precond_math(cfg, psi_s, scan_s[idx], probe_s, bmask)
            if want_probe:
                probe_part = probe_part + _probe_precond_math(cfg, psi_s, scan_s[idx], bmask)
        parts.append((psi_part, probe_part))
    psi_pre, probe_pre = all_reduce(parts, group)[0]
    return psi_pre.to(home), None if probe_pre is None else probe_pre.to(home)


def psi_preconditioner(cfg: PtychoConfig, psi, scan, probe, mask=None):
    """(D, H, W) float32 sum of |illumination|^2 at each object pixel over
    all positions (``mask`` (N,) optionally weighs them)."""
    return _psi_precond_math(cfg, psi, scan, probe, mask)


def probe_preconditioner(cfg: PtychoConfig, psi, scan, mask=None):
    """(D, P, P) float32 sum of |object patches|^2 over all positions."""
    return _probe_precond_math(cfg, psi, scan, mask)


def update_preconditioners(
    cfg: PtychoConfig,
    parameters: PtychoParameters,
    batches=None,
) -> PtychoParameters:
    """Refresh the object and probe preconditioners: write them into
    ``object_options.preconditioner`` and ``probe_options.preconditioner``
    (each where those options are set) and return ``parameters``.

    With ``batches``, the ``(indices, mask)`` pair of
    ``cluster.batches_padded``, one slice takes the FFT formulation and
    several the gather one summed batch by batch, and the preconditioners
    are complex64, as in the JAX package. Without, the gather formulation
    runs over the whole scan and they are float32. The parameters' arrays
    are made tensors on one device first (psi's, or the card for host
    arrays), in place.
    """
    device = _device_fields(parameters)
    p = parameters
    if batches is None:
        if p.object_options:
            p.object_options.preconditioner = psi_preconditioner(cfg, p.psi, p.scan, p.probe)
        if p.probe_options:
            p.probe_options.preconditioner = probe_preconditioner(cfg, p.psi, p.scan)
        return p
    batch_idx, batch_mask = batches
    psi_pre, probe_pre = _batched_preconditioners(
        cfg,
        p.psi,
        p.scan,
        p.probe,
        torch.as_tensor(batch_idx, dtype=torch.int64, device=device),
        torch.as_tensor(batch_mask, dtype=torch.float32, device=device),
        use_fft=cfg.nslices == 1,
        want_psi=p.object_options is not None,
        want_probe=p.probe_options is not None,
    )
    if p.object_options is not None:
        p.object_options.preconditioner = psi_pre.to(torch.complex64)
    if p.probe_options is not None:
        p.probe_options.preconditioner = probe_pre.to(torch.complex64)
    return p
