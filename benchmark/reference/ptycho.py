"""Plain PyTorch reference of far-field ptychography and of its LSQML and
rPIE epochs.

Written from the methods (Odstrcil, Menzel and Guizar-Sicairos, Optics
Express 26(3), 2018: least-squares maximum-likelihood with compact
mini-batches, eigen probes and position gradients; Maiden, Johnson and Li,
Optica 4, 2017: regularised PIE) as tike computes them. It
imports nothing of the program under test: no kernel, no cache, no
batching of its own beyond the batches it is handed. Every array is a
plain float32 / complex64 tensor on whatever device it is given.

``q`` is applied to every complex field the epoch computes; the identity
gives the reference, :func:`bf16` the lower-precision control.
"""

from __future__ import annotations

import typing

import torch

State = typing.Dict[str, typing.Optional[torch.Tensor]]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round a float or complex tensor to bfloat16 and back."""
    if x.is_complex():
        r = torch.view_as_real(x).to(torch.bfloat16).to(torch.float32)
        return torch.view_as_complex(r.contiguous())
    return x.to(torch.bfloat16).to(x.dtype)


# ---------------------------------------------------------------- operators


def _windows(pos: torch.Tensor, p: int):
    corner = torch.floor(pos)
    frac = pos - corner
    corner = corner.to(torch.int64)
    span = torch.arange(p + 1, device=pos.device)
    rows = corner[:, 0, None] + span
    cols = corner[:, 1, None] + span
    return rows, cols, frac[:, 0, None, None], frac[:, 1, None, None]


def extract(image: torch.Tensor, pos: torch.Tensor, p: int) -> torch.Tensor:
    """(B, P, P) bilinear samples of ``image`` (H, W) at ``pos + (i, j)``."""
    rows, cols, fy, fx = _windows(pos, p)
    h, w = image.shape
    if int(rows.min()) < 0 or int(rows.max()) >= h or int(cols.min()) < 0 or int(cols.max()) >= w:
        raise ValueError("a position's window leaves the object")
    win = image[rows[:, :, None], cols[:, None, :]]
    return (
        (1 - fy) * (1 - fx) * win[:, :-1, :-1]
        + (1 - fy) * fx * win[:, :-1, 1:]
        + fy * (1 - fx) * win[:, 1:, :-1]
        + fy * fx * win[:, 1:, 1:]
    )


def insert(values: torch.Tensor, pos: torch.Tensor, shape) -> torch.Tensor:
    """Adjoint of :func:`extract`: the (H, W) sum of every value spread
    over its four bilinear neighbours."""
    b, p, _ = values.shape
    rows, cols, fy, fx = _windows(pos, p)
    win = values.new_zeros((b, p + 1, p + 1))
    win[:, :-1, :-1] += (1 - fy) * (1 - fx) * values
    win[:, :-1, 1:] += (1 - fy) * fx * values
    win[:, 1:, :-1] += fy * (1 - fx) * values
    win[:, 1:, 1:] += fy * fx * values
    h, w = shape
    flat = (rows[:, :, None] * w + cols[:, None, :]).reshape(-1)
    out = values.new_zeros(h * w)
    if values.is_complex():
        torch.view_as_real(out).index_add_(0, flat, torch.view_as_real(win.reshape(-1)))
    else:
        out.index_add_(0, flat, win.reshape(-1))
    return out.reshape(h, w)


def to_detector(near: torch.Tensor, det: int) -> torch.Tensor:
    """Zero-pad the exit wave to the detector, centred, then the
    unitary 2-D FFT."""
    p = near.shape[-1]
    lo = (det - p) // 2
    if det != p:
        near = torch.nn.functional.pad(near, (lo, det - p - lo, lo, det - p - lo))
    return torch.fft.fft2(near, norm="ortho")


def from_detector(far: torch.Tensor, p: int) -> torch.Tensor:
    det = far.shape[-1]
    lo = (det - p) // 2
    near = torch.fft.ifft2(far, norm="ortho")
    return near[..., lo : lo + p, lo : lo + p]


def probes_at(probe, eigen_probe, weights):
    """Each position's probe modes (B, M, P, P): ``weights[:, 0]`` times
    the shared modes plus the weighted eigen probes of the modes they
    cover. ``weights`` (B, E + 1, M) or None."""
    shared = probe[0, 0]
    if weights is None:
        return shared[None]
    out = weights[:, 0, :, None, None] * shared
    if eigen_probe is not None:
        me = eigen_probe.shape[-3]
        extra = torch.einsum("bem,emxy->bmxy", weights[:, 1:, :me].to(out.dtype), eigen_probe[0, :, :me])
        out = torch.cat([out[:, :me] + extra, out[:, me:]], dim=1)
    return out


def intensity(psi0: torch.Tensor, pos, modes, det: int) -> torch.Tensor:
    """Far-field intensity (B, D, D), summed over the probe modes."""
    p = modes.shape[-1]
    near = extract(psi0, pos, p)[:, None] * modes
    return torch.sum(torch.abs(to_detector(near, det)) ** 2, dim=1)


def simulate(psi0, scan, probe, det: int, block: int = 1000) -> torch.Tensor:
    """Noise-free diffraction data (N, D, D) float32, block by block."""
    return torch.cat(
        [intensity(psi0, scan[i : i + block], probe[0, 0][None], det) for i in range(0, len(scan), block)]
    )


def probe_rescale(psi0, scan, probe, data, block: int = 1000) -> torch.Tensor:
    """The factor that makes the modelled photons equal the measured ones
    (square root of their ratio), with the shared probe alone."""
    s_data = torch.zeros((), dtype=torch.float64, device=data.device)
    s_model = torch.zeros((), dtype=torch.float64, device=data.device)
    for i in range(0, len(scan), block):
        s_data += torch.sum(data[i : i + block], dtype=torch.float64)
        s_model += torch.sum(intensity(psi0, scan[i : i + block], probe[0, 0][None], data.shape[-1]), dtype=torch.float64)
    return torch.sqrt(s_data / s_model).to(torch.float32)


def _gaussian_derivative(x: torch.Tensor, sigma: float = 0.333, truncate: float = 6.0):
    """(d/dy, d/dx) of ``-x`` over its last two axes by correlation with the
    order-1 Gaussian derivative, the borders extended with edge values."""
    radius = max(int(truncate * sigma + 0.5), 1)
    t = torch.arange(-radius, radius + 1, dtype=torch.float64)
    g = torch.exp(-0.5 * (t / sigma) ** 2)
    g = g / g.sum()
    taps = torch.flip((-t / sigma**2) * g, dims=(0,)).to(torch.float32).tolist()

    def along(arr, dim):
        n = arr.shape[dim]
        first = arr.narrow(dim, 0, 1)
        last = arr.narrow(dim, n - 1, 1)
        padded = torch.cat([first] * radius + [arr] + [last] * radius, dim=dim)
        acc = torch.zeros_like(arr)
        for i, k in enumerate(taps):
            acc = acc + k * padded.narrow(dim, i, n)
        return acc

    return along(-x, x.dim() - 2), along(-x, x.dim() - 1)


def _trimmed_mean(x: torch.Tensor, share: float = 0.05) -> torch.Tensor:
    n = x.shape[0]
    k = int(n * share)
    return torch.sort(x, dim=0).values[k : n - k].mean(dim=0, keepdim=True)


def _finite(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _rms(x):
    return torch.sqrt(torch.mean(torch.abs(x) ** 2))


# ------------------------------------------------------------------- epoch


def lsqml_epoch(
    state: State,
    data: torch.Tensor,
    batches: typing.Sequence[torch.Tensor],
    *,
    positions: bool,
    position_limit: float,
    q: typing.Callable = identity,
    drop_half: bool = False,
) -> typing.Tuple[State, float]:
    """One LSQML epoch over compact ``batches`` (index tensors of equal
    length into the user's order), in their order. The object takes the
    epoch's summed, preconditioned update at its end; the probe, the eigen
    probes and weights take each batch's; the positions take the epoch's
    gradient step at its end. Gaussian noise model, every pixel measured.

    ``state``: psi (1, H, W), probe (1, 1, M, P, P), eigen_probe (1, E, M',
    P, P) or None, weights (N, E + 1, M) or None, scan (N, 2). Returns the
    new state and the epoch's cost, the mean over batches of the mean
    per-pattern cost. ``drop_half`` leaves the second half of every batch
    out (a planted fault for the harness's own tests).
    """
    psi, probe = state["psi"], state["probe"]
    eig, weights, scan = state["eigen_probe"], state["weights"], state["scan"]
    weights = None if weights is None else weights.clone()
    h, w = psi.shape[-2:]
    p = probe.shape[-1]
    nb = len(batches)
    det = data.shape[-1]

    # The illumination that every position of the epoch gives each pixel.
    amp = torch.sum(torch.abs(probe[0, 0]) ** 2, dim=0)
    illum = torch.zeros((h, w), dtype=torch.float32, device=psi.device)
    for b in batches:
        illum += insert(amp.expand(len(b), p, p).contiguous(), scan[b], (h, w))
    dmax = illum.abs().max()
    precond = torch.sqrt((0.95 * illum.abs()) ** 2 + (0.05 * dmax) ** 2)

    object_sum = torch.zeros((h, w), dtype=psi.dtype, device=psi.device)
    pos_num = torch.zeros_like(scan)
    pos_den = torch.zeros_like(scan)
    costs, betas = [], []
    for b in batches:
        valid = torch.ones(len(b), dtype=torch.float32, device=psi.device)
        if drop_half:
            valid[len(b) // 2 :] = 0
        pos = scan[b]
        wb = None if weights is None else weights[b].clone()
        uprobe = q(probes_at(probe, eig, wb))  # (B or 1, M, P, P)
        obj = q(extract(psi[0], pos, p))  # (B, P, P)
        far = q(to_detector(obj[:, None] * uprobe, det))
        inten = torch.sum(torch.abs(far) ** 2, dim=1)
        meas = data[b]
        diff = torch.sqrt(inten) - torch.sqrt(meas)
        each = torch.mean(diff * diff, dim=(-2, -1))
        costs.append(torch.sum(each * valid) / valid.sum())
        chi = q(from_detector(-far * (1 - torch.sqrt(meas) / (torch.sqrt(inten) + 1e-9))[:, None], p))
        chi = chi * valid[:, None, None, None]  # (B, M, P, P)

        grad_obj = q(insert(torch.sum(uprobe.conj() * chi, dim=1), pos, (h, w)))
        grad_probe_each = q(obj.conj()[:, None] * chi)  # (B, M, P, P)
        grad_probe = torch.sum(grad_probe_each, dim=0) / nb  # (M, P, P)

        if wb is not None:
            # The shared component's weight, mode 0.
            op = obj * probe[0, 0, 0]
            num = torch.sum(torch.real(op.conj() * chi[:, 0]), dim=(-2, -1))
            den = torch.sum(torch.abs(op) ** 2, dim=(-2, -1)) + 1e-32
            wb[:, 0, 0] += 0.1 * (num / den) * valid
            if eig is not None:
                resid = grad_probe_each[:, 0] - grad_probe[0]  # (B, P, P)
                for c in range(1, eig.shape[1] + 1):
                    eig, wb = _eigen_step(resid, eig, wb, obj, chi[:, 0], valid, c, min(0.1, 1.0 / nb))
                    if c < eig.shape[1]:
                        e = eig[0, c - 1, 0]
                        resid = resid - torch.sum(e.conj() * resid, dim=(-2, -1), keepdim=True) / torch.sum(
                            e.conj() * e
                        ) * e

        if positions:
            gy, gx = _gaussian_derivative(obj)
            c = p // 4
            up = uprobe[:, 0, c:-c, c:-c]
            cc = chi[:, 0, c:-c, c:-c]
            dy, dx = gy[:, c:-c, c:-c] * up, gx[:, c:-c, c:-c] * up
            pos_num[b] += torch.stack(
                [torch.sum(torch.real(dy.conj() * cc), dim=(-2, -1)), torch.sum(torch.real(dx.conj() * cc), dim=(-2, -1))],
                dim=-1,
            ) * valid[:, None]
            pos_den[b] += torch.stack(
                [torch.sum(torch.abs(dy) ** 2, dim=(-2, -1)), torch.sum(torch.abs(dx) ** 2, dim=(-2, -1))], dim=-1
            ) * valid[:, None]

        # Jointly optimal object and probe steps, from mode 0.
        eps = 1e-9
        dpsi = grad_obj / precond
        d_op = q(extract(dpsi, pos, p)) * uprobe[:, 0]
        d_po = grad_probe[0] * obj
        a1 = torch.sum(torch.abs(d_op) ** 2, dim=(-2, -1)) + eps
        a4 = torch.sum(torch.abs(d_po) ** 2, dim=(-2, -1)) + eps
        a1 = a1 + 0.5 * a1.mean()
        a4 = a4 + 0.5 * a4.mean()
        b1 = torch.sum(torch.real(d_op.conj() * chi[:, 0]), dim=(-2, -1))
        b2 = torch.sum(torch.real(d_po.conj() * chi[:, 0]), dim=(-2, -1))
        a2 = torch.sum(d_op * d_po.conj(), dim=(-2, -1))
        a3 = a2.conj()
        determinant = a1 * a4 - a2 * a3
        determinant = torch.where(determinant.abs() == 0, torch.full_like(determinant, 1e-32), determinant)
        x1 = -torch.conj(a2 * b2 - a4 * b1) / determinant
        x2 = torch.conj(a1 * b2 - a3 * b1) / determinant
        n_valid = valid.sum() + 1e-32
        beta_obj = torch.sum(0.9 * torch.clamp(_finite(x1.real), min=0) * valid) / n_valid
        beta_probe = torch.sum(0.9 * torch.clamp(_finite(x2.real), min=0) * valid) / n_valid

        probe = q(probe + beta_probe * grad_probe)
        if wb is not None:
            weights[b] = wb
        object_sum = object_sum + grad_obj
        betas.append(beta_obj)

    if positions:
        step = pos_num / (0.95 * pos_den + 0.05 * torch.clamp(pos_den.max(), min=1e-6))
        if position_limit > 0:
            step = torch.clamp(step, -position_limit, position_limit)
        step = step - _trimmed_mean(step)
        scan = scan - step
        scan = torch.stack(
            [torch.clamp(scan[:, 0], 1.0, h - p - 1 / 256), torch.clamp(scan[:, 1], 1.0, w - p - 1 / 256)], dim=-1
        )
    beta = torch.stack(betas).mean()
    psi = q(psi + _finite(beta * object_sum / precond))
    new = dict(psi=psi, probe=probe, eigen_probe=eig, weights=weights, scan=scan)
    return new, float(torch.stack(costs).mean())


def _eigen_step(resid, eig, wb, obj, chi0, valid, c: int, beta: float):
    """Update eigen probe ``c`` (of mode 0) from the batch's probe-update
    residuals ``resid`` (B, P, P), then its weights."""
    wc = wb[:, c, 0]
    norm_w = torch.sum(wc * wc * valid) + 1e-32
    n_valid = valid.sum() + 1e-32
    e = eig[0, c - 1, 0]
    proj = (torch.real(resid.conj() * e) + wc[:, None, None]) / norm_w
    update = torch.sum(resid * proj.mean(dim=(-2, -1), keepdim=True) * valid[:, None, None], dim=0) / n_valid
    e = e + beta * update / (_rms(update) + 1e-32)
    e = e / (_rms(e) + 1e-32)
    eig = eig.clone()
    eig[0, c - 1, 0] = e
    phi = obj * e
    n = torch.mean(torch.real(chi0 * phi.conj()), dim=(-2, -1))
    d = torch.mean(torch.abs(phi) ** 2, dim=(-2, -1))
    d_mean = torch.sum(d * valid) / n_valid
    wb = wb.clone()
    wb[:, c, 0] += n / (d + 0.1 * d_mean) * valid
    return eig, wb


def rpie_epoch(
    state: State,
    data: torch.Tensor,
    batches: typing.Sequence[torch.Tensor],
    *,
    alpha: float = 0.05,
    q: typing.Callable = identity,
    drop_half: bool = False,
) -> typing.Tuple[State, float]:
    """One rPIE epoch over compact ``batches`` (Maiden, Johnson and Li,
    Optica 4, 2017): every batch's object and probe numerators against the
    state the epoch starts from, summed, then one step of each, divided by
    the regularised illumination (object) or object intensity (probe).
    Gaussian noise model, every pixel measured, shared probe modes only.
    Returns the new state and the epoch's cost, the mean over batches of
    the mean per-pattern cost."""
    psi, probe, scan = state["psi"], state["probe"], state["scan"]
    h, w = psi.shape[-2:]
    p = probe.shape[-1]
    det = data.shape[-1]
    modes = probe[0, 0]  # (M, P, P)
    nmodes = modes.shape[0]

    amp = torch.sum(torch.abs(modes) ** 2, dim=0)
    illum = torch.zeros((h, w), dtype=torch.float32, device=psi.device)
    obj_power = torch.zeros((p, p), dtype=torch.float32, device=psi.device)
    psi_num = torch.zeros((h, w), dtype=psi.dtype, device=psi.device)
    probe_num = torch.zeros_like(modes)
    costs = []
    for b in batches:
        valid = torch.ones(len(b), dtype=torch.float32, device=psi.device)
        if drop_half:
            valid[len(b) // 2 :] = 0
        pos = scan[b]
        illum += insert(amp.expand(len(b), p, p).contiguous(), pos, (h, w))
        obj = q(extract(psi[0], pos, p))
        obj_power += torch.sum(torch.abs(obj) ** 2, dim=0)
        far = q(to_detector(obj[:, None] * modes, det))
        inten = torch.sum(torch.abs(far) ** 2, dim=1)
        meas = data[b]
        diff = torch.sqrt(inten) - torch.sqrt(meas)
        each = torch.mean(diff * diff, dim=(-2, -1))
        costs.append(torch.sum(each * valid) / valid.sum())
        chi = q(from_detector(-far * (1 - torch.sqrt(meas) / (torch.sqrt(inten) + 1e-9))[:, None], p))
        chi = chi * valid[:, None, None, None]
        psi_num += q(insert(torch.sum(modes.conj() * chi, dim=1) / nmodes, pos, (h, w)))
        probe_num += q(torch.sum(obj.conj()[:, None] * chi, dim=0))

    psi_den = (1 - alpha) * illum + alpha * illum.abs().max()
    probe_den = (1 - alpha) * obj_power + alpha * obj_power.max()
    psi = q(psi + _finite(psi_num / psi_den))
    probe = q(probe + _finite(probe_num / probe_den)[None, None])
    new = dict(psi=psi, probe=probe, eigen_probe=state["eigen_probe"], weights=state["weights"], scan=scan)
    return new, float(torch.stack(costs).mean())
