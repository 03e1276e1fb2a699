"""Step directions and conjugate-gradient loops (PyTorch).

Counterpart of :mod:`tike_tpu.opt`: the step directions ``adam`` (the
position step, and rPIE's per-batch object and probe moments),
``momentum`` (LSQML's per-batch object momentum), ``adagrad`` and
``adadelta``; the checked momentum of compact runs, as
``momentum_checked_traced``, whose decisions stay on the device (the
epochs of ``Reconstruction``), and as ``momentum_checked``, which decides
on the host from the cost history (the per-epoch solver functions
``solvers.rpie`` and ``solvers.lstsq_grad``); ``is_converged``, the
early-stopping test of the per-epoch loop on the host cost history; the
batch helpers ``batch_indicies``, ``get_batch`` and ``put_batch``; and the
laminography solvers' loops, ``line_search``, ``direction_dy``,
``conjugate_gradient`` (``tike_tpu``'s ``conjugate_gradient_traced``) and
``cgls`` (``cgls_traced``). ``tike_tpu`` traces those loops into one
device program; here they are eager, and each trial of the backtracking
line search reads one comparison back to the host.

``HOST_READS`` counts, by what was read, the times this process has read
device values back to the host: ``line_search``, one per trial step of the
line search; ``ptycho.costs`` and ``ptycho.powers``, the epochs' costs and
probe powers that ``Reconstruction.iterate`` reads (once a call on the
fused path, once an epoch on the per-epoch path, once a chunk of epochs on
the striped object); ``position.scan`` and ``position.initial_scan``, the
positions that the affine position fit reads; ``probe.power``, the eigen
probes' powers that ``constrain_variable_probe`` sorts on the host;
``solvers.costs``, the batch costs of the per-epoch solver functions.
Callers may reset a count to 0. Each read of the ptychography path is also
a ``tike.host_read`` span (:mod:`tike_tpu_torch.trace`).
"""

from __future__ import annotations

import logging
import typing

import numpy as np
import torch

from . import linalg

logger = logging.getLogger(__name__)


def is_converged(algorithm_options) -> bool:
    """Return True if the cost slope is non-negative within the window.

    The test runs once ``convergence_window >= 2`` costs are recorded and
    ``len(costs) % window // 2 == 0`` (as written: the remainder by the
    window, halved and floored, so at remainders 0 and 1), on a line fitted
    to the last ``window`` epoch costs, each the mean of its entries.
    """
    window = algorithm_options.convergence_window
    if (
        window >= 2
        and len(algorithm_options.costs) >= window
        and len(algorithm_options.costs) % window // 2 == 0
    ):
        m = np.array(algorithm_options.costs[-window:])
        m = np.mean(np.reshape(m, (len(m), -1)), axis=1)
        p = np.polyfit(x=range(window), y=m, deg=1)
        if p[0] >= 0:
            logger.info(
                f"Considering the last {window:d} epochs, "
                "the cost function seems converged."
            )
            return True
    return False


def batch_indicies(n, m=1, use_random=True, rng=None):
    """Return the indices [0...n) as m groups, shuffled by ``rng`` unless
    ``use_random`` is false."""
    assert 0 < m <= n, (m, n)
    rng = np.random.default_rng() if rng is None else rng
    i = rng.permutation(n) if use_random else np.arange(n)
    return np.array_split(i, m)


def get_batch(x, b, n):
    """Return x[b[n]]; for use with map()."""
    return x[b[n]]


def put_batch(y, x, b, n):
    """Set x[b[n]] to y: a numpy ``x`` in place, which is returned; a
    tensor ``x`` is left as it is and the updated copy returned."""
    if isinstance(x, torch.Tensor):
        index = torch.as_tensor(b[n], device=x.device)
        return x.index_put((index,), torch.as_tensor(y, dtype=x.dtype, device=x.device))
    x[b[n]] = y
    return x


def update_single(x, step_length, d):
    """x + step_length * d."""
    return x + step_length * d


def dir_single(x):
    """The identity direction."""
    return x


def momentum(g, v, m, vdecay=None, mdecay=0.9):
    """Classical momentum direction. Returns ``(direction, None, m)``."""
    m = 0 if m is None else m
    m = mdecay * m + (1 - mdecay) * g
    return m, None, m


def adagrad(g, v=None, m=None, eps=1e-6):
    """Adagrad direction. The first call returns ``g`` itself and starts
    the sum of squares ``v``. Returns ``(direction, v, m)``."""
    if v is None:
        return g, (g * g.conj()).real, m
    v = v + (g * g.conj()).real
    return g / torch.sqrt(v + eps), v, m


def adadelta(g, d0=None, v=None, m=None, decay=0.9, eps=1e-6):
    """Adadelta direction from the gradient ``g`` and the last step ``d0``.
    Returns ``(direction, v, m)``."""
    v = 0 if v is None else v
    m = 0 if m is None else m
    d0 = torch.zeros_like(g) if d0 is None else d0
    v = v * decay + (1 - decay) * (g * g.conj()).real
    m = m * decay + (1 - decay) * (d0 * d0.conj()).real
    return torch.sqrt((m + eps) / (v + eps)) * g, v, m


def adam(g, v=None, m=None, vdecay=0.999, mdecay=0.9, eps=1e-8):
    """Adaptive moment estimation direction.

    Returns ``(direction, v, m)``: the new second moment ``v`` (real) and
    first moment ``m`` (of ``g``'s dtype) to pass to the next call.
    """
    v = torch.zeros_like(g.real) if v is None else v
    m = torch.zeros_like(g) if m is None else m
    m = mdecay * m + (1 - mdecay) * g
    v = vdecay * v + (1 - vdecay) * (g * g.conj()).real
    m_ = m / (1 - mdecay)
    v_ = torch.sqrt(v / (1 - vdecay))
    return m_ / (v_ + eps), v, m


def fit_line_least_squares(y, x):
    """Return the (slope, intercept) of the line fit to (x, y), in float64
    on the host."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    count = len(x)
    assert count == len(y)
    sx = x.sum()
    sy = y.sum()
    slope = (count * (x * y).sum() - sx * sy) / (count * (x * x).sum() - sx * sx)
    intercept = (sy - slope * sx) / count
    return slope, intercept


def momentum_checked(
    g,
    v,
    m,
    mdecay: float,
    errors: typing.List[float],
    beta: float = 1.0,
    memory_length: int = 3,
    vdecay=None,
):
    """Momentum, applied only while the cost trends down and the recent
    normalized steps agree, decided on the host.

    ``v`` (memory_length, *g.shape) holds the last normalized steps (None
    to start), ``m`` the momentum (like ``g``, None to start) and
    ``errors`` the recent epoch costs, the current one last. The trend is
    read from ``errors``; the correlations of the steps are read back
    from ``g``'s device, and the friction is fitted to them in float64.
    Returns ``(direction, v, m)``. :func:`momentum_checked_traced` is the
    same step with the decision left on the device.
    """
    m = torch.zeros_like(g) if m is None else m
    previous_g = (
        torch.zeros((memory_length, *g.shape), dtype=g.dtype, device=g.device)
        if v is None
        else v
    )
    previous_g = torch.roll(previous_g, shifts=-1, dims=0)
    gnorm = linalg.norm(g)
    previous_g[-1] = g / torch.where(gnorm == 0, 1, gnorm) * beta
    if len(errors) > 2 and max(errors[-3], errors[-2]) > min(errors[-2], errors[-1]):
        corr = (
            linalg.inner(previous_g[:-1], previous_g[-1:], dim=(-2, -1))
            .real.flatten().cpu().numpy()
        )
        if np.all(corr > 0):
            friction, _ = fit_line_least_squares(
                x=np.arange(len(corr) + 1),
                y=[0.0] + np.log(corr).tolist(),
            )
            friction = 0.5 * max(-friction, 0)
            m = (1 - friction) * m + g
            return mdecay * m, previous_g, m
    return torch.zeros_like(g), previous_g, m / 2


def momentum_checked_traced(
    g,
    previous_g,
    m,
    mdecay,
    err_hist,
    n_epochs_done,
    beta=1.0,
):
    """Momentum, applied only while the cost trends down and the recent
    normalized steps agree.

    ``previous_g`` (3, *g.shape) holds the last normalized steps, ``m`` the
    momentum (like ``g``), ``err_hist`` the (3,) tail of the epoch-cost
    series with the current epoch last, and ``n_epochs_done`` the length of
    that series. The decision is a ``torch.where`` over device values, as
    in the JAX package's traced version. Returns ``(direction, previous_g,
    m)``.
    """
    previous_g = torch.roll(previous_g, shifts=-1, dims=0)
    gnorm = linalg.norm(g)
    previous_g = previous_g.clone()
    previous_g[-1] = g / torch.where(gnorm == 0, 1, gnorm) * beta
    trending = (n_epochs_done > 2) & (
        torch.maximum(err_hist[0], err_hist[1])
        > torch.minimum(err_hist[1], err_hist[2])
    )
    corr = linalg.inner(
        previous_g[:-1], previous_g[-1:], dim=(-2, -1)
    ).real.reshape(-1)
    allpos = torch.all(corr > 0)
    # Least-squares slope of [0, log corr...] against [0, 1, ...].
    y = torch.cat(
        [torch.zeros((1,), dtype=corr.dtype, device=corr.device),
         torch.log(torch.clamp(corr, min=1e-30))]
    )
    x = torch.arange(y.shape[0], dtype=y.dtype, device=y.device)
    count = y.shape[0]
    slope = (count * torch.sum(x * y) - x.sum() * y.sum()) / (
        count * torch.sum(x * x) - x.sum() ** 2
    )
    friction = 0.5 * torch.clamp(-slope, min=0)
    take = trending & allpos
    m_new = torch.where(take, (1 - friction) * m + g, m / 2)
    d = torch.where(take, mdecay * m_new, torch.zeros_like(g))
    return d, previous_g, m_new


HOST_READS = {
    "line_search": 0,
    "ptycho.costs": 0,
    "ptycho.powers": 0,
    "position.scan": 0,
    "position.initial_scan": 0,
    "probe.power": 0,
    "solvers.costs": 0,
}
"""Host reads by what was read (the module's docstring); counts from 0."""


def line_search(f, x, d, step_length, cost, linesearch_iterations=4):
    """Backtracking line search along ``d`` from ``x``.

    The semantics of ``tike_tpu.opt.line_search_traced``: try
    ``x + step * d``; stop at the first trial whose cost does not exceed
    ``cost``, else halve the step, at most ``linesearch_iterations`` times.
    A total failure keeps ``x`` with a zero step; a success on the first
    trial doubles the step for next time. ``step_length`` is a float32
    value and ``cost`` a 0-d float32 tensor. Returns ``(next_step_length,
    cost_at_new_x, new_x)``.
    """
    step0 = float(np.float32(step_length))
    step = step0
    for _ in range(linesearch_iterations):
        xsd = x + step * d
        fxsd = f(xsd).to(torch.float32)
        HOST_READS["line_search"] += 1
        if bool(fxsd <= cost):
            break
        step *= 0.5
    else:
        step, fxsd, xsd = 0.0, cost, x
    next_step = step0 / 0.5 if step == step0 else step
    return next_step, fxsd, xsd


def direction_dy(grad0, grad1, dir_):
    """Dai-Yuan conjugate gradient direction."""
    numer = linalg.inner(grad1, grad1)
    denom = torch.sum((grad1.conj() * dir_).real) - torch.sum(
        (grad0.conj() * dir_).real
    )
    gamma = numer / torch.where(denom == 0, 1e-32, denom)
    return -grad1 + gamma * dir_


def conjugate_gradient(x, cost_function, grad, num_iter=1, step_length=1,
                       linesearch_iterations=4):
    """Dai-Yuan CG with a backtracking line search on every iteration.

    The loop of ``tike_tpu.opt.conjugate_gradient_traced``, run eagerly.
    Returns ``(x, cost, next_step_length)``, the cost a 0-d float32 tensor.
    """
    grad1 = grad(x)
    dir_ = -grad1
    step = float(np.float32(step_length))
    cost = cost_function(x).to(torch.float32)
    for i in range(num_iter):
        if i > 0:
            grad0 = grad1
            grad1 = grad(x)
            dir_ = direction_dy(grad0, grad1, dir_)
        step, cost, x = line_search(
            cost_function, x, dir_, step, cost, linesearch_iterations
        )
    return x, cost, step


def _sum_squares(x):
    return torch.sum((x * torch.conj(x)).real)


def cgls(fwd, adj, b, x0, num_iter=4, sum_squares=_sum_squares):
    """CGLS, conjugate gradients on the normal equations of a LINEAR
    ``fwd``: one ``fwd`` and one ``adj`` per iteration with optimal step
    lengths, the residual kept incrementally. The loop of
    ``tike_tpu.opt.cgls_traced``; every decision stays on the device.
    ``sum_squares`` takes ``|q|^2`` summed over a value of ``fwd`` (the
    sum over several processes, where each holds a part of it).

    Returns ``(x, cost)``, cost = |fwd(x) - b|^2 as a 0-d tensor.
    """
    r = b - fwd(x0)
    s = adj(r)
    p = s
    gamma = torch.sum((s * torch.conj(s)).real)
    x = x0
    for _ in range(num_iter):
        q = fwd(p)
        qq = sum_squares(q)
        # A zero q means p is in the null space measured by the data: no
        # step can help, so freeze.
        alpha = torch.where(qq == 0, 0.0, gamma / torch.where(qq == 0, 1.0, qq))
        x = x + alpha * p
        r = r - alpha * q
        s = adj(r)
        gamma_new = torch.sum((s * torch.conj(s)).real)
        beta = torch.where(gamma == 0, 0.0, gamma_new / torch.where(gamma == 0, 1.0, gamma))
        gamma = gamma_new
        p = s + beta * p
    return x, sum_squares(r)
