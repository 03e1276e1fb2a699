"""Complex linear algebra helpers (PyTorch).

Counterpart of :mod:`tike_tpu.linalg`.
"""

from __future__ import annotations

import torch


def mnorm(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Return the root-mean-square magnitude (norm normalized by count)."""
    sq = (x * x.conj()).real if x.is_complex() else x * x
    if dim is None:
        return torch.sqrt(torch.mean(sq))
    return torch.sqrt(torch.mean(sq, dim=dim, keepdim=keepdim))


def norm(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Return the complex vector 2-norm: sqrt(sum(|x|^2))."""
    sq = (x * x.conj()).real if x.is_complex() else x * x
    if dim is None:
        return torch.sqrt(torch.sum(sq))
    return torch.sqrt(torch.sum(sq, dim=dim, keepdim=keepdim))


def hermitian(x: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose of x along the last two dims."""
    return torch.conj_physical(x).transpose(-1, -2)


def cov(x: torch.Tensor) -> torch.Tensor:
    """Covariance of x, observations along dim -2 (not normalized)."""
    x0 = x - torch.mean(x, dim=-2, keepdim=True)
    return hermitian(x0) @ x0


def inner(x: torch.Tensor, y: torch.Tensor, dim=None, keepdim: bool = False):
    """Return the complex inner product <x|y> = sum(conj(x) * y)."""
    prod = torch.conj(x) * y
    if dim is None:
        return torch.sum(prod)
    return torch.sum(prod, dim=dim, keepdim=keepdim)


def projection(a: torch.Tensor, b: torch.Tensor, dim=None) -> torch.Tensor:
    """Return the vector projection of a onto b."""
    return inner(b, a, dim=dim, keepdim=True) / inner(b, b, dim=dim, keepdim=True) * b


def lstsq(a: torch.Tensor, b: torch.Tensor, weights=None) -> torch.Tensor:
    """Return the least-squares solution x of a @ x = b by the normal
    equations, a (..., M, N), b (..., M, K) -> x (..., N, K), optionally
    with per-row ``weights`` (..., M): the batched solve of the tiny (2x2)
    systems ptychography needs."""
    aT = a.transpose(-1, -2).conj()
    if weights is not None:
        aT = aT * weights[..., None, :]
    return torch.linalg.solve(aT @ a, aT @ b)


def orthogonalize_gs(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """Gram-Schmidt orthogonalize vectors whose components lie along
    ``dim`` (an int or a tuple of dims).

    The vectors are enumerated along the axis just before the first
    component axis (for a (..., MODES, W, H) array and ``dim=(-2, -1)``, the
    modes); from each, its projections onto the orthogonalized ones
    before it are subtracted in order (classical Gram-Schmidt: every
    coefficient from the original vector), each denominator offset by
    1e-32, as in the JAX package.
    """
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    dims = tuple(d % x.dim() for d in dims)
    rest = [d for d in range(x.dim()) if d not in dims]
    perm = rest + list(dims)
    xt = x.permute(perm)
    comp_shape = xt.shape[len(rest):]
    lead, nvec = xt.shape[: len(rest) - 1], xt.shape[len(rest) - 1]
    flat = xt.reshape(*lead, nvec, -1)
    u = []
    for i in range(nvec):
        vi = flat[..., i, :]
        ui = vi
        for uj in u:
            coef = inner(uj, vi, dim=-1, keepdim=True) / (
                inner(uj, uj, dim=-1, keepdim=True) + 1e-32
            )
            ui = ui - coef * uj
        u.append(ui)
    out = torch.stack(u, dim=-2).reshape(*lead, nvec, *comp_shape)
    inv = [0] * x.dim()
    for k, p in enumerate(perm):
        inv[p] = k
    return out.permute(inv)


def pca_eig(data: torch.Tensor, k: int):
    """Return the k principal components of data by eigendecomposition.

    data (N, ...) with its features flattened after the first axis;
    returns ``(S (k,), U (k, ...))``, the largest k eigenvalues of
    ``data^H data`` in descending order and their eigenvectors. Each
    eigenvector's sign or phase is the eigensolver's choice.
    """
    flat = data.reshape(data.shape[0], -1)
    vals, vecs = torch.linalg.eigh(flat.conj().T @ flat)
    # eigh is ascending; take the top k descending.
    vals = torch.flip(vals, dims=(0,))[:k]
    vecs = torch.flip(vecs, dims=(1,))[:, :k]
    return vals, vecs.T.reshape(k, *data.shape[1:])
