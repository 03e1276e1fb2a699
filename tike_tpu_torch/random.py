"""Random number helpers for complex data types.

Counterpart of :mod:`tike_tpu.random`. ``numpy_complex`` draws on the host
from a numpy generator, the same bits as the JAX package's from the same
one; ``torch_complex`` draws on a device from an explicit
``torch.Generator``, where the JAX package's ``jax_complex`` takes a PRNG key.
"""

import warnings

import numpy as np
import torch

from .precision import cfloating, floating

randomizer_np = np.random.default_rng()


def numpy_complex(*shape, rng=None):
    """Return a complex random array in the range [-0.5, 0.5)."""
    rng = randomizer_np if rng is None else rng
    return (
        rng.random(size=(*shape, 2), dtype=floating) - 0.5
    ).view(cfloating)[..., 0]


def torch_complex(*shape, generator=None, device=None) -> torch.Tensor:
    """Return a complex64 random tensor with real and imaginary parts in
    [-0.5, 0.5), drawn from ``generator`` on ``device``.

    ``device`` defaults to the generator's device, or to ``"cuda"`` without
    a generator.
    """
    if device is None:
        device = "cuda" if generator is None else generator.device
    pairs = torch.rand(
        (*shape, 2), generator=generator, dtype=torch.float32, device=device
    )
    return torch.view_as_complex(pairs - 0.5)


def _deprecated(name: str, new: str):
    warnings.warn(
        f"tike_tpu_torch.random.{name} is deprecated. "
        f"Use tike_tpu_torch.cluster.{new} instead.",
        DeprecationWarning,
    )
    from . import cluster

    return getattr(cluster, new)


def cluster_wobbly_center(*args, **kwargs):
    """Deprecated alias for :func:`tike_tpu_torch.cluster.wobbly_center`."""
    return _deprecated("cluster_wobbly_center", "wobbly_center")(*args, **kwargs)


def cluster_compact(*args, **kwargs):
    """Deprecated alias for :func:`tike_tpu_torch.cluster.compact`."""
    return _deprecated("cluster_compact", "compact")(*args, **kwargs)
