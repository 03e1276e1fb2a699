"""Global dtype policy: all compute is float32 / complex64.

Counterpart of :mod:`tike_tpu.precision`. The numpy names describe host
arrays. Every public function takes and returns complex64 tensors for
complex fields and float32 for real ones; the two helpers below cast at
each host/device boundary, because ``torch.from_numpy`` keeps numpy's
float64 and complex128.
"""

from __future__ import annotations

import numpy as np
import torch

floating = np.float32
cfloating = np.complex64
integer = np.int32


def as_tensor(x, dtype: torch.dtype, device=None) -> torch.Tensor:
    """Return ``x`` (array or tensor) as a tensor of ``dtype`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    a = np.asarray(x)
    if not a.flags.writeable:  # e.g. a JAX array's numpy view
        a = a.copy()
    return torch.as_tensor(a, dtype=dtype, device=device)


def to_numpy(x) -> np.ndarray | None:
    """Return a host numpy copy of a tensor (arrays pass through)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
