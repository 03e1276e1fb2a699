"""Tensor operators: the compute core of tike_tpu_torch.

Counterpart of :mod:`tike_tpu.ops`; the patch gather/scatter and the
USFFT's KB gather/scatter (:mod:`.usfft`, under :mod:`.lamino`) run as
hand-written CUDA kernels on CUDA tensors.
"""

from .patch import patch_adj, patch_fwd
from .propagation import propagation_adj, propagation_fwd
from .objective import (
    gaussian,
    gaussian_each_pattern,
    gaussian_grad,
    poisson,
    poisson_each_pattern,
    poisson_grad,
)
from .ptycho import (
    PtychoConfig,
    intensity_from_farplane,
    ptycho_cost,
    ptycho_fwd,
    simulate_intensity,
)
