"""Tensor operators: the compute core of tike_tpu_torch.

Counterpart of :mod:`tike_tpu.ops`; the patch gather/scatter, the USFFT's
KB gather/scatter (:mod:`.usfft`, under :mod:`.lamino`), the Bucket
projection pair (:mod:`.bucket`) and the alignment's Lanczos remap pair
(:mod:`.interp`, under :mod:`.flow` and :mod:`.rotate`) run as hand-written
CUDA kernels on CUDA tensors.
"""

from .patch import patch_adj, patch_fwd, patch_fwd_padded
from .propagation import (
    fresnel_adj,
    fresnel_fwd,
    fresnel_spectrum_propagator,
    propagation_adj,
    propagation_fwd,
)
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
    multislice_fwd,
    ptycho_adj,
    ptycho_cost,
    ptycho_fwd,
    ptycho_fwd_with_probes,
    simulate_intensity,
)
