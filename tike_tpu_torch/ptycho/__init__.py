"""Ptychography: the rPIE and LSQML solvers, multigrid, parameter model and options.

Public API mirrors :mod:`tike_tpu.ptycho` for what is ported: ``tike_tpu``
star-imports its submodules here, so every public function of those
submodules that the port has is re-exported below
(``tests/test_torch_namespaces.py`` holds the two namespaces to each other).
"""

from ..precision import cfloating, floating, integer
from ..utils.ndimage import (
    center_of_mass2d,
    gaussian_filter2d,
    integer_shift2d,
    median_filter2d,
)
from .exitwave import (
    ExitWaveOptions,
    poisson_steplength_all_modes,
    poisson_steplength_dominant_mode,
)
from .fresnel import MW_probe, single_probe
from .object import (
    ObjectOptions,
    clip_magnitude,
    get_absorbtion_image,
    get_padded_object,
    positivity_constraint,
    remove_object_ambiguity,
    smoothness_constraint,
)
from .position import (
    AffineTransform,
    PositionOptions,
    affine_position_regularization,
    check_allowed_positions,
    estimate_global_transformation,
    estimate_global_transformation_ransac,
    gaussian_gradient,
    update_positions_pd,
)
from .probe import (
    ProbeOptions,
    add_modes_cartesian_hermite,
    add_modes_random_phase,
    adjust_probe_power,
    apply_median_filter_abs_probe,
    constrain_center_peak,
    constrain_probe_sparsity,
    constrain_variable_probe,
    finite_probe_support,
    gaussian,
    get_varying_probe,
    init_varying_probe,
    orthogonalize_eig,
    power,
    rescale_probe_using_fixed_intensity_photons,
    simulate_varying_weights,
    update_eigen_probe,
)
from .ptycho import (
    Reconstruction,
    reconstruct,
    reconstruct_multigrid,
    simulate,
    simulate_device,
)
from .solvers import (
    IterativeOptions,
    LstsqOptions,
    PtychoParameters,
    RpieOptions,
    crop_fourier_space,
    lstsq_grad,
    pad_fourier_space,
    rpie,
    update_preconditioners,
)

__all__ = [
    "AffineTransform",
    "ExitWaveOptions",
    "IterativeOptions",
    "LstsqOptions",
    "MW_probe",
    "ObjectOptions",
    "PositionOptions",
    "ProbeOptions",
    "PtychoParameters",
    "Reconstruction",
    "RpieOptions",
    "add_modes_cartesian_hermite",
    "add_modes_random_phase",
    "adjust_probe_power",
    "affine_position_regularization",
    "apply_median_filter_abs_probe",
    "center_of_mass2d",
    "cfloating",
    "check_allowed_positions",
    "clip_magnitude",
    "constrain_center_peak",
    "constrain_probe_sparsity",
    "constrain_variable_probe",
    "crop_fourier_space",
    "estimate_global_transformation",
    "estimate_global_transformation_ransac",
    "finite_probe_support",
    "floating",
    "gaussian",
    "gaussian_filter2d",
    "gaussian_gradient",
    "get_absorbtion_image",
    "get_padded_object",
    "get_varying_probe",
    "init_varying_probe",
    "integer",
    "integer_shift2d",
    "lstsq_grad",
    "median_filter2d",
    "orthogonalize_eig",
    "pad_fourier_space",
    "poisson_steplength_all_modes",
    "poisson_steplength_dominant_mode",
    "positivity_constraint",
    "power",
    "reconstruct",
    "reconstruct_multigrid",
    "remove_object_ambiguity",
    "rescale_probe_using_fixed_intensity_photons",
    "rpie",
    "simulate",
    "simulate_device",
    "simulate_varying_weights",
    "single_probe",
    "smoothness_constraint",
    "update_eigen_probe",
    "update_positions_pd",
    "update_preconditioners",
]
