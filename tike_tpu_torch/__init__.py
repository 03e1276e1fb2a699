"""tike-tpu on PyTorch: ptychography, laminography and alignment for NVIDIA
Hopper GPUs.

A port of :mod:`tike_tpu` (the JAX package beside this one, which stays the
reference) to eager PyTorch. Module paths mirror ``tike_tpu``'s, so each
function's counterpart sits at the same relative path. The bilinear patch
gather and scatter, which ``tike_tpu`` wrote as Pallas kernels for the TPU,
and the USFFT's gather and scatter, which it wrote as XLA einsums for the
TPU's matrix unit (Kaiser-Bessel) and as tap scans (Gaussian), are
hand-written CUDA kernels here (``csrc/patch.cu``, ``csrc/usfft.cu``,
``csrc/usfft_gaussian.cu``), as is the Bucket laminography
operator's voxel projection and its adjoint, XLA scatter and gather code
there (``csrc/bucket.cu``), and so is the alignment's Lanczos remap and its
adjoint, XLA tap scans there (``csrc/interp.cu``, under the flow warp and the
rotation of ``align``); all are built with ``nvcc`` at first use on
a CUDA tensor; ``toolchain_probe`` holds the kernels of ``csrc/probe.cu``,
the counterparts of the JAX package's Pallas feature probes. ``admm`` joins
ptychography and laminography into one reconstruction, and
``ptycho.stream`` feeds a reconstruction from pinned host memory when the
patterns exceed the card. Multislice objects propagate the wave between
slices by the Fresnel spectrum propagators of ``ops.propagation``, on cuFFT.
``align`` is imported on its own, as ``tike_tpu.align`` is, and so are
``view`` and ``ptycho.io``, whose ``matplotlib`` and ``h5py`` are imported
only when a function is called. On CPU tensors
every function runs its plain PyTorch version, which the tests hold against
``tike_tpu``.

This package never imports ``jax`` or ``tike_tpu``.
"""

__version__ = "0.1.0"

from . import checkpoint
from . import cluster
from . import constants
from . import linalg
from . import opt
from . import precision
from . import random
from . import scan
from . import trajectory
