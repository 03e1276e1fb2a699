"""Move solver state between tike_tpu and tike_tpu_torch.

The two packages share their parameter model: the same attribute names,
the same option dataclass fields and the same array layouts. These helpers
copy one into the other so that tests can start both from the same state.
They read attributes only and never import ``tike_tpu`` or ``jax``.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from .precision import cfloating, floating, to_numpy
from .ptycho.exitwave import ExitWaveOptions
from .ptycho.object import ObjectOptions
from .ptycho.position import PositionOptions
from .ptycho.probe import ProbeOptions
from .ptycho.solvers.options import LstsqOptions, PtychoParameters, RpieOptions

_ALGORITHMS = {"lstsq_grad": LstsqOptions, "rpie": RpieOptions}


def _convert_options(obj, cls):
    """Build ``cls`` from the same-named fields of a dataclass ``obj``."""
    if obj is None:
        return None
    fields = [f for f in dataclasses.fields(cls) if f.name != "name"]
    out = cls(
        **{f.name: copy.deepcopy(getattr(obj, f.name)) for f in fields if f.init}
    )
    for f in fields:
        if not f.init:
            setattr(out, f.name, copy.deepcopy(getattr(obj, f.name)))
    return out


def parameters_from_jax(p) -> PtychoParameters:
    """Return the port's PtychoParameters holding the state of ``p``.

    ``p`` is a ``tike_tpu`` PtychoParameters whose arrays are on the host
    (after its ``copy_to_host()``). The result holds numpy arrays; pass it
    to :class:`tike_tpu_torch.ptycho.Reconstruction`, which moves it to a
    device.
    """
    algo = p.algorithm_options
    if algo.name not in _ALGORITHMS:
        raise NotImplementedError(f"algorithm {algo.name!r} is not ported")
    return PtychoParameters(
        probe=np.asarray(p.probe).astype(cfloating),
        psi=np.asarray(p.psi).astype(cfloating),
        scan=np.asarray(p.scan).astype(floating),
        eigen_probe=None
        if p.eigen_probe is None
        else np.asarray(p.eigen_probe).astype(cfloating),
        eigen_weights=None
        if p.eigen_weights is None
        else np.asarray(p.eigen_weights).astype(floating),
        algorithm_options=_convert_options(algo, _ALGORITHMS[algo.name]),
        exitwave_options=_convert_options(p.exitwave_options, ExitWaveOptions),
        probe_options=_convert_options(p.probe_options, ProbeOptions),
        object_options=_convert_options(p.object_options, ObjectOptions),
        position_options=_convert_options(p.position_options, PositionOptions),
    )


def parameters_to_numpy(p) -> dict:
    """Return the arrays and histories of either package's parameters.

    Keys: ``probe``, ``psi``, ``scan``, ``eigen_probe``, ``eigen_weights``
    (numpy arrays or None) and ``costs``, ``times`` (lists), for comparing
    a ``tike_tpu`` result with a ``tike_tpu_torch`` one.
    """
    return {
        "probe": to_numpy(p.probe),
        "psi": to_numpy(p.psi),
        "scan": to_numpy(p.scan),
        "eigen_probe": to_numpy(p.eigen_probe),
        "eigen_weights": to_numpy(p.eigen_weights),
        "costs": [list(c) for c in p.algorithm_options.costs],
        "times": list(p.algorithm_options.times),
    }
