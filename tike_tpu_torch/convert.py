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
from .ptycho.position import AffineTransform, PositionOptions
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


def _convert_moment_options(opts, cls):
    """Build the port's ObjectOptions or ProbeOptions from a tike_tpu one,
    its moment states (``v``, ``m``; device arrays after a fused call)
    as numpy arrays."""
    out = _convert_options(opts, cls)
    if out is not None:
        out.v, out.m = to_numpy(opts.v), to_numpy(opts.m)
    return out


def _convert_position_options(popt) -> PositionOptions | None:
    """Build the port's PositionOptions from a tike_tpu one, its affine
    transform, momentum, initial scan and confidence included."""
    out = _convert_options(popt, PositionOptions)
    if out is not None:
        out.transform = AffineTransform(*popt.transform.astuple())
        for name in ("initial_scan", "confidence", "_momentum"):
            value = getattr(out, name)
            if value is not None:
                setattr(out, name, np.asarray(value).astype(floating))
    return out


def parameters_from_jax(p) -> PtychoParameters:
    """Return the port's PtychoParameters holding the state of ``p``.

    ``p`` is a ``tike_tpu`` PtychoParameters whose arrays are on the host
    (after its ``copy_to_host()``). The result holds numpy arrays, the
    object and probe moment states included; pass it to
    :class:`tike_tpu_torch.ptycho.Reconstruction`, which moves it to a
    device. Every field of the algorithm options is carried, ``RpieOptions.alpha``
    among them.
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
        probe_options=_convert_moment_options(p.probe_options, ProbeOptions),
        object_options=_convert_moment_options(p.object_options, ObjectOptions),
        position_options=_convert_position_options(p.position_options),
    )


def parameters_to_numpy(p) -> dict:
    """Return the arrays and histories of either package's parameters.

    Keys: ``probe``, ``psi``, ``scan``, ``eigen_probe``, ``eigen_weights``
    (numpy arrays or None), ``costs``, ``times`` (lists), and from the
    position options ``initial_scan``, ``confidence``, ``position_momentum``
    (arrays or None), ``transform`` (the affine transform's 6-tuple, or
    None), and the moment states ``object_v``, ``object_m``, ``probe_v``,
    ``probe_m`` (arrays or None), for comparing a ``tike_tpu`` result with
    a ``tike_tpu_torch`` one.
    """
    popt = p.position_options
    oopt, prb = p.object_options, p.probe_options
    return {
        "object_v": None if oopt is None else to_numpy(oopt.v),
        "object_m": None if oopt is None else to_numpy(oopt.m),
        "probe_v": None if prb is None else to_numpy(prb.v),
        "probe_m": None if prb is None else to_numpy(prb.m),
        "initial_scan": None if popt is None else to_numpy(popt.initial_scan),
        "confidence": None if popt is None else to_numpy(popt.confidence),
        "position_momentum": None if popt is None else to_numpy(popt._momentum),
        "transform": None if popt is None else tuple(popt.transform.astuple()),
        "probe": to_numpy(p.probe),
        "psi": to_numpy(p.psi),
        "scan": to_numpy(p.scan),
        "eigen_probe": to_numpy(p.eigen_probe),
        "eigen_weights": to_numpy(p.eigen_weights),
        "costs": [list(c) for c in p.algorithm_options.costs],
        "times": list(p.algorithm_options.times),
    }
