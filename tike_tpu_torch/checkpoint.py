"""Checkpoint save/load for ptychography solver state (PyTorch).

Counterpart of :mod:`tike_tpu.checkpoint`, in the same file format: one
``.npz`` of arrays with a JSON header of the option fields (stored as the
uint8 array ``__header__``). The two packages' option dataclasses have the
same fields, so a file that either package writes loads in the other. AdaM
moments, cost and time histories, and the affine position transform all
round-trip, so a reconstruction resumes where it stopped.

Tensors (on any device) are copied to the host on save; ``load_parameters``
returns numpy arrays, which :class:`~tike_tpu_torch.ptycho.Reconstruction`
moves to its device.
"""

from __future__ import annotations

import dataclasses
import json
import typing

import numpy as np
import torch

from .precision import to_numpy
from .ptycho.exitwave import ExitWaveOptions
from .ptycho.object import ObjectOptions
from .ptycho.position import AffineTransform, PositionOptions
from .ptycho.probe import ProbeOptions
from .ptycho.solvers.options import LstsqOptions, PtychoParameters, RpieOptions

__all__ = ["save_parameters", "load_parameters"]

_ALGO_TYPES = {"rpie": RpieOptions, "lstsq_grad": LstsqOptions}


def _host(v):
    """A tensor as a numpy array; anything else as it is."""
    return to_numpy(v) if isinstance(v, torch.Tensor) else v


def _split_fields(obj, arrays, prefix):
    """Separate array fields (saved to npz) from JSON-able scalars."""
    meta = {}
    for f in dataclasses.fields(obj):
        v = _host(getattr(obj, f.name))
        if v is None:
            meta[f.name] = None
        elif isinstance(v, AffineTransform):
            meta[f.name] = {"__affine__": list(v.astuple())}
        elif hasattr(v, "shape") and getattr(v, "ndim", 0) > 0:
            key = f"{prefix}.{f.name}"
            arrays[key] = np.asarray(v)
            meta[f.name] = {"__array__": key}
        elif isinstance(v, (list, tuple)):
            try:
                json.dumps(v)
                meta[f.name] = list(v)
            except TypeError:
                key = f"{prefix}.{f.name}"
                arrays[key] = np.asarray([_host(e) for e in v])
                meta[f.name] = {"__array__": key, "__aslist__": True}
        elif isinstance(v, (bool, int, str)):
            meta[f.name] = v
        elif isinstance(v, float) or np.isscalar(v) or getattr(v, "ndim", None) == 0:
            meta[f.name] = float(v)
        else:
            meta[f.name] = None
    return meta


def _restore_fields(cls, meta, arrays):
    init_fields = {f.name for f in dataclasses.fields(cls) if f.init}

    def decode(v):
        if isinstance(v, dict) and "__array__" in v:
            arr = arrays[v["__array__"]]
            return arr.tolist() if v.get("__aslist__") else arr
        if isinstance(v, dict) and "__affine__" in v:
            return AffineTransform(*v["__affine__"])
        return v

    obj = cls(
        **{
            k: decode(v)
            for k, v in meta.items()
            if k in init_fields and not k.startswith("_")
        }
    )
    # Non-init fields: moments, histories, preconditioners.
    for k, v in meta.items():
        if k not in init_fields:
            try:
                setattr(obj, k, decode(v))
            except dataclasses.FrozenInstanceError:
                pass
    return obj


def save_parameters(path: str, parameters: PtychoParameters) -> None:
    """Serialize PtychoParameters (host arrays or tensors on any device) to
    a single .npz file."""
    p = parameters.copy_to_host()
    arrays: typing.Dict[str, np.ndarray] = {
        "probe": np.asarray(p.probe),
        "psi": np.asarray(p.psi),
        "scan": np.asarray(p.scan),
    }
    if p.eigen_probe is not None:
        arrays["eigen_probe"] = np.asarray(p.eigen_probe)
    if p.eigen_weights is not None:
        arrays["eigen_weights"] = np.asarray(p.eigen_weights)

    header = {"algorithm": p.algorithm_options.name}
    header["algorithm_options"] = _split_fields(p.algorithm_options, arrays, "algo")
    for name, opts in (
        ("exitwave_options", p.exitwave_options),
        ("probe_options", p.probe_options),
        ("object_options", p.object_options),
        ("position_options", p.position_options),
    ):
        if opts is None:
            header[name] = None
            continue
        header[name] = _split_fields(opts, arrays, name)
        # PositionOptions hides its momentum behind a private field.
        if name == "position_options" and opts._momentum is not None:
            arrays["position_options._momentum"] = np.asarray(_host(opts._momentum))
            header[name]["_momentum"] = {"__array__": "position_options._momentum"}

    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_parameters(path: str) -> PtychoParameters:
    """Load PtychoParameters saved by :func:`save_parameters` (of either
    package), with numpy arrays."""
    with np.load(path, allow_pickle=False) as f:
        arrays = {k: f[k] for k in f.files}
    header = json.loads(bytes(arrays.pop("__header__")).decode())

    algorithm_options = _restore_fields(
        _ALGO_TYPES[header["algorithm"]], header["algorithm_options"], arrays
    )

    def restore(name, cls):
        meta = header[name]
        return None if meta is None else _restore_fields(cls, meta, arrays)

    return PtychoParameters(
        probe=arrays["probe"],
        psi=arrays["psi"],
        scan=arrays["scan"],
        eigen_probe=arrays.get("eigen_probe"),
        eigen_weights=arrays.get("eigen_weights"),
        algorithm_options=algorithm_options,
        exitwave_options=restore("exitwave_options", ExitWaveOptions),
        probe_options=restore("probe_options", ProbeOptions),
        object_options=restore("object_options", ObjectOptions),
        position_options=restore("position_options", PositionOptions),
    )
