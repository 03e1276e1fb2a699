"""Seven feature probes of the Hopper toolchain, each a hand-written kernel.

Counterpart of ``scripts/pallas_probe.py``, which asks which Mosaic
features the TPU's compiler accepts. Each probe here is a CUDA kernel of
``csrc/probe.cu`` that computes what its Pallas probe computes, with the
card's own form of the feature (a launch grid, indices read by the block,
``cp.async``, Hopper's bulk asynchronous copy on an mbarrier), beside its
plain PyTorch expression. Run on a machine with a CUDA card:

    python -m tike_tpu_torch.toolchain_probe

It builds the kernels, runs each probe on non-constant (``arange``-valued)
inputs, prints one line per probe, and raises at the first probe whose
kernel does not build, launch, or equal its plain version bit for bit.
Pass ``--device cpu`` to run the plain versions alone.

Each probe function dispatches on its inputs' device: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise. The probes that take
an index array read it on the host first (the kernels do not clip); a
caller that has checked the indices itself passes ``check_indices=False``,
and the call then reads nothing back, so a CUDA graph can capture it.
"""

from __future__ import annotations

import argparse

import torch

from . import kernels

PROBES = {
    # name: (what it computes, the Pallas probe's kernel and call)
    "trivial": ("o = 2 x, one block of float4s", "scripts/pallas_probe.py:41-48 (:45)"),
    "gridded": (
        "o = 2 x over (8, 128, 128), a 2-D launch grid",
        "scripts/pallas_probe.py:52-63 (:56)",
    ),
    "prefetch": (
        "o[i] = x[idx[i]] + 1, the block reading its index",
        "scripts/pallas_probe.py:67-89 (:84)",
    ),
    "static_dma": (
        "x[0:128, 0:128] by 16-byte cp.async into shared memory",
        "scripts/pallas_probe.py:93-113 (:102)",
    ),
    "dynamic_dma": (
        "big[cy:+128, cx:+256] at read corners, cp.async.bulk in (mbarrier) and out",
        "scripts/pallas_probe.py:117-151 (:146)",
    ),
    "element_static": (
        "2 big[8i:+128, 16i:+256], starts from the block index",
        "scripts/pallas_probe.py:155-173 (:161)",
    ),
    "element_prefetch": (
        "2 big[9i+3:+128, 17i+5:+256], unaligned read starts",
        "scripts/pallas_probe.py:178-204 (:199)",
    ),
}

LAUNCHES = {name: 0 for name in PROBES}
"""How many times each probe kernel has been launched in this process."""

PLANES, ROWS, COLS = 8, 128, 128  # x
BIG, WINDOW_COLS = 1024, 256  # big (1024, 1024); windows (128, 256)
BAND_ROWS = 8  # csrc/probe.cu kBandRows


def inputs(device, ones: bool = False) -> dict:
    """The probes' inputs: ``x`` (8, 128, 128) and ``big`` (1024, 1024)
    float32, ``arange``-valued (all ones, as the Pallas probes use, with
    ``ones``); ``idx`` 7..0, the windows' corners ``dma_corners`` (8i, 16i)
    and ``element_corners`` (9i + 3, 17i + 5), int32."""
    i = torch.arange(PLANES, dtype=torch.int32, device=device)
    if ones:
        x = torch.ones((PLANES, ROWS, COLS), device=device)
        big = torch.ones((BIG, BIG), device=device)
    else:
        x = torch.arange(PLANES * ROWS * COLS, dtype=torch.float32, device=device)
        x = x.reshape(PLANES, ROWS, COLS)
        big = torch.arange(BIG * BIG, dtype=torch.float32, device=device)
        big = big.reshape(BIG, BIG)
    return {
        "x": x,
        "big": big,
        "idx": torch.flip(i, [0]).contiguous(),
        "dma_corners": torch.stack([8 * i, 16 * i], -1).contiguous(),
        "element_corners": torch.stack([9 * i + 3, 17 * i + 5], -1).contiguous(),
    }


def _windows(big, corners, rows=ROWS, cols=WINDOW_COLS):
    return torch.stack(
        [big[int(cy) : int(cy) + rows, int(cx) : int(cx) + cols] for cy, cx in corners.tolist()]
    )


def _element_static_corners(device):
    i = torch.arange(PLANES, device=device)
    return torch.stack([8 * i, 16 * i], -1)


# The plain PyTorch expression of each probe.
PLAIN = {
    "trivial": lambda x: x * 2.0,
    "gridded": lambda x: x * 2.0,
    "prefetch": lambda idx, x: x[idx.long()] + 1.0,
    "static_dma": lambda x: x[0:ROWS, 0:COLS].clone(),
    "dynamic_dma": lambda corners, big: _windows(big, corners),
    "element_static": lambda big: 2.0 * _windows(big, _element_static_corners(big.device)),
    "element_prefetch": lambda corners, big: 2.0 * _windows(big, corners),
}


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, not on {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)}; "
            f"got {t.dtype} {tuple(t.shape)}"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_corners(corners, big, rows, align: bool) -> None:
    """The windows must lie inside ``big`` (the kernels do not clip) and,
    for the bulk copy of exact rows, start on 16 bytes. One host read."""
    c = corners.cpu()
    if len(c) and (
        int(c.min()) < 0
        or int(c[:, 0].max()) + rows > big.shape[0]
        or int(c[:, 1].max()) + WINDOW_COLS > big.shape[1]
    ):
        raise ValueError(f"windows at {c.tolist()} leave big {tuple(big.shape)}")
    if align and bool((c[:, 1] % 4 != 0).any()):
        raise ValueError("dynamic_dma's column starts must be multiples of 4 floats")


def _launch(name: str, fn, device, *args) -> None:
    """Call the C entry point ``fn`` on ``args`` (tensors pass their data
    pointers) and the current stream; count the launch."""
    with torch.cuda.device(device):
        rc = fn(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"probe {name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def trivial(x):
    """o = 2 x over one (128, 128) plane, in one block."""
    if not x.is_cuda:
        return PLAIN["trivial"](x)
    _check("x", x, torch.float32, x.shape)
    out = torch.empty_like(x)
    _launch("trivial", kernels.load("probe").tike_probe_trivial, x.device, x, out, x.numel())
    return out


def gridded(x):
    """o = 2 x over (planes, rows, cols): a block per band of rows of a
    plane, on a 2-D launch grid."""
    if not x.is_cuda:
        return PLAIN["gridded"](x)
    _check("x", x, torch.float32, x.shape)
    planes, rows, cols = x.shape
    if cols > 1024:
        raise ValueError(f"gridded takes at most 1024 columns; got {cols}")
    out = torch.empty_like(x)
    lib = kernels.load("probe")
    _launch("gridded", lib.tike_probe_gridded, x.device, x, out, planes, rows, cols)
    return out


def prefetch(idx, x, check_indices: bool = True):
    """o[i] = x[idx[i]] + 1, each block reading its plane's index."""
    if not x.is_cuda:
        return PLAIN["prefetch"](idx, x)
    _check("x", x, torch.float32, x.shape)
    _check("idx", idx, torch.int32, (x.shape[0],))
    if check_indices:
        c = idx.cpu()
        if len(c) and (int(c.min()) < 0 or int(c.max()) >= x.shape[0]):
            raise ValueError(f"indices {c.tolist()} out of range for {x.shape[0]} planes")
    out = torch.empty_like(x)
    plane = x[0].numel()
    lib = kernels.load("probe")
    _launch("prefetch", lib.tike_probe_prefetch, x.device, idx, x, out, x.shape[0], plane)
    return out


def static_dma(x):
    """The window x[0:128, 0:128] of a (>= 128, >= 128) plane, through
    shared memory by ``cp.async``."""
    if not x.is_cuda:
        return PLAIN["static_dma"](x)
    _check("x", x, torch.float32, x.shape)
    if x.dim() != 2 or x.shape[0] < ROWS or x.shape[1] < COLS or x.shape[1] % 4:
        raise ValueError(f"static_dma takes a (>= {ROWS}, >= {COLS}) plane of a "
                         f"width that is a multiple of 4; got {tuple(x.shape)}")
    out = torch.empty((ROWS, COLS), dtype=x.dtype, device=x.device)
    lib = kernels.load("probe")
    _launch("static_dma", lib.tike_probe_static_dma, x.device, x, out, x.shape[1])
    return out


def _windows_cuda(name, fn, corners, big, check_indices=True, rows=ROWS):
    _check("big", big, torch.float32, big.shape)
    if big.dim() != 2 or big.shape[1] % 4 or rows % BAND_ROWS:
        raise ValueError(f"{name} takes a 2-D big of a width that is a multiple of 4 "
                         f"and windows of a multiple of {BAND_ROWS} rows")
    planes = PLANES if corners is None else corners.shape[0]
    if corners is not None:
        _check("corners", corners, torch.int32, (planes, 2))
    if check_indices:
        _check_corners(
            _element_static_corners(big.device) if corners is None else corners,
            big, rows, align=name == "dynamic_dma",
        )
    out = torch.empty((planes, rows, WINDOW_COLS), dtype=big.dtype, device=big.device)
    _launch(name, fn, big.device, corners, big, out, planes, rows, big.shape[1])
    return out


def dynamic_dma(corners, big, check_indices: bool = True):
    """o[i] = big[cy:cy+128, cx:cx+256] at the corners (planes, 2) int32,
    each row in by one ``cp.async.bulk`` and each band of 8 rows out by
    one; cx must be a multiple of 4."""
    if not big.is_cuda:
        return PLAIN["dynamic_dma"](corners, big)
    fn = kernels.load("probe").tike_probe_dynamic_dma
    return _windows_cuda("dynamic_dma", fn, corners, big, check_indices)


def element_static(big, check_indices: bool = True):
    """o[i] = 2 big[8i:8i+128, 16i:16i+256] for i < 8 (the Pallas probe's
    intended function; the probe itself fails, ROADMAP section 3)."""
    if not big.is_cuda:
        return PLAIN["element_static"](big)
    fn = kernels.load("probe").tike_probe_element
    return _windows_cuda("element_static", fn, None, big, check_indices)


def element_prefetch(corners, big, check_indices: bool = True):
    """o[i] = 2 big[cy:cy+128, cx:cx+256] at any corners (planes, 2) int32."""
    if not big.is_cuda:
        return PLAIN["element_prefetch"](corners, big)
    fn = kernels.load("probe").tike_probe_element
    return _windows_cuda("element_prefetch", fn, corners, big, check_indices)


def _args(name: str, inp: dict) -> tuple:
    return {
        "trivial": (inp["x"][0],),
        "gridded": (inp["x"],),
        "prefetch": (inp["idx"], inp["x"]),
        "static_dma": (inp["x"][0],),
        "dynamic_dma": (inp["dma_corners"], inp["big"]),
        "element_static": (inp["big"],),
        "element_prefetch": (inp["element_corners"], inp["big"]),
    }[name]


INDEXED = ("prefetch", "dynamic_dma", "element_static", "element_prefetch")
"""The probes that read an index array on the host unless told not to."""

FUNCTIONS = {
    "trivial": trivial,
    "gridded": gridded,
    "prefetch": prefetch,
    "static_dma": static_dma,
    "dynamic_dma": dynamic_dma,
    "element_static": element_static,
    "element_prefetch": element_prefetch,
}


def run(inp: dict) -> dict:
    """Each probe once on the inputs of :func:`inputs`: name -> output."""
    return {name: fn(*_args(name, inp)) for name, fn in FUNCTIONS.items()}


def check(outputs: dict, inp: dict) -> None:
    """Raise unless every output equals its probe's plain version on the
    same inputs, bit for bit."""
    for name, got in outputs.items():
        want = PLAIN[name](*_args(name, inp))
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"probe {name}: the kernel differs from its plain version")


def bound_bytes(name: str, inp: dict, out: torch.Tensor) -> int:
    """The bytes a probe must move at the least: every output value
    written once, the values it copies read once, and its index array."""
    index = {"prefetch": "idx", "dynamic_dma": "dma_corners", "element_prefetch": "element_corners"}
    extra = inp[index[name]].numel() * 4 if name in index else 0
    return 2 * out.numel() * out.element_size() + extra


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        kernels.load("probe")
    inp = inputs(device)
    outputs = run(inp)
    check(outputs, inp)
    if device.type == "cuda":
        torch.cuda.synchronize()
    width = max(len(name) for name in PROBES)
    how = "kernel equal to its plain version" if device.type == "cuda" else "plain version ran"
    for name, (what, where) in PROBES.items():
        print(f"{name:<{width}} : OK, {how} ({what}; {where})")


if __name__ == "__main__":
    main()
