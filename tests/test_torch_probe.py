"""The port's seven feature probes (``tike_tpu_torch/toolchain_probe.py``)
against ``scripts/pallas_probe.py`` on the CPU.

The JAX probes run in Pallas's interpret mode (``pl.pallas_call`` wrapped
to pass ``interpret=True``), each call's output recorded under the name of
the probe that made it; the port's plain versions must give the same
arrays on the same all-ones inputs. ``element_static`` fails in JAX (its
kernel writes a (128, 256) block into a (1, 128, 256) one; ROADMAP section
3), so its intended function is held against numpy instead. On the
``arange``-valued inputs that the card runs, every plain version is held
against numpy.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tike_tpu_torch import kernels
from tike_tpu_torch import toolchain_probe as tp

from . import _torch_parity  # noqa: F401  (one torch thread per worker)
from . import _torch_probe_cases as cases

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
import pallas_probe  # noqa: E402

RUNNABLE = ["trivial", "gridded", "prefetch", "static_dma", "dynamic_dma", "element_prefetch"]


@pytest.fixture(scope="module")
def jax_outputs():
    """Run ``pallas_probe.main`` in interpret mode; probe name -> output."""
    original = pl.pallas_call
    recorded = {}

    def interpreted(*args, **kwargs):
        name = sys._getframe(1).f_code.co_name
        call = original(*args, **{**kwargs, "interpret": True})

        def run(*inputs):
            out = call(*inputs)
            if name in tp.PROBES:
                recorded[name] = np.asarray(out)
            return out

        return run

    pl.pallas_call = interpreted
    try:
        pallas_probe.main()
    finally:
        pl.pallas_call = original
    return recorded


def test_six_jax_probes_ran_and_element_static_did_not(jax_outputs):
    assert sorted(jax_outputs) == sorted(RUNNABLE)


@pytest.mark.parametrize("name", RUNNABLE)
def test_plain_probe_matches_jax_probe(jax_outputs, name):
    inp = tp.inputs("cpu", ones=True)
    got = tp.FUNCTIONS[name](*tp._args(name, inp))
    np.testing.assert_array_equal(got.numpy(), jax_outputs[name])


def _numpy_windows(big, corners, scale):
    return np.stack([scale * big[y : y + 128, x : x + 256] for y, x in corners])


def _numpy_reference(name, inp):
    x, big = inp["x"].numpy(), inp["big"].numpy()
    i = np.arange(8)
    return {
        "trivial": lambda: 2 * x[0],
        "gridded": lambda: 2 * x,
        "prefetch": lambda: x[inp["idx"].numpy()] + 1,
        "static_dma": lambda: x[0, 0:128, 0:128],
        "dynamic_dma": lambda: _numpy_windows(big, inp["dma_corners"].numpy(), 1),
        "element_static": lambda: _numpy_windows(big, np.stack([8 * i, 16 * i], -1), 2),
        "element_prefetch": lambda: _numpy_windows(big, np.stack([9 * i + 3, 17 * i + 5], -1), 2),
    }[name]()


@pytest.mark.parametrize("name", list(tp.PROBES))
def test_plain_probe_matches_numpy_on_arange_inputs(name):
    inp = tp.inputs("cpu")
    got = tp.FUNCTIONS[name](*tp._args(name, inp))
    np.testing.assert_array_equal(got.numpy(), _numpy_reference(name, inp))


def test_inputs_are_not_constant_and_corners_are_the_probes():
    inp = tp.inputs("cpu")
    assert len(torch.unique(inp["big"])) == 1024 * 1024
    assert inp["idx"].tolist() == list(range(7, -1, -1))
    assert inp["dma_corners"].tolist() == [[8 * i, 16 * i] for i in range(8)]
    assert inp["element_corners"].tolist() == [[9 * i + 3, 17 * i + 5] for i in range(8)]
    # The element probe's column starts are not on 16 bytes; dynamic_dma's are.
    assert (inp["element_corners"][1:, 1] % 4 != 0).any()
    assert (inp["dma_corners"][:, 1] % 4 == 0).all()


def test_main_runs_the_plain_versions_on_the_cpu(capsys):
    tp.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == list(tp.PROBES)


def test_check_catches_a_wrong_output():
    inp = tp.inputs("cpu")
    outputs = tp.run(inp)
    tp.check(outputs, inp)
    outputs["element_prefetch"] = outputs["element_prefetch"].clone()
    outputs["element_prefetch"][3, 5, 7] += 1
    with pytest.raises(AssertionError, match="element_prefetch"):
        tp.check(outputs, inp)


def test_cpu_calls_launch_nothing():
    before = dict(tp.LAUNCHES)
    tp.run(tp.inputs("cpu"))
    assert tp.LAUNCHES == before


def _source_constant(source, name):
    match = re.search(rf"constexpr int {name} = (\d+)[;,]", source)
    assert match is not None, name
    return int(match.group(1))


def test_band_constants_equal_those_of_the_source():
    """``BAND_ROWS``, which the window wrappers refuse rows by, is
    ``csrc/probe.cu``'s ``kBandRows``, and each window kernel's band
    divides it."""
    with open(os.path.join(kernels.CSRC, "probe.cu")) as f:
        source = f.read()
    band = _source_constant(source, "kBandRows")
    assert tp.BAND_ROWS == band
    for name in ("kDmaRows", "kElementRows"):
        assert band % _source_constant(source, name) == 0, name
    assert tp.ROWS % band == 0
    assert _source_constant(source, "kStaticRows") % _source_constant(source, "kStaticBandRows") == 0


@pytest.mark.parametrize("shape", cases.BIG_SHAPES)
@pytest.mark.parametrize("lead", cases.LEADS)
def test_plain_element_prefetch_matches_numpy_at_every_lead_and_edge(lead, shape):
    big = cases.random_big(np.random.default_rng(lead), shape, "cpu")
    corners = cases.edge_corners(shape, lead)
    # The corners have the lead, and reach the last row and (through the
    # row's span widened to 16 bytes) the last column.
    cx = corners[:, 1].numpy()
    assert (cx % 4 == lead).all()
    assert int(corners[:, 0].max()) + tp.ROWS == shape[0]
    assert int(cx.max()) - lead + 4 * -(-(lead + tp.WINDOW_COLS) // 4) == shape[1]
    got = tp.element_prefetch(corners, big)
    np.testing.assert_array_equal(got.numpy(), _numpy_windows(big.numpy(), corners.numpy(), 2))
    cases.check_windows(big, corners)


def test_library_calls_compute_the_probes():
    inp = tp.inputs("cpu")
    for name, call in cases.library_calls(inp).items():
        if call is not None:
            assert torch.equal(call(), tp.PLAIN[name](*tp._args(name, inp))), name


def test_probe_sweep_variants_apply_to_the_source():
    """Every default variant of ``kernel_sweep --source probe`` finds the
    text it replaces in ``csrc/probe.cu``, and the variants are distinct
    sources."""
    from tike_tpu_torch import kernel_sweep

    with open(kernel_sweep.PROBE_SOURCE) as f:
        source = f.read()
    variants = kernel_sweep.probe_variants(source)
    sources = {kernel_sweep.variant_source(source, subs) for subs in variants.values()}
    # Two variants repeat the source as it stands: the element kernel's and
    # the static-DMA kernel's kept settings.
    assert len(sources) == len(variants) - 2
    assert {"element (a) staged, float4, 8 rows", "static_dma 8 rows, 128 threads"} <= set(variants)
