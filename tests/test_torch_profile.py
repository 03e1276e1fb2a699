"""The epoch profiler's trace arithmetic (``tike_tpu_torch.profile_epoch``).

The profiler itself needs a CUDA card; what it does with a trace does not.
"""

import pytest

from tike_tpu_torch import profile_epoch


@pytest.mark.parametrize(
    "cat, name, want",
    [
        ("kernel", "void (anonymous namespace)::kb_gather_kernel<1>(float2 const*, ...)", "kb_gather_kernel (ours)"),
        ("kernel", "void (anonymous namespace)::kb_scatter_kernel<2>(float2 const*, ...)", "kb_scatter_kernel (ours)"),
        ("kernel", "patch_fwd_kernel(float2 const*, ...)", "patch_fwd_kernel (ours)"),
        ("kernel", "patch_adj_kernel(float2 const*, ...)", "patch_adj_kernel (ours)"),
        ("kernel", "void vector_2d_fft<128u, 128u, EPT<16u>>(...)", "cuFFT"),
        ("kernel", "void at::native::reduce_kernel<512, 1, ReduceOp<...>>", "reductions (sum, mean, amax)"),
        ("kernel", "void at::native::indexing_backward_kernel<...>", "sort, index, cat, memset, memcpy"),
        ("gpu_memset", "Memset (Device)", "sort, index, cat, memset, memcpy"),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", "sort, index, cat, memset, memcpy"),
        ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", "copies from the host (memcpy HtoD)"),
        ("kernel", "void at::native::vectorized_elementwise_kernel<4, MulFunctor>", "elementwise (mul, copy, add, where, sqrt, abs, ...)"),
    ],
)
def test_kernel_class(cat, name, want):
    assert profile_epoch.kernel_class(cat + " " + name) == want


def test_device_breakdown_counts_overlap_once():
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        ev("kernel", "patch_fwd_kernel", 0.0, 10.0),
        ev("kernel", "reduce_kernel", 5.0, 10.0),  # overlaps the first by 5
        ev("gpu_memcpy", "Memcpy DtoH", 40.0, 10.0),
        ev("cpu_op", "aten::mul", 0.0, 100.0),  # host side: not device time
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 60.0},
    ]
    b = profile_epoch.device_breakdown(events, wall_us=100.0)
    assert b["activities"] == 3
    assert b["busy_us"] == 25.0
    assert b["classes"]["patch_fwd_kernel (ours)"] == [10.0, 1]
    assert b["classes"]["reductions (sum, mean, amax)"] == [10.0, 1]
    assert b["classes"]["sort, index, cat, memset, memcpy"] == [10.0, 1]


@pytest.mark.parametrize(
    "argv, config",
    [
        ([], "main"),
        (["--config", "config2"], "config2"),
        (["--config", "rpie"], "rpie"),
        (["--config", "lamino_cgrad"], "lamino_cgrad"),
        (["--config", "lamino_cgls"], "lamino_cgls"),
        (["--config", "bucket"], "bucket"),
        (["--config", "admm"], "admm"),
        (["--config", "stream"], "stream"),
        (["--config", "align"], "align"),
    ],
)
def test_parse_args_picks_the_configuration(argv, config):
    args = profile_epoch.parse_args(argv)
    assert args.config == config
    assert args.trace.endswith(f"_build/epoch_trace_{config}.json")
    assert profile_epoch.parse_args(argv + ["--trace", "t.json"]).trace == "t.json"


def test_parse_args_rejects_an_unknown_configuration():
    with pytest.raises(SystemExit):
        profile_epoch.parse_args(["--config", "config3"])


@pytest.mark.parametrize("config2", [False, True])
def test_profiled_parameters_are_accepted(config2):
    """The parameters the profiler and chip_smoke.py build for each path,
    at a small size, pass Reconstruction's checks and run an epoch on the
    CPU with the state each path carries."""
    import numpy as np

    import chip_smoke as cs
    import tike_tpu_torch.ptycho as tp

    from . import _torch_parity  # noqa: F401  (one torch thread)

    scan, psi, probe = cs.make_inputs(60, probe_shape=16, hw=80)
    if config2:
        probe = tp.add_modes_cartesian_hermite(probe, cs.MODES)
    data = tp.simulate(16, probe, scan, psi, device="cpu")
    params = cs.path_parameters(scan, psi, probe, config2)
    with tp.Reconstruction(data, params, device="cpu", random_seed=0) as context:
        assert context.batches[0].shape == (cs.NUM_BATCH, 6)
        context.iterate(1)
        result = context.get_result()
    assert np.isfinite(result.algorithm_options.costs[-1][0])
    assert (result.eigen_weights is not None) == config2
    assert (result.position_options is not None) == config2
    if config2:
        assert result.probe.shape[-3] == cs.MODES
        assert result.eigen_probe.shape == (1, 1, cs.MODES, 16, 16)


def test_rpie_parameters_are_accepted():
    """Phase 8's rPIE parameters and probe, at a small size: wobbly-center
    batches, the probe at RPIE_PHOTONS photons, and one epoch whose mode
    powers come out orthogonalized and sorted, and whose |psi| is clipped."""
    import numpy as np

    import chip_smoke as cs
    import tike_tpu_torch.ptycho as tp

    from . import _torch_parity  # noqa: F401  (one torch thread)

    scan, psi, probe = cs.make_inputs(60, probe_shape=16, hw=80)
    probe = cs.rpie_probe(probe)
    np.testing.assert_allclose(np.sum(np.abs(probe) ** 2), cs.RPIE_PHOTONS, rtol=1e-5)
    data = tp.simulate(16, probe, scan, psi, device="cpu")
    params = cs.rpie_parameters(scan, psi, probe)
    assert params.algorithm_options.batch_method == "wobbly_center"
    with tp.Reconstruction(data, params, device="cpu", random_seed=0) as context:
        assert context.batches[0].shape == (cs.RPIE_NUM_BATCH, 12)
        context.iterate(1)
        result = context.get_result()
    assert np.isfinite(result.algorithm_options.costs[-1][0])
    assert np.all(np.diff(result.probe_options.power[-1]) <= 0)
    assert np.max(np.abs(result.psi)) <= 1 + 1e-6
