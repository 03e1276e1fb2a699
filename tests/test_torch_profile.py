"""The epoch profiler's trace arithmetic (``tike_tpu_torch.profile_epoch``).

The profiler itself needs a CUDA card; what it does with a trace does not.
"""

import pytest

from tike_tpu_torch import profile_epoch


@pytest.mark.parametrize(
    "cat, name, want",
    [
        ("kernel", "patch_fwd_kernel(float2 const*, ...)", "patch_fwd_kernel (ours)"),
        ("kernel", "patch_adj_kernel(float2 const*, ...)", "patch_adj_kernel (ours)"),
        ("kernel", "void vector_2d_fft<128u, 128u, EPT<16u>>(...)", "cuFFT"),
        ("kernel", "void at::native::reduce_kernel<512, 1, ReduceOp<...>>", "reductions (sum, mean, amax)"),
        ("kernel", "void at::native::indexing_backward_kernel<...>", "sort, index, cat, memset, memcpy"),
        ("gpu_memset", "Memset (Device)", "sort, index, cat, memset, memcpy"),
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
