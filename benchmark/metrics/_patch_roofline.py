"""Shared by the patch rooflines: the least time the traced steps' patch
work needs (``TraceView.bounds``, from ``roofline.patch_bound_s``) over the
device time of the kernels of that name, in percent."""


def share(t, name):
    kernels = t.kernels(name + "_kernel")
    bound_s = t.bounds.get(name)
    if not kernels or not bound_s or not t.steps:
        return None
    device_s = sum(dur for *_, dur in kernels) / 1e6
    return 100.0 * bound_s * t.steps / device_s
