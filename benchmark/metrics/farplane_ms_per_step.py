"""Device milliseconds a solver step in the Gaussian model's far-field
kernel (``farplane_gaussian_kernel``); nothing where the program has no
such kernel."""


def read(t):
    kernels = t.kernels("farplane_gaussian_kernel")
    if not kernels or not t.steps:
        return None
    return sum(dur for *_, dur in kernels) / 1e3 / t.steps
