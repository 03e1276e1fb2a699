"""Device kernels launched a solver step, from the profiler's trace."""


def read(t):
    kernels = t.kernels()
    if not t.steps or not kernels:
        return None
    return len(kernels) / t.steps
