"""Peak device memory allocated in the traced window (the peak reset at its
start), in GiB."""


def read(t):
    if not t.window_peak_bytes:
        return None
    return t.window_peak_bytes / 2**30
