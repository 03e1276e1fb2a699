"""The share of the traced window in which no kernel, copy or memset ran
on the device, in percent."""


def read(t):
    if t.window_us <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
