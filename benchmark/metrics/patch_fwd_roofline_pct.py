"""The patch gather (``patch_fwd_kernel``) against its roofline, in percent."""

from metrics._patch_roofline import share


def read(t):
    return share(t, "patch_fwd")
