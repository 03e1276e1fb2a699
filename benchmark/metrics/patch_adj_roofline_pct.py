"""The patch accumulation (``patch_adj_kernel``) against its roofline, in percent."""

from metrics._patch_roofline import share


def read(t):
    return share(t, "patch_adj")
