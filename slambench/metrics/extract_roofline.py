"""Kernels: K1-K5 (csrc/level.cu, select.cu, patches.cu) share of their
roofline, %: the summed least time of their launches in the window over
their summed device time in the trace."""

from slambench import roofline


def read(ctx):
    if not ctx.get("trace"):
        return None
    return roofline.share(ctx["cfg"], ctx["trace"], roofline.EXTRACT)
