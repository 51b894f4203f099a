"""Kernels: K8 (csrc/pose_lm.cu) share of its roofline, %: the least time
of its launches in the window (slambench/roofline.py) over their device
time in the trace."""

from slambench import roofline


def read(ctx):
    if not ctx.get("trace"):
        return None
    return roofline.share(ctx["cfg"], ctx["trace"], roofline.POSE_LM)
