"""Loop closer: the window's `loop_detect` stage time over the keyframes
the window made, ms a keyframe."""


def read(ctx):
    st = ctx["stages"].get("loop_detect")
    if not st or not ctx["keyframes"]:
        return None
    return 1e3 * st["total_s"] / ctx["keyframes"]
