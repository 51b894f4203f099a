"""Local mapper: the window's `local_mapping` stage time over the
keyframes it mapped, ms a keyframe."""


def read(ctx):
    st = ctx["stages"].get("local_mapping")
    if not st or not st["count"]:
        return None
    return 1e3 * st["total_s"] / st["count"]
