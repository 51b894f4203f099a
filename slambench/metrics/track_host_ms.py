"""Tracker, host: mean ms a frame of the `track` stage's self time: the
stage minus the keyframe insertion, local mapping and loop closing stages
nested in it (slam/system.py's _track_frame)."""

NESTED = ("keyframe_insert", "local_mapping", "loop_closing")


def read(ctx):
    st = ctx["stages"]
    if "track" not in st or not ctx["frames"]:
        return None
    own = st["track"]["total_s"] - sum(st.get(k, {}).get("total_s", 0.0) for k in NESTED)
    return 1e3 * own / ctx["frames"]
