"""Tracker front end: mean host ms a frame in the `fused_frontend` stage
(the fused motion stage's extraction and matching, one graph replay) and
in `extract_frame` (the staged path's extraction), over the window."""


def read(ctx):
    st = ctx["stages"]
    total = sum(st.get(k, {}).get("total_s", 0.0) for k in ("fused_frontend", "extract_frame"))
    n = ctx["frames"]
    return 1e3 * total / n if n else None
