"""The peaks and the byte counts behind the kernels' roofline shares.

A share is the least time the card could take for the launches the window
made, over the device time those launches took in the trace. The least
time is the launch's bytes over the HBM peak (every kernel counted here is
bound by bytes at these shapes), from shapes the configuration fixes. The
counts are lower bounds: each input byte read once and each output byte
written once, and only what a launch is sure to touch (K2 reads the score
map inside the detection bounds; K4 + K5 is counted by the windows it
writes; K8 by the inputs it reads and the flags it writes). Work that
depends on the data inside a CUDA graph replay (how many LM evaluations K8
runs) is not observable from the trace, so no operation count enters, and
a share never reads above the truth.

The arithmetic follows chip_smoke.py's kernel rows (bound_ms, nbytes) and
the port's canvas layout (ops/packed_extractor.make_plan, kernels/level
.pad_level), copied here so that a later change to the program cannot move
the yardstick.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM5 80 GB, the data sheet's dense peaks at its 700 W limit.
PEAKS = {"hbm_bytes_per_s": 3.35e12}
PEAK_NAME = "NVIDIA H100 SXM data sheet: HBM3 3.35 TB/s, at 700 W"

STRIPE = 64       # canvas rows padded to a multiple of this (kernels/level.py)
LANE = 128        # canvas columns padded to a multiple of this
CELL = 32         # the combine's cell (ORBConfig.cell_size)
IC_PATCH, BRIEF_PATCH = 31, 39


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def level_shapes(orb: Dict, height: int, width: int) -> List[Tuple[int, int]]:
    s = float(orb["scale_factor"])
    return [(int(round(height / s ** i)), int(round(width / s ** i)))
            for i in range(int(orb["n_levels"]))]


def canvas(orb: Dict, height: int, width: int) -> Tuple[int, int, int, int]:
    """(canvas rows, canvas columns, padded rows, padded columns) of the
    packed pyramid one extraction runs on."""
    cell = int(orb.get("cell_size", CELL))
    rows = sum(_round_up(h, cell) for h, _ in level_shapes(orb, height, width))
    return rows, width, _round_up(rows, STRIPE), _round_up(width, LANE)


def detection_border(orb: Dict) -> int:
    """ops/extractor.detection_border: max(edge_threshold - 3, 16 + 3)."""
    return max(int(orb["edge_threshold"]) - 3, 19)


def launch_bytes(cfg: Dict) -> Dict[str, int]:
    """Bytes one launch of each counted kernel moves at the configuration's
    shapes, keyed by the kernel's name in the trace."""
    orb, cam = cfg["orb"], cfg["camera"]
    h, w = int(cam["height"]), int(cam["width"])
    rows, cols, hp, wp = canvas(orb, h, w)
    b = detection_border(orb)
    inside = sum(max(lh - 2 * b, 0) * max(lw - 2 * b, 0) for lh, lw in level_shapes(orb, h, w))
    n_k = int(orb["n_features"])
    k = int(orb.get("cell_top_k", 8))
    n_cells = (hp // CELL) * (wp // CELL)
    return {
        # K1: the float32 canvas read, blur and two FAST score maps written.
        "level_kernel": rows * cols * 4 + 3 * hp * wp * 4,
        # K2: the high-threshold scores inside the bounds read, the
        # suppressed map written.
        "combine_nms_kernel": inside * 4 + hp * wp * 4,
        # K3 (map form): the score map read, k values and indices a cell.
        "cell_topk_kernel": hp * wp * 4 + 2 * n_cells * k * 4,
        # K4 + K5: both windows a keypoint written, its centre read and its
        # two offsets written.
        "describe_kernel": n_k * (IC_PATCH ** 2 + BRIEF_PATCH ** 2) * 4 + 16 * n_k,
        # K8 over the feature budget: points, (u, v, u_r), weights and two
        # flags read, the pose and an inlier flag a slot written.
        "pose_lm_kernel": n_k * (12 + 12 + 4 + 1 + 1) + 56 + n_k,
    }


# The kernels of each share, and the names whose device time counts: K2's
# launch is two kernels (its cell flags, then the combine).
EXTRACT = {"level_kernel": ("level_kernel",),
           "combine_nms_kernel": ("combine_nms_kernel", "cell_flag_kernel"),
           "cell_topk_kernel": ("cell_topk_kernel",),
           "describe_kernel": ("describe_kernel",)}
POSE_LM = {"pose_lm_kernel": ("pose_lm_kernel",)}


def share(cfg: Dict, trace: Dict, kernels: Dict[str, Tuple[str, ...]]):
    """100 x (launches x least time a launch) / device time, over the
    kernels; None where the trace holds none of them."""
    per = launch_bytes(cfg)
    least = spent = 0.0
    for k, names in kernels.items():
        n = trace.get("count_by_kernel", {}).get(k, 0)
        least += n * per[k] / PEAKS["hbm_bytes_per_s"]
        spent += sum(trace.get("by_kernel", {}).get(x, 0.0) for x in names)
    if spent <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / spent
