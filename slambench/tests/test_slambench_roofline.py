"""The roofline's byte counts against shapes worked by hand."""

import pytest

from slambench import roofline


def cfg(h, w, levels=1, n=100):
    return {"camera": {"height": h, "width": w},
            "orb": {"scale_factor": 1.2, "n_levels": levels, "n_features": n,
                    "edge_threshold": 19, "cell_size": 32, "cell_top_k": 8}}


def test_one_level_canvas():
    # 100 x 200, one level: 100 rows round to 128 (cells of 32) and to 128
    # (stripes of 64); 200 columns to 256 (lanes of 128).
    assert roofline.canvas(cfg(100, 200)["orb"], 100, 200) == (128, 200, 128, 256)
    b = roofline.launch_bytes(cfg(100, 200))
    assert b["level_kernel"] == 128 * 200 * 4 + 3 * 128 * 256 * 4
    # Detection border 19: (100 - 38) x (200 - 38) pixels inside.
    assert b["combine_nms_kernel"] == 62 * 162 * 4 + 128 * 256 * 4
    assert b["cell_topk_kernel"] == 128 * 256 * 4 + 2 * (4 * 8) * 8 * 4
    assert b["describe_kernel"] == 100 * (31 * 31 + 39 * 39) * 4 + 16 * 100
    assert b["pose_lm_kernel"] == 100 * 30 + 56 + 100


def test_kitti_canvas():
    # KITTI 1241 x 376, 8 levels of 1.2: heights 376, 313, 261, 218, 181,
    # 151, 126, 105 round up to cells of 32.
    rows, cols, hp, wp = roofline.canvas(cfg(376, 1241, 8)["orb"], 376, 1241)
    assert rows == 384 + 320 + 288 + 224 + 192 + 160 + 128 + 128
    assert (cols, hp, wp) == (1241, 1856, 1280)


def test_share():
    c = cfg(100, 200)
    per = roofline.launch_bytes(c)["pose_lm_kernel"]
    least = 4 * per / roofline.PEAKS["hbm_bytes_per_s"]
    tr = {"count_by_kernel": {"pose_lm_kernel": 4}, "by_kernel": {"pose_lm_kernel": 2 * least}}
    assert roofline.share(c, tr, roofline.POSE_LM) == pytest.approx(50.0)
    assert roofline.share(c, {"count_by_kernel": {}, "by_kernel": {}}, roofline.POSE_LM) is None
    # K2's two kernels both count as its time.
    per2 = roofline.launch_bytes(c)["combine_nms_kernel"] / roofline.PEAKS["hbm_bytes_per_s"]
    tr = {"count_by_kernel": {"combine_nms_kernel": 1},
          "by_kernel": {"combine_nms_kernel": per2, "cell_flag_kernel": per2}}
    assert roofline.share(c, tr, roofline.EXTRACT) == pytest.approx(50.0)
