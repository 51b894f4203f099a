"""BENCHMARK.json against the contract's shape, and the registry that finds
each configuration, traffic mix, limit file and metric reader by name."""

import json
import re
import shutil

import pytest

from slambench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_shape():
    b = registry.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"] for m in b["end_to_end"]}
    assert e2e == {"frames_per_s", "frame_ms_p95", "setup_s"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("w", registry.benchmark()["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(w):
    b = registry.benchmark()
    cfg = registry.config(b, w["config"])
    assert cfg["name"] == w["config"] and all(k in cfg for k in cfg["reduced"])
    tr = registry.traffic(w["traffic"])
    assert tr["pool_frames"] > tr["warmup_frames"] > 0
    assert tr["feed"]["mode"] in ("closed", "paced")
    lim = registry.limits(w["name"])
    # Every frame tracked is the configuration's own guarantee: limit 0.
    assert lim["failed_frames"] == 0 and all(v > 0 for k, v in lim.items()
                                             if k != "failed_frames")
    for kind in ("end_to_end", "per_layer"):
        for m in registry.metrics(b, kind, w["name"]):
            if kind == "per_layer":
                assert callable(registry.reader(m["name"]))


def test_added_cell_is_found(tmp_path):
    """A later PR adds a cell with files and entries only: a traffic mix, a
    limit file, a metric reader and BENCHMARK.json's entries."""
    root = tmp_path / "checkout"
    shutil.copytree(registry.HERE, root / "slambench")
    b = registry.benchmark()
    b["workloads"].append({"name": "kitti-stereo.new", "config": "kitti00-02-stereo",
                           "traffic": "street-new", "chips": 1, "why": "an added cell"})
    b["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "tracker host",
                           "moves": "frames_per_s", "workloads": ["kitti-stereo.new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    here = root / "slambench"
    tr = registry.traffic("street-explore", here)
    (here / "traffic" / "street-new.json").write_text(json.dumps(dict(tr, pool_frames=7)))
    (here / "limits" / "kitti-stereo.new.json").write_text(
        json.dumps({"limits": {"pose_gap_sigma": 1.0}}))
    (here / "metrics" / "new_metric.py").write_text("def read(ctx):\n    return 42.0\n")

    b2 = registry.benchmark(root)
    w = registry.workload(b2, "kitti-stereo.new")
    assert registry.config(b2, w["config"], root)["sensor"] == "stereo"
    assert registry.traffic(w["traffic"], here)["pool_frames"] == 7
    assert registry.limits(w["name"], here) == {"pose_gap_sigma": 1.0}
    per = [m["name"] for m in registry.metrics(b2, "per_layer", w["name"])]
    assert "new_metric" in per and "mapping_ms_per_kf" not in per
    assert registry.reader("new_metric", here)({}) == 42.0
    assert "new_metric" not in [m["name"] for m in
                                registry.metrics(b2, "per_layer", "kitti-stereo.explore")]
