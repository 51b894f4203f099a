"""The trace's reduction on a synthetic trace: the busy union, the idle
share, the idle gaps and the host stage that names each."""

import pytest

from slambench import trace


def test_union_counts_overlap_once():
    # Two streams overlap on [2, 3]; [5, 6] is alone; [10, 12] lies half
    # outside the window [0, 11].
    iv = [(1.0, 3.0), (2.0, 4.0), (5.0, 6.0), (10.0, 12.0)]
    assert trace.union(iv) == [(1.0, 4.0), (5.0, 6.0), (10.0, 12.0)]
    busy = trace.busy_seconds(iv, 0.0, 11.0)
    assert busy == pytest.approx(3.0 + 1.0 + 1.0)
    idle_share = 1.0 - busy / 11.0
    assert idle_share == pytest.approx(6.0 / 11.0)


def test_idle_gaps_longest_first():
    iv = [(1.0, 3.0), (2.0, 4.0), (5.0, 6.0), (10.0, 12.0)]
    gaps = trace.idle_gaps(iv, 0.0, 11.0)
    assert gaps == [(6.0, 10.0), (0.0, 1.0), (4.0, 5.0)]
    assert trace.idle_gaps([], 0.0, 2.0) == [(0.0, 2.0)]


def test_open_stage_is_the_innermost():
    spans = [("track", 0.0, 10.0), ("local_mapping", 2.0, 8.0), ("map_lba", 3.0, 5.0)]
    assert trace.open_stage(spans, 4.0) == "map_lba"
    assert trace.open_stage(spans, 6.0) == "local_mapping"
    assert trace.open_stage(spans, 9.0) == "track"
    assert trace.open_stage(spans, 11.0) == "between frames"


def test_short_name():
    assert trace.short_name("void pose_lm_kernel<128>(float const*)") == "pose_lm_kernel"
    assert trace.short_name("(anonymous namespace)::level_kernel(int)") == "level_kernel"


def test_stage_spans_records_and_restores():
    from orb_slam2_commit_tpu_torch.utils.profiling import Profiler

    p = Profiler()
    spans = []
    timed = p.timed
    with trace.stage_spans(p, spans):
        with p.timed("track"):
            with p.timed("local_mapping"):
                pass
    assert [s[0] for s in spans] == ["local_mapping", "track"]
    assert spans[1][1] <= spans[0][1] <= spans[0][2] <= spans[1][2]
    assert p.summary()["track"]["count"] == 1.0
    assert p.timed == timed
