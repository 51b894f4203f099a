"""The end-to-end arithmetic: the rate over the whole window, the 95th
percentile over every frame."""

import statistics

from slambench import cell


def window(lat, seconds):
    return cell.Window(lat, len(lat), 0, seconds, False, 0, 0, {})


def test_rate_is_over_the_whole_window():
    # 100 frames of 10 ms, then the window idles to its end: the rate
    # counts the idle second, not the frames' own time.
    w = window([0.01] * 100, 2.0)
    assert cell.frames_per_s(w) == 50.0


def test_p95_is_over_every_frame():
    # Every 10th frame stalls (a keyframe's mapping): the 95th percentile
    # is the stall. Medians of chunks of 10 frames would read 20 ms.
    lat = [0.02] * 9 + [0.5]
    lat = lat * 30
    assert cell.p95_ms(lat) == statistics.quantiles(lat, n=20)[-1] * 1e3
    assert abs(cell.p95_ms(lat) - 500.0) < 1e-9
    chunks = [statistics.median(lat[i:i + 10]) for i in range(0, len(lat), 10)]
    assert max(chunks) * 1e3 < 21.0


def test_p95_of_few_frames():
    assert cell.p95_ms([0.1]) == 100.0
    assert cell.p95_ms([0.1, 0.3]) > 100.0
