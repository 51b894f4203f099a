"""The traced window: the card's operations under the autograd profiler, the
host's stage spans beside them, and the arithmetic that reduces the two to
the device's busy time, its idle gaps and the time of each kernel.

`device_ops` is a copy of chip_smoke.py's (the device operations of a
finished profiler run); the union of their intervals is the busy time (two
streams' operations that overlap count once), and the idle share is one
minus that union over the window.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

Interval = Tuple[float, float]
# The traced part of a --trace 1 window: its last seconds.
TRACE_SECONDS = 20.0


def device_ops(events) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """The device operations among a finished profiler run's events (the
    kineto events the autograd profiler returns) -> (names, starts, ends),
    seconds from the first operation's start. A copy of chip_smoke.py's device_ops,
    read from the raw events: building the profiler's FunctionEvent tree
    takes minutes over a window of a million launches."""
    from torch.autograd import DeviceType

    names, starts, lengths = [], [], []
    ns = bool(events) and hasattr(events[0], "start_ns")
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        names.append(e.name())
        if ns:
            starts.append(e.start_ns())
            lengths.append(e.duration_ns())
        else:
            starts.append(e.start_us() * 1000)
            lengths.append(e.duration_us() * 1000)
    a = np.asarray(starts, np.int64)
    a = a - (a.min() if a.size else 0)      # exact durations: ns from the first
    return names, a * 1e-9, (a + np.asarray(lengths, np.int64)) * 1e-9


def _merged(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The union of the intervals [a_i, b_i] as sorted disjoint intervals."""
    if a.size == 0:
        return a, b
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    reach = np.maximum.accumulate(b)
    # A new interval starts where it begins after everything before ends.
    new = np.concatenate([[True], a[1:] > reach[:-1]])
    first = np.flatnonzero(new)
    last = np.concatenate([first[1:] - 1, [a.size - 1]])
    return a[first], reach[last]


def union(intervals: List[Interval]) -> List[Interval]:
    """Sorted, merged intervals."""
    if not intervals:
        return []
    a, b = _merged(*np.asarray(intervals, np.float64).T)
    return list(zip(a.tolist(), b.tolist()))


def busy_seconds(intervals: List[Interval], lo: float, hi: float) -> float:
    """Length of the union of the intervals clipped to [lo, hi]."""
    if not intervals:
        return 0.0
    a, b = _merged(*np.asarray(intervals, np.float64).T)
    return float(np.clip(np.minimum(b, hi) - np.maximum(a, lo), 0.0, None).sum())


def idle_gaps(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The spans of [lo, hi] in which no interval runs, longest first."""
    if not intervals:
        return [(lo, hi)] if hi > lo else []
    a, b = _merged(*np.asarray(intervals, np.float64).T)
    g_lo = np.concatenate([[lo], b])
    g_hi = np.concatenate([a, [hi]])
    g_lo, g_hi = np.maximum(g_lo, lo), np.minimum(g_hi, hi)
    keep = g_hi > g_lo
    g_lo, g_hi = g_lo[keep], g_hi[keep]
    order = np.argsort(g_lo - g_hi, kind="stable")
    return list(zip(g_lo[order].tolist(), g_hi[order].tolist()))


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0][:64]


def open_stage(spans: List[Tuple[str, float, float]], t: float) -> str:
    """The innermost host stage open at time t (the latest started of those
    that cover it), or the harness's own loop between frames."""
    best: Optional[Tuple[str, float, float]] = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or a >= best[1]):
            best = (name, a, b)
    return best[0] if best else "between frames"


@contextlib.contextmanager
def stage_spans(profiler, spans: List[Tuple[str, float, float]]):
    """Inside the block, every stage the System's Profiler times is also
    recorded as a span (name, start, end) on the host clock."""
    timed = profiler.timed

    @contextlib.contextmanager
    def spanned(stage):
        t0 = time.perf_counter()
        try:
            with timed(stage):
                yield
        finally:
            spans.append((stage, t0, time.perf_counter()))

    profiler.timed = spanned
    try:
        yield
    finally:
        profiler.timed = timed


class Traced:
    """The autograd profiler (kineto), CUDA activity alone, driven through
    its own configuration so that its raw events are read and no event tree
    is built. It is prepared before the window and started inside it, for
    the window's last `TRACE_SECONDS` (the profiler's own processing grows
    with the launches it saw, and a run has to end within its time limit).
    A first operation launched on an idle card right after the host's clock
    is read ties the profiler's clock to the host's."""

    def __init__(self):
        from torch.autograd import _prepare_profiler
        from torch.autograd import profiler as autograd_profiler

        p = autograd_profiler.profile(use_device="cuda", use_cpu=False, use_kineto=True)
        self.config, self.activities = p.config(), p.kineto_activities
        _prepare_profiler(self.config, self.activities)
        self.events = []
        self.cost_s: Dict[str, float] = {}
        self.t_host0: Optional[float] = None

    def start(self) -> None:
        from torch.autograd import _enable_profiler

        _enable_profiler(self.config, self.activities)
        torch.cuda.synchronize()
        self.t_host0 = time.perf_counter()
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()

    def stop(self) -> None:
        from torch.autograd import _disable_profiler

        if self.t_host0 is None:
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = _disable_profiler()
        t1 = time.perf_counter()
        self.events = result.events()
        self.cost_s = {"stop_s": t1 - t0, "events_s": time.perf_counter() - t1}

    def reduce(self, t_hi: float, spans, top: int = 10) -> Dict:
        """The traced window, from the start to t_hi (host clock): busy and
        window seconds, device seconds and operation counts by kernel name,
        and the breakdown's lists (the device operations that took most
        time, the longest idle gaps named by the host stage open at their
        middle)."""
        t0 = time.perf_counter()
        names, a, b = device_ops(self.events)
        self.cost_s.update(n_events=len(self.events), n_device_ops=len(names))
        if not names:
            return {}
        t_lo = self.t_host0
        offset = a.min() - t_lo
        a, b = a - offset, b - offset
        inside = np.flatnonzero((b > t_lo) & (a < t_hi))
        a, b = a[inside], b[inside]
        clipped = np.minimum(b, t_hi) - np.maximum(a, t_lo)
        short: Dict[str, str] = {}
        by_name: Dict[str, float] = {}
        count: Dict[str, int] = {}
        for i, d in zip(inside.tolist(), clipped.tolist()):
            n = names[i]
            k = short.get(n)
            if k is None:
                k = short[n] = short_name(n)
            by_name[k] = by_name.get(k, 0.0) + d
            count[k] = count.get(k, 0) + 1
        ma, mb = _merged(a, b)
        busy = float(np.clip(np.minimum(mb, t_hi) - np.maximum(ma, t_lo), 0.0, None).sum())
        gaps = idle_gaps(list(zip(ma.tolist(), mb.tolist())), t_lo, t_hi)[:top]
        self.cost_s["reduce_s"] = time.perf_counter() - t0
        return {
            "busy_s": busy,
            "window_s": t_hi - t_lo,
            "by_kernel": by_name,
            "count_by_kernel": count,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": [[open_stage(spans, 0.5 * (g0 + g1)), g1 - g0] for g0, g1 in gaps],
        }
