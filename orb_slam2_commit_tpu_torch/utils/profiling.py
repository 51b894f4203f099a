"""Per-stage wall timers (the port's copy of utils/profiling.py's
Profiler): named stage timers (count / total / EMA / min / max) that the
System records around extraction, tracking, keyframe insertion and each
mapper stage; cheap enough to stay always-on. The reference only has
wall-clock prints in its example programs (mono_tum.cc:83-101,119-127).

A stage's time is host wall time: on the card a stage that does not wait
for the device ends before its kernels do, and the next stage that waits
(a copy to the host) takes their time.

`device_trace` (utils/profiling.py:97-121's twin) records the device's
operations inside a block with torch.profiler and writes them as a Chrome
trace.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator

import torch


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    ema_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def record(self, dt: float, ema_alpha: float = 0.1) -> None:
        self.count += 1
        self.total_s += dt
        self.ema_s = dt if self.count == 1 else (
            (1.0 - ema_alpha) * self.ema_s + ema_alpha * dt
        )
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class Profiler:
    """Thread-safe named-stage wall timers."""

    def __init__(self) -> None:
        self._stats: Dict[str, StageStats] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def timed(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(stage, time.perf_counter() - t0)

    def record(self, stage: str, dt: float) -> None:
        with self._lock:
            st = self._stats.get(stage)
            if st is None:
                st = self._stats[stage] = StageStats()
            st.record(dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                k: {
                    "count": float(v.count),
                    "mean_ms": v.mean_s * 1e3,
                    "ema_ms": v.ema_s * 1e3,
                    "min_ms": (0.0 if v.count == 0 else v.min_s * 1e3),
                    "max_ms": v.max_s * 1e3,
                    "total_s": v.total_s,
                }
                for k, v in self._stats.items()
            }

    def report(self) -> str:
        rows = ["stage                  count   mean ms    ema ms    max ms"]
        for k, v in sorted(self.summary().items()):
            rows.append(
                f"{k:22s} {int(v['count']):6d} {v['mean_ms']:9.2f} "
                f"{v['ema_ms']:9.2f} {v['max_ms']:9.2f}"
            )
        return "\n".join(rows)

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


# One trace at a time in a process: torch.profiler does not refuse a
# second session, and stopping either ends both.
_TRACE_LOCK = threading.Lock()


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True) -> Iterator[bool]:
    """torch.profiler trace of the block, written into log_dir as
    trace_<pid>_<n>.json (a Chrome trace). On a machine with a card it
    records the card's operations (kernels, copies) and the runtime calls
    that launched them, from every thread; on one without, the host's
    operators. Yields whether tracing is active: False when disabled, when
    the profiler cannot start, or while another torch.profiler session runs
    in the process (a second concurrent trace degrades to a no-op instead
    of raising)."""
    if not enabled or not _TRACE_LOCK.acquire(blocking=False):
        yield False
        return
    from torch.profiler import ProfilerActivity, profile

    try:
        prof = None
        if not torch._C._autograd._profiler_enabled():
            cuda = torch.cuda.is_available()
            prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
            try:
                prof.start()
            except RuntimeError:
                prof = None
        if prof is None:
            yield False
            return
        try:
            yield True
        finally:
            if cuda:
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
            prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
    finally:
        _TRACE_LOCK.release()
