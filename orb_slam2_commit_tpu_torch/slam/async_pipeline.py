"""Asynchronous pipeline: local mapping and loop closing on a background
thread (PyTorch port of slam/async_pipeline.py).

The reference's thread layout: tracking on the caller's thread,
LocalMapping on its own thread draining a keyframe queue
(src/System.cc:95-96, src/LocalMapping.cc:149-161), LoopClosing after it
(src/System.cc:99-100). The cross-thread protocol follows the reference:

- a bounded keyframe queue feeds the worker, and insertion never blocks
  the tracker (a full queue drops the keyframe, counted);
- a waiting keyframe makes the worker skip local BA (mbAbortBA,
  src/LocalMapping.cc:149-154);
- one coarse map lock (the System's RLock) stands for the reference's
  mutexes: the worker holds it for each keyframe's local mapping, the
  local BA solve included, and for its loop closing, as the JAX package's
  worker does. So a global BA merges only between two keyframes, never
  between a local BA's pack and its write-back (the reference's
  RunGlobalBundleAdjustment stops local mapping before it merges);
- request_stop / release and request_finish follow
  src/LocalMapping.cc:701-933.

On the card the worker's device work runs on a CUDA stream of its own.
Nothing on the device crosses between threads: the map, the database and
the BA problems are numpy on the host, and a thread reads a result back
(`.cpu()`) on its own stream. An exception on the worker is kept and raised
again by `wait_idle` and `join` (the System's `shutdown`), so it cannot
vanish with the thread.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Optional

import torch


class MappingWorker:
    """A background thread that runs LocalMapper (and LoopCloser) per
    keyframe."""

    def __init__(self, mapper, loop_closer, map_lock, max_queue: int = 8, device=None):
        """device: the System's device; on a card the worker makes its own
        stream there."""
        self.mapper = mapper
        self.loop_closer = loop_closer
        self.map_lock = map_lock
        self.queue: "queue.Queue[int]" = queue.Queue(maxsize=max_queue)
        self._finish_requested = threading.Event()
        self._stop_requested = threading.Event()
        self._stopped = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self.processed = 0
        self.dropped = 0
        self.error: Optional[BaseException] = None
        device = None if device is None else torch.device(device)
        self.stream = (torch.cuda.Stream(device)
                       if device is not None and device.type == "cuda" else None)
        self.thread = threading.Thread(target=self._run, daemon=True, name="mapping-worker")
        self.thread.start()

    # -- the tracker's side ------------------------------------------------

    def insert_keyframe(self, kf: int) -> None:
        """Queue a keyframe without blocking; it interrupts local BA
        (InsertKeyFrame sets mbAbortBA, src/LocalMapping.cc:149-154). The
        tracker's need_new_keyframe refuses insertion while the queue is
        deep (src/Tracking.cc:1272-1293), so a full queue here means that
        gate was passed by; the keyframe is dropped and counted."""
        self.mapper.abort_ba = True
        try:
            self.queue.put_nowait(kf)
        except queue.Full:
            self.dropped += 1

    def accept_keyframes(self) -> bool:
        """Is the mapper idle? (AcceptKeyFrames, :778-790)."""
        return self._idle.is_set() and self.queue.empty()

    def interrupt_ba(self) -> None:
        """Abort the running local BA so the mapper frees up sooner
        (InterruptBA, src/Tracking.cc:1283)."""
        self.mapper.abort_ba = True

    def queued(self) -> int:
        """Keyframes waiting (KeyframesInQueue, src/LocalMapping.cc:792-796)."""
        return self.queue.qsize()

    def request_stop(self) -> None:
        """Pause processing (src/LocalMapping.cc:701-717)."""
        self._stop_requested.set()

    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    def release(self) -> None:
        self._stop_requested.clear()
        self._stopped.clear()

    def request_finish(self) -> None:
        self._finish_requested.set()

    def join(self, timeout: float = 30.0) -> None:
        """Finish the thread; raises what the worker raised."""
        self.request_finish()
        self.thread.join(timeout=timeout)
        self._raise_error()

    def wait_idle(self, timeout: float = 60.0) -> None:
        """Drain the queue (shutdown, reset and tests); raises what the
        worker raised."""
        self.queue.join()
        self._idle.wait(timeout=timeout)
        self._raise_error()

    def _raise_error(self) -> None:
        if self.error is not None:
            raise RuntimeError("the mapping worker failed") from self.error

    # -- the worker's side -------------------------------------------------

    def _run(self) -> None:
        stream = (torch.cuda.stream(self.stream) if self.stream is not None
                  else contextlib.nullcontext())
        with stream:
            while not self._finish_requested.is_set():
                if self._stop_requested.is_set():
                    self._stopped.set()
                    self._finish_requested.wait(timeout=0.003)
                    continue
                self._stopped.clear()
                try:
                    kf = self.queue.get(timeout=0.01)
                except queue.Empty:
                    continue
                self._idle.clear()
                try:
                    if self.error is None:
                        self._process(kf)
                except BaseException as e:   # kept, raised again on join
                    self.error = e
                finally:
                    self._idle.set()
                    self.queue.task_done()

    def _process(self, kf: int) -> None:
        # Skip local BA while more keyframes wait (mbAbortBA,
        # src/Optimizer.cc:749-762).
        self.mapper.abort_ba = not self.queue.empty()
        with self.map_lock, self._timed("local_mapping"):
            self.mapper.process_keyframe(kf)
        if self.loop_closer is not None:
            with self.map_lock, self._timed("loop_closing"):
                self.loop_closer.process_keyframe(kf)
        self.processed += 1

    def _timed(self, stage: str):
        """The System's profiler stage on the worker's thread."""
        profiler = getattr(self.mapper, "profiler", None)
        return profiler.timed(stage) if profiler is not None else contextlib.nullcontext()
