"""One CUDA graph per call signature: the card's counterpart of one XLA
dispatch of a jitted function (the JAX package's `jax.jit`). It has no
twin in the JAX package.

`call(fn, args, config)` runs fn(*args, config), and `loop(fn, carry,
args, config, n)` runs `carry = fn(carry, *args, config)` n times (the
JAX package's `while_loop` / `fori_loop` bodies, masked to a fixed count):

- on CPU tensors, eagerly (the CPU tests' path); also on the card inside
  `eager()` (an eager run to compare a replay with);
- on CUDA tensors, the first call for a key (the function, the
  configuration, `static`, the device, the arguments' tree structure,
  each tensor leaf's shape and dtype and each other leaf's value, as jit
  keys a trace on its static arguments) warms fn up on a side stream (the
  kernels built and loaded, the device tables uploaded, the side stream's
  cuBLAS workspace made), then captures it into a `torch.cuda.CUDAGraph`
  on that stream, in thread-local mode (the tracker, the mapping worker
  and the global BA runner use the card from their own threads
  meanwhile), with a memory pool of its own. A loop's graph ends by
  writing the new carry over the carry's own buffers, so replays follow
  one another on the same buffers with no copy between them. Every call,
  the first included, copies its tensor arguments into the graph's static
  input buffers (not where a caller passes such a buffer itself), replays
  the graph on the caller's current stream (a loop's n times) and returns
  copies of its static outputs, so a result the caller holds does not
  change at the next replay (JAX's results are immutable). Nothing is read
  on the host. A failed capture or replay raises; nothing falls back to
  the eager function on the card.

A capture holds only its own key's lock (another thread's capture of the
same key waits for it); replays of other graphs go on meanwhile, each
graph replayed by one thread at a time.

Launch counting (kernels/_build.py): the capture's kernel launches are
counted into the capture's tally, not into `_build.launches`, and each
replay adds the tally. The warm-up's launches ran and are counted.

A graph holds its memory pool (its inputs, intermediates and outputs)
until it is released: `release(owner, ...)` drops the graphs captured
under a configuration or for a function (System.shutdown releases its
own and the solvers'), `release()` all, and hands their pools' memory
back to the driver.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from orb_slam2_commit_tpu_torch.kernels import _build

_LOG = logging.getLogger(__name__)

_lock = threading.RLock()
graphs: Dict[tuple, "Graph"] = {}
# One lock a key while it is captured.
_capturing: Dict[tuple, threading.Lock] = {}
_eager = threading.local()
# Captures and replays since the process started (graphs dropped from
# `graphs` included), and the kernel launches the replays added, in all
# and by captured function's name.
totals = {"captures": 0, "replays": 0}
replayed_launches: Dict[str, int] = {}
replayed_by: Dict[str, Dict[str, int]] = {}


class Graph:
    """One captured call: the graph, its static tensor inputs (the
    arguments' tensor leaves, in order) and outputs, the launches one
    replay makes, its pool's size, its counts and its function's name."""

    def __init__(self, graph, device, inputs, outputs, launches: Dict[str, int],
                 pool_bytes: Optional[int] = None, name: str = ""):
        self.graph = graph
        self.name = name
        self.device = device
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self._pool_bytes = pool_bytes
        self.replays = 0
        self.lock = threading.Lock()
        # Recorded after each call's copies out; the next call's stream
        # waits for it, since the last call may have run on another
        # thread's stream. (A wait on an event never recorded returns.)
        self.done = torch.cuda.Event()

    def __call__(self, leaves, times: int = 1):
        with self.lock:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.done)
            for buf, a in zip(self.inputs, leaves):
                if a.data_ptr() != buf.data_ptr() or a.stride() != buf.stride():
                    buf.copy_(a)
            for _ in range(times):
                self.graph.replay()
            out = tree_map(torch.clone, self.outputs)
            self.done.record(stream)
        self.replayed(times)
        return out

    @property
    def pool_bytes(self) -> int:
        """The bytes the graph's private memory pool holds (read from the
        allocator's snapshot at first use)."""
        if self._pool_bytes is None:
            pool = tuple(self.graph.pool())
            self._pool_bytes = sum(
                s["total_size"] for s in torch.cuda.memory_snapshot()
                if tuple(s.get("segment_pool_id", ())) == pool)
        return self._pool_bytes

    def replayed(self, times: int = 1) -> None:
        tally = {name: n * times for name, n in self.launches.items()}
        with _lock:
            self.replays += times
            totals["replays"] += times
            by = replayed_by.setdefault(self.name, {})
            for name, n in tally.items():
                replayed_launches[name] = replayed_launches.get(name, 0) + n
                by[name] = by.get(name, 0) + n
        _build.add_launches(tally)


def _signature(leaves) -> tuple:
    return tuple((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
                 for a in leaves)


def key(fn: Callable, args, config, static=()) -> tuple:
    """The cache key of fn(*args, config)."""
    leaves, spec = tree_flatten(args)
    device = next(a.device for a in leaves if isinstance(a, torch.Tensor))
    return _key(fn, config, static, device, spec, leaves)


def _key(fn, config, static, device, spec, leaves) -> tuple:
    return (fn, config, static, device, spec, _signature(leaves))


@contextlib.contextmanager
def eager():
    """Inside the block, `call` and `loop` run their functions eagerly on
    this thread, on any device."""
    prev = getattr(_eager, "on", False)
    _eager.on = True
    try:
        yield
    finally:
        _eager.on = prev


def _device(leaves):
    devices = {a.device for a in leaves if isinstance(a, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"cuda_graph: arguments on {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"cuda_graph: no route for {device}")
    return device


def call(fn: Callable, args: Tuple[Any, ...], config, static=()):
    """fn(*args, config): eagerly on CPU tensors, as a replay of its CUDA
    graph on CUDA tensors (every tensor of the arguments, which may be
    nested tuples, on one device). `static`: hashable values that fn
    reads besides its arguments (the extraction routes read at call
    time), part of the key."""
    leaves, spec = tree_flatten(args)
    device = _device(leaves)
    if device.type == "cpu" or getattr(_eager, "on", False):
        return fn(*args, config)
    k = _key(fn, config, static, device, spec, leaves)
    g = _graph(k, lambda: _capture(fn, leaves, spec, config, device))
    return g([a for a in leaves if isinstance(a, torch.Tensor)])


def loop(fn: Callable, carry, args: Tuple[Any, ...], config, n: int, static=()):
    """`carry = fn(carry, *args, config)` n times -> the last carry (a
    tree of tensors of fixed shapes and dtypes): eagerly on CPU tensors,
    as n replays of one CUDA graph on CUDA tensors."""
    leaves, spec = tree_flatten((carry,) + tuple(args))
    device = _device(leaves)
    if device.type == "cpu" or getattr(_eager, "on", False):
        for _ in range(n):
            carry = fn(carry, *args, config)
        return carry
    if n == 0:
        return carry
    n_carry = len(tree_flatten(carry)[0])
    k = _key(fn, config, static, device, spec, leaves)
    g = _graph(k, lambda: _capture(fn, leaves, spec, config, device, n_carry))
    return g([a for a in leaves if isinstance(a, torch.Tensor)], times=n)


def _graph(k: tuple, capture: Callable[[], Graph]) -> Graph:
    """The graph under key k, captured first if there is none (holding
    k's own lock, not the module's)."""
    with _lock:
        g = graphs.get(k)
        if g is not None:
            return g
        pending = _capturing.setdefault(k, threading.Lock())
    with pending:
        with _lock:
            g = graphs.get(k)
        if g is None:
            g = capture()
            with _lock:
                graphs[k] = g
                _capturing.pop(k, None)
    return g


def _capture(fn, leaves, spec, config, device, n_carry: int = 0) -> Graph:
    """Capture fn over clones of the tensor leaves (a loop's body, with
    the carry its first n_carry leaves, written back at the graph's end)."""
    stream = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        bufs = [a.clone() if isinstance(a, torch.Tensor) else a for a in leaves]
        args = tree_unflatten(bufs, spec)
        fn(*args, config)
    graph = torch.cuda.CUDAGraph()
    # capture_begin / capture_end, not torch.cuda.graph: that one first
    # synchronizes the device and empties the allocator's cache, which
    # would stall the other threads' work at every capture.
    with _build.recorded_launches() as launches, torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            outputs = fn(*args, config)
            if n_carry:
                new, carry_spec = tree_flatten(outputs)
                if len(new) != n_carry or not all(isinstance(a, torch.Tensor) for a in new):
                    raise TypeError(f"cuda_graph.loop: {getattr(fn, '__name__', fn)} must "
                                    f"return its carry's structure, tensors only")
                for buf, a in zip(bufs[:n_carry], new):
                    buf.copy_(a)
                outputs = tree_unflatten(bufs[:n_carry], carry_spec)
        finally:
            graph.capture_end()
    stream.wait_stream(side)
    with _lock:
        totals["captures"] += 1
    inputs = tuple(a for a in bufs if isinstance(a, torch.Tensor))
    name = getattr(fn, "__name__", str(fn))
    _LOG.info("captured %s on %s, inputs %s: launches %s", name, device,
              [tuple(a.shape) for a in inputs], launches)
    return Graph(graph, device, inputs, outputs, dict(launches), name=name)


def release(*owners) -> int:
    """Drop the graphs captured under any of `owners`, configurations or
    functions (every graph when none is given) -> how many were dropped. A
    later call under their keys captures again; a replay in flight keeps
    its graph until it returns. A dropped graph's memory pool goes back to
    the driver: the allocator keeps a dead pool's segments until its cache
    is emptied, so other processes on the card could not have them."""
    with _lock:
        gone = [k for k in graphs if not owners or k[0] in owners or k[1] in owners]
        for k in gone:
            del graphs[k]
    if gone:
        torch.cuda.empty_cache()
    return len(gone)


def n_captures() -> int:
    return totals["captures"]


def n_replays() -> int:
    return totals["replays"]
