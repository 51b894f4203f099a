"""One CUDA graph per call signature: the card's counterpart of one XLA
dispatch of a jitted function (the JAX package's `jax.jit`). It has no
twin in the JAX package.

`call(fn, args, config)` runs fn(*args, config):

- on CPU tensors, eagerly (the CPU tests' path);
- on CUDA tensors, the first call for a key (the function, the
  configuration, `static`, the device and each input's shape and dtype,
  as jit keys a trace) warms fn up on a side stream (the kernels built and
  loaded, the device tables uploaded, the side stream's cuBLAS workspace
  made), then captures it into a `torch.cuda.CUDAGraph` on that stream,
  in thread-local mode (the mapping worker and the global BA runner use
  the card from their own threads meanwhile), with a memory pool of its
  own. Every call, the first included, copies its inputs into the graph's
  static input buffers (not where a caller passes such a buffer itself),
  replays the graph on the caller's current stream and returns copies of
  its static outputs, so a result the caller holds does not change at the
  next replay (JAX's results are immutable). A failed capture or replay
  raises; nothing falls back to the eager function on the card.

Launch counting (kernels/_build.py): the capture's kernel launches are
counted into the capture's tally, not into `_build.launches`, and each
replay adds the tally. The warm-up's launches ran and are counted.

A graph holds its memory pool (its inputs, intermediates and outputs)
until it is released: `release(config)` drops the graphs captured under
a configuration (System.shutdown releases its own), `release()` all.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._pytree import tree_map

from orb_slam2_commit_tpu_torch.kernels import _build

_LOG = logging.getLogger(__name__)

_lock = threading.RLock()
graphs: Dict[tuple, "Graph"] = {}
# Captures and replays since the process started (graphs dropped from
# `graphs` included), and the kernel launches the replays added.
totals = {"captures": 0, "replays": 0}
replayed_launches: Dict[str, int] = {}


class Graph:
    """One captured call: the graph, its static inputs and outputs, the
    launches one replay makes, its pool's size and its counts."""

    def __init__(self, graph, device, inputs, outputs, launches: Dict[str, int],
                 pool_bytes: int):
        self.graph = graph
        self.device = device
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.pool_bytes = pool_bytes
        self.replays = 0
        # Recorded after each call's copies out; the next call's stream
        # waits for it, since the last call may have run on another
        # thread's stream. (A wait on an event never recorded returns.)
        self.done = torch.cuda.Event()

    def __call__(self, args):
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.done)
        for buf, a in zip(self.inputs, args):
            if a.data_ptr() != buf.data_ptr() or a.stride() != buf.stride():
                buf.copy_(a)
        self.graph.replay()
        out = tree_map(torch.clone, self.outputs)
        self.done.record(stream)
        self.replayed()
        return out

    def replayed(self) -> None:
        self.replays += 1
        with _lock:
            totals["replays"] += 1
            for name, n in self.launches.items():
                replayed_launches[name] = replayed_launches.get(name, 0) + n
        _build.add_launches(self.launches)


def key(fn: Callable, args: Tuple[torch.Tensor, ...], config, static=()) -> tuple:
    """The cache key of fn(*args, config)."""
    return (fn, config, static, args[0].device,
            tuple((tuple(a.shape), a.dtype) for a in args))


def call(fn: Callable, args: Tuple[Any, ...], config, static=()):
    """fn(*args, config): eagerly on CPU tensors, as a replay of its CUDA
    graph on CUDA tensors (every argument a tensor on one device).
    `static`: hashable values that fn reads besides its arguments (the
    extraction routes read at call time), part of the key."""
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"cuda_graph: arguments on {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return fn(*args, config)
    if device.type != "cuda":
        raise ValueError(f"cuda_graph: no route for {device}")
    if not all(isinstance(a, torch.Tensor) for a in args):
        raise TypeError("cuda_graph: every argument but the configuration must be a tensor")
    k = key(fn, args, config, static)
    with _lock:
        g = graphs.get(k)
        if g is None:
            g = graphs[k] = _capture(fn, args, config, device)
        return g(args)


def _capture(fn, args, config, device) -> Graph:
    stream = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        inputs = tuple(a.clone() for a in args)
        fn(*inputs, config)
    graph = torch.cuda.CUDAGraph()
    with _build.recorded_launches() as launches:
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            outputs = fn(*inputs, config)
    stream.wait_stream(side)
    totals["captures"] += 1
    pool_bytes = _pool_bytes(graph)
    _LOG.info("captured %s on %s, inputs %s: pool %s bytes, launches %s",
              getattr(fn, "__name__", fn), device,
              [tuple(a.shape) for a in args], pool_bytes, launches)
    return Graph(graph, device, inputs, outputs, dict(launches), pool_bytes)


def _pool_bytes(graph) -> int:
    """The bytes the graph's private memory pool holds."""
    pool = tuple(graph.pool())
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool)


def release(*configs) -> int:
    """Drop the graphs captured under any of `configs` (every graph when
    none is given), so that their memory pools can be freed -> how many
    were dropped. A later call under their keys captures again."""
    with _lock:
        gone = [k for k in graphs if not configs or k[1] in configs]
        for k in gone:
            del graphs[k]
    return len(gone)


def n_captures() -> int:
    return totals["captures"]


def n_replays() -> int:
    return totals["replays"]
