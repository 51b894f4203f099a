"""Full float32 matrix products, whatever the caller has set.

A caller may let the card run float32 products in TF32, which keeps about
3 decimal digits (`torch.set_float32_matmul_precision("high")`). That
would move pyramid levels, FAST scores, BRIEF comparisons, projections
and the pose LM's normal equations. Every function of the port that
multiplies matrices runs under `full_float32`: "highest" for the call,
the caller's setting restored after it.

The setting is process-wide, and an asynchronous System runs such
functions on several threads at once (tracking, the mapping worker, the
global BA runner). So the calls share one count under a lock: the first
to enter saves the caller's setting and sets "highest", the last to leave
restores it, and no call runs in TF32 while another still holds it.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, TypeVar

import torch

F = TypeVar("F", bound=Callable)

_lock = threading.Lock()
_depth = 0
_saved = "highest"


def _enter() -> None:
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision("highest")
        _depth += 1


def _leave() -> None:
    global _depth
    with _lock:
        _depth -= 1
        if _depth == 0:
            torch.set_float32_matmul_precision(_saved)


def full_float32(fn: F) -> F:
    """Decorator: run fn with float32 matrix products in full float32."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _enter()
        try:
            return fn(*args, **kwargs)
        finally:
            _leave()

    return wrapper
