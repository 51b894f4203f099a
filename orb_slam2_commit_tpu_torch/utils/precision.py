"""Full float32 matrix products, whatever the caller has set.

A caller may let the card run float32 products in TF32, which keeps about
3 decimal digits (`torch.set_float32_matmul_precision("high")`). That
would move pyramid levels, FAST scores, BRIEF comparisons, projections
and the pose LM's normal equations. Every function of the port that
multiplies matrices runs under `full_float32`: "highest" for the call,
the caller's setting restored after it.
"""

from __future__ import annotations

import functools
from typing import Callable, TypeVar

import torch

F = TypeVar("F", bound=Callable)


def full_float32(fn: F) -> F:
    """Decorator: run fn with float32 matrix products in full float32."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(prev)

    return wrapper
