"""Constant tables on the device, made once.

Copying a CPU tensor to the card (`.to("cuda")`) waits until the card has
finished all work queued before it, so a table uploaded inside the
per-frame step would stall the host behind the device every frame. The
step's static tables (resize operators, level bounds, gather maps, BRIEF
offsets, ...) depend only on the configuration, so each is built with
numpy and uploaded once per (arguments, device).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


def device_table(fn: Callable[..., np.ndarray]) -> Callable[..., torch.Tensor]:
    """fn(*args) -> numpy array, with hashable args, becomes
    table(device, *args) -> that array as a tensor on `device`, cached."""

    @functools.lru_cache(maxsize=None)
    def table(device: torch.device, *args) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(fn(*args))).to(device)

    def lookup(device, *args) -> torch.Tensor:
        return table(torch.device(device), *args)

    lookup.__doc__ = fn.__doc__
    return lookup
