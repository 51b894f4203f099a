"""The benchmark's CPU tests: `python -m pytest slambench/tests -q` from the
root of the repository. Tests that need the card carry the `card` marker
and skip inside the test, where no card is found (run them on the card with
`python -m pytest slambench/tests -q -m card`)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
    import torch

    # Several workers share the CPU: a few threads each.
    torch.set_num_threads(min(torch.get_num_threads(), 2))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def tiny(workload: str, pool: int, warmup: int):
    """A cell's configuration and traffic at a size a CPU test holds: the
    published image and features (the compared numbers grow with them), a
    local BA window of 16 keyframes, a pool of `pool` frames, and half the
    frames sampled for the check."""
    from slambench import generator, registry

    bench = registry.benchmark()
    wl = registry.workload(bench, workload)
    cfg = copy.deepcopy(registry.config(bench, wl["config"]))
    tr = copy.deepcopy(registry.traffic(wl["traffic"]))
    cfg["tracker"].update(lba_max_free_kfs=16, lba_max_fixed_kfs=16, lba_max_points=2048)
    cfg["map"].update(max_keyframes=64, max_points=8192)
    tr.update(pool_frames=pool, warmup_frames=warmup)
    # A CPU window holds a few frames: sample half of them for the check,
    # and judge the drift from a third of the way the window drives on.
    tr["check"]["frame_share"] = 0.5
    window_m = (pool - warmup) * generator.step_m(tr["path"])
    tr["check"]["drift_min_m"] = min(tr["check"]["drift_min_m"], window_m / 3.0)
    return bench, wl, cfg, tr
