"""The runner's look for a card, and the trace's reading on one."""

import time

import pytest

from slambench import run, trace

ARGS = ["--workload", "tum-rgbd.corridor", "--seed", "3000000000000", "--seconds", "1",
        "--trace", "0"]


@pytest.mark.parametrize("available,count", [(False, 0), (True, 0)])
def test_no_card_no_result(available, count, monkeypatch, capsys):
    """Without a CUDA card (or with fewer than the cell asks for) a run
    fails and prints no result: it never falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.card
def test_trace_reads_the_card(card):
    import torch

    tp = trace.Traced()
    x = torch.randn(1024, 1024, device="cuda")
    tp.start()
    for _ in range(10):
        x = x @ x
        x = x / x.norm()
    torch.cuda.synchronize()
    time.sleep(0.05)
    t_hi = time.perf_counter()
    tp.stop()
    tr = tp.reduce(t_hi, [("matmul", tp.t_host0, t_hi)])
    assert 0.0 < tr["busy_s"] < tr["window_s"]
    assert sum(tr["count_by_kernel"].values()) >= 20
    assert tr["idle_gaps"] and tr["idle_gaps"][0][0] == "matmul"
