"""Graphs: CUDA graph captures made inside the window (the program's
utils/cuda_graph.totals["captures"], its difference over the window)."""


def read(ctx):
    return float(ctx["captures"])
