"""Build, load and count the port's CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` for sm_90a into its own
shared library with a plain C interface, at first use, into `_build/`
beside the package (a directory git ignores); the library's file name
carries a hash of its source, of the headers under `csrc/` it includes
(`subpix_solve.cuh`, shared by patches.cu and subpix.cu) and of its flags,
so an edited source or header, or a source whose flags changed, is
rebuilt. Libraries
are loaded with ctypes: pointers and the CUDA stream travel as
`c_void_p`, and every C entry point returns `cudaGetLastError()`, which
`check` turns into an exception.

`launches` counts, per kernel wrapper, the calls that launched the
kernel on the card (plain-version calls on CPU tensors are not counted);
a wrapper counts through `count_launch`, under a lock, since an
asynchronous System launches from several threads. While a thread
captures a CUDA graph (utils/cuda_graph.py), its wrappers enqueue nothing
to run: `recorded_launches` sends that thread's counts to the capture's
own tally, and each replay of the graph adds the tally (`add_launches`).
Building and loading a library take a lock too: two threads that first
need one library would otherwise both run nvcc into the same temporary
file.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("level", "select", "patches", "subpix", "matching", "pose_lm")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# No multiply-add contraction where a kernel must round like its plain
# version (the blur, csrc/level.cu; the subpixel terms, csrc/subpix_solve.cuh
# in subpix.cu and patches.cu);
# the integer and compare kernels keep the flag they were measured with.
# The pose LM agrees to float32 rounding only and contracts freely.
NO_FMA = ("-fmad=false",)
SOURCE_FLAGS = {"level": NO_FMA, "select": NO_FMA, "patches": NO_FMA,
                "subpix": NO_FMA, "matching": NO_FMA, "pose_lm": ()}

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float

# C signatures of the entry points, per library.
SIGNATURES = {
    "level": {
        "level_preprocess_launch": (
            _c_void_p, _c_int, _c_int, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            _c_void_p, _c_int, _c_int, _c_float, _c_float,
            ctypes.POINTER(_c_float), _c_void_p),
        "combine_nms_launch": (
            _c_void_p, _c_void_p, _c_void_p, _c_int, _c_void_p, _c_void_p,
            _c_int, _c_int, _c_void_p),
    },
    "select": {
        "cell_topk_launch": (
            _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_void_p, _c_void_p,
            _c_void_p),
        "cell_topk_map_launch": (
            _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_void_p, _c_void_p,
            _c_void_p),
    },
    "patches": {
        "describe_patches_launch": (
            _c_void_p, _c_int, _c_int, _c_void_p, _c_int, _c_int, _c_void_p, _c_int,
            _c_void_p, _c_void_p, _c_void_p, _c_void_p),
        "extract_patches_launch": (
            _c_void_p, _c_int, _c_int, _c_void_p, _c_int, _c_int, _c_void_p,
            _c_void_p),
    },
    "subpix": {
        "corner_subpix_launch": (
            _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_void_p, _c_void_p),
    },
    "matching": {
        "projection_top2_launch": (
            _c_void_p, ctypes.c_longlong, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            _c_void_p, _c_void_p, _c_int, _c_void_p, _c_void_p, _c_void_p,
            _c_void_p, _c_int, _c_int, _c_void_p, _c_void_p),
        "candidate_top2_launch": (
            _c_int, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            _c_void_p, _c_void_p, _c_void_p, _c_float, _c_int, _c_int, _c_int,
            ctypes.c_uint, _c_void_p, _c_void_p),
        "stereo_band_top2_launch": (
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int,
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_float,
            _c_void_p, _c_void_p),
    },
    "pose_lm": {
        "pose_lm_launch": (
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            _c_void_p, _c_int, _c_float, _c_float, _c_float, _c_float, _c_float,
            _c_int, _c_int, _c_void_p, _c_void_p, _c_void_p, _c_void_p),
    },
}

launches: Dict[str, int] = {
    "level_preprocess": 0, "combine_nms": 0, "cell_topk_map": 0, "cell_topk": 0,
    "describe_patches": 0, "extract_patches": 0, "corner_subpix": 0,
    "projection_hamming_top2": 0,
    "stereo_band_top2": 0, "masked_hamming_top2": 0, "valid_hamming_top2": 0,
    "window_hamming_top2": 0, "epipolar_hamming_top2": 0, "pose_lm": 0,
}

_libraries: Dict[str, ctypes.CDLL] = {}
_launch_lock = threading.Lock()
_build_lock = threading.RLock()
_recording = threading.local()


def count_launch(name: str) -> None:
    """launches[name] += 1, for a launch of the kernel on the card (or
    into this thread's tally, inside `recorded_launches`)."""
    tally = getattr(_recording, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
        return
    with _launch_lock:
        launches[name] += 1


def add_launches(tally: Dict[str, int]) -> None:
    """launches[name] += tally[name] for each name, under the lock."""
    with _launch_lock:
        for name, n in tally.items():
            launches[name] += n


@contextlib.contextmanager
def recorded_launches():
    """Inside the block, this thread's launches are counted into the
    yielded dict {kernel: launches} and not into `launches`; other
    threads count as before."""
    prev = getattr(_recording, "tally", None)
    _recording.tally = tally = {}
    try:
        yield tally
    finally:
        _recording.tally = prev


def reset_launches() -> None:
    with _launch_lock:
        for name in launches:
            launches[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def nvcc_flags(name: str) -> Tuple[str, ...]:
    """nvcc's flags for csrc/<name>.cu."""
    return (*NVCC_FLAGS, *SOURCE_FLAGS[name])


def source_files(name: str) -> Tuple[Path, ...]:
    """csrc/<name>.cu and every header it includes by `#include "..."`,
    directly or through another header, in the order first met."""
    files, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path not in files:
            files.append(path)
            todo += [path.parent / inc for inc in _INCLUDE.findall(path.read_text())]
    return tuple(files)


def _library_path(name: str) -> Path:
    digest = hashlib.sha1()
    for path in source_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile the named sources that are not built yet, all nvcc
    processes at once. -> {name: (seconds, compiler log)} for each source
    compiled now; raises if any compile fails."""
    with _build_lock:
        return _compile(names)


def _compile(names) -> Dict[str, Tuple[float, str]]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *nvcc_flags(name), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter(), tmp, out)
    results, failed = {}, []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        results[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return results


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libraries.get(name)
    if lib is not None:
        return lib
    with _build_lock:
        lib = _libraries.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                _compile((name,))
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libraries[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def on_card(t, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for {t.device}")


def aligned(t: torch.Tensor, n_bytes: int = 16) -> torch.Tensor:
    """t where its data starts on an n_bytes boundary, else a copy (a new
    allocation is aligned far beyond that), for kernels that load vectors."""
    return t if t.data_ptr() % n_bytes == 0 else t.clone()


def require(t, name: str, dtype, ndim: int) -> None:
    """Check what a kernel takes: dtype, rank and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
