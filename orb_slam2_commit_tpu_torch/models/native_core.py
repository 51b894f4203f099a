"""The native C++ map core (native/map_core.cpp) bound through ctypes, with
the plain numpy versions of its three operations (PyTorch port of
models/native_core.py).

`get_lib()` builds the core with `g++ -O3 -shared -fPIC` into the port's
build directory (`_build/`, beside the CUDA kernels' libraries; the file
name carries a hash of the source), loads it, and returns None where no
compiler or no source is found. `covis_row`, `obs_counts` and
`covis_matrix` go through the library when it loads and through their
plain versions otherwise. This is host code: the map tables live in
numpy on the host.

Each gives exactly what the C++ core gives over the observation table
kf_point_idx [K, N] (-1 = no observation): an observation counts once per
feature, so a keyframe that binds one point to two features counts it
twice.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "map_core.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
ARGTYPES = {
    "covis_row": (_i32p, _u8p, _i64, _i64, _i64, _i64, _i32p),
    "obs_counts": (_i32p, _u8p, _i64, _i64, _i64, _i32p),
    "covis_matrix": (_i32p, _u8p, _i64, _i64, _i64, _i32p),
}


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmap_core-{digest.hexdigest()[:12]}.so"


def _load() -> Optional[ctypes.CDLL]:
    gxx = shutil.which("g++")
    if gxx is None or not SOURCE.exists():
        return None
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        done = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{done.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded map core, built at the first call; None where g++ or the
    source is missing (a compile error raises)."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            _lib = _load()
            _tried = True
    return _lib


def _tables(kf_point_idx, kf_valid):
    return (np.ascontiguousarray(kf_point_idx, np.int32),
            np.ascontiguousarray(kf_valid, np.uint8))


def _observed(kf_point_idx: np.ndarray, kf_valid: np.ndarray,
              max_points: int) -> np.ndarray:
    """[K, N] bool: a valid keyframe's observation of a point in range."""
    return ((kf_point_idx >= 0) & (kf_point_idx < max_points)
            & np.asarray(kf_valid, bool)[:, None])


def covis_row(kf_point_idx: np.ndarray, kf_valid: np.ndarray,
              max_points: int, k: int) -> np.ndarray:
    """[K] int32: for every other valid keyframe j, how many of its
    observations are of a point that keyframe k observes."""
    lib = get_lib()
    if lib is None:
        return covis_row_plain(kf_point_idx, kf_valid, max_points, k)
    K, N = kf_point_idx.shape
    out = np.zeros(K, np.int32)
    lib.covis_row(*_tables(kf_point_idx, kf_valid), K, N, max_points, k, out)
    return out


def obs_counts(kf_point_idx: np.ndarray, kf_valid: np.ndarray,
               max_points: int) -> np.ndarray:
    """[max_points] int32: observations of each point by valid keyframes."""
    lib = get_lib()
    if lib is None:
        return obs_counts_plain(kf_point_idx, kf_valid, max_points)
    K, N = kf_point_idx.shape
    out = np.zeros(max_points, np.int32)
    lib.obs_counts(*_tables(kf_point_idx, kf_valid), K, N, max_points, out)
    return out


def covis_matrix(kf_point_idx: np.ndarray, kf_valid: np.ndarray,
                 max_points: int) -> np.ndarray:
    """[K, K] int32: for each point, every pair of its observations (a, b)
    in different rows adds one to out[ka, kb] and out[kb, ka]; the
    diagonal gathers the pairs within one keyframe."""
    lib = get_lib()
    if lib is None:
        return covis_matrix_plain(kf_point_idx, kf_valid, max_points)
    K, N = kf_point_idx.shape
    out = np.zeros((K, K), np.int32)
    lib.covis_matrix(*_tables(kf_point_idx, kf_valid), K, N, max_points, out)
    return out


def covis_row_plain(kf_point_idx: np.ndarray, kf_valid: np.ndarray,
                    max_points: int, k: int) -> np.ndarray:
    """Plain version of covis_row."""
    K = kf_point_idx.shape[0]
    out = np.zeros(K, np.int32)
    if not kf_valid[k]:
        return out
    obs = _observed(kf_point_idx, kf_valid, max_points)
    mark = np.zeros(max_points, bool)
    mark[kf_point_idx[k][obs[k]]] = True
    hit = obs & mark[np.clip(kf_point_idx, 0, max_points - 1)]
    out[:] = hit.sum(axis=1)
    out[k] = 0
    return out


def obs_counts_plain(kf_point_idx: np.ndarray, kf_valid: np.ndarray,
                     max_points: int) -> np.ndarray:
    """Plain version of obs_counts."""
    obs = _observed(kf_point_idx, kf_valid, max_points)
    return np.bincount(kf_point_idx[obs], minlength=max_points).astype(np.int32)


def covis_matrix_plain(kf_point_idx: np.ndarray, kf_valid: np.ndarray,
                       max_points: int) -> np.ndarray:
    """Plain version of covis_matrix."""
    K = kf_point_idx.shape[0]
    obs = _observed(kf_point_idx, kf_valid, max_points)
    ks, fs = np.nonzero(obs)
    # Point x keyframe incidence counts C [P, K]; C^T C counts pairs.
    C = np.zeros((max_points, K), np.int64)
    np.add.at(C, (kf_point_idx[ks, fs], ks), 1)
    used = C.any(axis=1)
    C = C[used]
    out = C.T @ C
    # Pairs (a, b) with a < b: off-diagonal counts each pair once per
    # ordering; on the diagonal, n(n-1)/2 pairs each counted twice.
    diag = (C * (C - 1)).sum(axis=0)
    np.fill_diagonal(out, diag)
    return out.astype(np.int32)
