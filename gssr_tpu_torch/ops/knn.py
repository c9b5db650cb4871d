"""Mean squared distance to the 3 nearest neighbours, for gaussian scale
initialization (port of gssr_tpu/ops/knn.py and ops/knn_native.py).

Host-side: the native C++ Morton-box implementation in
native/libsimple_knn.so through ctypes (built with `make -C native` when
missing), else scipy's cKDTree.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libsimple_knn.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO_PATH):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR],
                               check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
            lib.mean_knn_dist2.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float)]
            lib.mean_knn_dist2.restype = None
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def mean_knn_dist2_native(points: np.ndarray):
    """[N,3] -> [N] float32, or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    out = np.empty(pts.shape[0], dtype=np.float32)
    lib.mean_knn_dist2(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(pts.shape[0]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def mean_knn_dist2_host(points: np.ndarray, k: int = 3) -> np.ndarray:
    if k == 3:
        out = mean_knn_dist2_native(points)
        if out is not None:
            return out.astype(np.float64)
    from scipy.spatial import cKDTree
    tree = cKDTree(np.asarray(points, dtype=np.float64))
    d, _ = tree.query(points, k=k + 1)   # the first neighbour is the point
    return np.mean(d[:, 1:] ** 2, axis=1)
