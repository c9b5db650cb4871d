"""Build and bind the hand-written CUDA kernels of csrc/.

At first use the sources are compiled with nvcc for sm_90a into a shared
library with a plain C interface, `build/gssr_tpu_torch/libblend-<hash>.so`
under the repository root, and loaded through ctypes. The hash covers the
sources and flags, so an edited source is rebuilt. Importing this module
touches neither CUDA nor nvcc: CPU-only test runs import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gssr_tpu_torch"
SOURCES = ("blend.cu",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# C entry points: (argtypes without the trailing stream)
_SIGNATURES = {
    "gssr_blend_fwd": (_P, _I64, _P, _I32, _I32, _P),
    "gssr_blend_bwd": (_P, _I64, _P, _I32, _I32, _P, _P, _P),
}

_lib = None


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build gssr_tpu_torch's kernels")
    return exe


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update((_SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libblend-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels unless this source hash is already built.
    Returns {"path", "seconds", "log"} (log: nvcc/ptxas output)."""
    so = library_path()
    log = so.with_suffix(".log")
    if so.exists():
        return {"path": so, "seconds": 0.0, "log": log.read_text()}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp),
           *[str(_SRC_DIR / s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return {"path": so, "seconds": seconds, "log": proc.stdout + proc.stderr}


def load():
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()["path"]))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [*args, _P]
            fn.restype = ctypes.c_int
        lib.gssr_error_string.argtypes = [ctypes.c_int]
        lib.gssr_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args):
    """Call C entry point `name` on `device`'s current stream; raise on any
    CUDA error the launch reports."""
    if device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {device}")
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib.gssr_error_string(err).decode()})")
