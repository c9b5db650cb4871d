"""Build and bind the hand-written CUDA kernels of csrc/.

At first use each source is compiled with nvcc for sm_90a into its own
shared library with a plain C interface,
`build/gssr_tpu_torch/lib<source>-<hash>.so` under the repository root;
the nvcc runs for all sources start together. The libraries are loaded
through ctypes. A hash covers the source, the shared header and the flags,
so an edited source is rebuilt. Importing this module touches neither CUDA
nor nvcc: CPU-only test runs import every module. `build` also takes
another checkout's csrc/, and skips the sources that one lacks, and `bind`
binds what it built (chip_smoke.py --yardstick holds these kernels against
the parent commit's so).
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
HEADERS = ("common.cuh",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_FWD = (_P, _I64, _P, _I32, _I32, _P)
_BWD = (_P, _I64, _P, _I32, _I32, _P, _P, _P)
_EXPAND = (_P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _P, _P)
_GATHER = (_P, _I64, _I64, _P, _P, _I64, _I32, _P)
_SH_FWD = (_P, _P, _P, _P, _I64, _I32, _I32, _P)
_SH_BWD = (_P, _P, _P, _P, _P, _I64, _I32, _I32, _P, _P, _P)
# source -> its C entry points: (argtypes without the trailing stream);
# *_occupancy report a kernel's registers, shared memory and blocks per SM.
SOURCES = {
    "blend.cu": {
        "gssr_blend_fwd": _FWD,
        "gssr_blend_fwd_occupancy": (_P,),
        "gssr_blend_bwd": _BWD,
        "gssr_blend_bwd_occupancy": (_P,),
        "gssr_gather_bwd": _GATHER,
    },
    "blend2d.cu": {
        "gssr_blend2d_fwd": _FWD,
        "gssr_blend2d_fwd_occupancy": (_P,),
        "gssr_blend2d_bwd": _BWD,
        "gssr_blend2d_bwd_occupancy": (_P,),
    },
    "blend_pgsr.cu": {
        "gssr_blend_pgsr_fwd": _FWD,
        "gssr_blend_pgsr_fwd_occupancy": (_P,),
        "gssr_blend_pgsr_obs": _FWD,
        "gssr_blend_pgsr_obs_occupancy": (_P,),
        "gssr_blend_pgsr_bwd": _BWD,
        "gssr_blend_pgsr_bwd_occupancy": (_P,),
    },
    "binning.cu": {
        "gssr_bin_expand": _EXPAND,
    },
    "projection.cu": {
        "gssr_tile_mask": (_P, _P, _P, _P, _P, _I64, _P, _P),
    },
    "sh.cu": {
        "gssr_sh_fwd": _SH_FWD,
        "gssr_sh_bwd": _SH_BWD,
    },
}

_fns = None


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build gssr_tpu_torch's kernels")
    return exe


def library_path(source: str, src_dir: Path = _SRC_DIR,
                 build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in (source,) + HEADERS:
        h.update((src_dir / name).read_bytes())
    return build_dir / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(src_dir: Path = _SRC_DIR, build_dir: Path = BUILD_DIR) -> dict:
    """Compile every source of src_dir whose hash is not built yet into
    build_dir, one nvcc each, all at once. Returns {"seconds": wall time,
    "libs": {source: {"path", "seconds", "log"}}} (log: nvcc/ptxas
    output; seconds 0 if cached)."""
    src_dir, build_dir = Path(src_dir), Path(build_dir)
    t0 = time.perf_counter()
    libs, procs = {}, {}
    for src in SOURCES:
        if src_dir != _SRC_DIR and not (src_dir / src).is_file():
            continue
        so = library_path(src, src_dir, build_dir)
        if so.exists():
            libs[src] = {"path": so, "seconds": 0.0,
                         "log": so.with_suffix(".log").read_text()}
            continue
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(src_dir / src)]
        procs[src] = (so, tmp, cmd, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for src, (so, tmp, cmd, t_start, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{log}")
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
        libs[src] = {"path": so, "seconds": time.perf_counter() - t_start,
                     "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "libs": libs}


def bind(libs: dict) -> dict:
    """Entry point name -> (C function, its library's error string), for
    the entry points of SOURCES that the built libraries `libs`
    (build()["libs"]) define."""
    fns = {}
    for src, entries in SOURCES.items():
        if src not in libs:
            continue
        lib = ctypes.CDLL(str(libs[src]["path"]))
        lib.gssr_error_string.argtypes = [ctypes.c_int]
        lib.gssr_error_string.restype = ctypes.c_char_p
        for name, args in entries.items():
            if not hasattr(lib, name):
                continue
            fn = getattr(lib, name)
            fn.argtypes = [*args, _P]
            fn.restype = ctypes.c_int
            fns[name] = (fn, lib.gssr_error_string)
    return fns


def load() -> dict:
    """Entry point name -> bound C function, the libraries built on first
    use."""
    global _fns
    if _fns is None:
        _fns = bind(build()["libs"])
    return _fns


def launch(name: str, device: torch.device, *args):
    """Call C entry point `name` on `device`'s current stream; raise on any
    CUDA error the launch reports."""
    if device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {device}")
    fn, error_string = load()[name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({error_string(err).decode()})")


def occupancy(name: str, device: torch.device) -> dict:
    """What occupancy entry point `name` reports of its kernel on
    `device`: registers and local (spill) bytes per thread, dynamic shared
    memory bytes per block, resident blocks per SM."""
    out = (ctypes.c_int * 4)()
    launch(name, device, out)
    return dict(zip(("registers", "local_bytes", "dynamic_smem",
                     "blocks_per_sm"), out))
