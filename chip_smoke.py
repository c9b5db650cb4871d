#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port, gssr_tpu_torch, on one CUDA card.

    python3 chip_smoke.py [--profile FILE] [--yardstick DIR]

Phases; any failure exits non-zero, and nothing is caught and passed over:

1. build    one nvcc per source of gssr_tpu_torch/csrc/, all started
            together, for sm_90a; prints the build seconds, the registers
            and spills, and the card; for the seven redesigned kernels
            (vanilla forward and backward, surfel forward and backward,
            planar forward, observe count and backward) also their dynamic
            shared memory and resident blocks per SM, which must be at
            least 3, 3, 3, 2, 3, 4 and 3, with no spill (the observe
            count's 4 blocks of 256 threads cap it at 64 registers). With
            --yardstick DIR it also builds DIR's kernels
            (DIR/gssr_tpu_torch/csrc/, a checkout of the parent commit)
            into build/yardstick/.
            (`python -m gssr_tpu_torch.sass_count` prints the kernels'
            SASS instruction counts.)
2. kernels  each blend kernel against its plain PyTorch version on the
            card at 256x256: the vanilla pair with ~20k gaussians, the
            surfel pair with ~20k surfels, the planar (PGSR) forward,
            observe and backward with ~20k gaussians and random normals and
            plane distances, each with a dense overdraw stack (so the early
            stop fires; for the surfels the median too, for the planar
            observe count its D > 0.5 cut-off) and a seeded randn
            cotangent; the observe count also on observe_cases' hand-built
            stacks (D exactly 0.5, the 0.5 point on either side of a chunk
            boundary, a warp done beside walking ones, a tile that never
            reaches 0.5). Each backward runs twice and must agree bit for
            bit, and the planar backward's observe row must equal the
            observe kernel's counts. The first designs of the four
            redesigned backward and surfel kernels (the *_v1 kernels, their
            yardstick) pass the same checks and must equal the current ones
            bit for bit; each pair is timed in turns. With --yardstick, the
            vanilla and planar forwards and the observe count must equal
            DIR's bit for bit, and the observe count is timed in turns with
            DIR's.
3. train    each main path through its CLI entry point, called in process
            on one synthetic COLMAP scene (8 ring cameras at 1600x1056, 200k
            initial points seen by the cameras whose frustum holds them, GT
            rendered by the port from a separate random gaussian set):
            `python -m gssr_tpu_torch.train 3dgs`, then `... 2dgs`, `...
            pgsr` (its two-camera step after step MULTI_VIEW_FROM), and the
            six anchor methods at their presets' full width (feat_dim 32,
            10 offsets, appearance_dim 32, octree 0): `scaffold-gs`,
            `octree-gs`, `scaffold-2dgs`, `octree-2dgs`, `scaffold-pgsr` and
            `octree-pgsr` (statistics from step 3; the octree ones with 4
            levels; the planar ones two-camera after MULTI_VIEW_FROM).
            STEPS steps each with two densify passes (the first three paths
            with SH degree 3). Asserts finite losses, image losses that
            fall, a changed n_active, the written PLY (anchor paths: also
            the _mlp.npz and checkpoints.pth), and that every train render
            launched the path's forward and backward kernels (two renders
            on a multi-view step) and no render launched a *_v1 kernel or
            the observe count; for the two-camera paths also ring
            neighbours and no camera its own, and geo and NCC losses above
            0 on every multi-view step; for the anchor paths a scaling loss
            above 0 at every step, and for the octree ones an LOD mask that
            drops active anchors on some render. Prints the median step
            (two-camera paths: also single- and multi-view apart), its
            tail, Mpix/s, peak memory; for the anchor paths the anchors
            grown and pruned at each adjust_anchor (octree: the active
            anchors of each level at init and after each pass), the
            offsets' mean screen gradients against the grow threshold, the
            visible anchors and neural gaussians per render, and the share
            of the active anchors the LOD mask drops.
   mesh     `python -m gssr_tpu_torch.extract_mesh` in process: the 2dgs
            run bounded at a 257^3 grid and unbounded at 128^3, the pgsr and
            octree-2dgs runs bounded; no render launches the observe
            kernel. Asserts non-empty meshes; prints their sizes and the
            seconds of rendering, fusion and marching tetrahedra.
   split    the partitioned pipeline (BASELINE.md's large-scene path,
            VastGaussian with octree-2dgs) through its entry points, in
            process, in the same temporary root: `python -m
            gssr_tpu_torch.split_scene --num-col 2 --num-row 1
            --auto-align` (2 tiles, each with cameras and a box.txt),
            `... train_split octree-2dgs` with phase 3's octree-2dgs
            options (tile 0 also with a profiler window over steps 10-12,
            whose trace must exist), each tile's trainer gone before the
            next tile starts, then `train_split` again, which must skip
            both; `... extract_mesh_split` at the mesh phase's bounded
            257^3 grid (non-empty, every camera rendered in some tile's
            box); `... extract_mesh --render-video --video-frames 30
            --skip-mesh` on the 2dgs run (30 frames, an mp4 or PNGs).
            Prints each tile's cameras and points, its median step, tail,
            peak memory and anchors grown, the merge's stage seconds, and
            the seconds a video frame.
4. report   all seven kernels against their plain versions again, at their
            main path's own inputs (the trained model, one of its cameras):
            the vanilla pair under the cotangent of its loss, the surfel
            pair under that of the 2dgs loss with both regularisers live
            plus a random one on median_normal, the planar kernels under
            that of the pgsr multi-view loss, each channel group scaled to
            unit size; with times and bounds, the four redesigned backward
            and surfel kernels timed in turns with their v1 kernels (v1,
            new, new, v1; "v1_ms" in their rows) after asserting that each
            equals its v1 bit for bit, and each plain version timed on its
            one comparison call. At the 3dgs, 2dgs and pgsr inputs it also
            prints, from the plain versions of the forwards' culls, the
            share of evaluated pairs the per-pair test proves zero and the
            share of (warp, instance) steps that a warp's 8 x 4 block skips
            whole (the vanilla and planar forwards' instance lists; for the
            surfels, where every walking lane skips), from which the
            kernels' bounds charge such pairs only the test that proves
            them zero; for the observe count the same up to each pixel's
            D <= 0.5 point, where its walk and its bound end. The same
            checks also run at three anchor paths' inputs (the neural
            gaussians decoded for camera 0), printed apart: the vanilla
            pair at scaffold-gs's, the surfel pair at octree-2dgs's, the
            planar kernels at scaffold-pgsr's; the {"kernels": [...]} line
            keeps one row per kernel. With
            --yardstick, the vanilla and planar forwards and the observe
            count must equal DIR's bit for bit, are timed in turns with
            them (DIR, new, new, DIR) and their rows gain "parent_ms".
            Prints the {"kernels": [...]} line, the card, and last the
            {"ok": true, "device": {...}} line.

--profile FILE adds three profiled train steps to five paths after phase 3
and writes torch.profiler's per-kernel tables to FILE (3dgs) and to FILE
with `_2dgs`, `_pgsr`, `_scaffold` and `_octree2dgs` before its suffix;
for the anchor paths it also prints the step's stages
(scene/scaffold.py's profiler ranges).

--yardstick DIR names a checkout of the parent commit (for example `git
archive HEAD` unpacked under build/): its vanilla and planar forward
kernels and its observe count are the yardstick the redesigned ones are
held and timed against.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import weakref
from functools import partial
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per evaluated (pixel, instance) pair, counted from the
# kernels in gssr_tpu_torch/csrc/blend.cu (the exp counts as one)
FWD_OPS_PER_PAIR = 28
BWD_OPS_PER_PAIR = 56
# the same for the surfel kernels of gssr_tpu_torch/csrc/blend2d.cu: per
# evaluated pair (the surfel and the transmittance walk), per contributing
# pair (the sums, or the gradient terms and one add a row for the sum over
# pixels), and per evaluated pair that the forward's cull proves to have
# alpha 0 (the intersection and rho2d, 18, and the cull's test, 9), which
# both kernels then need no more for
SURFEL_OPS_PER_PAIR = 49
SURFEL_OPS_PER_CULLED = 27
FWD2_OPS_PER_CONTRIB = 30
BWD2_OPS_PER_CONTRIB = 103
# the same for the planar kernels of gssr_tpu_torch/csrc/blend_pgsr.cu: per
# evaluated pair the gaussian (17) and the walk (5), and for the observe
# count its one comparison more (its pairs end at each pixel's 0.5 point);
# per contributing pair the weight, 7 channel sums and T forward, and
# backward the weight, u (7 FMAs), the prefix, da, 15 gradient terms and
# one add a row for the sum over pixels
FWDP_OPS_PER_PAIR = 22
FWDP_OPS_PER_CONTRIB = 16
OBSP_OPS_PER_PAIR = 23
BWDP_OPS_PER_PAIR = 22
BWDP_OPS_PER_CONTRIB = 69
# the least work of a vanilla or planar pair whose alpha the forwards' cull
# (gssr_tpu_torch/csrc/common.cuh) proves 0, which all five vanilla and
# planar kernels then need no more for: per (warp, instance) step that the
# warp test skips whole, block_culled once for all its pairs (the block's
# far corner 2; four edge minima, each a clamped point 5 and Q 10 with the
# corner's offset shared; their minimum 3; the inside test and select 5; X
# and Y 2; Emax 9; the margin and the two compares 4); per pair of a walked
# step that the per-pair proof covers, the power, 11, and its test against
# the instance's limit, 1. The limit itself, once per (tile, instance), is
# left out.
GAUSS_OPS_PER_BLOCK_TEST = 85
GAUSS_OPS_PER_CULLED = 12

FWD_TOL = dict(atol=1e-5, rtol=1e-4)
BWD_TOL = dict(atol=2e-4, rtol=2e-3)

WIDTH, HEIGHT = 1600, 1056      # bench.py's resolution
N_CAMS = 8
N_POINTS = 200_000
N_GT_GAUSSIANS = 50_000
# SH degree 3 from step 15 (oneup every 5), densify after steps 20 and 30,
# four whole epochs of the N_CAMS cameras
STEPS = 32
# pgsr's two-camera step runs after this step: steps 17-32
MULTI_VIEW_FROM = 16
# extract_mesh's options: the ring has radius 4, so the bounded grid spans
# 6 units at a 256^3 resolution. The 2dgs run is meshed both ways, the
# pgsr run bounded.
MESH_RUNS = (("bounded", ["--depth-trunc", "6.0", "--voxel-size", "0.0234",
                          "--sdf-trunc", "0.08"]),
             ("unbounded", ["--unbounded", "--resolution", "128"]))
MESH_METHODS = {"2dgs": ("bounded", "unbounded"), "pgsr": ("bounded",),
                "octree-2dgs": ("bounded",)}
# the split phase: the partitioned path of BASELINE.md's large-scene
# configuration (VastGaussian with octree-2dgs), and the fly-through's length
SPLIT_METHOD = "octree-2dgs"
VIDEO_FRAMES = 30
# the kernels each main path must launch at every render of a train step
VANILLA_PAIR = ("blend_fwd", "blend_bwd")
SURFEL_PAIR = ("blend2d_fwd", "blend2d_bwd")
PLANAR_PAIR = ("blend_pgsr_fwd", "blend_pgsr_bwd")
PATH_KERNELS = {"3dgs": VANILLA_PAIR, "2dgs": SURFEL_PAIR,
                "pgsr": PLANAR_PAIR, "scaffold-gs": VANILLA_PAIR,
                "octree-gs": VANILLA_PAIR, "scaffold-2dgs": SURFEL_PAIR,
                "octree-2dgs": SURFEL_PAIR, "scaffold-pgsr": PLANAR_PAIR,
                "octree-pgsr": PLANAR_PAIR}
# the anchor paths (scaffold and octree), the octree ones, and the paths
# with PGSR's two-camera step, in the order phase 3 trains them
ANCHOR_METHODS = ("scaffold-gs", "octree-gs", "scaffold-2dgs", "octree-2dgs",
                  "scaffold-pgsr", "octree-pgsr")
OCTREE_METHODS = ("octree-gs", "octree-2dgs", "octree-pgsr")
MULTI_VIEW_METHODS = ("pgsr", "scaffold-pgsr", "octree-pgsr")
# the first designs of the redesigned kernels, kept as the yardstick of the
# current ones: no render may launch them
V1_KERNELS = ("blend_bwd_v1", "blend2d_fwd_v1", "blend2d_bwd_v1",
              "blend_pgsr_bwd_v1")
# the redesigned kernels' occupancy entry points and the resident blocks per
# SM each must keep
OCCUPANCY = {"gssr_blend_fwd_occupancy": 3,
             "gssr_blend_bwd_occupancy": 3,
             "gssr_blend2d_fwd_occupancy": 3,
             "gssr_blend2d_bwd_occupancy": 2,
             "gssr_blend_pgsr_fwd_occupancy": 3,
             "gssr_blend_pgsr_obs_occupancy": 4,
             "gssr_blend_pgsr_bwd_occupancy": 3}
# the kernels --yardstick holds against the parent commit's: wrapper ->
# (C entry point, output channels per pixel; None for the observe count,
# one float per instance slot)
YARDSTICK = {"blend_fwd": ("gssr_blend_fwd", 4),
             "blend_pgsr_fwd": ("gssr_blend_pgsr_fwd", 8),
             "blend_pgsr_obs": ("gssr_blend_pgsr_obs", None)}
# each path's options beyond the common ones: SH degree 3 from step 15
# (the anchor models have no SH); the anchor paths gather their
# statistics from step 3, so that adjust_anchor after steps 20 and 30 has
# offsets and anchors seen often enough to grow and prune; the octree
# paths take 4 levels (the preset's derived 2 keep only level 0 after the
# weed-out on this scene, so no LOD mask would drop an anchor); the
# surfel anchor paths grow offsets from a mean screen gradient of 5e-6
# (the surfel render moves an offset's screen position only through its
# low-pass term: at 1600x1056 no offset reaches the preset's 2e-4, whose
# 99.9th percentile is ~5e-6, so no anchor would grow); the two-camera
# paths switch at MULTI_VIEW_FROM
SH_ARGS = ["--scene.gaussians.oneup-sh-interval", "5"]
ANCHOR_ARGS = ["--scene.gaussians.start-stat", "2"]
OCTREE_ARGS = ANCHOR_ARGS + ["--scene.gaussians.levels", "4"]
SURFEL_GROW_ARGS = ["--scene.gaussians.densify-grad-threshold", "5e-6"]
MULTI_VIEW_ARGS = ["--scene.multi-view-from", str(MULTI_VIEW_FROM)]
METHOD_ARGS = {"3dgs": SH_ARGS, "2dgs": SH_ARGS,
               "pgsr": SH_ARGS + MULTI_VIEW_ARGS,
               "scaffold-gs": ANCHOR_ARGS, "octree-gs": OCTREE_ARGS,
               "scaffold-2dgs": ANCHOR_ARGS + SURFEL_GROW_ARGS,
               "octree-2dgs": OCTREE_ARGS + SURFEL_GROW_ARGS,
               "scaffold-pgsr": ANCHOR_ARGS + MULTI_VIEW_ARGS,
               "octree-pgsr": OCTREE_ARGS + MULTI_VIEW_ARGS}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def event_ms(fn, reps: int) -> list:
    """Per-call CUDA-event times, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def median_ms(fn, reps: int) -> float:
    return statistics.median(event_ms(fn, reps))


def timed(fn):
    """fn() and its CUDA-event time in ms, from this one call (the plain
    versions are timed so: their one call is also their comparison's)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def turns_ms(v1, new, reps: int = 20):
    """A yardstick kernel (v1, or the parent commit's) and its redesign
    timed in turns v1, new, new, v1: (v1 ms, new ms), each the median of
    its two turns' samples."""
    times = {v1: [], new: []}
    for fn in (v1, new, new, v1):
        times[fn] += event_ms(fn, reps)
    return statistics.median(times[v1]), statistics.median(times[new])


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def camera(width, height, R=np.eye(3), T=(0.0, 0.0, 4.0), uid=0,
           name="smoke"):
    from gssr_tpu_torch.cameras import Camera
    return Camera(uid=uid, colmap_id=uid + 1, image_name=name, R=R,
                  T=np.asarray(T, np.float64), fovx=math.radians(60),
                  fovy=2 * math.atan(math.tan(math.radians(30)) * height
                                     / width),
                  width=width, height=height)


@torch.no_grad()
def blend_inputs(means, scales, rots, opacity, color, cam, width, height,
                 active=None):
    """The blend's inputs as ops/rasterize.py makes them: preprocess,
    binning and the instance pack. Returns (attrs, ranges, tiles_x,
    tiles_y)."""
    from gssr_tpu_torch.ops.binning import bin_gaussians
    from gssr_tpu_torch.ops.blend import CHUNK, pack_instance_attrs
    from gssr_tpu_torch.ops.projection import TILE, preprocess
    from gssr_tpu_torch.ops.rasterize import pad_to_tiles
    pw, ph = pad_to_tiles(width, height)
    proj = preprocess(means, scales, rots, cam, pw, ph, opacity,
                      active_mask=active)
    b = bin_gaussians(proj.rect, proj.depth, proj.tiles_touched, pw // TILE,
                      ph // TILE, proj.tile_mask, chunk=CHUNK)
    attrs = pack_instance_attrs(proj.mean2d, proj.conic, color, opacity, b)
    return attrs, b.tile_ranges, pw // TILE, ph // TILE


@torch.no_grad()
def blend2d_inputs(means, scales2, rots, opacity, color, cam, width, height,
                   active=None):
    """The surfel blend's inputs as ops/rasterize2d.py makes them:
    preprocess_2d, binning and the instance pack. Returns (attrs, ranges,
    tiles_x, tiles_y)."""
    from gssr_tpu_torch.ops.binning import bin_gaussians
    from gssr_tpu_torch.ops.blend import CHUNK
    from gssr_tpu_torch.ops.blend2d import pack_instance_attrs_2d
    from gssr_tpu_torch.ops.projection import TILE
    from gssr_tpu_torch.ops.projection2d import preprocess_2d
    from gssr_tpu_torch.ops.rasterize import pad_to_tiles
    pw, ph = pad_to_tiles(width, height)
    proj = preprocess_2d(means, scales2, rots, cam, pw, ph, opacity,
                         active_mask=active)
    b = bin_gaussians(proj.rect, proj.depth, proj.tiles_touched, pw // TILE,
                      ph // TILE, chunk=CHUNK)
    attrs = pack_instance_attrs_2d(proj.mean2d, proj.Tmat, proj.normal,
                                   color, opacity, b)
    return attrs, b.tile_ranges, pw // TILE, ph // TILE


@torch.no_grad()
def pgsr_inputs(means, scales, rots, opacity, color, normal, distance, cam,
                width, height, active=None):
    """The planar blend's inputs as ops/rasterize_pgsr.py makes them: the
    vanilla preprocess with its tile mask, binning and the planar pack
    with zero observe and abs columns. Returns (attrs, binning, tiles_x,
    tiles_y)."""
    from gssr_tpu_torch.ops.binning import bin_gaussians
    from gssr_tpu_torch.ops.blend import CHUNK
    from gssr_tpu_torch.ops.blend_pgsr import pack_instance_attrs_pgsr
    from gssr_tpu_torch.ops.projection import TILE, preprocess
    from gssr_tpu_torch.ops.rasterize import pad_to_tiles
    pw, ph = pad_to_tiles(width, height)
    proj = preprocess(means, scales, rots, cam, pw, ph, opacity,
                      active_mask=active)
    b = bin_gaussians(proj.rect, proj.depth, proj.tiles_touched, pw // TILE,
                      ph // TILE, proj.tile_mask, chunk=CHUNK)
    n = means.shape[0]
    attrs = pack_instance_attrs_pgsr(proj.mean2d, proj.conic, color, opacity,
                                     normal, distance, means.new_zeros(n, 1),
                                     means.new_zeros(n, 2), b)
    return attrs, b, pw // TILE, ph // TILE


def per_gaussian(slot_values, b):
    """Per-gaussian sums of per-instance-slot values [I] -> [N]."""
    from gssr_tpu_torch.ops.blend import segment_sum_sorted
    return segment_sum_sorted(slot_values[:, None], b.gid_reduce,
                              b.seg_bounds)[:, 0]


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def phase_build(dev, yardstick=None):
    """Build and load the kernels; with `yardstick` (a checkout of the
    parent commit) also build its kernels into build/yardstick/. Returns
    {wrapper name: the parent's forward} for YARDSTICK's forwards, or
    None."""
    from gssr_tpu_torch.ops import _kernels
    builds = [("", _kernels.build())]
    _kernels.load()
    parent = None
    if yardstick:
        info = _kernels.build(
            Path(yardstick) / "gssr_tpu_torch" / "csrc",
            _kernels.BUILD_DIR.parent / "yardstick")
        builds.append(("yardstick ", info))
        parent = {name: partial(parent_fwd, bind_parent(info["libs"], entry),
                                rows)
                  for name, (entry, rows) in YARDSTICK.items()}
    for tag, info in builds:
        print(f"[build] {tag}{len(info['libs'])} libraries in "
              f"{info['seconds']:.2f} s (one nvcc per source, in parallel)")
        log_build(tag, info)
    for name, least in OCCUPANCY.items():
        occ = _kernels.occupancy(name, dev)
        print(f"[build] {name}: {occ}")
        assert occ["blocks_per_sm"] >= least, (name, occ)
        assert occ["local_bytes"] == 0, (name, occ)
    return parent


def log_build(tag, info):
    for src, lib in info["libs"].items():
        print(f"[build] {tag}{src} -> {lib['path'].name} in "
              f"{lib['seconds']:.2f} s")
        for line in lib["log"].splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "Compiling entry" in line):
                print(f"[build] {tag}{line.strip()}")


def bind_parent(libs, entry):
    """The parent commit's forward `entry` from its built libraries `libs`
    (build()["libs"]), bound through ctypes: (C function, error string)."""
    import ctypes

    from gssr_tpu_torch.ops import _kernels
    src = next(s for s, entries in _kernels.SOURCES.items()
               if entry in entries)
    lib = ctypes.CDLL(str(libs[src]["path"]))
    lib.gssr_error_string.argtypes = [ctypes.c_int]
    lib.gssr_error_string.restype = ctypes.c_char_p
    fn = getattr(lib, entry)
    fn.argtypes = [*_kernels.SOURCES[src][entry], ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, lib.gssr_error_string


def parent_fwd(bound, rows, attrs, ranges, tiles_x, tiles_y):
    """The parent commit's forward (bind_parent's `bound`) on these inputs
    -> [H, W, rows], or with rows None its observe count -> [I] (zero-
    filled first, as its entry point asks); called here, so no LAUNCHES
    count moves."""
    import ctypes

    from gssr_tpu_torch.ops.blend import _ptr
    fn, error_string = bound
    out = (torch.zeros(attrs.shape[1], dtype=torch.float32,
                       device=attrs.device) if rows is None else
           torch.empty((tiles_y * 16, tiles_x * 16, rows),
                       dtype=torch.float32, device=attrs.device))
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    err = fn(_ptr(attrs), ctypes.c_int64(attrs.shape[1]), _ptr(ranges),
             ctypes.c_int(tiles_x), ctypes.c_int(tiles_y), _ptr(out),
             ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"the parent's kernel: "
                           f"{error_string(err).decode()}")
    return out


def assert_parent_equal(parent, name, out, *inputs):
    """With --yardstick, kernel `name`'s result `out` must equal the
    parent commit's on the same inputs, bit for bit."""
    if parent is not None:
        assert torch.equal(out, parent[name](*inputs)), \
            f"{name} differs from the parent commit's kernel"


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions, with an overdraw tile
# ---------------------------------------------------------------------------

def phase_kernels(dev, parent=None):
    from gssr_tpu_torch.ops import blend as B
    g = torch.Generator(device="cpu").manual_seed(1)
    n = 20_000
    scene = overdraw_scene(g, n, 2_000, scale_dim=3)
    cam = camera(256, 256).arrays(dev)
    attrs, ranges, tx, ty = blend_inputs(*(x.to(dev) for x in scene), cam,
                                         256, 256)
    out_k = B.blend_fwd(attrs, ranges, tx, ty)
    out_p = B.blend_fwd_plain(attrs, ranges, tx, ty)
    torch.testing.assert_close(out_k, out_p, **FWD_TOL)
    assert_parent_equal(parent, "blend_fwd", out_k, attrs, ranges, tx, ty)
    saturated = int((out_k[..., 3] < 1e-3).sum())
    assert saturated > 0, "the overdraw tile did not saturate"
    cot = torch.randn(out_k.shape, generator=g).to(dev)
    bwd = partial(B.blend_bwd, attrs, ranges, out_k, cot, tx, ty)
    bwd_v1 = partial(B.blend_bwd_v1, attrs, ranges, out_k, cot, tx, ty)
    d_k, d_v1 = bwd(), bwd_v1()
    d_p = B.blend_bwd_plain(attrs, ranges, out_k, cot, tx, ty)
    assert_backward_pair(d_k, d_v1, d_p, range(B.LIVE_ATTRS), B.LIVE_ATTRS,
                         bwd, bwd_v1)
    fwd_ms = median_ms(lambda: B.blend_fwd(attrs, ranges, tx, ty), 20)
    fwd_plain_ms = median_ms(lambda: B.blend_fwd_plain(attrs, ranges, tx,
                                                       ty), 3)
    bwd_plain_ms = median_ms(lambda: B.blend_bwd_plain(attrs, ranges, out_k,
                                                       cot, tx, ty), 3)
    v1_ms, bwd_ms = turns_ms(bwd_v1, bwd)
    print(f"[kernels] 256x256, {n} gaussians, {attrs.shape[1]} instance "
          f"slots, {saturated} saturated pixels")
    print(f"[kernels] blend_fwd max|err| {max_err(out_k, out_p):.3e}  "
          f"{fwd_ms:.4f} ms  plain {fwd_plain_ms:.4f} ms"
          + ("; bitwise equal to the parent's" if parent else ""))
    print(f"[kernels] blend_bwd max|err| {max_err(d_k, d_p):.3e}  "
          f"{bwd_ms:.4f} ms  v1 {v1_ms:.4f} ms  plain {bwd_plain_ms:.4f} ms  "
          f"deterministic: yes; bitwise equal to v1: yes")


def overdraw_scene(g, n, n_dense, scale_dim):
    """n random primitives, n_dense of them a stack of nearly-opaque ones
    in front of one spot, so that transmittance collapses there and the
    early stop fires."""
    def u(m, k, lo, hi):
        return lo + (hi - lo) * torch.rand((m, k), generator=g)
    means = torch.cat([u(n - n_dense, 1, -2.0, 2.0), u(n - n_dense, 1, -2.0,
                       2.0), u(n - n_dense, 1, -1.0, 1.0)], 1)
    dense = torch.tensor([0.5, -0.5, 0.0]) + 0.04 * torch.randn(
        (n_dense, 3), generator=g)
    means = torch.cat([means, dense])
    scales = torch.cat([u(n - n_dense, scale_dim, 0.005, 0.06),
                        u(n_dense, scale_dim, 0.02, 0.05)])
    rots = torch.randn((n, 4), generator=g)
    opacity = torch.cat([u(n - n_dense, 1, 0.05, 0.95),
                         u(n_dense, 1, 0.9, 0.99)])[:, 0]
    colors = u(n, 3, 0.0, 1.0)
    return means, scales, rots, opacity, colors


def observe_cases():
    """A planar pack built by hand to hit every case of the observe
    count's stop at D <= 0.5, on 3 x 2 tiles (48 x 32 pixels), each
    tile's instances in depth order and padded with zero filler columns
    to whole chunks. "Flat" instances have a zero conic (alpha = op
    exactly at every pixel); rows past the 6 geometry rows are zero.

    tile 0  D exactly 0.5: op 0.5, then 0.3 and 0.2 (counted 256, 0, 0)
    tile 1  the 0.5 point at the last instance of chunk 0: 126 x op
            0.004, op 0.1, op 0.2 (D 0.603, 0.543, 0.434), then chunk 1's
            op 0.3 three times, which no pixel counts
    tile 2  the 0.5 point at the first instance of chunk 1: as tile 1 up
            to op 0.1, then op 0.03 (D 0.527), chunk 1 op 0.2 (counted,
            D 0.421), op 0.5 and op 0.3 (not counted)
    tile 3  a warp done while its neighbours walk: op 0.99 with conic
            0.02 over warp 0's 8 x 4 block takes its D below 0.15 (and
            part of warp 1's below 0.5); four flat op 0.1 follow
    tile 4  a tile that never reaches 0.5: three flat op 0.1 (D 0.729)
    tile 5  no instance

    Returns (attrs [16, I], ranges [7] int32, 3, 2, {slot: count}), on
    the CPU, with the counts that the cases fix."""
    from gssr_tpu_torch.ops.blend import CHUNK
    from gssr_tpu_torch.ops.blend_pgsr import NUM_ATTRS_P
    tiles_x, tiles_y = 3, 2

    def flat(t, op):
        cx, cy = 16 * (t % tiles_x) + 7.5, 16 * (t // tiles_x) + 7.5
        return (cx, cy, 0.0, 0.0, 0.0, op)

    ramp = [0.004] * 126 + [0.1]
    stacks = [
        [flat(0, op) for op in (0.5, 0.3, 0.2)],
        [flat(1, op) for op in ramp + [0.2] + [0.3] * 3],
        [flat(2, op) for op in ramp + [0.03, 0.2, 0.5, 0.3]],
        [(3.5, 17.5, 0.02, 0.0, 0.02, 0.99)] + [flat(3, 0.1)] * 4,
        [flat(4, 0.1)] * 3,
        [],
    ]
    cols, ranges = [], [0]
    for st in stacks:
        pad = -len(st) % CHUNK
        cols += st + [(0.0,) * 6] * pad
        ranges.append(len(cols))
    attrs = torch.zeros((NUM_ATTRS_P, len(cols)), dtype=torch.float32)
    attrs[:6] = torch.tensor(cols, dtype=torch.float32).T
    r = ranges
    want = {r[0]: 256, r[0] + 1: 0, r[0] + 2: 0,
            r[1] + 127: 256, r[1] + 128: 0,
            r[2] + 127: 256, r[2] + 128: 256, r[2] + 129: 0,
            r[3]: 256, r[4]: 256, r[4] + 2: 256}
    return (attrs, torch.tensor(ranges, dtype=torch.int32), tiles_x,
            tiles_y, want)


def assert_observe_cases(obs, ranges, want):
    """The counts observe_cases fixes, and its tile 3: warp 0's 32 pixels
    and part of warp 1's are done after the first instance, the others
    count the next one."""
    for slot, n in want.items():
        assert int(obs[slot]) == n, (slot, int(obs[slot]), n)
    later = int(obs[int(ranges[3]) + 1])
    assert 0 < later <= 256 - 32 - 1, later


def phase_kernels2d(dev):
    """Both surfel kernels against their plain versions at 256x256 with
    ~20k random surfels and a dense overdraw stack: the early stop and
    the median both fire; the backward runs twice, bit for bit."""
    from gssr_tpu_torch.ops import blend2d as B
    g = torch.Generator(device="cpu").manual_seed(2)
    n = 20_000
    scene = overdraw_scene(g, n, 2_000, scale_dim=2)
    # the dense stack faces the camera, so its disks cover the spot
    scene[2][-2_000:] = torch.tensor([1.0, 0.0, 0.0, 0.0]) \
        + 0.1 * torch.randn((2_000, 4), generator=g)
    cam = camera(256, 256).arrays(dev)
    attrs, ranges, tx, ty = blend2d_inputs(*(x.to(dev) for x in scene), cam,
                                           256, 256)
    fwd = partial(B.blend2d_fwd, attrs, ranges, tx, ty)
    fwd_v1 = partial(B.blend2d_fwd_v1, attrs, ranges, tx, ty)
    out_k = fwd()
    out_p = B.blend2d_fwd_plain(attrs, ranges, tx, ty)
    assert_forward_pair(out_k, fwd_v1(), out_p, B.O_SELPOS)
    saturated = int((out_k[..., B.O_T] < 1e-3).sum())
    medians = int((out_k[..., B.O_SELPOS] >= 0).sum())
    assert saturated > 0, "the overdraw stack did not saturate"
    assert medians > 0, "no pixel has a median"
    cot = torch.randn(out_k.shape, generator=g).to(dev)
    cot[..., list(B.NO_GRAD_ROWS)] = 0.0
    bwd = partial(B.blend2d_bwd, attrs, ranges, out_k, cot, tx, ty)
    bwd_v1 = partial(B.blend2d_bwd_v1, attrs, ranges, out_k, cot, tx, ty)
    d_k, d_v1 = bwd(), bwd_v1()
    d_p = B.blend2d_bwd_plain(attrs, ranges, out_k, cot, tx, ty)
    assert_backward_pair(d_k, d_v1, d_p, range(B.LIVE_ATTRS2), B.LIVE_ATTRS2,
                         bwd, bwd_v1)
    fwd_v1_ms, fwd_ms = turns_ms(fwd_v1, fwd)
    v1_ms, bwd_ms = turns_ms(bwd_v1, bwd)
    print(f"[kernels2d] 256x256, {n} surfels, {attrs.shape[1]} instance "
          f"slots, {saturated} saturated pixels, {medians} with a median")
    print(f"[kernels2d] blend2d_fwd max|err| {max_err(out_k, out_p):.3e}  "
          f"{fwd_ms:.4f} ms  v1 {fwd_v1_ms:.4f} ms  bitwise equal to v1: "
          f"yes")
    print(f"[kernels2d] blend2d_bwd max|err| {max_err(d_k, d_p):.3e}  "
          f"{bwd_ms:.4f} ms  v1 max|err| {max_err(d_v1, d_p):.3e}  "
          f"{v1_ms:.4f} ms  deterministic: yes; bitwise equal to v1: yes")


def phase_kernels_pgsr(dev, parent=None):
    """The three planar kernels against their plain versions at 256x256
    with ~20k gaussians carrying random camera-space normals and plane
    distances, and a dense overdraw stack: the early stop and the T > 0.5
    cut-off of the observe count both fire. The backward runs twice, bit
    for bit, and its observe row equals the observe kernel's counts per
    instance slot and summed per gaussian (on the card, what
    tests/test_pgsr.py::test_observe_gradient_channel_matches_forward
    checks)."""
    from gssr_tpu_torch.ops import blend_pgsr as B
    from gssr_tpu_torch.ops.blend import blend_pair_count
    g = torch.Generator(device="cpu").manual_seed(4)
    n = 20_000
    scene = overdraw_scene(g, n, 2_000, scale_dim=3)
    normal = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                           dim=-1)
    distance = 0.5 + 4.5 * torch.rand(n, generator=g)
    cam = camera(256, 256).arrays(dev)
    attrs, b, tx, ty = pgsr_inputs(
        *(x.to(dev) for x in scene + (normal, distance)), cam, 256, 256)
    ranges = b.tile_ranges
    out_k = B.blend_pgsr_fwd(attrs, ranges, tx, ty)
    out_p = B.blend_pgsr_fwd_plain(attrs, ranges, tx, ty)
    torch.testing.assert_close(out_k, out_p, **FWD_TOL)
    assert_parent_equal(parent, "blend_pgsr_fwd", out_k, attrs, ranges, tx,
                        ty)
    saturated = int((out_k[..., B.PO_T] < 1e-3).sum())
    assert saturated > 0, "the overdraw stack did not saturate"
    obs_k = B.blend_pgsr_observe(attrs, ranges, tx, ty)
    assert torch.equal(obs_k, B.blend_pgsr_obs_plain(attrs, ranges, tx, ty))
    assert_parent_equal(parent, "blend_pgsr_obs", obs_k, attrs, ranges, tx,
                        ty)
    a_c, r_c, tx_c, ty_c, want = observe_cases()
    a_c, r_c = a_c.to(dev), r_c.to(dev)
    obs_c = B.blend_pgsr_observe(a_c, r_c, tx_c, ty_c)
    assert torch.equal(obs_c, B.blend_pgsr_obs_plain(a_c, r_c, tx_c, ty_c))
    assert_observe_cases(obs_c, r_c, want)
    assert_parent_equal(parent, "blend_pgsr_obs", obs_c, a_c, r_c, tx_c,
                        ty_c)
    pairs, contrib = blend_pair_count(attrs, ranges, tx, ty)
    observed = int(obs_k.sum())
    assert 0 < observed < contrib, \
        f"the T > 0.5 cut-off did not fire ({observed} of {contrib})"
    cot = torch.randn(out_k.shape, generator=g).to(dev)
    bwd = partial(B.blend_pgsr_bwd, attrs, ranges, out_k, cot, tx, ty)
    bwd_v1 = partial(B.blend_pgsr_bwd_v1, attrs, ranges, out_k, cot, tx, ty)
    d_k, d_v1 = bwd(), bwd_v1()
    d_p = B.blend_pgsr_bwd_plain(attrs, ranges, out_k, cot, tx, ty)
    # every row but the observe count is a gradient
    grad_rows = [r for r in range(B.NUM_ATTRS_P) if r != B.P_OBS]
    assert_backward_pair(d_k, d_v1, d_p, grad_rows, B.NUM_ATTRS_P, bwd,
                         bwd_v1)
    for d in (d_k, d_v1):
        assert torch.equal(d[B.P_OBS], d_p[B.P_OBS])
        assert torch.equal(d[B.P_OBS], obs_k)
    assert torch.equal(per_gaussian(d_k[B.P_OBS], b), per_gaussian(obs_k, b))
    fwd_ms = median_ms(lambda: B.blend_pgsr_fwd(attrs, ranges, tx, ty), 20)
    obs = partial(B.blend_pgsr_observe, attrs, ranges, tx, ty)
    if parent is None:
        obs_line = f"{median_ms(obs, 20):.4f} ms"
    else:
        base_ms, obs_ms = turns_ms(partial(parent["blend_pgsr_obs"], attrs,
                                           ranges, tx, ty), obs)
        obs_line = (f"{obs_ms:.4f} ms  parent {base_ms:.4f} ms; bitwise "
                    f"equal to the parent's")
    v1_ms, bwd_ms = turns_ms(bwd_v1, bwd)
    print(f"[kernels pgsr] 256x256, {n} gaussians, {attrs.shape[1]} "
          f"instance slots, {saturated} saturated pixels; {contrib} "
          f"contributing pairs, {observed} of them observed (D > 0.5)")
    print(f"[kernels pgsr] blend_pgsr_fwd max|err| "
          f"{max_err(out_k, out_p):.3e}  {fwd_ms:.4f} ms"
          + ("; bitwise equal to the parent's" if parent else ""))
    print(f"[kernels pgsr] blend_pgsr_obs exact, and on observe_cases' "
          f"stacks (D exactly 0.5, the 0.5 point at either side of a chunk "
          f"boundary, a warp done beside walking ones, a tile that never "
          f"reaches 0.5)  {obs_line}")
    print(f"[kernels pgsr] blend_pgsr_bwd max|err| {max_err(d_k, d_p):.3e}  "
          f"{bwd_ms:.4f} ms  v1 max|err| {max_err(d_v1, d_p):.3e}  "
          f"{v1_ms:.4f} ms  deterministic: yes; bitwise equal to v1: yes; "
          f"observe row = observe kernel, per slot and per gaussian")


# ---------------------------------------------------------------------------
# 3. the main path: train 3dgs through the CLI's entry point
# ---------------------------------------------------------------------------

def ring_cameras(width, height, n=N_CAMS, radius=4.0):
    """Cameras on a ring around the origin, looking at it."""
    cams = []
    for i in range(n):
        ang = 2 * math.pi * i / n
        pos = np.array([radius * math.sin(ang), 0.3 * math.cos(3 * ang),
                        -radius * math.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, -1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R_w2c = np.stack([right, np.cross(fwd, right), fwd])
        cams.append(camera(width, height, R=R_w2c.T, T=-R_w2c @ pos, uid=i,
                           name=f"cam{i:03d}"))
    return cams


def frustum_points(cam, pts):
    """The indices of the points that project inside the camera's image
    in front of it, and their pixel positions [n, 2]."""
    from gssr_tpu_torch.cameras import ZNEAR
    p = pts @ cam.w2c[:3, :3].T + cam.w2c[:3, 3]
    z = np.where(p[:, 2] > ZNEAR, p[:, 2], 1.0)
    xy = np.stack([cam.fx * p[:, 0] / z + cam.cx,
                   cam.fy * p[:, 1] / z + cam.cy], 1)
    seen = np.flatnonzero((p[:, 2] > ZNEAR) & (xy[:, 0] >= 0)
                          & (xy[:, 0] < cam.width) & (xy[:, 1] >= 0)
                          & (xy[:, 1] < cam.height))
    return seen, xy[seen]


@torch.no_grad()
def write_scene(root, dev, seed=0):
    """A COLMAP scene written by the port's dataio/colmap.py: ring
    cameras, N_POINTS random initial points, and GT frames that the port
    renders from a separate random gaussian set. Each image observes the
    initial points inside its frustum (its point3D_ids, and the points'
    tracks to match): the covisibility from which PGSR picks each camera's
    neighbours."""
    from PIL import Image

    from gssr_tpu_torch.dataio import colmap
    from gssr_tpu_torch.ops.rasterize import rasterize
    rng = np.random.default_rng(seed)
    cams = ring_cameras(WIDTH, HEIGHT)
    n = N_GT_GAUSSIANS
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    gt = dict(means=f32(rng.uniform(-1, 1, (n, 3))),
              scales=f32(np.exp(rng.uniform(np.log(0.01), np.log(0.05),
                                            (n, 3)))),
              rots=f32(rng.normal(size=(n, 4))),
              opacity=f32(rng.uniform(0.3, 0.9, n)),
              colors=f32(rng.uniform(0, 1, (n, 3))))
    os.makedirs(os.path.join(root, "images"))
    for c in cams:
        img = rasterize(gt["means"], gt["scales"], gt["rots"], gt["opacity"],
                        c.arrays(dev), WIDTH, HEIGHT,
                        torch.zeros(3, device=dev),
                        colors_precomp=gt["colors"]).image
        img8 = (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(img8).save(os.path.join(root, "images",
                                                f"{c.image_name}.png"))
    pts = rng.uniform(-1, 1, (N_POINTS, 3))
    rgb = rng.integers(0, 256, (N_POINTS, 3)).astype(np.uint8)
    images, track = {}, []      # track: (point, image id, its 2-D index)
    for i, c in enumerate(cams):
        seen, xy = frustum_points(c, pts)
        images[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat_to_qvec(c.R.T), c.T, 1,
            f"{c.image_name}.png", xy, seen + 1)
        track.append(np.stack([seen, np.full_like(seen, i + 1),
                               np.arange(len(seen))], 1))
    track = np.concatenate(track)
    track = track[np.argsort(track[:, 0], kind="stable")].astype(np.int32)
    ends = np.searchsorted(track[:, 0], np.arange(N_POINTS + 1))
    points = {i + 1: colmap.ColmapPoint3D(
        i + 1, pts[i], rgb[i], 0.1, track[ends[i]:ends[i + 1], 1],
        track[ends[i]:ends[i + 1], 2]) for i in range(N_POINTS)}
    c0 = cams[0]
    intr = {1: colmap.ColmapCamera(1, "PINHOLE", WIDTH, HEIGHT, np.array(
        [c0.fx, c0.fy, WIDTH / 2, HEIGHT / 2]))}
    colmap.write_model(intr, images, points, os.path.join(root, "sparse/0"))


def kernel_counts():
    """Every kernel wrapper's launch count dict."""
    from gssr_tpu_torch.ops import blend, blend2d, blend_pgsr
    return (blend.LAUNCHES, blend2d.LAUNCHES, blend_pgsr.LAUNCHES)


def reset_counts():
    for counts in kernel_counts():
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    return {k: n for counts in kernel_counts() for k, n in counts.items()}


def step_line(step_ms) -> str:
    """Median step, the highest percentile with ten samples above it (the
    largest step where that would lie below the median), and Mpix/s of a
    list of step times."""
    step_ms = sorted(step_ms)
    med = statistics.median(step_ms)
    tail_n = len(step_ms) - 10
    tail = (f"p{100 * tail_n / len(step_ms):.0f} {step_ms[tail_n - 1]:.2f}"
            if tail_n > len(step_ms) // 2 else f"max {step_ms[-1]:.2f}")
    return (f"median step {med:.2f} ms, {tail} ms (n={len(step_ms)}), "
            f"{WIDTH * HEIGHT / med / 1e3:.2f} Mpix/s")


def assert_ring_neighbours(cameras):
    """PGSR's view selection gives each ring camera its two ring
    neighbours first, and never the camera itself. near_ids index the
    (shuffled) camera list; the ring position is in the image name."""
    n = len(cameras)
    ring = [int(c.image_name[len("cam"):]) for c in cameras]
    for i, c in enumerate(cameras):
        assert i not in c.near_ids, (c.image_name, c.near_ids)
        assert {ring[k] for k in c.near_ids[:2]} == \
            {(ring[i] - 1) % n, (ring[i] + 1) % n}, (c.image_name, c.near_ids)


def phase_train(dev, root, card_line, method):
    """Train `method` through its CLI entry point on the scene under root;
    returns the trainer and the launch counts of that run alone."""
    from gssr_tpu_torch import train
    from gssr_tpu_torch.configs.cli import parse_config
    config = parse_config([
        method, "--source-path", os.path.join(root, "scene"),
        "--output-path", os.path.join(root, "out"),
        "--trainer.iterations", str(STEPS),
        "--trainer.test-iterations", str(STEPS),
        "--trainer.save-iterations", str(STEPS),
        "--trainer.log-interval", "1",
        "--scene.gaussians.densify-from-iter", "10",
        "--scene.gaussians.densification-interval", "10",
        *METHOD_ARGS[method]])
    # the earlier paths' models stay on the card: a path's own peak is the
    # peak above what was allocated when it started
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    trainer = train.main(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    scene, state = trainer.scene, trainer.scene.state
    hist = trainer.history
    assert len(hist) == STEPS, len(hist)
    # the image terms, which every step has: pgsr's total loss gains its
    # multi-view terms after MULTI_VIEW_FROM
    losses = [h[4]["L1_loss"] + h[4]["ssim_loss"] for h in hist]
    assert all(math.isfinite(h[1]) for h in hist), [h[1] for h in hist]
    # the sampler draws every camera once per epoch of N_CAMS steps:
    # compare whole epochs, first against last
    first = statistics.mean(losses[:N_CAMS])
    last_epoch = STEPS // N_CAMS * N_CAMS
    last = statistics.mean(losses[last_epoch - N_CAMS:last_epoch])
    assert last < first, (first, last)
    tag = f"[train {method}]"
    saved = config.get_gaussian_dir() / f"iteration_{STEPS}"
    files = ["point_cloud.ply"]
    if method in ANCHOR_METHODS:
        files += ["point_cloud_mlp.npz", "checkpoints.pth"]
        n0 = anchor_lines(tag, scene, hist)
    else:
        assert scene.gaussians.active_sh_degree(STEPS) == 3
        n0 = min(N_POINTS, state.active.shape[0])
    assert int(state.n_active) != n0, "densify changed nothing"
    for f in files:
        assert (saved / f).stat().st_size > 0, saved / f
    renders = STEPS
    # step time: from one log point to the next, so from step 3 on
    step_ms = {b[0]: 1e3 * (b[3] - a[3]) for a, b in zip(hist[1:], hist[2:])}
    if method in MULTI_VIEW_METHODS:
        assert_ring_neighbours(scene.dataloader.train_cameras)
        multi = [h[4] for h in hist if h[0] > MULTI_VIEW_FROM]
        assert all("geo_loss" not in h[4] for h in hist
                   if h[0] <= MULTI_VIEW_FROM)
        assert all(t["geo_loss"] > 0 and t["ncc_loss"] > 0 for t in multi), \
            multi
        renders += len(multi)       # the neighbour's render
        print(f"{tag} single-view steps 3-{MULTI_VIEW_FROM}: " + step_line(
            [v for s, v in step_ms.items() if s <= MULTI_VIEW_FROM]))
        print(f"{tag} multi-view steps {MULTI_VIEW_FROM + 1}-{STEPS}: "
              + step_line([v for s, v in step_ms.items()
                           if s > MULTI_VIEW_FROM]))
        print(f"{tag} step {STEPS} terms "
              f"{ {k: round(v, 6) for k, v in hist[-1][4].items()} }")
    for k in PATH_KERNELS[method]:
        assert launches[k] >= renders, \
            f"{k} launched {launches[k]} times in {renders} train renders"
    # no render reads an observe count, and none runs a yardstick kernel
    assert all(launches[k] == 0 for k in V1_KERNELS + ("blend_pgsr_obs",)), \
        launches
    psnr = trainer.evals[STEPS]["eval_psnr"]
    print(f"{tag} {STEPS} steps in {wall:.1f} s (eval and save included); "
          f"L1 + D-SSIM loss epoch 1 {first:.5f} -> epoch "
          f"{last_epoch // N_CAMS} {last:.5f}")
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} n_active {n0} -> {int(state.n_active)} of capacity "
          f"{state.active.shape[0]}; launches {launches}; peak memory "
          f"{peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} GiB above "
          f"the earlier paths' {held / 2**30:.2f} GiB")
    print(f"{tag} {step_line(step_ms.values())}, num_rendered {hist[-1][2]}, "
          f"eval PSNR {psnr:.3f} dB  | {card_line}", flush=True)
    return trainer, launches


def anchor_lines(tag, scene, hist) -> int:
    """An anchor path's own checks and prints: a scaling loss above 0 at
    every step, the anchors grown and pruned at each adjust_anchor (for
    the octree paths also the active anchors of each level, at init and
    after each pass), and the visible anchors and decoded neural gaussians
    per train render; on an octree path the LOD mask must drop an active
    anchor on some render, and its share is printed. Returns the anchor
    count before the first adjust_anchor."""
    assert all(h[4]["scaling_loss"] > 0 for h in hist)
    log = scene.anchor_log
    assert [e[0] for e in log] == [20, 30], log
    octree = hasattr(scene, "init_level_counts")
    if octree:
        print(f"{tag} active anchors by level at init: "
              f"{scene.init_level_counts}")
    for step, grown, pruned, n_after, *levels in log:
        print(f"{tag} adjust_anchor after step {step}: {grown} anchors "
              f"grown, {pruned} pruned, {n_after} active"
              + (f"; by level {levels[0]}" if levels else ""))
    _, grown, pruned, n_after = log[0][:4]
    n0 = n_after - grown + pruned
    # the offsets' mean screen gradients since the last pass (steps 31-32),
    # against the threshold of the first growing level
    st = scene.state.stats
    seen = st["offset_denom"] > 0
    grads = (st["offset_grad_accum"][seen] / st["offset_denom"][seen]).float()
    q = torch.quantile(grads[:1 << 24].cpu(),
                       torch.tensor([0.5, 0.99, 0.999])).tolist()
    print(f"{tag} offsets' mean screen gradient over steps 31-32: median "
          f"{q[0]:.3g}, p99 {q[1]:.3g}, p99.9 {q[2]:.3g}, max "
          f"{float(grads.max()):.3g} (threshold "
          f"{scene.config.gaussians.densify_grad_threshold:.3g})")
    vis = sorted(h[4]["n_visible"] for h in hist)
    neural = sorted(h[4]["n_neural"] for h in hist)
    print(f"{tag} per train render: visible anchors median "
          f"{statistics.median(vis):.0f} ({vis[0]:.0f}-{vis[-1]:.0f}), "
          f"rendered neural gaussians median {statistics.median(neural):.0f} "
          f"({neural[0]:.0f}-{neural[-1]:.0f}) of "
          f"{scene.config.gaussians.n_offsets} per visible anchor")
    if octree:
        # the active anchors at each step: n0 until the first pass
        def active_at(step):
            return ([n0] + [e[3] for e in log if e[0] < step])[-1]
        share = sorted(100 * h[4]["n_lod_dropped"] / active_at(h[0])
                       for h in hist)
        assert share[-1] > 0, "the LOD mask dropped no active anchor"
        print(f"{tag} the LOD mask drops median {statistics.median(share):.2f}"
              f" % ({share[0]:.2f}-{share[-1]:.2f} %) of the active anchors "
              f"per train render")
    return n0


def phase_mesh(trainer, card_line):
    """`python -m gssr_tpu_torch.extract_mesh` on a run, in process, with
    each of its MESH_METHODS options: bounded at a grid of about 256^3,
    unbounded at 128^3. Each renders every camera once through the path's
    forward kernel, and no render launches the observe kernel."""
    from gssr_tpu_torch import extract_mesh
    from gssr_tpu_torch.utils.mesh_extract import read_mesh_ply
    method = trainer.config.method_name
    cfg = str(trainer.config.get_base_dir() / "config.yml")
    runs = {}
    for name, extra in MESH_RUNS:
        if name not in MESH_METHODS[method]:
            continue
        reset_counts()
        t0 = time.perf_counter()
        res = extract_mesh.main(["--load-config", cfg, "--skip-images",
                                 *extra])
        wall = time.perf_counter() - t0
        launches = read_counts()
        assert launches[PATH_KERNELS[method][0]] >= N_CAMS, launches
        # nothing reads a mesh render's observe counts
        assert launches["blend_pgsr_obs"] == 0, launches
        verts, faces = read_mesh_ply(str(res["mesh_path"]))
        assert len(verts) > 0 and len(faces) > 0, (name, len(verts))
        assert np.isfinite(verts).all()
        sec = res["seconds"]
        print(f"[mesh {method} {name}] {len(verts)} verts, {len(faces)} "
              f"faces in "
              f"{wall:.1f} s: render {sec['render']:.2f} s, fusion "
              f"{sec['fusion']:.2f} s, marching tetrahedra "
              f"{sec['mtet']:.2f} s; launches {launches}  | {card_line}",
              flush=True)
        runs[name] = launches
    if method == "pgsr":
        observe_saving(trainer, card_line)
    return runs


@torch.no_grad()
def observe_saving(trainer, card_line):
    """The eval and mesh renders of the pgsr run (every training camera,
    eval_render's arguments) with the observe kernel, as before it was
    dropped from them, and without, as now: in turns (with, without,
    without, with), three reps of all cameras each."""
    scene, state = trainer.scene, trainer.scene.state
    dev = state.active.device
    cams = [c.arrays(dev) for c in scene.dataloader.train_cameras]
    degree = scene.gaussians.active_sh_degree(10 ** 9)

    def renders(observe):
        for cam in cams:
            scene.render_params(state.params, cam, degree, state.active,
                                scene.background, forward_observe=observe)

    with_ms, without_ms = turns_ms(partial(renders, True),
                                   partial(renders, False), reps=3)
    print(f"[mesh pgsr] {len(cams)} eval/mesh renders: {with_ms:.2f} ms with "
          f"the observe kernel, {without_ms:.2f} ms without  | {card_line}")


# ---------------------------------------------------------------------------
# split: VastGaussian partitioned training and merged meshing
# ---------------------------------------------------------------------------

def split_args(split, runs):
    """train_split's arguments: the octree-2dgs path's own, on the tiles."""
    return [SPLIT_METHOD, "--source-path", split, "--output-path", runs,
            "--trainer.iterations", str(STEPS),
            "--trainer.test-iterations", str(STEPS),
            "--trainer.save-iterations", str(STEPS),
            "--trainer.log-interval", "1",
            "--scene.gaussians.densify-from-iter", "10",
            "--scene.gaussians.densification-interval", "10",
            *METHOD_ARGS[SPLIT_METHOD]]


def phase_split(root, video_run, card_line):
    """The partitioned pipeline through its entry points, in process:
    split_scene into 2 tiles in the ground-plane frame, train_split of
    octree-2dgs on each (a profiler window on tile 0), train_split again
    (it must skip both), extract_mesh_split's merged 257^3 mesh, and a
    30-frame fly-through of the 2dgs run `video_run`."""
    from gssr_tpu_torch import (
        extract_mesh,
        extract_mesh_split,
        split_scene,
        train,
        train_split,
    )
    from gssr_tpu_torch.dataio import colmap
    from gssr_tpu_torch.utils.mesh_extract import read_mesh_ply
    tag = "[split]"
    split = os.path.join(root, "split")
    runs = os.path.join(root, "split_runs")
    prof = os.path.join(root, "prof")

    t0 = time.perf_counter()
    tiles = split_scene.main(["--source-path", os.path.join(root, "scene"),
                              "--output-path", split, "--num-col", "2",
                              "--num-row", "1", "--auto-align"])
    split_s = time.perf_counter() - t0
    assert len(tiles) == 2, tiles
    for t in tiles:
        sparse = os.path.join(t, "sparse/0")
        images = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        n_points = int(np.fromfile(os.path.join(sparse, "points3D.bin"),
                                   np.uint64, 1)[0])
        assert images and os.path.exists(os.path.join(t, "box.txt")), t
        with open(os.path.join(t, "box.txt")) as f:
            box = f.read().splitlines()[1]
        print(f"{tag} {os.path.basename(t)}: {len(images)} cameras, "
              f"{n_points} points, box (mx Mx my My) {box}")
    print(f"{tag} split_scene --auto-align: {len(tiles)} tiles in "
          f"{split_s:.2f} s (host)")

    # each tile through train.main, measured; the trainer is dropped when
    # it returns, and must be gone (its memory freed) before the next tile
    held = torch.cuda.memory_allocated()
    done = []

    def train_tile(config):
        name = os.path.basename(config.source_path)
        if not done:
            config.trainer.profile_dir = prof
            config.trainer.profile_steps = [10, 12]
        else:
            assert done[-1]() is None, "the previous tile's trainer lives on"
        start = torch.cuda.memory_allocated()
        assert start - held < 256 * 2**20, (start, held)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t1 = time.perf_counter()
        trainer = train.main(config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = read_counts()
        hist = trainer.history
        assert len(hist) == STEPS and all(math.isfinite(h[1]) for h in hist)
        for k in SURFEL_PAIR:
            assert launches[k] >= STEPS, launches
        assert all(launches[k] == 0 for k in V1_KERNELS + ("blend_pgsr_obs",))
        log = trainer.scene.anchor_log
        step_ms = [1e3 * (b[3] - a[3]) for a, b in zip(hist[1:], hist[2:])]
        peak = torch.cuda.max_memory_allocated()
        print(f"{tag} {name}: {len(trainer.scene.dataloader.train_cameras)} "
              f"cameras, {STEPS} steps in {wall:.1f} s, {step_line(step_ms)};"
              f" anchors grown {[e[1] for e in log]} at steps "
              f"{[e[0] for e in log]}, {int(trainer.scene.state.n_active)} "
              f"active; eval PSNR {trainer.evals[STEPS]['eval_psnr']:.3f} dB;"
              f" peak memory {(peak - start) / 2**30:.2f} GiB above the "
              f"{start / 2**30:.2f} GiB held at its start; launches "
              f"{launches}  | {card_line}", flush=True)
        done.append(weakref.ref(trainer))

    args = split_args(split, runs)
    trained, skipped = train_split.main(args, train_tile=train_tile)
    assert len(trained) == 2 and not skipped
    traces = os.listdir(prof)
    assert traces, "no profiler trace"
    print(f"{tag} profiler window (tile_0000 steps 10-12): "
          f"{[(t, os.path.getsize(os.path.join(prof, t))) for t in traces]}")
    again = io.StringIO()
    with contextlib.redirect_stdout(again):
        # both tiles are done: a tile trained here would call None
        train_split.main(args, train_tile=None)
    print(again.getvalue(), end="")
    assert "trained 0 tiles (skipped 2 done) on host 0/1" in \
        again.getvalue(), again.getvalue()

    reset_counts()
    t0 = time.perf_counter()
    res = extract_mesh_split.main([
        "--source-path", split, "--runs-root", runs, "--method", SPLIT_METHOD,
        "--depth-trunc", "6", "--voxel-size", "0.0234", "--sdf-trunc",
        "0.08", "--num-cluster", "0"])
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_in_box = sum(len(v) for v in res["in_box"].values())
    assert launches["blend2d_fwd"] >= n_in_box and \
        launches["blend_pgsr_obs"] == 0, launches
    rendered = {n for names in res["in_box"].values() for n in names}
    assert rendered == {f"cam{i:03d}" for i in range(N_CAMS)}, res["in_box"]
    assert tuple(res["volume"].tsdf.shape) == (257,) * 3
    verts, faces = read_mesh_ply(res["mesh_path"])
    assert len(verts) > 0 and len(faces) > 0 and np.isfinite(verts).all()
    sec = res["seconds"]
    print(f"{tag} merged mesh: {len(verts)} verts, {len(faces)} faces on a "
          f"257^3 grid in {wall:.1f} s: render {sec['render']:.2f} s, fusion "
          f"{sec['fusion']:.2f} s, marching tetrahedra {sec['mtet']:.2f} s; "
          f"in-box cameras {res['in_box']}; launches {launches}  | "
          f"{card_line}", flush=True)
    del res

    reset_counts()
    cfg = str(video_run.config.get_base_dir() / "config.yml")
    res = extract_mesh.main(["--load-config", cfg, "--render-video",
                             "--video-frames", str(VIDEO_FRAMES),
                             "--skip-mesh"])
    launches = read_counts()
    assert launches["blend2d_fwd"] >= N_CAMS + VIDEO_FRAMES, launches
    video = res["video"]
    if video.endswith(".mp4"):
        import cv2
        n = int(cv2.VideoCapture(video).get(cv2.CAP_PROP_FRAME_COUNT))
    else:
        n = len([f for f in os.listdir(video) if f.endswith(".png")])
    assert n == VIDEO_FRAMES, (video, n)
    frame_ms = 1e3 * res["seconds"]["video"] / n
    print(f"{tag} fly-through of the 2dgs run: {n} frames into "
          f"{os.path.basename(video)}, {frame_ms:.2f} ms a frame; launches "
          f"{launches}  | {card_line}", flush=True)


def phase_profile(trainer, path, card_line):
    """Three more train steps under torch.profiler: kernel time by name
    and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile
    scene = trainer.scene
    state = scene.state
    step0 = trainer.config.trainer.iterations
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            state, m = scene.train_step(state, scene.dataloader.next_train(),
                                        step0 + 1 + i)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    avgs = prof.key_averages()

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else e.self_cuda_time_total

    # kernels only: an operator's row repeats the time of its kernels, and
    # a profiler range's device row spans the kernels it ran
    kernels = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("scaffold.")]
    busy = sum(dev_us(e) for e in kernels)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{card_line}\n3 train steps, wall {wall_us / 1e3:.3f} ms, "
                f"device busy {busy / 1e3:.3f} ms\n")
        f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    tag = f"[profile {trainer.config.method_name}]"
    print(f"{tag} 3 steps: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f} %)  | "
          f"{card_line}")
    for e in top:
        print(f"{tag} {dev_us(e) / 3e3:9.3f} ms/step  {e.count // 3:5d} "
              f"calls/step  {e.key[:90]}")
    # the step's stages where the scene marks them (scene/scaffold.py):
    # each range has a host row (host time inside it, the device time of
    # the kernels it launched) and a device row (its span on the device)
    stages = {}
    for e in avgs:
        if e.key.startswith("scaffold."):
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            st = stages.setdefault(e.key, {"host": 0.0, "kernels": 0.0,
                                           "span": 0.0})
            if e.cpu_time_total > 0:
                st.update(host=e.cpu_time_total, kernels=total)
            else:
                st["span"] = total
    for key, st in stages.items():
        print(f"{tag} stage {key:26s} host {st['host'] / 3e3:8.3f} ms/step, "
              f"its kernels {st['kernels'] / 3e3:8.3f} ms/step, device span "
              f"{st['span'] / 3e3:8.3f} ms/step")


# ---------------------------------------------------------------------------
# 4. the kernels at the main paths' own inputs
# ---------------------------------------------------------------------------

def bound(ops, nbytes):
    """The least time the card could take: operations at the FP32 peak or
    bytes at the memory rate, whichever is longer. (ms, what bounds it)"""
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


@torch.no_grad()
def cull_counts(attrs, ranges, tiles_x, tiles_y, alpha, pair_cull,
                warp_cull=None, walks=None):
    """What a forward's cull skips on these inputs, from its plain version
    (alpha, pair_cull and warp_cull map a chunk and the pixel centres to
    [T, PIX, CHUNK] alpha and culled pairs, and [T, WARPS, CHUNK] culled
    warp steps). A pixel evaluates an instance while walks(D) holds for
    the transmittance D before it (default D >= T_EPS, the blends' stop;
    the observe count walks while D > 0.5). Returns a namespace: pairs, the
    evaluated pairs (for the default, as the pair counts count them);
    culled, those the per-pair test proves zero; steps, the (warp,
    instance) steps in which some lane of a warp's 8 x 4 pixel block
    evaluates the pair; whole, those the warp skips whole (where warp_cull
    says so, or without it where every such lane's pair is culled);
    in_whole, the pairs inside them; proof, the culled pairs inside the
    other steps; slots, the instance slots of the chunks in which some
    pixel of their tile evaluates a pair. A lane's skip saves issue slots
    only in a whole step."""
    from types import SimpleNamespace

    from gssr_tpu_torch.ops.blend import (
        CHUNK,
        T_EPS,
        _chunks,
        _pixel_coords,
        _walk,
        warp_blocks,
    )
    from gssr_tpu_torch.ops.blend2d import _tile_batches
    if walks is None:
        walks = lambda d: d >= T_EPS                    # noqa: E731
    px, py = _pixel_coords(tiles_x, tiles_y, attrs.device)
    c = SimpleNamespace(pairs=0, culled=0, steps=0, whole=0, in_whole=0,
                        proof=0, slots=0)
    for t0, t1 in _tile_batches(tiles_x * tiles_y):
        x, y = px[t0:t1], py[t0:t1]
        D = torch.ones_like(x)
        for A, _, live in _chunks(attrs, ranges[t0:t1 + 1]):
            _, d_before, _, _, D = _walk(alpha(A, x, y), D)
            walked = walks(d_before) & live[:, None, None]
            culled = walked & pair_cull(A, x, y)
            lanes = warp_blocks(walked)
            step = lanes.any(2)
            skip = (warp_cull(A, x, y) if warp_cull is not None
                    else ~warp_blocks(walked & ~culled).any(2))
            whole = (step & skip)[:, :, None, :]
            c.pairs += int(walked.sum())
            c.culled += int(culled.sum())
            c.steps += int(step.sum())
            c.whole += int(whole.sum())
            c.in_whole += int((lanes & whole).sum())
            c.proof += int((warp_blocks(culled) & ~whole).sum())
            c.slots += CHUNK * int(walked.any(2).any(1).sum())
    return c


def surfel_cull_counts(attrs, ranges, tiles_x, tiles_y):
    """cull_counts of the surfel forward's cull."""
    from gssr_tpu_torch.ops import blend2d as B
    return cull_counts(attrs[:B.LIVE_ATTRS2], ranges, tiles_x, tiles_y,
                       lambda A, x, y: B._surfel_alpha(A, x, y).a,
                       B.surfel_cull_plain)


def gauss_cull_counts(attrs, ranges, tiles_x, tiles_y, walks=None):
    """cull_counts of the vanilla and planar forwards' cull, whose warps
    walk only the instances warp_cull_plain leaves in (alpha_cull_plain,
    the per-pair proof under it, no kernel runs); rows 0-5, which the two
    layouts share. The observe count's walk passes walks=D > 0.5."""
    from gssr_tpu_torch.ops import blend as B
    return cull_counts(attrs[:B.ATTR_R], ranges, tiles_x, tiles_y,
                       lambda A, x, y: B._chunk_alpha(A, x, y)[0],
                       B.alpha_cull_plain, B.warp_cull_plain, walks)


def gauss_pair_ops(per_pair, c):
    """The operations a vanilla or planar kernel needs at least for the
    evaluated pairs of cull counts c: a (warp, instance) step that the warp
    test skips whole costs that test once, for all of its pairs; a pair of
    a walked step that the per-pair proof covers costs the proof; every
    other pair costs per_pair."""
    return (per_pair * (c.pairs - c.in_whole - c.proof)
            + GAUSS_OPS_PER_CULLED * c.proof
            + GAUSS_OPS_PER_BLOCK_TEST * c.whole)


def print_cull_shares(tag, c):
    print(f"{tag} forward's cull (its plain version): the per-pair test "
          f"proves {c.culled} of {c.pairs} evaluated pairs zero "
          f"({100 * c.culled / c.pairs:.2f} %); an 8 x 4 warp skips "
          f"{c.whole} of {c.steps} (warp, instance) steps whole "
          f"({100 * c.whole / c.steps:.2f} %), which hold {c.in_whole} pairs "
          f"({100 * c.in_whole / c.pairs:.2f} %); the walked steps hold "
          f"{c.proof} proved pairs")


def report_row(name, source, replaces, launches, err, fn, plain_ms, ops,
               nbytes, v1=None, parent=None):
    """The kernel's row of the {"kernels": [...]} line; plain_ms is the
    plain version's time (timed). With its v1 kernel `v1`, or the parent
    commit's kernel `parent`, the two are timed in turns (v1, new, new,
    v1) and the row gains "v1_ms" or "parent_ms"."""
    bound_ms, bound_by = bound(ops, nbytes)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err}
    base = v1 if v1 is not None else parent
    if base is None:
        row["ms"] = median_ms(fn, 20)
    else:
        base_ms, row["ms"] = turns_ms(base, fn)
        row["v1_ms" if v1 is not None else "parent_ms"] = base_ms
    row.update(plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=None)
    return row


def assert_live_rows(d_plain, live):
    """Every live row must carry gradients well above the tolerance, so
    that a zeroed or misplaced row cannot pass the comparison."""
    row_max = d_plain[:live].abs().amax(dim=1)
    assert bool((row_max > 100 * BWD_TOL["atol"]).all()), row_max.tolist()


def assert_rows_close(d_k, d_p, rows):
    """Each of these gradient rows against its plain version in units of
    the row's largest plain value (the absolute tolerance taken relative
    to it, the relative one as it is), so that a zeroed or swapped row
    fails however small its gradients are. The surfel rows of CA are:
    dL/dCA carries 1/pz, and pz grows with the square of the image size."""
    rows = list(rows)
    scale = d_p[rows].abs().amax(dim=1, keepdim=True)
    assert bool((scale > 0).all()), scale.flatten().tolist()
    torch.testing.assert_close(d_k[rows] / scale, d_p[rows] / scale,
                               **BWD_TOL)


def assert_zero_rows(d_k, live):
    """The rows past the live ones are never written."""
    assert torch.equal(d_k[live:], torch.zeros_like(d_k[live:]))


def assert_backward_pair(d_k, d_v1, d_p, rows, live, again, again_v1):
    """A redesigned backward kernel's result d_k and its v1 kernel's d_v1,
    each against the plain version's d_p as a whole and row by row (the
    gradient rows `rows`), rows from `live` on zero, and bit for bit on a
    second run (again, again_v1); then against each other, bit for bit."""
    for d, rerun in ((d_k, again), (d_v1, again_v1)):
        torch.testing.assert_close(d, d_p, **BWD_TOL)
        assert_rows_close(d, d_p, rows)
        assert_zero_rows(d, live)
        assert torch.equal(d, rerun()), "a backward is not deterministic"
    assert torch.equal(d_k, d_v1), "a backward differs from its v1 kernel"


def assert_forward_pair(out_k, out_v1, out_p, sel):
    """A redesigned forward kernel's maps out_k and its v1 kernel's out_v1:
    each against the plain version's out_p, the median's sorted position
    (channel `sel`) exactly, and each other bit for bit on every channel."""
    for out in (out_k, out_v1):
        torch.testing.assert_close(out, out_p, **FWD_TOL)
        assert torch.equal(out[..., sel], out_p[..., sel])
    assert torch.equal(out_k, out_v1), "a forward differs from its v1 kernel"


def phase_report(trainer, launches, dev, parent=None):
    """The vanilla pair at the 3dgs path's own inputs (the trained model,
    camera 0): its rows of the {"kernels": [...]} line."""
    from gssr_tpu_torch.ops.sh import sh_to_color
    scene, state = trainer.scene, trainer.scene.state
    g, p = scene.gaussians, state.params
    cam_h = scene.dataloader.train_cameras[0]
    cam = cam_h.arrays(dev)
    with torch.no_grad():
        color = sh_to_color(3, g.get_features(p), p["xyz"], cam.campos)
        inputs = blend_inputs(
            p["xyz"], g.get_scaling(p), g.get_rotation(p),
            g.get_opacity(p)[:, 0], color, cam, scene.width, scene.height,
            active=state.active)
    return vanilla_pair("[report 3dgs]", scene, cam_h, cam, inputs,
                        launches, parent)


@torch.no_grad()
def decoded_camera0(scene, state, dev, camera_index=0):
    """The neural gaussians that an anchor path's trained anchors and MLP
    decode for one of its cameras (its train render's visible anchors and
    level gate): (host camera, its CameraArrays, the NeuralGaussians, the
    visible mask)."""
    cam_h = scene.dataloader.train_cameras[camera_index]
    cam = cam_h.arrays(dev)
    visible, gate, _ = scene.visible_anchors(state, cam, STEPS)
    ng = scene.gaussians.decode(state.anchors, state.mlp, cam.campos,
                                cam_h.uid, visible, state.active,
                                level_scale_gate=gate)
    return cam_h, cam, ng, visible


def print_rows(tag, rows, card_line):
    """Report rows printed apart: the {"kernels": [...]} line keeps one row
    per kernel, at its own path's inputs."""
    for row in rows:
        base = row.get("v1_ms", row.get("parent_ms"))
        print(f"{tag} {row['name']}: max|err| {row['max_abs_err']:.3e}, "
              f"{row['ms']:.4f} ms"
              + (f" (v1 {base:.4f} ms)" if base is not None else "")
              + f", bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"plain {row['plain_ms']:.1f} ms, {row['launches']} launches "
              f"on the path  | {card_line}", flush=True)


def phase_report_scaffold(trainer, launches, dev, card_line):
    """The vanilla pair at the scaffold-gs path's own inputs: the neural
    gaussians that the trained anchors and MLP decode for camera 0. Its
    numbers are printed here; the {"kernels": [...]} line keeps the 3dgs
    path's rows of the same two kernels."""
    scene, state = trainer.scene, trainer.scene.state
    cam_h, cam, ng, visible = decoded_camera0(scene, state, dev)
    with torch.no_grad():
        inputs = blend_inputs(ng.xyz, ng.scaling, ng.rotation, ng.opacity,
                              ng.color, cam, scene.width, scene.height,
                              active=ng.mask)
    tag = "[report scaffold-gs]"
    print(f"{tag} camera 0: {int(visible.sum())} visible anchors of "
          f"{int(state.n_active)}, {int(ng.mask.sum())} of "
          f"{ng.mask.shape[0]} neural gaussians with opacity > 0")
    print_rows(tag, vanilla_pair(tag, scene, cam_h, cam, inputs, launches),
               card_line)


def vanilla_pair(tag, scene, cam_h, cam, inputs, launches, parent=None):
    """The vanilla forward and backward against their plain versions on
    `inputs` (blend_inputs' tuple, from camera cam_h of `scene`), under
    the cotangent of the scene's image loss scaled to unit size; the
    backward also against its v1 kernel, bit for bit, and timed in turns
    with it; with `parent`, the forward against the parent commit's.
    Prints the cull shares; returns the two report rows."""
    from types import SimpleNamespace

    from gssr_tpu_torch.ops import blend as B
    attrs, ranges, tx, ty = inputs
    out_k = B.blend_fwd(attrs, ranges, tx, ty)
    out_p, fwd_plain_ms = timed(lambda: B.blend_fwd_plain(attrs, ranges, tx,
                                                          ty))
    torch.testing.assert_close(out_k, out_p, **FWD_TOL)
    assert_parent_equal(parent, "blend_fwd", out_k, attrs, ranges, tx, ty)
    # the cotangent of the training loss itself, scaled to unit size: the
    # loss is a mean over every pixel channel, so its raw cotangent (~1e-7)
    # would leave every gradient far below the absolute tolerance
    f = out_k.clone().requires_grad_(True)
    image = (f[..., :3] + f[..., 3:4] * scene.background)[:scene.height,
                                                          :scene.width]
    loss = sum(scene.loss_terms(SimpleNamespace(image=image),
                                scene.gt_device(cam_h), STEPS, cam).values())
    (cot,) = torch.autograd.grad(loss, f)
    cot = (cot / cot.abs().max()).contiguous()
    bwd = partial(B.blend_bwd, attrs, ranges, out_k, cot, tx, ty)
    bwd_v1 = partial(B.blend_bwd_v1, attrs, ranges, out_k, cot, tx, ty)
    d_k, d_v1 = bwd(), bwd_v1()
    d_p, bwd_plain_ms = timed(lambda: B.blend_bwd_plain(attrs, ranges, out_k,
                                                        cot, tx, ty))
    assert_live_rows(d_p, B.LIVE_ATTRS)
    assert_backward_pair(d_k, d_v1, d_p, range(B.LIVE_ATTRS), B.LIVE_ATTRS,
                         bwd, bwd_v1)

    pairs, _ = B.blend_pair_count(attrs, ranges, tx, ty)
    cull = gauss_cull_counts(attrs, ranges, tx, ty)
    assert cull.pairs == pairs, (cull.pairs, pairs)
    print_cull_shares(tag, cull)
    n_inst = attrs.shape[1]
    hw = out_k.shape[0] * out_k.shape[1]
    live_bytes = B.LIVE_ATTRS * n_inst * 4 + ranges.numel() * 4
    src = "gssr_tpu_torch/csrc/blend.cu"
    fwd = partial(B.blend_fwd, attrs, ranges, tx, ty)
    rows = [
        report_row("blend_fwd", src, "gssr_tpu/ops/blend_pallas.py:158",
                   launches["blend_fwd"], max_err(out_k, out_p), fwd,
                   fwd_plain_ms, gauss_pair_ops(FWD_OPS_PER_PAIR, cull),
                   live_bytes + hw * 16,
                   parent=parent and partial(parent["blend_fwd"], attrs,
                                             ranges, tx, ty)),
        report_row("blend_bwd", src, "gssr_tpu/ops/blend_pallas.py:265",
                   launches["blend_bwd"], max_err(d_k, d_p), bwd,
                   bwd_plain_ms, gauss_pair_ops(BWD_OPS_PER_PAIR, cull),
                   live_bytes + 2 * hw * 16 + attrs.numel() * 4, v1=bwd_v1)]
    print(f"{tag} blend inputs: {tx * 16}x{ty * 16} padded, "
          f"{n_inst} instance slots, {pairs} (pixel, instance) pairs "
          f"before saturation", flush=True)
    return rows


def phase_report2d(trainer, launches, dev):
    """Both surfel kernels against their plain versions at the 2dgs path's
    own inputs (the trained model, camera 0): their rows of the
    {"kernels": [...]} line."""
    from gssr_tpu_torch.ops.sh import sh_to_color
    scene, state = trainer.scene, trainer.scene.state
    g, p = scene.gaussians, state.params
    cam_h = scene.dataloader.train_cameras[0]
    cam = cam_h.arrays(dev)
    with torch.no_grad():
        color = sh_to_color(3, g.get_features(p), p["xyz"], cam.campos)
        inputs = blend2d_inputs(
            p["xyz"], g.get_scaling(p), g.get_rotation(p),
            g.get_opacity(p)[:, 0], color, cam, scene.width, scene.height,
            active=state.active)
    return surfel_pair("[report 2dgs]", scene, cam_h, cam, inputs, launches)


def phase_report_octree2d(trainer, launches, dev, card_line):
    """Both surfel kernels at the octree-2dgs path's own inputs: the
    neural gaussians that its trained anchors and MLP decode for camera 0
    through its LOD mask, as surfels (their first two scales). Printed
    apart."""
    scene, state = trainer.scene, trainer.scene.state
    cam_h, cam, ng, visible = decoded_camera0(scene, state, dev)
    with torch.no_grad():
        inputs = blend2d_inputs(ng.xyz, ng.scaling[:, :2], ng.rotation,
                                ng.opacity, ng.color, cam, scene.width,
                                scene.height, active=ng.mask)
    tag = "[report octree-2dgs]"
    print(f"{tag} camera 0: {int(visible.sum())} visible anchors of "
          f"{int(state.n_active)}, {int(ng.mask.sum())} of "
          f"{ng.mask.shape[0]} neural gaussians with opacity > 0")
    print_rows(tag, surfel_pair(tag, scene, cam_h, cam, inputs, launches),
               card_line)


def surfel_pair(tag, scene, cam_h, cam, inputs, launches):
    """Both surfel kernels against their plain versions on `inputs`
    (blend2d_inputs' tuple, from camera cam_h of `scene`), under the
    cotangent of the scene's image loss plus the 2DGS regularisers, both
    live (past step 7000, lambda_dist 1000, depth_ratio 0.5), plus a
    random one on median_normal, each channel group scaled to a largest
    entry of 1; the forward and backward also against their v1 kernels,
    bit for bit, and timed in turns with them. Prints the cull shares;
    returns the two report rows."""
    import dataclasses
    from types import SimpleNamespace

    from gssr_tpu_torch.ops import blend2d as B
    from gssr_tpu_torch.ops.rasterize2d import surfel_outputs
    from gssr_tpu_torch.scene.twodgs import surfel_reg_losses
    attrs, ranges, tx, ty = inputs
    fwd = partial(B.blend2d_fwd, attrs, ranges, tx, ty)
    fwd_v1 = partial(B.blend2d_fwd_v1, attrs, ranges, tx, ty)
    out_k = fwd()
    out_p, fwd_plain_ms = timed(lambda: B.blend2d_fwd_plain(attrs, ranges,
                                                            tx, ty))
    assert_forward_pair(out_k, fwd_v1(), out_p, B.O_SELPOS)

    cfg = dataclasses.replace(scene.config, lambda_dist=1000.0,
                              depth_ratio=0.5)
    f = out_k.clone().requires_grad_(True)
    out = SimpleNamespace(**surfel_outputs(
        B.SurfelMaps(f), cam, scene.width, scene.height, scene.background,
        cfg.depth_ratio))
    # the image terms, and the regularisers (the 2dgs scene's loss_terms
    # holds them, the anchor scenes' extra_losses)
    terms = scene.loss_terms(out, scene.gt_device(cam_h), 7001, cam)
    terms.update(surfel_reg_losses(out, cam, 7001, cfg.lambda_normal,
                                   cfg.lambda_dist))
    terms_line = {k: round(float(v.detach()), 6) for k, v in terms.items()}
    assert all(v > 0 for v in terms_line.values()), terms_line
    gen = torch.Generator(device="cpu").manual_seed(3)
    probe = torch.randn(out.median_normal.shape, generator=gen).to(f.device)
    (cot,) = torch.autograd.grad(
        sum(terms.values()) + (out.median_normal * probe).sum(), f)
    cot[..., list(B.NO_GRAD_ROWS)] = 0.0
    for lo, hi in ((B.O_RGB, B.O_RGB + 3), (B.O_NRM, B.O_NRM + 3),
                   (B.O_D, B.O_D + 1), (B.O_DIST, B.O_DIST + 1),
                   (B.O_T, B.O_T + 1), (B.O_MED, B.O_MED + 1),
                   (B.O_MEDNRM, B.O_MEDNRM + 3)):
        peak = cot[..., lo:hi].abs().max()
        assert float(peak) > 0, (lo, hi)
        cot[..., lo:hi] /= peak
    cot = cot.contiguous()
    bwd = partial(B.blend2d_bwd, attrs, ranges, out_k, cot, tx, ty)
    bwd_v1 = partial(B.blend2d_bwd_v1, attrs, ranges, out_k, cot, tx, ty)
    d_k, d_v1 = bwd(), bwd_v1()
    d_p, bwd_plain_ms = timed(lambda: B.blend2d_bwd_plain(
        attrs, ranges, out_k, cot, tx, ty))
    assert_backward_pair(d_k, d_v1, d_p, range(B.LIVE_ATTRS2), B.LIVE_ATTRS2,
                         bwd, bwd_v1)
    # the rows of the low-pass centre and of CA stay far below the others
    # (dL/dCA carries 1/pz), so no one cotangent puts every row above
    # 100 x atol while the largest rows' rounding stays inside atol; the
    # per-row comparison above holds each in units of its own largest value
    row_max = d_p[:B.LIVE_ATTRS2].abs().amax(dim=1)
    print(f"{tag} largest plain gradient per live row: "
          f"{[float(f'{x:.3g}') for x in row_max.tolist()]}; "
          f"{int((row_max > 100 * BWD_TOL['atol']).sum())} of "
          f"{B.LIVE_ATTRS2} rows above 100 x atol; v1 max|err| "
          f"{max_err(d_v1, d_p):.3e}, bitwise equal to v1: yes")

    pairs, contrib = B.blend2d_pair_count(attrs, ranges, tx, ty)
    cull = surfel_cull_counts(attrs, ranges, tx, ty)
    assert cull.pairs == pairs, (cull.pairs, pairs)
    print_cull_shares(f"{tag} surfel", cull)
    # both surfel kernels need the cull's test alone on the culled pairs
    pair_ops = (SURFEL_OPS_PER_PAIR * (pairs - cull.culled)
                + SURFEL_OPS_PER_CULLED * cull.culled)
    n_inst = attrs.shape[1]
    hw = out_k.shape[0] * out_k.shape[1]
    live_bytes = B.LIVE_ATTRS2 * n_inst * 4 + ranges.numel() * 4
    out_bytes = hw * B.OUT2_ROWS * 4
    src = "gssr_tpu_torch/csrc/blend2d.cu"
    rows = [
        report_row("blend2d_fwd", src, "gssr_tpu/ops/blend2d_pallas.py:127",
                   launches["blend2d_fwd"], max_err(out_k, out_p), fwd,
                   fwd_plain_ms, pair_ops + FWD2_OPS_PER_CONTRIB * contrib,
                   live_bytes + out_bytes, v1=fwd_v1),
        report_row("blend2d_bwd", src, "gssr_tpu/ops/blend2d_pallas.py:269",
                   launches["blend2d_bwd"], max_err(d_k, d_p), bwd,
                   bwd_plain_ms, pair_ops + BWD2_OPS_PER_CONTRIB * contrib,
                   live_bytes + 2 * out_bytes + attrs.numel() * 4,
                   v1=bwd_v1)]
    print(f"{tag} surfel blend inputs: {tx * 16}x{ty * 16} padded, "
          f"{n_inst} instance slots, {pairs} (pixel, instance) pairs before "
          f"saturation, {contrib} contributing; loss terms {terms_line}",
          flush=True)
    return rows


def phase_report_pgsr(trainer, launches, dev, parent=None):
    """The three planar kernels at the pgsr path's own inputs (the trained
    model, camera 0, and the neighbour drawn for it): their rows of the
    {"kernels": [...]} line."""
    from gssr_tpu_torch.ops.rasterize_pgsr import planar_geometry
    from gssr_tpu_torch.ops.sh import sh_to_color
    scene, state = trainer.scene, trainer.scene.state
    g, p = scene.gaussians, state.params
    cam_h = scene.dataloader.train_cameras[0]
    cam = cam_h.arrays(dev)
    with torch.no_grad():
        scales, rots = g.get_scaling(p), g.get_rotation(p)
        color = sh_to_color(3, g.get_features(p), p["xyz"], cam.campos)
        normal, distance = planar_geometry(p["xyz"], scales, rots, cam)
        inputs = pgsr_inputs(
            p["xyz"], scales, rots, g.get_opacity(p)[:, 0], color, normal,
            distance, cam, scene.width, scene.height, active=state.active)
        near, near_gray = scene.near_for(cam_h)
        near_cam = near.arrays(dev)
        near_out = scene.render_params(p, near_cam, g.active_sh_degree(STEPS),
                                       state.active, scene.background,
                                       forward_observe=False)
    return planar_kernels("[report pgsr]", scene, cam_h, cam, inputs,
                          (near_out, near_cam, near_gray), launches, parent)


def phase_report_scaffold_pgsr(trainer, launches, dev, card_line):
    """The three planar kernels at the scaffold-pgsr path's own inputs: the
    neural gaussians that its trained anchors and MLP decode for camera 0,
    with the neighbour's render of the same anchors for the multi-view
    loss. Printed apart."""
    from gssr_tpu_torch.ops.rasterize_pgsr import planar_geometry
    scene, state = trainer.scene, trainer.scene.state
    cam_h, cam, ng, visible = decoded_camera0(scene, state, dev)
    with torch.no_grad():
        normal, distance = planar_geometry(ng.xyz, ng.scaling, ng.rotation,
                                           cam)
        inputs = pgsr_inputs(ng.xyz, ng.scaling, ng.rotation, ng.opacity,
                             ng.color, normal, distance, cam, scene.width,
                             scene.height, active=ng.mask)
        near, near_gray = scene.near_for(cam_h)
        near_cam = near.arrays(dev)
        n_visible, n_gate, _ = scene.visible_anchors(state, near_cam, STEPS)
        _, near_out = scene.decode_and_render(
            state.anchors, state.mlp, near_cam, near.uid, n_visible,
            state.active, scene.background, level_scale_gate=n_gate)
    tag = "[report scaffold-pgsr]"
    print(f"{tag} camera 0: {int(visible.sum())} visible anchors of "
          f"{int(state.n_active)}, {int(ng.mask.sum())} of "
          f"{ng.mask.shape[0]} neural gaussians with opacity > 0")
    print_rows(tag, planar_kernels(tag, scene, cam_h, cam, inputs,
                                   (near_out, near_cam, near_gray),
                                   launches), card_line)


def planar_kernels(tag, scene, cam_h, cam, inputs, near, launches,
                   parent=None):
    """The three planar kernels against their plain versions on `inputs`
    (pgsr_inputs' tuple, from camera cam_h of `scene`), under the
    cotangent of the pgsr multi-view loss at the end of training through
    this render (`near`: the neighbour's render, CameraArrays and
    grayscale frame) plus a random one on final_T, each channel group
    scaled to a largest entry of 1. The backward compares as a whole at
    the stated tolerance and row by row in units of each row's largest
    plain value; rows 14-15 (the abs screen gradients) as gradients, row
    13 (the observe count) exactly and equal to the observe kernel's
    counts. Prints the cull shares; returns the three report rows."""
    from types import SimpleNamespace

    from gssr_tpu_torch.ops import blend_pgsr as B
    from gssr_tpu_torch.ops.blend import blend_pair_count
    from gssr_tpu_torch.ops.rasterize_pgsr import planar_outputs
    attrs, b, tx, ty = inputs
    near_out, near_cam, near_gray = near
    ranges = b.tile_ranges
    out_k = B.blend_pgsr_fwd(attrs, ranges, tx, ty)
    out_p, fwd_plain_ms = timed(lambda: B.blend_pgsr_fwd_plain(attrs, ranges,
                                                               tx, ty))
    torch.testing.assert_close(out_k, out_p, **FWD_TOL)
    assert_parent_equal(parent, "blend_pgsr_fwd", out_k, attrs, ranges, tx,
                        ty)
    obs_k = B.blend_pgsr_observe(attrs, ranges, tx, ty)
    obs_p, obs_plain_ms = timed(lambda: B.blend_pgsr_obs_plain(attrs, ranges,
                                                               tx, ty))
    assert torch.equal(obs_k, obs_p)
    assert_parent_equal(parent, "blend_pgsr_obs", obs_k, attrs, ranges, tx,
                        ty)

    step = STEPS
    f = out_k.clone().requires_grad_(True)
    out = SimpleNamespace(**planar_outputs(
        B.PlanarMaps(f), cam, scene.width, scene.height, scene.background))
    gt = scene.gt_device(cam_h)
    terms = scene.loss_terms(out, gt, step, cam)
    terms.update(scene.multi_view_terms(out, near_out, cam, near_cam, gt,
                                        near_gray, step))
    terms_line = {k: round(float(v.detach()), 6) for k, v in terms.items()}
    assert all(v > 0 for v in terms_line.values()), terms_line
    # the loss reaches final_T only through the background, black here: a
    # random probe on it drives the backward's background term
    gen = torch.Generator(device="cpu").manual_seed(5)
    probe = torch.randn(out.final_T.shape, generator=gen).to(f.device)
    (cot,) = torch.autograd.grad(
        sum(terms.values()) + (out.final_T * probe).sum(), f)
    for lo, hi in ((B.PO_RGB, B.PO_RGB + 3), (B.PO_NRM, B.PO_NRM + 3),
                   (B.PO_DIST, B.PO_DIST + 1), (B.PO_T, B.PO_T + 1)):
        peak = cot[..., lo:hi].abs().max()
        assert float(peak) > 0, (lo, hi)
        cot[..., lo:hi] /= peak
    cot = cot.contiguous()
    bwd = partial(B.blend_pgsr_bwd, attrs, ranges, out_k, cot, tx, ty)
    bwd_v1 = partial(B.blend_pgsr_bwd_v1, attrs, ranges, out_k, cot, tx, ty)
    d_k, d_v1 = bwd(), bwd_v1()
    d_p, bwd_plain_ms = timed(lambda: B.blend_pgsr_bwd_plain(
        attrs, ranges, out_k, cot, tx, ty))
    grad_rows = [r for r in range(B.NUM_ATTRS_P) if r != B.P_OBS]
    assert_backward_pair(d_k, d_v1, d_p, grad_rows, B.NUM_ATTRS_P, bwd,
                         bwd_v1)
    for d in (d_k, d_v1):
        assert torch.equal(d[B.P_OBS], d_p[B.P_OBS])
        assert torch.equal(d[B.P_OBS], obs_k)
    # the normal and distance channels' cotangents are large at few pixels
    # (the plane depth divides by n . ray), so those rows can stay below
    # 100 x atol; the per-row comparison above holds each in units of its
    # own largest value
    row_max = d_p.abs().amax(dim=1)
    grad_max = row_max[:B.LIVE_ATTRS_P]
    print(f"{tag} largest plain value per row: "
          f"{[float(f'{x:.3g}') for x in row_max.tolist()]}; "
          f"{int((grad_max > 100 * BWD_TOL['atol']).sum())} of "
          f"{B.LIVE_ATTRS_P} live rows above 100 x atol; v1 max|err| "
          f"{max_err(d_v1, d_p):.3e}, bitwise equal to v1: yes")

    pairs, contrib = blend_pair_count(attrs, ranges, tx, ty)
    cull = gauss_cull_counts(attrs, ranges, tx, ty)
    assert cull.pairs == pairs, (cull.pairs, pairs)
    print_cull_shares(f"{tag} planar", cull)
    # the observe count's own work: the pairs up to every pixel's 0.5
    # point, and the block test of a warp step it skips whole
    obs_cull = gauss_cull_counts(attrs, ranges, tx, ty,
                                 walks=lambda d: d > 0.5)
    print_cull_shares(f"{tag} observe (to D <= 0.5)", obs_cull)
    print(f"{tag} observe: {pairs - obs_cull.pairs} of {pairs} "
          f"pairs to T_EPS ({100 * (1 - obs_cull.pairs / pairs):.2f} %) lie "
          f"past their pixel's 0.5 point; the tiles read {obs_cull.slots} "
          f"of {attrs.shape[1]} instance slots up to their stop")
    n_inst = attrs.shape[1]
    hw = out_k.shape[0] * out_k.shape[1]
    range_bytes = ranges.numel() * 4
    map_bytes = hw * B.OUTP_ROWS * 4
    live_bytes = B.LIVE_ATTRS_P * n_inst * 4 + range_bytes
    src = "gssr_tpu_torch/csrc/blend_pgsr.cu"
    pallas = "gssr_tpu/ops/blend_pgsr_pallas.py"
    rows = [
        report_row("blend_pgsr_fwd", src, f"{pallas}:83",
                   launches["blend_pgsr_fwd"], max_err(out_k, out_p),
                   partial(B.blend_pgsr_fwd, attrs, ranges, tx, ty),
                   fwd_plain_ms, gauss_pair_ops(FWDP_OPS_PER_PAIR, cull)
                   + FWDP_OPS_PER_CONTRIB * contrib,
                   live_bytes + map_bytes,
                   parent=parent and partial(parent["blend_pgsr_fwd"],
                                             attrs, ranges, tx, ty)),
        report_row("blend_pgsr_obs", src, f"{pallas}:182",
                   launches["blend_pgsr_obs"], max_err(obs_k, obs_p),
                   lambda: B.blend_pgsr_observe(attrs, ranges, tx, ty),
                   obs_plain_ms, gauss_pair_ops(OBSP_OPS_PER_PAIR, obs_cull),
                   B.P_RGB * obs_cull.slots * 4 + range_bytes + n_inst * 4,
                   parent=parent and partial(parent["blend_pgsr_obs"],
                                             attrs, ranges, tx, ty)),
        report_row("blend_pgsr_bwd", src, f"{pallas}:216",
                   launches["blend_pgsr_bwd"], max_err(d_k, d_p), bwd,
                   bwd_plain_ms, gauss_pair_ops(BWDP_OPS_PER_PAIR, cull)
                   + BWDP_OPS_PER_CONTRIB * contrib,
                   live_bytes + 2 * map_bytes + attrs.numel() * 4,
                   v1=bwd_v1)]
    print(f"{tag} planar blend inputs: {tx * 16}x{ty * 16} padded, "
          f"{n_inst} instance slots, {pairs} (pixel, instance) pairs before "
          f"saturation, {contrib} contributing, {int(obs_k.sum())} observed; "
          f"loss terms {terms_line}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None)
    ap.add_argument("--yardstick", default=None, metavar="DIR",
                    help="a checkout of the parent commit whose vanilla and "
                         "planar forwards and observe count the current "
                         "ones must equal bit for bit and are timed against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    import gssr_tpu_torch  # noqa: F401  (fails in a bare directory)

    dev = torch.device("cuda")
    card_line = card()
    print(f"[card] {card_line}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    parent = phase_build(dev, args.yardstick)
    phase_kernels(dev, parent)
    phase_kernels2d(dev)
    phase_kernels_pgsr(dev, parent)
    with tempfile.TemporaryDirectory() as root:
        t1 = time.perf_counter()
        write_scene(os.path.join(root, "scene"), dev)
        print(f"[train] scene written in {time.perf_counter() - t1:.1f} s")
        runs = {m: phase_train(dev, root, card_line, m)
                for m in ("3dgs", "2dgs", "pgsr") + ANCHOR_METHODS}
        for m in MESH_METHODS:
            phase_mesh(runs[m][0], card_line)
        t1 = time.perf_counter()
        phase_split(root, runs["2dgs"][0], card_line)
        print(f"[split] phase in {time.perf_counter() - t1:.1f} s")
        if args.profile:
            stem, ext = os.path.splitext(args.profile)
            phase_profile(runs["3dgs"][0], args.profile, card_line)
            for m, suffix in (("2dgs", "2dgs"), ("pgsr", "pgsr"),
                              ("scaffold-gs", "scaffold"),
                              ("octree-2dgs", "octree2dgs")):
                phase_profile(runs[m][0], f"{stem}_{suffix}{ext}", card_line)
        rows = phase_report(*runs["3dgs"], dev, parent)
        rows += phase_report2d(*runs["2dgs"], dev)
        rows += phase_report_pgsr(*runs["pgsr"], dev, parent)
        phase_report_scaffold(*runs["scaffold-gs"], dev, card_line)
        phase_report_octree2d(*runs["octree-2dgs"], dev, card_line)
        phase_report_scaffold_pgsr(*runs["scaffold-pgsr"], dev, card_line)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
