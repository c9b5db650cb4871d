#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port, gssr_tpu_torch, on one CUDA card.

    python3 chip_smoke.py [--profile FILE] [--yardstick DIR] [--convergence]

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
            observe kernel's counts. Then the intersect mask
            (csrc/projection.cu) against tile_intersect_mask_plain on the
            same CUDA tensors, element for element: mask_cases' hand-made
            and random rows (and the same on the CPU) and N = 0, which
            launches nothing; then, for
            each MASK_CELLS cell of portbench/ at its real size, the mask
            inputs of one training step, whose step launched the kernel
            once; prints there the kernel's device time and its bound.
            Then binning's instance expansion (csrc/binning.cu) against
            expand_instances_plain, key and payload bit for bit, on the
            card and the CPU: expand_cases' hand-made inputs (n = 0, all
            culled, rects wider than 32 tiles, no mask, a band with the
            frame's key_tiles, long culled runs), then the inputs of one
            training step of each EXPAND_CELLS cell, which launched the
            kernel once a render; prints there the kernel's and the plain
            chain's device times and the kernel's byte bound. With
            --yardstick, every kernel of this phase is held against DIR's
            build (below).
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
            on a multi-view step) and the instance expansion, and no
            render launched the observe count; for the two-camera paths
            also ring
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
   parallel the multi-device modes (parallel/, ops/band.py) on the same
            scene: `python -m gssr_tpu_torch.train 3dgs --machine.parallel
            dp --machine.num-devices 1` for PAR_STEPS steps in a subprocess
            (a group of one: NCCL on the card), whose losses must equal an
            in-process one-device run's bit for bit; then two ranks sharing
            the card over gloo (parallel/launch.py::spawn; NCCL refuses two
            ranks on one card), each holding its modes against its own
            one-device computation at full width: 3dgs dp with the same
            camera on both ranks (xyz to 1e-5, denom twice), the band maps
            of 3dgs, 2dgs (the rebased surfel map) and pgsr against the
            full-frame render (each 2dgs pixel past the tolerance
            witnessed by surfel_flips: a decision within float32 rounding
            of its threshold), the merged gradients and screen-space
            inputs of 3dgs band and gshard (each rank's slice), 2dgs band,
            pgsr band on a two-camera step (observe counts summed exactly)
            and octree-2dgs band and gshard (the MLP summed; the ranks
            decode different numbers of visible anchors, so the gather is
            padded); every rank must launch the six blend kernels of those
            paths. Then each (method, mode) of PAR_TRAIN trains PAR_STEPS
            steps; prints the median step of each rank (two ranks sharing
            one card: not a scaling figure), one step's collectives, MiB
            and ms (gloo stages CUDA tensors through the host), and each
            rank's peak memory. Then train_split over several devices a
            tile, on the split phase's two tiles, PAR_STEPS steps a tile:
            `python -m gssr_tpu_torch.train_split octree-2dgs
            --machine.parallel band --machine.num-devices 1` in a
            subprocess (NCCL), each tile's losses equal to an in-process
            one-device train_split's bit for bit; then two ranks sharing
            the card over gloo, each running train_split in band and in
            gshard (both ranks train both tiles; rank 0 writes each tile's
            run once, one config.yml and one DONE; a second call skips both
            tiles on both ranks; every rank launches the surfel forward and
            backward kernels on every tile), printing each tile's median
            step and peak memory per rank (not a scaling figure).
4. report   all seven kernels against their plain versions again, at their
            main path's own inputs (the trained model, one of its cameras):
            the vanilla pair under the cotangent of its loss, the surfel
            pair under that of the 2dgs loss with both regularisers live
            plus a random one on median_normal, the planar kernels under
            that of the pgsr multi-view loss, each channel group scaled to
            unit size; with times and bounds, each plain version timed on
            its one comparison call. At the 3dgs, 2dgs and pgsr inputs it also
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
            keeps one row per kernel. With --yardstick, every kernel is
            held against DIR's build here too, and its row gains
            "parent_ms"; then every entry point both trees define must
            have been held. Prints the {"kernels": [...]} line, the card,
            and last the {"ok": true, "device": {...}} line.

--convergence adds, after the report, the port's long run held against
gssr_tpu's records (benchmarks/results/convergence_r5.json): gssr_tpu's
structured scene (benchmarks/convergence.py, copied here: a ground plane,
three spheres and a box of 29,500 gaussians, 54 orbit views at 400x304
rendered by the port's rasterize, a sparse init of 1/12 of the means)
written as a COLMAP scene; `python -m gssr_tpu_torch.train octree-2dgs`
and `... pgsr` for 2,400 steps each with that script's flags (--eval true,
an eval every 150 steps, densify until step 1,200, its capacities; pgsr
two-camera from step 1,200), each meshed by `python -m
gssr_tpu_torch.extract_mesh` (voxel 0.02, sdf_trunc 0.08, depth_trunc 8)
and scored with utils/mesh_eval.py against the scene's means (200,000
samples, seed 0). It prints the eval PSNR curve, the saved PLY's count,
the mesh's precision, recall and F1 at 0.03 and 0.05 and the seconds,
and fails unless each method's mean eval PSNR over steps 2100-2400 lies
at most CONV_PSNR_BELOW dB below the record's and its f1@0.05 at most
CONV_F1_BELOW below.

--profile FILE adds three profiled train steps to five paths after phase 3
and writes torch.profiler's per-kernel tables to FILE (3dgs) and to FILE
with `_2dgs`, `_pgsr`, `_scaffold` and `_octree2dgs` before its suffix;
for the anchor paths it also prints the step's stages
(scene/scaffold.py's profiler ranges).

--yardstick DIR names a checkout of the parent commit (for example `git
archive HEAD` unpacked under build/), whose build of the kernels is the
yardstick of this tree's. Each kernel call of phases 2 and 4 is made
again through the same wrapper with DIR's kernels swapped in
(kernel_table), so that they see the same buffers, zero-fills and
strides: the result must equal this tree's bit for bit, and both are timed
in turns (DIR, new, new, DIR; "parent_ms"). The run fails unless every
entry point that both trees define, the occupancy ones apart, was held so.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
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
# FP32 operations of the intersect mask (gssr_tpu_torch/csrc/projection.cu)
# per tested tile: the box 4, four clamped edge points 5 each, four
# quadratics 11 each, their minimum 3, the inside test 4 and the cut 1
MASK_OPS_PER_TILE = 76

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
# the redesigned kernels' occupancy entry points and the resident blocks per
# SM each must keep
OCCUPANCY = {"gssr_blend_fwd_occupancy": 3,
             "gssr_blend_bwd_occupancy": 3,
             "gssr_blend2d_fwd_occupancy": 3,
             "gssr_blend2d_bwd_occupancy": 2,
             "gssr_blend_pgsr_fwd_occupancy": 3,
             "gssr_blend_pgsr_obs_occupancy": 4,
             "gssr_blend_pgsr_bwd_occupancy": 3}
# the cells (portbench/workloads/) at whose inputs phase 2 holds the
# intersect mask and the instance expansion against their plain versions,
# and the seed of their scenes
MASK_CELLS = ("3dgs.init", "3dgs.full", "octree-2dgs.init")
EXPAND_CELLS = MASK_CELLS + ("pgsr.two-camera",)
CELL_SEED = 2_147_483_713
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


def turns_ms(a, b, reps: int = 20):
    """Two versions of a call timed in turns a, b, b, a: (a ms, b ms), each
    the median of its two turns' samples."""
    times = {a: [], b: []}
    for fn in (a, b, b, a):
        times[fn] += event_ms(fn, reps)
    return statistics.median(times[a]), statistics.median(times[b])


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
    the parent's Yardstick, or None."""
    from gssr_tpu_torch.ops import _kernels
    builds = [("", _kernels.build())]
    _kernels.load()
    yard = None
    if yardstick:
        info = _kernels.build(
            Path(yardstick) / "gssr_tpu_torch" / "csrc",
            _kernels.BUILD_DIR.parent / "yardstick")
        builds.append(("yardstick ", info))
        yard = Yardstick(_kernels.bind(info["libs"]))
    for tag, info in builds:
        print(f"[build] {tag}{len(info['libs'])} libraries in "
              f"{info['seconds']:.2f} s (one nvcc per source, in parallel)")
        log_build(tag, info)
    for name, least in OCCUPANCY.items():
        occ = _kernels.occupancy(name, dev)
        print(f"[build] {name}: {occ}")
        assert occ["blocks_per_sm"] >= least, (name, occ)
        assert occ["local_bytes"] == 0, (name, occ)
    return yard


def log_build(tag, info):
    for src, lib in info["libs"].items():
        print(f"[build] {tag}{src} -> {lib['path'].name} in "
              f"{lib['seconds']:.2f} s")
        for line in lib["log"].splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "Compiling entry" in line):
                print(f"[build] {tag}{line.strip()}")


# ---------------------------------------------------------------------------
# --yardstick: the parent commit's kernels through this tree's wrappers
# ---------------------------------------------------------------------------

def kernel_keys(names) -> set:
    """The launch counters of these entry points, the occupancy ones
    apart: entry point gssr_<key> counts its launches in LAUNCHES[key]."""
    return {name[len("gssr_"):] for name in names
            if not name.endswith("_occupancy")}


@contextlib.contextmanager
def kernel_table(fns):
    """The kernel wrappers launch the entry points of `fns` (a table
    _kernels.bind returns) in place of _kernels' own; on the way out that
    table and every LAUNCHES count are as they were. Yields the set of
    LAUNCHES keys that moved meanwhile, filled on the way out."""
    from gssr_tpu_torch.ops import _kernels
    own = _kernels.load()
    counts = [dict(c) for c in kernel_counts()]
    moved = set()
    _kernels._fns = fns
    try:
        yield moved
    finally:
        _kernels._fns = own
        for c, was in zip(kernel_counts(), counts):
            moved.update(k for k in c if c[k] != was[k])
            c.update(was)


class Yardstick:
    """The parent commit's build of the kernels (--yardstick DIR), bound as
    _kernels binds this tree's and launched through this tree's own
    wrappers. `keys` are the counters of the entry points both trees
    define (an entry point the parent lacks runs this tree's kernel on
    both sides and is not held); `held` those a check has held."""

    def __init__(self, fns):
        from gssr_tpu_torch.ops import _kernels
        self.own = _kernels.load()
        self.fns = {**self.own, **fns}
        self.keys, self.held = kernel_keys(fns), set()

    def equal(self, fn, out, tag):
        """fn(), one wrapper call, must give `out`, its result on this
        tree's kernels, on the parent's too, bit for bit (a tensor or a
        tuple of them)."""
        with kernel_table(self.fns) as moved:
            base = fn()
        assert len(moved) == 1, (tag, moved)
        if not moved <= self.keys:
            return
        pairs = zip(out, base) if isinstance(out, tuple) else [(out, base)]
        assert all(torch.equal(a, b) for a, b in pairs), \
            f"{moved} differs from the parent's build at {tag}"
        self.held |= moved

    def turns(self, fn, timer):
        """fn on the parent's kernels and on this tree's in turns (parent,
        new, new, parent); timer(fn) gives a list of ms. Returns (ms,
        parent_ms), each the median of its side's samples."""
        times = {True: [], False: []}
        for parent in (True, False, False, True):
            with kernel_table(self.fns if parent else self.own):
                times[parent] += timer(fn)
        return statistics.median(times[False]), statistics.median(times[True])


def held(yard, fn, out, tag):
    """With --yardstick, `out` = fn() must equal the parent's build's."""
    if yard is not None:
        yard.equal(fn, out, tag)


def kernel_ms(fn, yard=None, timer=None):
    """(fn's time, None), the median of timer(fn) (default: 20 CUDA-event
    samples); with --yardstick (ms, the parent's build's ms), in turns."""
    timer = timer or (lambda f: event_ms(f, 20))
    if yard is None:
        return statistics.median(timer(fn)), None
    return yard.turns(fn, timer)


def parent_line(parent_ms) -> str:
    return ("" if parent_ms is None else
            f"  parent {parent_ms:.4f} ms, bitwise equal")


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions, with an overdraw tile
# ---------------------------------------------------------------------------

def phase_kernels(dev, yard=None):
    from gssr_tpu_torch.ops import blend as B
    g = torch.Generator(device="cpu").manual_seed(1)
    n = 20_000
    scene = overdraw_scene(g, n, 2_000, scale_dim=3)
    cam = camera(256, 256).arrays(dev)
    attrs, ranges, tx, ty = blend_inputs(*(x.to(dev) for x in scene), cam,
                                         256, 256)
    fwd = partial(B.blend_fwd, attrs, ranges, tx, ty)
    out_k = fwd()
    out_p = B.blend_fwd_plain(attrs, ranges, tx, ty)
    torch.testing.assert_close(out_k, out_p, **FWD_TOL)
    held(yard, fwd, out_k, "kernels")
    saturated = int((out_k[..., 3] < 1e-3).sum())
    assert saturated > 0, "the overdraw tile did not saturate"
    cot = torch.randn(out_k.shape, generator=g).to(dev)
    bwd = partial(B.blend_bwd, attrs, ranges, out_k, cot, tx, ty)
    d_k = bwd()
    d_p = B.blend_bwd_plain(attrs, ranges, out_k, cot, tx, ty)
    assert_backward(d_k, d_p, range(B.LIVE_ATTRS), B.LIVE_ATTRS, bwd)
    held(yard, bwd, d_k, "kernels")
    fwd_ms, fwd_parent_ms = kernel_ms(fwd, yard)
    fwd_plain_ms = median_ms(lambda: B.blend_fwd_plain(attrs, ranges, tx,
                                                       ty), 3)
    bwd_plain_ms = median_ms(lambda: B.blend_bwd_plain(attrs, ranges, out_k,
                                                       cot, tx, ty), 3)
    bwd_ms, bwd_parent_ms = kernel_ms(bwd, yard)
    print(f"[kernels] 256x256, {n} gaussians, {attrs.shape[1]} instance "
          f"slots, {saturated} saturated pixels")
    print(f"[kernels] blend_fwd max|err| {max_err(out_k, out_p):.3e}  "
          f"{fwd_ms:.4f} ms  plain {fwd_plain_ms:.4f} ms"
          + parent_line(fwd_parent_ms))
    print(f"[kernels] blend_bwd max|err| {max_err(d_k, d_p):.3e}  "
          f"{bwd_ms:.4f} ms  plain {bwd_plain_ms:.4f} ms  deterministic: yes"
          + parent_line(bwd_parent_ms))


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


def phase_kernels2d(dev, yard=None):
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
    out_k = fwd()
    out_p = B.blend2d_fwd_plain(attrs, ranges, tx, ty)
    assert_surfel_forward(out_k, out_p, B.O_SELPOS)
    held(yard, fwd, out_k, "kernels2d")
    saturated = int((out_k[..., B.O_T] < 1e-3).sum())
    medians = int((out_k[..., B.O_SELPOS] >= 0).sum())
    assert saturated > 0, "the overdraw stack did not saturate"
    assert medians > 0, "no pixel has a median"
    cot = torch.randn(out_k.shape, generator=g).to(dev)
    cot[..., list(B.NO_GRAD_ROWS)] = 0.0
    bwd = partial(B.blend2d_bwd, attrs, ranges, out_k, cot, tx, ty)
    d_k = bwd()
    d_p = B.blend2d_bwd_plain(attrs, ranges, out_k, cot, tx, ty)
    assert_backward(d_k, d_p, range(B.LIVE_ATTRS2), B.LIVE_ATTRS2, bwd)
    held(yard, bwd, d_k, "kernels2d")
    fwd_ms, fwd_parent_ms = kernel_ms(fwd, yard)
    bwd_ms, bwd_parent_ms = kernel_ms(bwd, yard)
    print(f"[kernels2d] 256x256, {n} surfels, {attrs.shape[1]} instance "
          f"slots, {saturated} saturated pixels, {medians} with a median")
    print(f"[kernels2d] blend2d_fwd max|err| {max_err(out_k, out_p):.3e}  "
          f"{fwd_ms:.4f} ms" + parent_line(fwd_parent_ms))
    print(f"[kernels2d] blend2d_bwd max|err| {max_err(d_k, d_p):.3e}  "
          f"{bwd_ms:.4f} ms  deterministic: yes"
          + parent_line(bwd_parent_ms))


def phase_kernels_pgsr(dev, yard=None):
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
    fwd = partial(B.blend_pgsr_fwd, attrs, ranges, tx, ty)
    out_k = fwd()
    out_p = B.blend_pgsr_fwd_plain(attrs, ranges, tx, ty)
    torch.testing.assert_close(out_k, out_p, **FWD_TOL)
    held(yard, fwd, out_k, "kernels pgsr")
    saturated = int((out_k[..., B.PO_T] < 1e-3).sum())
    assert saturated > 0, "the overdraw stack did not saturate"
    obs = partial(B.blend_pgsr_observe, attrs, ranges, tx, ty)
    obs_k = obs()
    assert torch.equal(obs_k, B.blend_pgsr_obs_plain(attrs, ranges, tx, ty))
    held(yard, obs, obs_k, "kernels pgsr")
    a_c, r_c, tx_c, ty_c, want = observe_cases()
    a_c, r_c = a_c.to(dev), r_c.to(dev)
    obs_cases = partial(B.blend_pgsr_observe, a_c, r_c, tx_c, ty_c)
    obs_c = obs_cases()
    assert torch.equal(obs_c, B.blend_pgsr_obs_plain(a_c, r_c, tx_c, ty_c))
    assert_observe_cases(obs_c, r_c, want)
    held(yard, obs_cases, obs_c, "observe_cases")
    pairs, contrib = blend_pair_count(attrs, ranges, tx, ty)
    observed = int(obs_k.sum())
    assert 0 < observed < contrib, \
        f"the T > 0.5 cut-off did not fire ({observed} of {contrib})"
    cot = torch.randn(out_k.shape, generator=g).to(dev)
    bwd = partial(B.blend_pgsr_bwd, attrs, ranges, out_k, cot, tx, ty)
    d_k = bwd()
    d_p = B.blend_pgsr_bwd_plain(attrs, ranges, out_k, cot, tx, ty)
    # every row but the observe count is a gradient
    grad_rows = [r for r in range(B.NUM_ATTRS_P) if r != B.P_OBS]
    assert_backward(d_k, d_p, grad_rows, B.NUM_ATTRS_P, bwd)
    assert torch.equal(d_k[B.P_OBS], d_p[B.P_OBS])
    assert torch.equal(d_k[B.P_OBS], obs_k)
    assert torch.equal(per_gaussian(d_k[B.P_OBS], b), per_gaussian(obs_k, b))
    held(yard, bwd, d_k, "kernels pgsr")
    fwd_ms, fwd_parent_ms = kernel_ms(fwd, yard)
    obs_ms, obs_parent_ms = kernel_ms(obs, yard)
    bwd_ms, bwd_parent_ms = kernel_ms(bwd, yard)
    print(f"[kernels pgsr] 256x256, {n} gaussians, {attrs.shape[1]} "
          f"instance slots, {saturated} saturated pixels; {contrib} "
          f"contributing pairs, {observed} of them observed (D > 0.5)")
    print(f"[kernels pgsr] blend_pgsr_fwd max|err| "
          f"{max_err(out_k, out_p):.3e}  {fwd_ms:.4f} ms"
          + parent_line(fwd_parent_ms))
    print(f"[kernels pgsr] blend_pgsr_obs exact, and on observe_cases' "
          f"stacks (D exactly 0.5, the 0.5 point at either side of a chunk "
          f"boundary, a warp done beside walking ones, a tile that never "
          f"reaches 0.5)  {obs_ms:.4f} ms" + parent_line(obs_parent_ms))
    print(f"[kernels pgsr] blend_pgsr_bwd max|err| {max_err(d_k, d_p):.3e}  "
          f"{bwd_ms:.4f} ms  deterministic: yes; observe row = observe "
          f"kernel, per slot and per gaussian" + parent_line(bwd_parent_ms))


# ---------------------------------------------------------------------------
# 2b. the tile intersect mask against its plain loop
# ---------------------------------------------------------------------------

def mask_cases():
    """Hand-made intersect-mask inputs on the CPU, (mean2d, conic, rect,
    cutoff, visible), one row a case, a unit conic (cxx = cyy = 1) and
    cutoff 4.5 unless said: the mean on a tile's edge (x = 16, the first
    pixel centre of tile 1; x = 15, the last of tile 0), between two
    tiles (15.5), on a corner (16, 16), and 3 px off a tile (q exactly
    4.5 = cutoff); a wide flat gaussian over rects of exactly 32 (8 x 4),
    33 (11 x 3) and 1,200 (40 x 30) tiles, touching each, and a narrow
    one over 33;
    zero and NaN conic rows culled (visible False); a zero conic, a NaN
    conic, a NaN cxy, an infinite cxx, a NaN and a negative cutoff
    visible; empty and inverted rects; then 20,000 seeded random rows
    (every 16th culled, rects of 0-12 x 0-6 tiles near the mean, conics
    of random shape, cutoffs 0-6)."""
    nan, inf = float("nan"), float("inf")
    unit = (1.0, 0.0, 1.0)
    flat = (1e-4, 0.0, 1e-4)
    rows = [  # mean, conic, rect, cutoff, visible
        ((16.0, 8.0), unit, (0, 0, 2, 1), 4.5, True),
        ((15.0, 8.0), unit, (0, 0, 2, 1), 4.5, True),
        ((15.5, 8.0), unit, (0, 0, 2, 1), 4.5, True),
        ((16.0, 16.0), unit, (0, 0, 2, 2), 4.5, True),
        ((18.0, 8.0), unit, (0, 0, 2, 1), 4.5, True),
        ((64.0, 32.0), flat, (0, 0, 8, 4), 4.5, True),
        ((88.0, 24.0), flat, (0, 0, 11, 3), 4.5, True),
        ((320.0, 240.0), (1e-6, 0.0, 1e-6), (0, 0, 40, 30), 4.5, True),
        ((88.0, 24.0), (0.02, 0.01, 0.5), (0, 0, 11, 3), 4.5, True),
        ((8.0, 8.0), (0.0, 0.0, 0.0), (0, 0, 2, 2), 4.5, False),
        ((8.0, 8.0), (nan, nan, nan), (0, 0, 2, 2), 4.5, False),
        ((8.0, 8.0), (0.0, 0.0, 0.0), (0, 0, 3, 2), 4.5, True),
        ((8.0, 8.0), (nan, nan, nan), (0, 0, 3, 2), 4.5, True),
        ((8.0, 8.0), (1.0, nan, 1.0), (0, 0, 3, 2), 4.5, True),
        ((8.0, 8.0), (inf, 0.5, 1.0), (0, 0, 3, 2), 4.5, True),
        ((8.0, 8.0), unit, (0, 0, 40, 2), nan, True),
        ((8.0, 8.0), unit, (0, 0, 3, 2), -1.0, True),
        ((8.0, 8.0), unit, (1, 1, 1, 3), 4.5, True),
        ((8.0, 8.0), unit, (3, 2, 1, 1), 4.5, True),
    ]
    mean2d = torch.tensor([r[0] for r in rows], dtype=torch.float32)
    conic = torch.tensor([r[1] for r in rows], dtype=torch.float32)
    rect = torch.tensor([r[2] for r in rows], dtype=torch.int32)
    cutoff = torch.tensor([r[3] for r in rows], dtype=torch.float32)
    visible = torch.tensor([r[4] for r in rows])
    g = torch.Generator(device="cpu").manual_seed(5)
    n = 20_000
    m = torch.rand((n, 2), generator=g) * torch.tensor([400.0, 200.0]) - 20
    a = torch.exp(torch.rand((n, 2), generator=g) * 10 - 8)
    c = (torch.rand(n, generator=g) * 2 - 1) * torch.sqrt(a[:, 0] * a[:, 1])
    lo = torch.floor(m / 16).to(torch.int32) - torch.randint(
        0, 3, (n, 2), generator=g, dtype=torch.int32)
    size = torch.randint(0, 13, (n, 2), generator=g, dtype=torch.int32)
    size[:, 1] //= 2
    return (torch.cat([mean2d, m]),
            torch.cat([conic, torch.stack([a[:, 0], c, a[:, 1]], 1)]),
            torch.cat([rect, torch.cat([lo, lo + size], 1)]),
            torch.cat([cutoff, 6 * torch.rand(n, generator=g)]),
            torch.cat([visible, torch.arange(n) % 16 != 0]))


def cell_calls(cell_name, seed, dev, module, name, counter):
    """The calls of module.<name> in one training step of portbench's cell
    `cell_name` on `dev`, at its real size (its scene written from `seed`,
    the program built as the benchmark builds it): [(args, out)] and the
    kernel launches module.LAUNCHES[counter] counted in the step."""
    from portbench import harness
    from portbench.scene import write_scene as write_cell_scene
    cell = harness.Cell.named(cell_name)
    calls, fn = [], getattr(module, name)

    def spy(*args):
        out = fn(*args)
        calls.append((args, out))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        scene_dir = os.path.join(tmp, "scene")
        write_cell_scene(scene_dir, seed, cell.points, cell.cameras,
                         cell.width, cell.height, dev.type)
        trainer = harness.build_trainer(harness.program_argv(
            cell, scene_dir, os.path.join(tmp, "out"), seed, dev.type), seed)
        trainer.start_step = cell.start_step
        launched = module.LAUNCHES[counter]
        setattr(module, name, spy)
        try:
            harness.train_to(trainer, cell.start_step + 1)
        finally:
            setattr(module, name, fn)
        launched = module.LAUNCHES[counter] - launched
        del trainer
    return calls, launched


def device_ms(fn, reps=200):
    """fn's device time per call: `reps` calls queued behind a sleeping
    kernel, so that the host's launches do not pace them."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def mask_work(args):
    """The least the mask needs of the card for these inputs: (FP32
    operations, bytes). Each slot reads its visible flag and writes mask
    and count; a visible one also its rect; one with a non-empty rect its
    mean, conic and cutoff, two divisions and MASK_OPS_PER_TILE a tested
    tile."""
    _, _, rect, _, visible = args
    w = (rect[:, 2] - rect[:, 0]).long()
    area = w * (rect[:, 3] - rect[:, 1]).long()
    work = visible & (area > 0)
    tiles = int(torch.where(work, area.clamp(max=32), 0).sum())
    n, n_vis, n_work = visible.numel(), int(visible.sum()), int(work.sum())
    return (MASK_OPS_PER_TILE * tiles + 2 * n_work,
            9 * n + 16 * n_vis + 24 * n_work)


def phase_tile_mask(dev, yard=None):
    """csrc/projection.cu's intersect mask against
    tile_intersect_mask_plain on the same CUDA tensors, element for
    element: mask_cases' rows (and N = 0), then the mask inputs of one
    training step of each MASK_CELLS cell, whose step must launch the
    kernel once (one vanilla render, or one anchor prefilter); there the
    kernel is timed (device_ms) beside its bound."""
    from gssr_tpu_torch.ops import projection as P
    cpu = mask_cases()
    cases = tuple(t.to(dev) for t in cpu)
    before = P.LAUNCHES["tile_mask"]
    mask, count = P.tile_intersect_mask(*cases)
    assert P.LAUNCHES["tile_mask"] == before + 1
    held(yard, partial(P.tile_intersect_mask, *cases), (mask, count),
         "mask_cases")
    for want in (P.tile_intersect_mask_plain(*cases),
                 P.tile_intersect_mask_plain(*cpu)):
        assert torch.equal(mask.cpu(), want[0].cpu()), "mask differs"
        assert torch.equal(count.cpu(), want[1].cpu()), "count differs"
    assert (mask == -1).any() and (count == 1200).any(), \
        "no case set every bit, or none counted past bit 31"
    empty = tuple(t[:0] for t in cases)
    for got, want in zip(P.tile_intersect_mask(*empty),
                         P.tile_intersect_mask_plain(*empty)):
        assert got.shape == want.shape == (0,) and got.is_cuda
    assert P.LAUNCHES["tile_mask"] == before + 1, "N = 0 launched"
    print(f"[kernels] tile_mask: {mask.numel()} hand-made and random rows "
          f"and N = 0 equal to the plain loop's (on the card and the CPU)")
    for cell in MASK_CELLS:
        calls, launched = cell_calls(cell, CELL_SEED, dev, P,
                                     "tile_intersect_mask", "tile_mask")
        assert launched == len(calls) == 1, (cell, launched, len(calls))
        (args, (mask, count)), = calls
        want = P.tile_intersect_mask_plain(*args)
        assert torch.equal(mask, want[0]) and torch.equal(count, want[1]), \
            f"tile_mask differs from the plain loop at {cell}'s inputs"
        fn = partial(P.tile_intersect_mask, *args)
        held(yard, fn, (mask, count), cell)
        ops, nbytes = mask_work(args)
        bound_ms, bound_by = bound(ops, nbytes)
        ms, parent_ms = kernel_ms(fn, yard, timer=lambda f: [device_ms(f)])
        visible = args[4]
        print(f"[kernels] tile_mask at {cell}: {visible.numel()} slots, "
              f"{int(visible.sum())} visible, {int((count > 0).sum())} "
              f"touching a tile; equal to the plain loop; {ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {ops} operations, "
              f"{nbytes} bytes)" + parent_line(parent_ms), flush=True)


# ---------------------------------------------------------------------------
# 2c. binning's instance expansion against its plain chain
# ---------------------------------------------------------------------------

def expand_cases():
    """Hand-made binning inputs on the CPU, name -> (rect, depth,
    tiles_touched, tile_mask, tiles_x, tiles_y, key_tiles), as
    bin_gaussians takes them: no gaussian (n = 0); all 50 culled (every
    slot a filler of tile 0); 3,000 seeded splats over 100 x 66 tiles (a
    third culled, rects of 1-6 x 1-4 tiles, depths of either sign), once
    with random masks and once with none; 400 rects 20-100 tiles
    wide, one the whole frame (a run of 6,600 slots, longer than a block's
    range, and a hit past bit 31 on every wide one); 20,000 gaussians of
    which one in 97 is visible (long culled runs between two runs); and
    rank 1's band of two of the random frame, clipped as ops/band.py
    clips it, with the frame's key_tiles."""
    from gssr_tpu_torch.ops.band import clip_to_band
    rng = np.random.default_rng(18)

    def splats(n, tx, ty, width, culled, mask=True):
        x0 = rng.integers(0, tx, n)
        y0 = rng.integers(0, ty, n)
        x1 = np.minimum(x0 + rng.integers(width[0], width[1] + 1, n), tx)
        y1 = np.minimum(y0 + rng.integers(1, 5, n), ty)
        rect = np.stack([x0, y0, x1, y1], 1).astype(np.int32)
        tiles = np.where(culled(n), 0, (x1 - x0) * (y1 - y0))
        depth = rng.uniform(-2.0, 40.0, n).astype(np.float32)
        bits = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
        return [torch.from_numpy(rect), torch.from_numpy(depth),
                torch.from_numpy(tiles.astype(np.int32)),
                torch.from_numpy(bits) if mask else None]

    third = lambda n: rng.random(n) < 1 / 3          # noqa: E731
    frame = splats(3000, 100, 66, (1, 6), third)
    wide = splats(400, 100, 66, (20, 100), lambda n: np.zeros(n, bool))
    wide[0][0] = torch.tensor([0, 0, 100, 66], dtype=torch.int32)
    wide[2][0] = 100 * 66
    sparse = splats(20_000, 100, 66, (1, 6), lambda n: np.arange(n) % 97 > 0)
    empty = splats(0, 4, 3, (1, 2), third)
    culled = splats(50, 4, 3, (1, 2), lambda n: np.ones(n, bool))
    band_rect, band_tiles, band_mask, _ = clip_to_band(
        frame[0], frame[2], frame[3], 33, 33)
    return {
        "n = 0": (*empty, 4, 3, None),
        "all culled": (*culled, 4, 3, None),
        "random": (*frame, 100, 66, None),
        "no mask": (*frame[:3], None, 100, 66, None),
        "wide rects": (*wide, 100, 66, None),
        "sparse": (*sparse, 100, 66, None),
        "band": (band_rect, frame[1], band_tiles, band_mask, 100, 33,
                 100 * 66),
    }


def expand_inputs(case, dev):
    """The arguments bin_gaussians hands expand_instances for one
    expand_cases case on `dev` (the plain chain computes its result, so no
    kernel is launched)."""
    from gssr_tpu_torch.ops import binning as B
    from gssr_tpu_torch.ops.blend import CHUNK
    rect, depth, tiles, mask, tiles_x, tiles_y, key_tiles = case
    calls = []

    def spy(*args):
        calls.append(args)
        return B.expand_instances_plain(*args)

    B.expand_instances, fn = spy, B.expand_instances
    try:
        B.bin_gaussians(rect.to(dev), depth.to(dev), tiles.to(dev), tiles_x,
                        tiles_y, None if mask is None else mask.to(dev),
                        chunk=CHUNK, key_tiles=key_tiles)
    finally:
        B.expand_instances = fn
    (args,) = calls
    return args


def expand_work(args):
    """The least bytes the expansion moves: key and payload out per slot;
    in, every gaussian's offset, each visible one's rect, depth and mask,
    and the filler starts."""
    _, _, mask, offsets, fill_starts, _, cap, _, _ = args
    visible = int((torch.diff(offsets, prepend=offsets.new_zeros(1)) > 0)
                  .sum())
    return (8 * cap + 4 * offsets.numel()
            + (20 + 4 * (mask is not None)) * visible
            + 4 * fill_starts.numel() + 4)


def phase_bin_expand(dev, yard=None):
    """csrc/binning.cu's instance expansion against expand_instances_plain
    on the same CUDA tensors and on the CPU, bit for bit: expand_cases'
    inputs, then those of one training step of each EXPAND_CELLS cell,
    whose step must launch the kernel once a render; there the kernel and
    the plain chain are timed (device_ms) beside the kernel's byte
    bound."""
    from gssr_tpu_torch.ops import binning as B

    def check(args, got, tag):
        cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
        for want in (B.expand_instances_plain(*args),
                     B.expand_instances_plain(*cpu)):
            for g, w, what in zip(got, want, ("key", "payload")):
                assert torch.equal(g.cpu(), w.cpu()), \
                    f"bin_expand's {what} differs from the plain chain's " \
                    f"at {tag}"
        held(yard, partial(B.expand_instances, *args), got, tag)

    for name, case in expand_cases().items():
        args = expand_inputs(case, dev)
        before = B.LAUNCHES["bin_expand"]
        got = B.expand_instances(*args)
        assert B.LAUNCHES["bin_expand"] == before + 1
        check(args, got, name)
        print(f"[kernels] bin_expand {name}: {args[1].numel()} gaussians, "
              f"{args[6]} slots, equal to the plain chain's (on the card "
              f"and the CPU)", flush=True)
    for cell in EXPAND_CELLS:
        calls, launched = cell_calls(cell, CELL_SEED, dev, B,
                                     "expand_instances", "bin_expand")
        assert launched == len(calls) >= 1, (cell, launched, len(calls))
        for i, (args, got) in enumerate(calls):
            tag = f"{cell} render {i}"
            check(args, got, tag)
            nbytes = expand_work(args)
            bound_ms, bound_by = bound(0, nbytes)
            ms, parent_ms = kernel_ms(partial(B.expand_instances, *args),
                                      yard, timer=lambda f: [device_ms(f)])
            plain_ms = device_ms(lambda: B.expand_instances_plain(*args),
                                 reps=20)
            print(f"[kernels] bin_expand at {tag}: {args[1].numel()} "
                  f"gaussians, {args[6]} slots, equal to the plain chain; "
                  f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{nbytes} bytes), plain chain {plain_ms:.3f} ms"
                  + parent_line(parent_ms), flush=True)
        del calls


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
    from gssr_tpu_torch.ops import (binning, blend, blend2d, blend_pgsr,
                                    projection)
    return (blend.LAUNCHES, blend2d.LAUNCHES, blend_pgsr.LAUNCHES,
            projection.LAUNCHES, binning.LAUNCHES)


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
    # the vanilla preprocess launches the intersect mask at every render
    # but a surfel one, and at every anchor prefilter; 2dgs has none
    if method == "2dgs":
        assert launches["tile_mask"] == 0, launches
    else:
        least = STEPS if PATH_KERNELS[method] == SURFEL_PAIR else renders
        assert launches["tile_mask"] >= least, (launches["tile_mask"], least)
    # every render bins its instances through the expansion kernel
    assert launches["bin_expand"] >= renders, (launches["bin_expand"],
                                               renders)
    # no render reads an observe count
    assert launches["blend_pgsr_obs"] == 0, launches
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

def split_args(split, runs, steps=STEPS):
    """train_split's arguments: the octree-2dgs path's own, on the tiles."""
    return [SPLIT_METHOD, "--source-path", split, "--output-path", runs,
            "--trainer.iterations", str(steps),
            "--trainer.test-iterations", str(steps),
            "--trainer.save-iterations", str(steps),
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
        assert launches["blend_pgsr_obs"] == 0, launches
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


# the parallel phase: the reference's tolerances (forward; gradients with
# atol 2e-4 or, where larger, 2e-3 of the leaf's largest magnitude, as
# gssr_tpu's tests/test_parallel.py::_grad_tree_close scales them: the
# cross-rank sum reassociates each per-gaussian sum and the surfel map's
# band rebase rounds differently), the one-rank NCCL run's steps, each
# two-rank training run's steps, and the kernels every rank must launch
PAR_STEPS = 8
PAR_RANKS = 2
PAR_METHODS = ("3dgs", "2dgs", "pgsr", "octree-2dgs")
# (method, mode, first step): pgsr on its two-camera step, the anchor
# statistics from step 3
PAR_TRAIN = (("3dgs", "dp", 1), ("3dgs", "band", 1), ("3dgs", "gshard", 1),
             ("2dgs", "band", 1), ("pgsr", "band", MULTI_VIEW_FROM + 1),
             ("octree-2dgs", "band", 3), ("octree-2dgs", "gshard", 3))
PAR_KERNELS = VANILLA_PAIR + SURFEL_PAIR + PLANAR_PAIR
# the kernels every rank must launch on every tile of the multi-device
# train_split (octree-2dgs)
PAR_SPLIT_KERNELS = SURFEL_PAIR
_NCCL_RUN = """
import json, sys
from gssr_tpu_torch import train
from gssr_tpu_torch.configs.cli import parse_config
trainer = train.main(parse_config(sys.argv[1:]))
print("LOSSES " + json.dumps([h[1] for h in trainer.history]))
"""

_NCCL_SPLIT = """
import json, os, sys
from gssr_tpu_torch import train, train_split
losses = {}
def tile(config):
    trainer = train.main(config)
    losses[os.path.basename(config.source_path)] = [
        h[1] for h in trainer.history]
train_split.main(sys.argv[1:], train_tile=tile)
print("TILE_LOSSES " + json.dumps(losses))
"""


def grads_close(got, want):
    """max |got - want| and whether it is inside the gradient tolerance."""
    err = (got - want).abs()
    atol = max(BWD_TOL["atol"], BWD_TOL["rtol"] * float(want.abs().max())
               if want.numel() else 0.0)
    ok = bool((err <= atol + BWD_TOL["rtol"] * want.abs()).all())
    return (float(err.max()) if err.numel() else 0.0), ok


class StepSpy:
    """The gradients a train step hands to Adam (after the cross-rank
    merge) and its screen-space statistics inputs, caught while the spy is
    on by wrapping the scene's Adam and statistics calls in this
    process."""

    def __init__(self, scene):
        import gssr_tpu_torch.scene.scaffold as scaffold_mod
        self.g, self.mod = scene.gaussians, scaffold_mod
        self._adam = scaffold_mod.adam_update
        self.anchors = hasattr(scene.state, "anchors")
        self.grads, self.screen = {}, {}

    def __enter__(self):
        g, mod = self.g, self.mod
        if self.anchors:
            adam, stats = mod.adam_update, g.update_stats

            def adam_update(params, grads, adam_state, lrs):
                group = "mlp" if "anchors" in self.grads else "anchors"
                self.grads[group] = dict(grads)
                return adam(params, grads, adam_state, lrs)

            def update_stats(st, op, mask, radii, m2d, *rest):
                self.screen["mean2d"] = m2d
                return stats(st, op, mask, radii, m2d, *rest)
            mod.adam_update, g.update_stats = adam_update, update_stats
            return self
        step = g.adam_step

        def adam_step(state, grads, lrs):
            self.grads["params"] = dict(grads)
            return step(state, grads, lrs)
        g.adam_step = adam_step
        if hasattr(g, "update_stats_pgsr"):
            stats = g.update_stats_pgsr

            def update_stats_pgsr(st, extra, radii, m2d, m2d_abs, obs, sc):
                self.screen.update(mean2d=m2d, mean2d_abs=m2d_abs,
                                   observe=obs)
                return stats(st, extra, radii, m2d, m2d_abs, obs, sc)
            g.update_stats_pgsr = update_stats_pgsr
        else:
            stats = g.update_stats

            def update_stats(st, radii, m2d, sc):
                self.screen["mean2d"] = m2d
                return stats(st, radii, m2d, sc)
            g.update_stats = update_stats
        return self

    def __exit__(self, *exc):
        if self.anchors:
            self.mod.adam_update = self._adam
        for k in ("adam_step", "update_stats", "update_stats_pgsr"):
            vars(self.g).pop(k, None)       # back to the class's


def par_step(scene, mode, cam, step):
    """One train step of the scene's initial state in `mode` ("none": one
    process alone): (its StepSpy, metrics, new state in the step layout,
    the step layout's initial state)."""
    from gssr_tpu_torch.parallel.comm import Parallel
    if mode == "none":
        scene.parallel = Parallel()
    else:
        scene.setup_parallel(mode)
    if hasattr(scene, "_near_draws"):
        scene._near_draws = 0           # the same neighbour every time
    state0 = scene.step_state(scene.state)
    cams = [cam] * scene.parallel.world if mode == "dp" else cam
    with StepSpy(scene) as spy:
        state, metrics = scene.train_step(state0, cams, step)
    scene.parallel = Parallel()
    return spy, metrics, state, state0


def par_build(method, scene_dir, out, dev, capacity=None):
    """`method`'s scene with phase 3's options (and a capacity)."""
    from gssr_tpu_torch.configs.cli import parse_config
    from gssr_tpu_torch.configs.methods import build_scene
    extra = [] if capacity is None else ["--scene.gaussians.capacity",
                                         str(capacity)]
    config = parse_config([method, "--source-path", scene_dir,
                           "--output-path", out, "--machine.device",
                           dev.type, *METHOD_ARGS[method], *extra])
    return build_scene(config, dev)


# the share of a surfel band map's elements allowed past FWD_TOL, and the
# bound on the image, final_T and normal there: the band rebase of the
# surfel map (ops/band.py::rebase_tmat) rounds the ray intersection
# differently, so at full width a few pixels see a decision at a threshold
# (the alpha >= 1/255 gate, the near plane, the T_EPS stop, the median's
# T > 0.5) go the other way; a gate flip moves those maps by at most one
# contribution at the gate, alpha 1/255. surfel_flips witnesses each such
# pixel: its first differing decision lies within SURFEL_FLIP_REL of its
# threshold in a float64 evaluation
SURFEL_BAND_SHARE = 1e-4
SURFEL_BAND_GATE = 1 / 255 + FWD_TOL["atol"]
SURFEL_FLIP_REL = 1e-3


class SurfelBlendSpy:
    """Each surfel blend's packed instance attributes, binning and output
    rows (ops/rasterize2d.py::blend2d) while the spy is on."""

    def __init__(self):
        import gssr_tpu_torch.ops.rasterize2d as mod
        self.mod, self.inner, self.calls = mod, mod.blend2d, []

    def __enter__(self):
        from gssr_tpu_torch.ops.blend2d import pack_instance_attrs_2d

        def blend2d(mean2d, Tmat, normal, color, opacity, binning, width,
                    height):
            maps = self.inner(mean2d, Tmat, normal, color, opacity, binning,
                              width, height)
            attrs = pack_instance_attrs_2d(mean2d, Tmat, normal, color,
                                           opacity, binning)
            self.calls.append((attrs, binning, maps.rows))
            return maps
        self.mod.blend2d = blend2d
        return self

    def __exit__(self, *exc):
        self.mod.blend2d = self.inner


def surfel_pixel_walk(A, px, py, upto=0):
    """The plain surfel forward (ops/blend2d.py) of one tile's instances A
    [LIVE_ATTRS2, n] at pixels px, py [P], in A's dtype, up to the
    instance after which T < T_EPS at every pixel (no later one
    contributes), and at least `upto` instances: per instance and pixel [P, m] the alpha, its value
    before the gate, depth, gate, T before it, contributing and median
    candidate masks; per pixel the blended RGB, T, depth sum and median
    depth (the kernel rows O_RGB, O_T, O_D, O_MED)."""
    from gssr_tpu_torch.ops import blend2d as b2
    from gssr_tpu_torch.ops.blend import T_EPS
    sf = b2._surfel_alpha(A[:, None, :], px[None], py[None])
    a = sf.a[0]
    D, d_before = torch.ones_like(px), []
    for i in range(a.shape[-1]):
        d_before.append(D)
        D = D * (1.0 - a[:, i])          # the kernels' order, one at a time
        if i + 1 >= upto and bool((D < T_EPS).all()):
            break
    d_before = torch.stack(d_before, dim=-1)
    m = d_before.shape[-1]
    a, depth = a[:, :m], sf.depth[0][:, :m]
    contrib = (a > 0.0) & (d_before * (1.0 - a) >= T_EPS)
    w = torch.where(contrib, a * d_before, 0.0)
    med = contrib & (d_before > 0.5)
    last = torch.where(med, torch.arange(1, m + 1), 0).amax(-1)
    med_depth = torch.where(
        last > 0, depth.gather(-1, (last - 1).clamp(min=0)[:, None])[:, 0],
        0.0)
    return dict(a=a, raw=torch.clamp(sf.raw[0][:, :m], max=b2.ALPHA_MAX),
                depth=depth, ok=sf.ok[0][:, :m], d_before=d_before,
                contrib=contrib, med=med, last=last,
                rgb=w @ A[b2.A_RGB:b2.A_RGB + 3, :m].T,
                T=torch.where(contrib, 1.0 - a, 1.0).prod(-1),
                dsum=(w * depth).sum(-1), med_depth=med_depth)


@torch.no_grad()
def surfel_flips(full, band, ty0, tiles_x, pixels):
    """Witness the surfel band pixels past FWD_TOL (`pixels`, (y, x) in
    this rank's band): for each, the full-frame and band instance lists of
    its tile are the same; the plain forward reproduces both kernels'
    rows there (so its decisions are theirs); and the first decision that
    differs between them (a gate, the T_EPS stop or the median's T > 0.5)
    lies within SURFEL_FLIP_REL of its threshold in a float64 evaluation
    of the full-frame instances. Returns (flips by kind, the largest
    float64 relative distance, and per pixel the bounds of the
    median-depth difference, the gap between the two median picks' depths,
    and of the expected depth's, 2 sum(alpha of the flipped) (depth spread)
    / alpha of the pixel)."""
    from collections import defaultdict

    from gssr_tpu_torch.ops import blend2d as b2
    from gssr_tpu_torch.ops.blend import ALPHA_MIN, T_EPS
    from gssr_tpu_torch.ops.projection import TILE
    cpu = torch.device("cpu")
    (A_f, bin_f, rows_f), (A_b, bin_b, rows_b) = full, band
    tiles = defaultdict(list)
    for y, x in pixels:
        tiles[(y // TILE, x // TILE)].append((y, x))
    kinds = {"alpha gate": 0, "near plane": 0, "T_EPS stop": 0,
             "median T > 0.5": 0}
    worst, bounds = 0.0, {}
    for (ty, tx), pix in sorted(tiles.items()):
        runs = []
        for bn, t in ((bin_f, ty * tiles_x + tx),
                      (bin_b, (ty - ty0) * tiles_x + tx)):
            lo, hi = (int(v) for v in bn.tile_ranges[t:t + 2])
            runs.append((slice(lo, hi), torch.where(
                bn.hit[lo:hi] > 0, bn.gauss_id[lo:hi], -1).to(cpu)))
        assert torch.equal(runs[0][1], runs[1][1]), (ty, tx)
        Af = A_f[:b2.LIVE_ATTRS2, runs[0][0]].to(cpu)
        Ab = A_b[:b2.LIVE_ATTRS2, runs[1][0]].to(cpu)
        ys = torch.tensor([y for y, _ in pix], dtype=torch.float32)
        xs = torch.tensor([x for _, x in pix], dtype=torch.float32)
        f = surfel_pixel_walk(Af, xs, ys)
        b = surfel_pixel_walk(Ab, xs, ys - ty0 * TILE)
        f64 = surfel_pixel_walk(Af.double(), xs.double(), ys.double(),
                                upto=max(f["a"].shape[-1], b["a"].shape[-1]))
        for j, (y, x) in enumerate(pix):
            for ev, rows, yy in ((f, rows_f, y), (b, rows_b, y - ty0 * TILE)):
                kern = rows[yy, x].to(cpu)
                got = torch.cat([ev["rgb"][j], ev["T"][j:j + 1],
                                 ev["dsum"][j:j + 1],
                                 ev["med_depth"][j:j + 1]])
                want = torch.cat([kern[b2.O_RGB:b2.O_RGB + 3],
                                  kern[b2.O_T:b2.O_T + 1],
                                  kern[b2.O_D:b2.O_D + 1],
                                  torch.nan_to_num(kern[b2.O_MED:b2.O_MED
                                                        + 1])])
                assert torch.allclose(got, want, **FWD_TOL), (y, x, got, want)
            m = min(f["a"].shape[-1], b["a"].shape[-1])
            differ = ((f["ok"][j, :m] != b["ok"][j, :m])
                      | (f["contrib"][j, :m] != b["contrib"][j, :m])
                      | (f["med"][j, :m] != b["med"][j, :m]))
            assert differ.any(), f"pixel {(y, x)}: no decision differs"
            i = int(differ.nonzero()[0, 0])
            rel = []
            if bool(f["ok"][j, i] != b["ok"][j, i]):
                if (f["raw"][j, i] >= ALPHA_MIN) != (b["raw"][j, i]
                                                     >= ALPHA_MIN):
                    kinds["alpha gate"] += 1
                    rel.append(abs(float(f64["raw"][j, i]) - ALPHA_MIN)
                               / ALPHA_MIN)
                if (f["depth"][j, i] >= b2.NEAR_N) != (b["depth"][j, i]
                                                       >= b2.NEAR_N):
                    kinds["near plane"] += 1
                    rel.append(abs(float(f64["depth"][j, i]) - b2.NEAR_N)
                               / b2.NEAR_N)
            elif bool(f["contrib"][j, i] != b["contrib"][j, i]):
                kinds["T_EPS stop"] += 1
                rel.append(abs(float(f64["d_before"][j, i]
                                     * (1 - f64["a"][j, i])) - T_EPS) / T_EPS)
            else:
                kinds["median T > 0.5"] += 1
                rel.append(abs(float(f64["d_before"][j, i]) - 0.5) / 0.5)
            assert rel and min(rel) <= SURFEL_FLIP_REL, (y, x, i, rel)
            worst = max(worst, min(rel))
            # the bounds of the pixel's depth differences
            picks = [int(ev["last"][j]) - 1 for ev in (f, b)]
            gap = abs(float(f["depth"][j, picks[0]] if picks[0] >= 0 else 0.0)
                      - float(b["depth"][j, picks[1]] if picks[1] >= 0
                              else 0.0))
            flipped = (f["ok"][j, :m] != b["ok"][j, :m]) | (
                f["contrib"][j, :m] != b["contrib"][j, :m])
            amax = torch.maximum(f["a"][j, :m], b["a"][j, :m])
            dep = torch.cat([f["depth"][j][f["contrib"][j]],
                             b["depth"][j][b["contrib"][j]]])
            spread = float(dep.max() - dep.min()) if dep.numel() else 0.0
            alpha = min(1 - float(f["T"][j]), 1 - float(b["T"][j]))
            bounds[(y, x)] = (gap, 2 * float(amax[flipped].sum()) * spread
                              / max(alpha, 1e-6))
    return kinds, worst, bounds


@torch.no_grad()
def par_render_errs(scene, method, cam, par):
    """(max |err|, elements past FWD_TOL) of each map of a banded render
    against the one-device render of the scene's initial state: none past
    it for the vanilla and planar payloads (their band shift of mean2d is
    exact). For the surfel one at most SURFEL_BAND_SHARE of them, its
    image, final_T and normal within SURFEL_BAND_GATE, each such pixel of
    this rank's band witnessed by surfel_flips, and there its median depth
    and surf_depth within their bounds."""
    from gssr_tpu_torch.ops import band as band_ops
    from gssr_tpu_torch.ops.projection import TILE
    from gssr_tpu_torch.ops.rasterize import pad_to_tiles
    st = scene.state
    sh = scene.gaussians.active_sh_degree(STEPS)
    kw = dict(forward_observe=False) if method == "pgsr" else {}
    spy = SurfelBlendSpy() if method == "2dgs" else contextlib.nullcontext()
    with spy:
        one = scene.render_params(st.params, cam, sh, st.active,
                                  scene.background, **kw)
        band = scene.render_params(st.params, cam, sh, st.active,
                                   scene.background, **kw, **par)
    maps = {"3dgs": ("image", "final_T"),
            "2dgs": ("image", "final_T", "normal", "surf_depth",
                     "median_depth"),
            "pgsr": ("image", "final_T", "normal", "plane_depth")}[method]
    errs, past_px = {}, {}
    for k in maps:
        a, b = getattr(band, k), getattr(one, k)
        past = ~torch.isclose(a, b, **FWD_TOL)
        errs[k] = (max_err(a, b), int(past.sum()))
        if method != "2dgs":
            assert errs[k][1] == 0, (method, k, errs[k])
            continue
        assert errs[k][1] <= SURFEL_BAND_SHARE * a.numel(), (k, errs[k])
        if k in ("image", "final_T", "normal"):
            assert errs[k][0] <= SURFEL_BAND_GATE, (k, errs[k])
        if past.ndim == 3:
            past = past.any(-1)
        past_px[k] = {tuple(v) for v in past.nonzero().tolist()}
    if method != "2dgs":
        return errs
    ph = pad_to_tiles(scene.width, scene.height)[1]
    band_ty, ty0 = band_ops.band_rows(ph, par["band_rank"],
                                      par["band_count"])
    mine = {(y, x) for s_ in past_px.values() for y, x in s_
            if ty0 * TILE <= y < (ty0 + band_ty) * TILE}
    kinds, worst, bounds = surfel_flips(
        spy.calls[0], spy.calls[1], ty0,
        pad_to_tiles(scene.width, scene.height)[0] // TILE, sorted(mine))
    for k, col in (("median_depth", 0), ("surf_depth", 1)):
        d = (getattr(band, k) - getattr(one, k)).abs()
        for y, x in past_px[k] & mine:
            lim = bounds[(y, x)][col] + FWD_TOL["atol"] \
                + FWD_TOL["rtol"] * abs(float(getattr(one, k)[y, x]))
            assert float(d[y, x]) <= lim, (k, y, x, float(d[y, x]), lim)
    errs["witness"] = (worst, len(mine), kinds)
    return errs


def par_grad_errs(spy, ref, rows=None, world=1):
    """max |err| of each merged gradient and screen-space input of `spy`
    against the one-device `ref`'s; under gshard (`rows`: this rank's
    slice of the capacity axis, one of `world`) against the slice of each
    capacity-axis leaf, the replicated MLP whole. Asserts the gradient
    tolerance, and equal observe counts."""
    def mine(want, got):
        if rows is None:
            return want
        n = rows.stop - rows.start
        return want.reshape(n * world, -1)[rows].reshape(got.shape)
    errs = {}
    for group, grads in ref.grads.items():
        for k, want in grads.items():
            got = spy.grads[group][k]
            if group != "mlp":
                want = mine(want, got)
            errs[f"{group}.{k}"], ok = grads_close(got, want)
            assert ok, (group, k, errs[f"{group}.{k}"])
    for k, want in ref.screen.items():
        got = spy.screen[k]
        want = mine(want, got)
        if k == "observe":
            assert torch.equal(got, want), "observe counts differ"
            errs[k] = 0.0
        else:
            errs[k], ok = grads_close(got, want)
            assert ok, (k, errs[k])
    return errs


class CollectiveClock:
    """Host time and bytes of every all_reduce and all-gather (the bytes
    of the reduced or gathered tensor) while it is on, each call
    synchronised on both sides so that the time is the collective's."""
    NAMES = ("all_reduce", "all_gather_into_tensor")

    def __init__(self, dev):
        import torch.distributed as dist
        self.dist, self.dev = dist, dev
        self.inner = {k: getattr(dist, k) for k in self.NAMES}
        self.ms = self.bytes = 0.0
        self.calls = 0

    def __enter__(self):
        def timed(fn):
            def call(t, *a, **kw):
                sync(self.dev)
                t0 = time.perf_counter()
                out = fn(t, *a, **kw)
                sync(self.dev)
                self.ms += 1e3 * (time.perf_counter() - t0)
                self.bytes += t.numel() * t.element_size()
                self.calls += 1
                return out
            return call
        for k, fn in self.inner.items():
            setattr(self.dist, k, timed(fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self.inner.items():
            setattr(self.dist, k, fn)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def par_train(scene, mode, step0, steps, dev, rank, world):
    """`steps` train steps of the scene in `mode` from its initial state
    (dp: one camera per rank from the shared sequence), then one more
    under the CollectiveClock: (step ms, collective ms, MiB and calls of
    that step)."""
    scene.setup_parallel(mode)
    state = scene.step_state(scene.state)
    times = []
    for step in range(step0, step0 + steps + 1):
        cams = [scene.dataloader.next_train()
                for _ in range(world if mode == "dp" else 1)]
        cam = cams if mode == "dp" else cams[0]
        sync(dev)
        t0 = time.perf_counter()
        if step == step0 + steps:
            with CollectiveClock(dev) as clock:
                state, m = scene.train_step(state, cam, step)
        else:
            state, m = scene.train_step(state, cam, step)
        state = scene.train_densify(state, step)
        sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
        assert math.isfinite(float(m["loss"])), (mode, step)
    return times[:-1], clock.ms, clock.bytes / 2**20, clock.calls


def parallel_rank(scene_dir, out_dir, device_type, steps):
    """One rank of the two-rank phase (a process that spawn started, in a
    gloo group whose ranks share the card): every check against this
    process's own one-device computation, then `steps` steps of each
    training run. Returns errors, counts, times and peak memory; rank 0
    prints each stage's seconds."""
    from gssr_tpu_torch.parallel import comm
    dev = torch.device(device_type)
    rank, world = comm.rank(), comm.world()
    t0 = time.perf_counter()

    def stage(what):
        if rank == 0:
            print(f"[parallel] rank 0: {what} at "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    assert comm.backend() == "gloo" and world == PAR_RANKS
    if dev.type == "cuda":
        assert torch.cuda.current_device() == 0      # the ranks share it
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = {"rank": rank, "errs": {}, "train": {}, "active": {}}
    out = f"{out_dir}/rank{rank}"
    scenes = {m: par_build(m, scene_dir, out, dev) for m in PAR_METHODS}
    # gshard splits the capacity axis into contiguous halves; at the
    # presets' capacity (8x the points) every active row lies in rank 0's
    # half, so gshard runs a capacity that just holds the initial model
    # (its rows rounded up to 128 per rank): both ranks hold active rows
    for m in ("3dgs", "octree-2dgs"):
        unit = 128 * world
        cap = -(-int(scenes[m].state.n_active) // unit) * unit
        scenes[f"{m} gshard"] = par_build(m, scene_dir, out, dev, cap)
    assert all(s.device.type == device_type for s in scenes.values())
    stage("scenes built")
    band = {"band_rank": rank, "band_count": world}
    modes = {"3dgs": ("dp", "band"), "2dgs": ("band",), "pgsr": ("band",),
             "octree-2dgs": ("band",), "3dgs gshard": ("gshard",),
             "octree-2dgs gshard": ("gshard",)}
    for key, scene in scenes.items():
        method = key.split()[0]
        step = {"pgsr": MULTI_VIEW_FROM + 1, "octree-2dgs": 3}.get(method, 1)
        cam = scene.dataloader.train_cameras[0]
        if key in ("3dgs", "2dgs", "pgsr"):
            res["errs"][f"{method} band maps"] = par_render_errs(
                scene, method, cam.arrays(dev), band)
        ref, _, one, _ = par_step(scene, "none", cam, step)
        if method == "pgsr":
            assert ref.screen["observe"].max() > 0
        for mode in modes[key]:
            spy, metrics, state, state0 = par_step(scene, mode, cam, step)
            assert math.isfinite(float(metrics["loss"]))
            if mode == "dp":
                # the same camera on both ranks: the mean of equal
                # gradients is each of them; each rank's statistics delta
                # adds (the camera counts twice)
                e = max_err(state.params["xyz"], one.params["xyz"])
                assert e <= 1e-5, e
                assert torch.equal(state.stats["denom"],
                                   2 * one.stats["denom"])
                res["errs"]["3dgs dp"] = {"xyz": e, "denom x2": 0.0}
                continue
            rows = None
            if mode == "gshard":
                n = state0.active.shape[0]
                rows = slice(rank * n, (rank + 1) * n)
                res["active"][method] = (int(state0.active.sum()), n)
            res["errs"][f"{method} {mode}"] = par_grad_errs(spy, ref, rows,
                                                            world)
            if method == "octree-2dgs" and mode == "gshard":
                visible, _, _ = scene.visible_anchors(
                    state0, cam.arrays(dev), step)
                res["n_visible"] = int((visible & state0.active).sum())
        stage(f"{key} checked")
    for method, mode, step0 in PAR_TRAIN:
        scene = scenes[f"{method} gshard" if mode == "gshard" else method]
        res["train"][f"{method} {mode}"] = par_train(
            scene, mode, step0, steps, dev, rank, world)
        stage(f"{method} {mode} trained")
    res["launches"] = read_counts()
    if dev.type == "cuda":
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def phase_parallel(root, dev, card_line):
    """The multi-device modes on the written scene: the one-rank NCCL run
    through the CLI against a one-device run, then two ranks sharing the
    card over gloo (parallel_rank)."""
    from gssr_tpu_torch import train
    from gssr_tpu_torch.configs.cli import parse_config
    from gssr_tpu_torch.parallel.launch import backend_for, spawn
    tag = "[parallel]"
    scene_dir = os.path.join(root, "scene")
    args = ["3dgs", "--source-path", scene_dir, "--output-path",
            os.path.join(root, "par_out"), "--machine.device", dev.type,
            "--trainer.iterations", str(PAR_STEPS),
            "--trainer.log-interval", "1", *SH_ARGS]

    # 1. one rank through the CLI, in a subprocess: NCCL on the card
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-c", _NCCL_RUN, *args, "--machine.parallel", "dp",
         "--machine.num-devices", "1"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    sub_s = time.perf_counter() - t0
    line = [x for x in p.stdout.splitlines() if x.startswith("multi-device")]
    want = f"over 1 ranks, backend {backend_for(dev.type)}"
    assert len(line) == 1 and want in line[0], p.stdout[-4000:]
    losses = json.loads([x for x in p.stdout.splitlines()
                         if x.startswith("LOSSES ")][0][len("LOSSES "):])
    single = [h[1] for h in train.main(parse_config(args)).history]
    # a mean over one rank is the value itself: bit for bit (tolerance 0)
    assert losses == single, (losses, single)
    print(f"{tag} one rank through the CLI (`--machine.parallel dp "
          f"--machine.num-devices 1`): {line[0]}; its {PAR_STEPS} losses "
          f"equal the one-device run's bit for bit (tolerance 0): "
          f"{[round(x, 6) for x in losses]}; {sub_s:.1f} s in its "
          f"subprocess  | {card_line}", flush=True)

    # 2. two ranks sharing the card over gloo
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root) as store:
        out = spawn(parallel_rank, PAR_RANKS, "gloo", dev.type, store,
                    (scene_dir, os.path.join(root, "par_ranks"), dev.type,
                     PAR_STEPS))
    spawn_s = time.perf_counter() - t0
    assert [r["rank"] for r in out] == list(range(PAR_RANKS))
    for r in out:
        for k in PAR_KERNELS:
            assert r["launches"][k] > 0, (r["rank"], k, r["launches"])
        for case, errs in r["errs"].items():
            wit = errs.pop("witness", None)
            print(f"{tag} rank {r['rank']} {case}: max|err| " + ", ".join(
                f"{k} {v:.3e}" if not isinstance(v, tuple) else
                f"{k} {v[0]:.3e} ({v[1]} past tolerance)"
                for k, v in errs.items()))
            if wit is not None:
                print(f"{tag} rank {r['rank']} {case}: {wit[1]} pixels of "
                      f"its band past tolerance, each witnessed: the first "
                      f"decision that differs, by kind {wit[2]}, lies within "
                      f"{wit[0]:.3e} of its threshold (relative, float64; "
                      f"bound {SURFEL_FLIP_REL}); median depth within the "
                      f"depth gap of the two picks, surf_depth within 2 "
                      f"sum(flipped alpha) x depth spread / alpha")
    n_vis = [r["n_visible"] for r in out]
    assert len(set(n_vis)) > 1, n_vis
    for m in ("3dgs", "octree-2dgs"):
        act = [r["active"][m] for r in out]
        assert all(a > 0 for a, _ in act), (m, act)
        print(f"{tag} {m} gshard: active rows of each rank's "
              f"{act[0][1]} {[a for a, _ in act]}")
    print(f"{tag} tolerances: maps atol {FWD_TOL['atol']} rtol "
          f"{FWD_TOL['rtol']} (2dgs: at most {SURFEL_BAND_SHARE} of a map "
          f"past it, its image, final_T and normal within "
          f"{SURFEL_BAND_GATE:.5f}); gradients rtol {BWD_TOL['rtol']}, atol "
          f"{BWD_TOL['atol']} or {BWD_TOL['rtol']} of the leaf's largest "
          f"magnitude; observe counts exact; dp xyz atol 1e-5, denom x2 "
          f"exact. octree-2dgs gshard visible anchors per rank {n_vis} "
          f"(the gather padded to the larger)")
    for case in out[0]["train"]:
        step_ms = [statistics.median(r["train"][case][0]) for r in out]
        coll = out[0]["train"][case][1:]
        print(f"{tag} {case}: median step {step_ms[0]:.2f} / "
              f"{step_ms[1]:.2f} ms (rank 0 / 1) over {PAR_STEPS} steps: "
              f"two ranks sharing one card: not a scaling figure; one "
              f"step's collectives {coll[2]}, {coll[1]:.1f} MiB, "
              f"{coll[0]:.1f} ms (gloo, through the host)  | {card_line}",
              flush=True)
    print(f"{tag} peak memory per rank: "
          + ", ".join(f"{r.get('peak_gib', float('nan')):.2f} GiB"
                      for r in out)
          + f"; launches per rank "
          f"{[{k: r['launches'][k] for k in PAR_KERNELS} for r in out]}; "
          f"the two "
          f"ranks in {spawn_s:.1f} s  | {card_line}", flush=True)


def split_tiles_run(argv, dev):
    """train_split with `argv` on this rank of the group that is up (a
    rank of the two-rank phase): the tiles trained and skipped, and per
    trained tile its step times, the peak memory above what the rank held
    at the tile's start, its losses and its kernel launches."""
    from gssr_tpu_torch import train, train_split
    cuda = dev.type == "cuda"
    tiles = {}

    def tile(config):
        sync(dev)
        start = torch.cuda.memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        trainer = train.main(config)
        sync(dev)
        hist = trainer.history
        assert len(hist) == PAR_STEPS and \
            all(math.isfinite(h[1]) for h in hist), hist
        peak = torch.cuda.max_memory_allocated() if cuda else start
        tiles[os.path.basename(config.source_path)] = dict(
            step_ms=[1e3 * (b[3] - a[3]) for a, b in zip(hist, hist[1:])],
            peak_gib=(peak - start) / 2**30, losses=[h[1] for h in hist],
            launches=read_counts())
    trained, skipped = train_split.main(argv, train_tile=tile)
    return trained, skipped, tiles


def split_rank(split, runs, device_type):
    """One rank of the two-rank train_split check: band, then band again
    (every tile done), then gshard and gshard again, all in this group."""
    from gssr_tpu_torch.parallel import comm
    assert comm.backend() == "gloo" and comm.world() == PAR_RANKS
    out = {"rank": comm.rank()}
    for mode in ("band", "gshard"):
        argv = split_args(split, os.path.join(runs, mode), PAR_STEPS) + [
            "--machine.device", device_type, "--machine.parallel", mode,
            "--machine.num-devices", str(PAR_RANKS)]
        dev = torch.device(device_type)
        out[mode] = split_tiles_run(argv, dev)
        out[f"{mode} again"] = split_tiles_run(argv, dev)
    return out


def phase_parallel_split(root, dev, card_line):
    """train_split over several devices per tile, on the split phase's two
    tiles: one rank through the CLI in a subprocess (NCCL), its losses
    against an in-process one-device train_split, bit for bit; then two
    ranks sharing the card over gloo in band and in gshard, each training
    both tiles, rank 0 writing each tile's run once, and a second call
    skipping both tiles on both ranks."""
    from gssr_tpu_torch import train, train_split
    from gssr_tpu_torch.parallel.launch import backend_for, spawn
    tag = "[parallel split]"
    split = os.path.join(root, "split")
    tiles = sorted(os.path.basename(t) for t in
                   glob.glob(os.path.join(split, "tile_*")))
    assert len(tiles) == 2, tiles
    # every run below reads the points3D.ply that the split phase's first
    # read of each tile wrote (from points3D.bin's float64 points): the
    # same initial state in every process
    for t in tiles:
        assert os.path.exists(os.path.join(split, t, "sparse/0/points3D.ply"))

    # 1. one rank through the CLI, in a subprocess: NCCL on the card
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-c", _NCCL_SPLIT,
         *split_args(split, os.path.join(root, "par_split_nccl"), PAR_STEPS),
         "--machine.device", dev.type, "--machine.parallel", "band",
         "--machine.num-devices", "1"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    sub_s = time.perf_counter() - t0
    lines = p.stdout.splitlines()
    up = [x for x in lines if x.startswith("multi-device")]
    want = f"mode=band over 1 ranks, backend {backend_for(dev.type)}"
    assert len(up) == 2 and all(want in x for x in up), p.stdout[-4000:]
    got = json.loads([x for x in lines if x.startswith("TILE_LOSSES ")][0]
                     [len("TILE_LOSSES "):])
    single = {}

    def tile(config):
        trainer = train.main(config)
        single[os.path.basename(config.source_path)] = [
            h[1] for h in trainer.history]
    train_split.main(split_args(split, os.path.join(root, "par_split_one"),
                                PAR_STEPS), train_tile=tile)
    assert sorted(got) == tiles and len(got[tiles[0]]) == PAR_STEPS
    # a band of the whole frame and a mean over one rank: bit for bit
    assert got == single, (got, single)
    for t in tiles:
        print(f"{tag} one rank through the CLI (`train_split "
              f"{SPLIT_METHOD} --machine.parallel band --machine.num-devices "
              f"1`, NCCL): {t}'s {PAR_STEPS} losses equal the one-device "
              f"train_split's bit for bit (tolerance 0): "
              f"{[round(x, 6) for x in got[t]]}", flush=True)
    print(f"{tag} the one-rank sweep took {sub_s:.1f} s in its subprocess"
          f"  | {card_line}", flush=True)

    # 2. two ranks sharing the card over gloo
    runs = os.path.join(root, "par_split_ranks")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root) as store:
        out = spawn(split_rank, PAR_RANKS, "gloo", dev.type, store,
                    (split, runs, dev.type))
    spawn_s = time.perf_counter() - t0
    assert [r["rank"] for r in out] == list(range(PAR_RANKS))
    paths = [os.path.join(split, t) for t in tiles]
    for mode in ("band", "gshard"):
        for r in out:
            trained, skipped, per_tile = r[mode]
            assert (trained, skipped) == (paths, []), (mode, r[mode][:2])
            assert r[f"{mode} again"] == ([], paths, {}), \
                (mode, r[f"{mode} again"][:2])
            for t in tiles:
                launches = per_tile[t]["launches"]
                assert all(launches[k] >= PAR_STEPS
                           for k in PAR_SPLIT_KERNELS), \
                    (mode, r["rank"], t, launches)
        # rank 0 alone wrote each tile's run, once
        for name in ("config.yml", "DONE"):
            found = sorted(glob.glob(os.path.join(
                runs, mode, "*", "tile_*", SPLIT_METHOD, "*", name)))
            assert [f.split(os.sep)[-4] for f in found] == tiles, found
        for t in tiles:
            ranks_ms = [statistics.median(r[mode][2][t]["step_ms"])
                        for r in out]
            peaks = [r[mode][2][t]["peak_gib"] for r in out]
            launches = [{k: r[mode][2][t]["launches"][k]
                         for k in SURFEL_PAIR} for r in out]
            losses = [round(x, 6) for x in out[0][mode][2][t]["losses"]]
            print(f"{tag} {mode} {t}: median step "
                  + " / ".join(f"{x:.2f}" for x in ranks_ms)
                  + f" ms (rank 0 / 1) over its steps 2-{PAR_STEPS}, peak "
                  "memory " + " / ".join(f"{x:.2f}" for x in peaks)
                  + " GiB above each rank's start: two ranks sharing one "
                  f"card over gloo, not a scaling figure; surfel launches "
                  f"per rank {launches}; losses {losses}  | {card_line}",
                  flush=True)
        print(f"{tag} {mode}: both ranks trained both tiles, rank 0 wrote "
              f"each tile's run once (one config.yml, one DONE); the "
              f"second call skipped both tiles on both ranks", flush=True)
    print(f"{tag} the two ranks in {spawn_s:.1f} s  | {card_line}",
          flush=True)


# ---------------------------------------------------------------------------
# convergence: the port's first long run, held against gssr_tpu's records
# ---------------------------------------------------------------------------

# gssr_tpu's "structured-v1" scene (benchmarks/convergence.py): 54 orbit
# cameras at 400 x 304, 2,400 steps, an eval every 150 steps
CONV_WIDTH, CONV_HEIGHT = 400, 304
CONV_CAMS = 54
CONV_STEPS = 2400
CONV_EVAL_EVERY = 150
CONV_LAST_EVALS = (2100, 2250, 2400)
# gssr_tpu's records (benchmarks/results/convergence_r5.json): eval PSNR at
# CONV_LAST_EVALS, TSDF f1@0.05 and the saved PLY's vertex count (anchors;
# gaussians)
CONV_RECORD = {
    "octree-2dgs": ((34.8612, 35.3151, 36.3022), 0.8166736535922875, 4676),
    "pgsr": ((39.0633, 38.8956, 39.0504), 0.7365097790861876, 25841)}
# the bounds: the mean PSNR over CONV_LAST_EVALS at most this far below
# the record's mean, f1@0.05 at most this far below the record's
CONV_PSNR_BELOW = 1.0
CONV_F1_BELOW = 0.05
# benchmarks/convergence.py's run_method and METHOD_ARGS (its
# --scene.instance-cap dropped: the port sizes each render exactly) and
# eval_mesh's extraction flags and scoring
CONV_ARGS = {"octree-2dgs": ["--scene.gaussians.capacity", "65536"],
             "pgsr": ["--scene.gaussians.capacity", "262144",
                      "--scene.multi-view-from", str(CONV_STEPS // 2)]}
CONV_MESH_ARGS = ["--skip-images", "--voxel-size", "0.02", "--sdf-trunc",
                  "0.08", "--depth-trunc", "8.0", "--num-cluster", "0"]
CONV_SAMPLES = 200_000
CONV_TAUS = (0.03, 0.05)


def make_structured_scene(rng):
    """Ground plane + 3 spheres + a box, surfaced with small gaussians: a
    copy of benchmarks/convergence.py::make_structured_scene (the same
    draws from `rng`, bit for bit).

    Returns (means [N,3], colors [N,3], scales [N])."""
    means, cols, scales = [], [], []

    # checkered ground plane at y=+0.9 (cameras look down slightly)
    n_side = 110
    xs = np.linspace(-2.6, 2.6, n_side)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    gy = np.full_like(gx, 0.9)
    p = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    check = ((np.floor(gx * 2) + np.floor(gz * 2)) % 2).reshape(-1)
    c = np.where(check[:, None] > 0.5,
                 np.array([[0.85, 0.8, 0.7]]), np.array([[0.25, 0.3, 0.4]]))
    means.append(p + rng.normal(0, 0.004, p.shape))
    cols.append(c)
    scales.append(np.full(len(p), 0.030))

    def sphere(center, radius, n, color_fn):
        i = np.arange(n)
        phi = math.pi * (3.0 - math.sqrt(5.0)) * i   # fibonacci sphere
        y = 1 - 2 * (i + 0.5) / n
        r = np.sqrt(1 - y * y)
        d = np.stack([np.cos(phi) * r, y, np.sin(phi) * r], -1)
        p = center + radius * d
        means.append(p)
        cols.append(color_fn(d))
        scales.append(np.full(n, radius * 3.2 / math.sqrt(n)))

    sphere(np.array([0.0, 0.25, 0.0]), 0.65, 6000,
           lambda d: 0.5 + 0.45 * np.stack([np.sin(9 * d[:, 0]),
                                            np.sin(9 * d[:, 1]),
                                            np.sin(9 * d[:, 2])], -1))
    sphere(np.array([-1.3, 0.45, 0.8]), 0.45, 3500,
           lambda d: np.where((np.floor(6 * np.arccos(d[:, 1]) /
                                        math.pi) % 2)[:, None] > 0.5,
                              np.array([[0.9, 0.35, 0.2]]),
                              np.array([[0.95, 0.9, 0.85]])))
    sphere(np.array([1.2, 0.55, -0.7]), 0.35, 2500,
           lambda d: 0.5 + 0.5 * np.stack([d[:, 0] * 0, d[:, 1],
                                           -d[:, 1]], -1) * 0.8)

    # axis-aligned box
    n_face = 900
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            uv = rng.uniform(-0.35, 0.35, (n_face, 2))
            p = np.zeros((n_face, 3))
            other = [a for a in range(3) if a != axis]
            p[:, other[0]] = uv[:, 0]
            p[:, other[1]] = uv[:, 1]
            p[:, axis] = 0.35 * sgn
            p += np.array([0.9, 0.5, 1.1])
            means.append(p)
            stripe = (np.floor((uv[:, 0] + uv[:, 1]) * 7) % 2)[:, None]
            cols.append(np.where(stripe > 0.5, np.array([[0.2, 0.7, 0.3]]),
                                 np.array([[0.95, 0.85, 0.3]])))
            scales.append(np.full(n_face, 0.032))

    means = np.concatenate(means)
    cols = np.clip(np.concatenate(cols), 0.0, 1.0)
    scales = np.concatenate(scales)
    return means, cols, scales


def orbit_cameras(n, width, height):
    """benchmarks/convergence.py::orbit_cameras on the port's Camera: n
    cameras on three loops around the scene, looking at its centre."""
    from gssr_tpu_torch.cameras import Camera
    cams = []
    for i in range(n):
        ang = 2 * math.pi * i / n * 3.0          # 3 loops
        radius = 3.6 + 0.6 * math.sin(i * 0.7)
        elev = 0.8 + 0.8 * (i % 5) / 4.0          # heights above scene
        pos = np.array([radius * math.sin(ang), -elev,
                        -radius * math.cos(ang)])
        target = np.array([0.0, 0.45, 0.0])
        fwd = target - pos
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        true_up = np.cross(fwd, right)
        R_w2c = np.stack([right, true_up, fwd])
        t = -R_w2c @ pos
        cams.append(Camera(uid=i, colmap_id=i, image_name=f"cam{i:03d}",
                           R=R_w2c.T, T=t, fovx=math.radians(62),
                           fovy=math.radians(62 * height / width),
                           width=width, height=height))
    return cams


def structured_gaussians(means, cols, scales, dev):
    """The GT gaussians of benchmarks/convergence.py::build_scene_dir:
    isotropic scales, identity rotations, opacity 0.92, float32."""
    n = len(means)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return dict(means=f32(means), scales=f32(np.stack([scales] * 3, -1)),
                rots=f32(np.tile([[1.0, 0, 0, 0]], (n, 1))),
                opacity=f32(np.full(n, 0.92)), colors=f32(cols))


@torch.no_grad()
def render_structured(g, cam, width, height, dev) -> np.ndarray:
    """A GT view [H, W, 3] of structured_gaussians on a black background,
    through the port's rasterize (on the card, the vanilla forward
    kernel)."""
    from gssr_tpu_torch.ops.rasterize import rasterize
    return rasterize(g["means"], g["scales"], g["rots"], g["opacity"],
                     cam.arrays(dev), width, height,
                     torch.zeros(3, device=dev),
                     colors_precomp=g["colors"]).image.cpu().numpy()


def build_structured_scene(root, dev, width=CONV_WIDTH, height=CONV_HEIGHT,
                           n_cams=CONV_CAMS, gt_sub=1, seed=0):
    """benchmarks/convergence.py::build_scene_dir on the port: the
    structured scene's GT views rendered by render_structured and written
    with the port's dataio/colmap.py, beside a sparse init of 1/12 of the
    GT means jittered by 0.02 (at least 512), which every image observes.
    gt_sub > 1 thins the scene (its splats fattened by sqrt(gt_sub)).
    Returns the number of GT gaussians."""
    from PIL import Image

    from gssr_tpu_torch.dataio.colmap import (
        ColmapCamera,
        ColmapImage,
        ColmapPoint3D,
        rotmat_to_qvec,
        write_model,
    )
    rng = np.random.default_rng(seed)
    means, cols, scales = make_structured_scene(rng)
    if gt_sub > 1:
        means, cols = means[::gt_sub], cols[::gt_sub]
        scales = scales[::gt_sub] * math.sqrt(gt_sub)
    n = len(means)
    cams = orbit_cameras(n_cams, width, height)
    g = structured_gaussians(means, cols, scales, dev)
    os.makedirs(os.path.join(root, "sparse/0"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    fx = cams[0].fx
    ccams = {1: ColmapCamera(1, "PINHOLE", width, height,
                             np.array([fx, cams[0].fy, width / 2,
                                       height / 2]))}
    sel = rng.choice(n, size=max(n // 12, 512), replace=False)
    pts = means[sel] + rng.normal(0, 0.02, (len(sel), 3))
    pcols = cols[sel]
    images = {}
    for i, c in enumerate(cams):
        img = render_structured(g, c, width, height, dev)
        img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        name = f"{c.image_name}.png"
        Image.fromarray(img8).save(os.path.join(root, "images", name))
        pids = np.arange(1, len(pts) + 1, dtype=np.int64)
        images[i + 1] = ColmapImage(i + 1, rotmat_to_qvec(c.R.T), c.T, 1,
                                    name, np.zeros((len(pts), 2)), pids)
    pts3d = {j + 1: ColmapPoint3D(
        j + 1, pts[j], (pcols[j] * 255).astype(np.uint8), 0.1,
        np.arange(1, len(cams) + 1, dtype=np.int32),
        np.full(len(cams), j, dtype=np.int32)) for j in range(len(pts))}
    write_model(ccams, images, pts3d, os.path.join(root, "sparse/0"))
    return n


def ply_vertex_count(path) -> int:
    with open(path, "rb") as f:
        for _ in range(32):
            line = f.readline().decode("ascii", "ignore")
            if line.startswith("element vertex"):
                return int(line.split()[-1])
    raise ValueError(f"no vertex count in {path}")


def conv_run(method, scene_dir, out, truth, dev, card_line,
             steps=CONV_STEPS, every=CONV_EVAL_EVERY,
             last=CONV_LAST_EVALS):
    """`method` trained `steps` steps on the structured scene through its
    CLI entry point with benchmarks/convergence.py's run_method flags, then
    meshed and scored as its eval_mesh does: the numbers compared with the
    record."""
    import gc

    from gssr_tpu_torch import extract_mesh, train
    from gssr_tpu_torch.configs.cli import parse_config
    from gssr_tpu_torch.utils.mesh_eval import (
        point_cloud_metrics,
        sample_points_on_mesh,
    )
    from gssr_tpu_torch.utils.mesh_extract import read_mesh_ply
    tag = f"[convergence {method}]"
    evals = list(range(every, steps + 1, every))
    args = [method, "--source-path", scene_dir, "--output-path", out,
            "--eval", "true", "--trainer.iterations", str(steps),
            "--trainer.test-iterations", ",".join(map(str, evals)),
            "--trainer.save-iterations", str(steps),
            "--trainer.log-interval", "50",
            "--scene.gaussians.densify-until-iter", str(steps // 2),
            "--scene.gaussians.position-lr-max-steps", str(steps),
            *CONV_ARGS[method]]
    pair = PATH_KERNELS[method]
    reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    trainer = train.main(parse_config(args))
    sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    assert all(launches[k] >= steps for k in pair), launches
    psnr = {s: trainer.evals[s]["eval_psnr"] for s in evals}
    assert all(math.isfinite(v) for v in psnr.values()), psnr
    base = trainer.config.get_base_dir()
    ply = base / "point_cloud" / f"iteration_{steps}" / "point_cloud.ply"
    res = dict(wall=wall, psnr=psnr,
               n_active=int(trainer.scene.state.n_active),
               ply_vertices=ply_vertex_count(ply),
               n_test=len(trainer.scene.dataloader.test_cameras),
               n_train=len(trainer.scene.dataloader.train_cameras),
               launches={k: launches[k] for k in pair},
               anchor_log=list(getattr(trainer.scene, "anchor_log", [])))
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    mesh = extract_mesh.main(["--load-config", str(base / "config.yml"),
                              *CONV_MESH_ARGS])
    res["mesh_s"] = time.perf_counter() - t0
    assert read_counts()[pair[0]] >= res["n_train"], read_counts()
    verts, faces = read_mesh_ply(mesh["mesh_path"])
    assert len(verts) > 0 and len(faces) > 0 and np.isfinite(verts).all()
    pred = sample_points_on_mesh(verts, faces, CONV_SAMPLES, 0)
    res["mesh"] = point_cloud_metrics(pred, truth, taus=CONV_TAUS)
    res["verts"] = len(verts)
    res["psnr_last"] = statistics.mean(psnr[s] for s in last)
    curve = ", ".join(f"{s}: {psnr[s]:.3f}" for s in evals)
    print(f"{tag} {steps} steps on {res['n_train']} train cameras in "
          f"{wall:.1f} s (evals and save included); eval PSNR over "
          f"{res['n_test']} test cameras at steps {curve}; final n_active "
          f"{res['n_active']}, saved PLY {res['ply_vertices']} vertices; "
          f"anchor passes (step, grown) {[e[:2] for e in res['anchor_log']]}"
          f"; launches {res['launches']}  | {card_line}", flush=True)
    m = res["mesh"]
    print(f"{tag} mesh {res['verts']} vertices in {res['mesh_s']:.1f} s "
          f"(render {mesh['seconds']['render']:.2f}, fusion "
          f"{mesh['seconds']['fusion']:.2f}, marching tetrahedra "
          f"{mesh['seconds']['mtet']:.2f} s); chamfer {m['chamfer']:.4f}, "
          + ", ".join(f"{k} {m[k]:.4f}" for k in sorted(m)
                      if "@" in k) + f"  | {card_line}", flush=True)
    return res


def phase_convergence(root, dev, card_line):
    """The structured scene built on the card, octree-2dgs and pgsr
    trained CONV_STEPS steps each and meshed, each held against gssr_tpu's
    record: the mean eval PSNR over CONV_LAST_EVALS at most
    CONV_PSNR_BELOW dB below the record's, f1@0.05 at most CONV_F1_BELOW
    below. Every number is printed before any bound is asserted."""
    tag = "[convergence]"
    scene_dir = os.path.join(root, "structured")
    reset_counts()
    t0 = time.perf_counter()
    n = build_structured_scene(scene_dir, dev)
    launches = read_counts()
    assert launches["blend_fwd"] >= CONV_CAMS, launches
    print(f"{tag} structured scene: {n} GT gaussians, {CONV_CAMS} views at "
          f"{CONV_WIDTH}x{CONV_HEIGHT} rendered in "
          f"{time.perf_counter() - t0:.1f} s; launches "
          f"{{'blend_fwd': {launches['blend_fwd']}}}", flush=True)
    truth = make_structured_scene(np.random.default_rng(0))[0]
    out = os.path.join(root, "conv_runs")
    results = {m: conv_run(m, scene_dir, out, truth, dev, card_line)
               for m in CONV_RECORD}
    misses = []
    for method, r in results.items():
        ref_psnr, ref_f1, ref_n = CONV_RECORD[method]
        want = statistics.mean(ref_psnr)
        f1 = r["mesh"]["f1@0.05"]
        ok_psnr = r["psnr_last"] >= want - CONV_PSNR_BELOW
        ok_f1 = f1 >= ref_f1 - CONV_F1_BELOW
        print(f"{tag} {method}: mean eval PSNR over steps "
              f"{list(CONV_LAST_EVALS)} {r['psnr_last']:.3f} dB against the "
              f"record's {want:.3f} (bound: at least "
              f"{want - CONV_PSNR_BELOW:.3f}): "
              f"{'within' if ok_psnr else 'MISS'}; f1@0.05 {f1:.4f} against "
              f"{ref_f1:.4f} (bound: at least {ref_f1 - CONV_F1_BELOW:.4f}):"
              f" {'within' if ok_f1 else 'MISS'}; saved PLY "
              f"{r['ply_vertices']} vertices against the record's {ref_n}; "
              f"{r['wall']:.1f} s of training, {r['mesh_s']:.1f} s of "
              f"meshing  | {card_line}", flush=True)
        if not ok_psnr:
            misses.append(f"{method} PSNR {r['psnr_last']:.3f}")
        if not ok_f1:
            misses.append(f"{method} f1@0.05 {f1:.4f}")
    assert not misses, misses


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
               nbytes, yard=None):
    """The kernel's row of the {"kernels": [...]} line; plain_ms is the
    plain version's time (timed). With --yardstick (`yard`), fn is timed
    in turns with the parent's build (parent, new, new, parent) and the
    row gains "parent_ms"."""
    bound_ms, bound_by = bound(ops, nbytes)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err}
    row["ms"], parent_ms = kernel_ms(fn, yard)
    if parent_ms is not None:
        row["parent_ms"] = parent_ms
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


def assert_backward(d_k, d_p, rows, live, again):
    """A backward kernel's result d_k against the plain version's d_p as a
    whole and row by row (the gradient rows `rows`), rows from `live` on
    zero, and bit for bit on a second run (again)."""
    torch.testing.assert_close(d_k, d_p, **BWD_TOL)
    assert_rows_close(d_k, d_p, rows)
    assert_zero_rows(d_k, live)
    assert torch.equal(d_k, again()), "a backward is not deterministic"


def assert_surfel_forward(out_k, out_p, sel):
    """The surfel forward kernel's maps out_k against the plain version's
    out_p, the median's sorted position (channel `sel`) exactly."""
    torch.testing.assert_close(out_k, out_p, **FWD_TOL)
    assert torch.equal(out_k[..., sel], out_p[..., sel])


def phase_report(trainer, launches, dev, yard=None):
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
                        launches, yard)


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
        base = row.get("parent_ms")
        print(f"{tag} {row['name']}: max|err| {row['max_abs_err']:.3e}, "
              f"{row['ms']:.4f} ms"
              + (f" (parent {base:.4f} ms)" if base is not None else "")
              + f", bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"plain {row['plain_ms']:.1f} ms, {row['launches']} launches "
              f"on the path  | {card_line}", flush=True)


def phase_report_scaffold(trainer, launches, dev, card_line, yard=None):
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
    print_rows(tag, vanilla_pair(tag, scene, cam_h, cam, inputs, launches,
                                 yard), card_line)


def vanilla_pair(tag, scene, cam_h, cam, inputs, launches, yard=None):
    """The vanilla forward and backward against their plain versions on
    `inputs` (blend_inputs' tuple, from camera cam_h of `scene`), under
    the cotangent of the scene's image loss scaled to unit size; with
    --yardstick, both against the parent's build. Prints the cull shares;
    returns the two report rows."""
    from types import SimpleNamespace

    from gssr_tpu_torch.ops import blend as B
    attrs, ranges, tx, ty = inputs
    fwd = partial(B.blend_fwd, attrs, ranges, tx, ty)
    out_k = fwd()
    out_p, fwd_plain_ms = timed(lambda: B.blend_fwd_plain(attrs, ranges, tx,
                                                          ty))
    torch.testing.assert_close(out_k, out_p, **FWD_TOL)
    held(yard, fwd, out_k, tag)
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
    d_k = bwd()
    d_p, bwd_plain_ms = timed(lambda: B.blend_bwd_plain(attrs, ranges, out_k,
                                                        cot, tx, ty))
    assert_live_rows(d_p, B.LIVE_ATTRS)
    assert_backward(d_k, d_p, range(B.LIVE_ATTRS), B.LIVE_ATTRS, bwd)
    held(yard, bwd, d_k, tag)

    pairs, _ = B.blend_pair_count(attrs, ranges, tx, ty)
    cull = gauss_cull_counts(attrs, ranges, tx, ty)
    assert cull.pairs == pairs, (cull.pairs, pairs)
    print_cull_shares(tag, cull)
    n_inst = attrs.shape[1]
    hw = out_k.shape[0] * out_k.shape[1]
    live_bytes = B.LIVE_ATTRS * n_inst * 4 + ranges.numel() * 4
    src = "gssr_tpu_torch/csrc/blend.cu"
    rows = [
        report_row("blend_fwd", src, "gssr_tpu/ops/blend_pallas.py:158",
                   launches["blend_fwd"], max_err(out_k, out_p), fwd,
                   fwd_plain_ms, gauss_pair_ops(FWD_OPS_PER_PAIR, cull),
                   live_bytes + hw * 16, yard),
        report_row("blend_bwd", src, "gssr_tpu/ops/blend_pallas.py:265",
                   launches["blend_bwd"], max_err(d_k, d_p), bwd,
                   bwd_plain_ms, gauss_pair_ops(BWD_OPS_PER_PAIR, cull),
                   live_bytes + 2 * hw * 16 + attrs.numel() * 4, yard)]
    print(f"{tag} blend inputs: {tx * 16}x{ty * 16} padded, "
          f"{n_inst} instance slots, {pairs} (pixel, instance) pairs "
          f"before saturation", flush=True)
    return rows


def phase_report2d(trainer, launches, dev, yard=None):
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
    return surfel_pair("[report 2dgs]", scene, cam_h, cam, inputs, launches,
                       yard)


def phase_report_octree2d(trainer, launches, dev, card_line, yard=None):
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
    print_rows(tag, surfel_pair(tag, scene, cam_h, cam, inputs, launches,
                                yard), card_line)


def surfel_pair(tag, scene, cam_h, cam, inputs, launches, yard=None):
    """Both surfel kernels against their plain versions on `inputs`
    (blend2d_inputs' tuple, from camera cam_h of `scene`), under the
    cotangent of the scene's image loss plus the 2DGS regularisers, both
    live (past step 7000, lambda_dist 1000, depth_ratio 0.5), plus a
    random one on median_normal, each channel group scaled to a largest
    entry of 1; with --yardstick, both against the parent's build. Prints
    the cull shares; returns the two report rows."""
    import dataclasses
    from types import SimpleNamespace

    from gssr_tpu_torch.ops import blend2d as B
    from gssr_tpu_torch.ops.rasterize2d import surfel_outputs
    from gssr_tpu_torch.scene.twodgs import surfel_reg_losses
    attrs, ranges, tx, ty = inputs
    fwd = partial(B.blend2d_fwd, attrs, ranges, tx, ty)
    out_k = fwd()
    out_p, fwd_plain_ms = timed(lambda: B.blend2d_fwd_plain(attrs, ranges,
                                                            tx, ty))
    assert_surfel_forward(out_k, out_p, B.O_SELPOS)
    held(yard, fwd, out_k, tag)

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
    d_k = bwd()
    d_p, bwd_plain_ms = timed(lambda: B.blend2d_bwd_plain(
        attrs, ranges, out_k, cot, tx, ty))
    assert_backward(d_k, d_p, range(B.LIVE_ATTRS2), B.LIVE_ATTRS2, bwd)
    held(yard, bwd, d_k, tag)
    # the rows of the low-pass centre and of CA stay far below the others
    # (dL/dCA carries 1/pz), so no one cotangent puts every row above
    # 100 x atol while the largest rows' rounding stays inside atol; the
    # per-row comparison above holds each in units of its own largest value
    row_max = d_p[:B.LIVE_ATTRS2].abs().amax(dim=1)
    print(f"{tag} largest plain gradient per live row: "
          f"{[float(f'{x:.3g}') for x in row_max.tolist()]}; "
          f"{int((row_max > 100 * BWD_TOL['atol']).sum())} of "
          f"{B.LIVE_ATTRS2} rows above 100 x atol")

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
                   live_bytes + out_bytes, yard),
        report_row("blend2d_bwd", src, "gssr_tpu/ops/blend2d_pallas.py:269",
                   launches["blend2d_bwd"], max_err(d_k, d_p), bwd,
                   bwd_plain_ms, pair_ops + BWD2_OPS_PER_CONTRIB * contrib,
                   live_bytes + 2 * out_bytes + attrs.numel() * 4, yard)]
    print(f"{tag} surfel blend inputs: {tx * 16}x{ty * 16} padded, "
          f"{n_inst} instance slots, {pairs} (pixel, instance) pairs before "
          f"saturation, {contrib} contributing; loss terms {terms_line}",
          flush=True)
    return rows


def phase_report_pgsr(trainer, launches, dev, yard=None):
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
        near, near_gray = scene.near_for([cam_h])
        near_cam = near.arrays(dev)
        near_out = scene.render_params(p, near_cam, g.active_sh_degree(STEPS),
                                       state.active, scene.background,
                                       forward_observe=False)
    return planar_kernels("[report pgsr]", scene, cam_h, cam, inputs,
                          (near_out, near_cam, near_gray), launches, yard)


def phase_report_scaffold_pgsr(trainer, launches, dev, card_line,
                               yard=None):
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
        near, near_gray = scene.near_for([cam_h])
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
                                   launches, yard), card_line)


def planar_kernels(tag, scene, cam_h, cam, inputs, near, launches,
                   yard=None):
    """The three planar kernels against their plain versions on `inputs`
    (pgsr_inputs' tuple, from camera cam_h of `scene`), under the
    cotangent of the pgsr multi-view loss at the end of training through
    this render (`near`: the neighbour's render, CameraArrays and
    grayscale frame) plus a random one on final_T, each channel group
    scaled to a largest entry of 1. The backward compares as a whole at
    the stated tolerance and row by row in units of each row's largest
    plain value; rows 14-15 (the abs screen gradients) as gradients, row
    13 (the observe count) exactly and equal to the observe kernel's
    counts; with --yardstick, all three against the parent's build. Prints
    the cull shares; returns the three report rows."""
    from types import SimpleNamespace

    from gssr_tpu_torch.ops import blend_pgsr as B
    from gssr_tpu_torch.ops.blend import blend_pair_count
    from gssr_tpu_torch.ops.rasterize_pgsr import planar_outputs
    attrs, b, tx, ty = inputs
    near_out, near_cam, near_gray = near
    ranges = b.tile_ranges
    fwd = partial(B.blend_pgsr_fwd, attrs, ranges, tx, ty)
    out_k = fwd()
    out_p, fwd_plain_ms = timed(lambda: B.blend_pgsr_fwd_plain(attrs, ranges,
                                                               tx, ty))
    torch.testing.assert_close(out_k, out_p, **FWD_TOL)
    held(yard, fwd, out_k, tag)
    obs = partial(B.blend_pgsr_observe, attrs, ranges, tx, ty)
    obs_k = obs()
    obs_p, obs_plain_ms = timed(lambda: B.blend_pgsr_obs_plain(attrs, ranges,
                                                               tx, ty))
    assert torch.equal(obs_k, obs_p)
    held(yard, obs, obs_k, tag)

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
    d_k = bwd()
    d_p, bwd_plain_ms = timed(lambda: B.blend_pgsr_bwd_plain(
        attrs, ranges, out_k, cot, tx, ty))
    grad_rows = [r for r in range(B.NUM_ATTRS_P) if r != B.P_OBS]
    assert_backward(d_k, d_p, grad_rows, B.NUM_ATTRS_P, bwd)
    assert torch.equal(d_k[B.P_OBS], d_p[B.P_OBS])
    assert torch.equal(d_k[B.P_OBS], obs_k)
    held(yard, bwd, d_k, tag)
    # the normal and distance channels' cotangents are large at few pixels
    # (the plane depth divides by n . ray), so those rows can stay below
    # 100 x atol; the per-row comparison above holds each in units of its
    # own largest value
    row_max = d_p.abs().amax(dim=1)
    grad_max = row_max[:B.LIVE_ATTRS_P]
    print(f"{tag} largest plain value per row: "
          f"{[float(f'{x:.3g}') for x in row_max.tolist()]}; "
          f"{int((grad_max > 100 * BWD_TOL['atol']).sum())} of "
          f"{B.LIVE_ATTRS_P} live rows above 100 x atol")

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
                   launches["blend_pgsr_fwd"], max_err(out_k, out_p), fwd,
                   fwd_plain_ms, gauss_pair_ops(FWDP_OPS_PER_PAIR, cull)
                   + FWDP_OPS_PER_CONTRIB * contrib,
                   live_bytes + map_bytes, yard),
        report_row("blend_pgsr_obs", src, f"{pallas}:182",
                   launches["blend_pgsr_obs"], max_err(obs_k, obs_p), obs,
                   obs_plain_ms, gauss_pair_ops(OBSP_OPS_PER_PAIR, obs_cull),
                   B.P_RGB * obs_cull.slots * 4 + range_bytes + n_inst * 4,
                   yard),
        report_row("blend_pgsr_bwd", src, f"{pallas}:216",
                   launches["blend_pgsr_bwd"], max_err(d_k, d_p), bwd,
                   bwd_plain_ms, gauss_pair_ops(BWDP_OPS_PER_PAIR, cull)
                   + BWDP_OPS_PER_CONTRIB * contrib,
                   live_bytes + 2 * map_bytes + attrs.numel() * 4, yard)]
    print(f"{tag} planar blend inputs: {tx * 16}x{ty * 16} padded, "
          f"{n_inst} instance slots, {pairs} (pixel, instance) pairs before "
          f"saturation, {contrib} contributing, {int(obs_k.sum())} observed; "
          f"loss terms {terms_line}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None)
    ap.add_argument("--yardstick", default=None, metavar="DIR",
                    help="a checkout of the parent commit whose build of "
                         "the kernels every kernel must equal bit for bit "
                         "and is timed against")
    ap.add_argument("--convergence", action="store_true",
                    help="also train octree-2dgs and pgsr 2,400 steps on "
                         "gssr_tpu's structured scene, mesh them, and hold "
                         "them against gssr_tpu's convergence records")
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
    yard = phase_build(dev, args.yardstick)
    phase_kernels(dev, yard)
    phase_kernels2d(dev, yard)
    phase_kernels_pgsr(dev, yard)
    phase_tile_mask(dev, yard)
    phase_bin_expand(dev, yard)
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
        t1 = time.perf_counter()
        phase_parallel(root, dev, card_line)
        phase_parallel_split(root, dev, card_line)
        print(f"[parallel] phase in {time.perf_counter() - t1:.1f} s")
        if args.profile:
            stem, ext = os.path.splitext(args.profile)
            phase_profile(runs["3dgs"][0], args.profile, card_line)
            for m, suffix in (("2dgs", "2dgs"), ("pgsr", "pgsr"),
                              ("scaffold-gs", "scaffold"),
                              ("octree-2dgs", "octree2dgs")):
                phase_profile(runs[m][0], f"{stem}_{suffix}{ext}", card_line)
        rows = phase_report(*runs["3dgs"], dev, yard)
        rows += phase_report2d(*runs["2dgs"], dev, yard)
        rows += phase_report_pgsr(*runs["pgsr"], dev, yard)
        phase_report_scaffold(*runs["scaffold-gs"], dev, card_line, yard)
        phase_report_octree2d(*runs["octree-2dgs"], dev, card_line, yard)
        phase_report_scaffold_pgsr(*runs["scaffold-pgsr"], dev, card_line,
                                   yard)
        if yard is not None:
            assert yard.held == yard.keys, sorted(yard.keys - yard.held)
            print(f"[yardstick] {len(yard.held)} kernels bitwise equal to "
                  f"{args.yardstick}'s build: {sorted(yard.held)}")
        if args.convergence:
            t1 = time.perf_counter()
            phase_convergence(root, dev, card_line)
            print(f"[convergence] phase in {time.perf_counter() - t1:.1f} s")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
