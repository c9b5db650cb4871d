#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port, gssr_tpu_torch, on one CUDA card.

    python3 chip_smoke.py [--profile FILE]

Phases; any failure exits non-zero, and nothing is caught and passed over:

1. build    nvcc builds the hand-written kernels of gssr_tpu_torch/csrc/
            for sm_90a; prints the build seconds and the card.
2. kernels  each blend kernel against its plain PyTorch version on the
            card, at 256x256 with ~20k gaussians and a dense-overdraw tile
            (so the early stop fires); the backward runs twice and must
            agree bit for bit.
3. train    the main path: `python -m gssr_tpu_torch.train 3dgs`, called
            in process on a synthetic COLMAP scene (8 ring cameras at
            1600x1056, 200k initial points, GT rendered by the port from a
            separate random gaussian set), STEPS steps with SH degree 3 and
            two densify passes on the card. Asserts finite losses that fall, a written
            PLY, and that every step launched both kernels.
4. report   both kernels against their plain versions again, at the blend
            inputs of the main path (the trained model, one of its
            cameras, the cotangent of its own loss scaled to unit size),
            with times and bounds;
            prints the {"kernels": [...]} line, the card, and last the
            {"ok": true, "device": {...}} line.

--profile FILE adds three profiled train steps after phase 3 and writes
torch.profiler's per-kernel table to FILE.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per evaluated (pixel, instance) pair, counted from the
# kernels in gssr_tpu_torch/csrc/blend.cu (the exp counts as one)
FWD_OPS_PER_PAIR = 28
BWD_OPS_PER_PAIR = 56

FWD_TOL = dict(atol=1e-5, rtol=1e-4)
BWD_TOL = dict(atol=2e-4, rtol=2e-3)

WIDTH, HEIGHT = 1600, 1056      # bench.py's resolution
N_CAMS = 8
N_POINTS = 200_000
N_GT_GAUSSIANS = 50_000
# SH degree 3 from step 15 (oneup every 5), densify after steps 20 and 30,
# four whole epochs of the N_CAMS cameras
STEPS = 32


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    """Median of per-call CUDA-event times, after one warm-up call."""
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
    return statistics.median(times)


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


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def phase_build():
    from gssr_tpu_torch.ops import _kernels
    info = _kernels.build()
    _kernels.load()
    print(f"[build] {info['path'].name} built in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}")


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions, with an overdraw tile
# ---------------------------------------------------------------------------

def phase_kernels(dev):
    from gssr_tpu_torch.ops import blend as B
    g = torch.Generator(device="cpu").manual_seed(1)

    def u(n, k, lo, hi):
        return lo + (hi - lo) * torch.rand((n, k), generator=g)

    n, n_dense = 20_000, 2_000
    means = torch.cat([u(n - n_dense, 1, -2.0, 2.0), u(n - n_dense, 1, -2.0,
                       2.0), u(n - n_dense, 1, -1.0, 1.0)], 1)
    # a dense stack of nearly-opaque gaussians in front of one spot:
    # transmittance collapses there and the early stop fires
    dense = torch.tensor([0.5, -0.5, 0.0]) + 0.04 * torch.randn(
        (n_dense, 3), generator=g)
    means = torch.cat([means, dense])
    scales = torch.cat([u(n - n_dense, 3, 0.005, 0.06),
                        u(n_dense, 3, 0.02, 0.05)])
    rots = torch.randn((n, 4), generator=g)
    opacity = torch.cat([u(n - n_dense, 1, 0.05, 0.95),
                         u(n_dense, 1, 0.9, 0.99)])[:, 0]
    colors = u(n, 3, 0.0, 1.0)
    cam = camera(256, 256).arrays(dev)
    attrs, ranges, tx, ty = blend_inputs(
        *(x.to(dev) for x in (means, scales, rots, opacity, colors)), cam,
        256, 256)
    out_k = B.blend_fwd(attrs, ranges, tx, ty)
    out_p = B.blend_fwd_plain(attrs, ranges, tx, ty)
    torch.testing.assert_close(out_k, out_p, **FWD_TOL)
    saturated = int((out_k[..., 3] < 1e-3).sum())
    assert saturated > 0, "the overdraw tile did not saturate"
    cot = torch.randn(out_k.shape, generator=g).to(dev)
    d_k = B.blend_bwd(attrs, ranges, out_k, cot, tx, ty)
    d_p = B.blend_bwd_plain(attrs, ranges, out_k, cot, tx, ty)
    torch.testing.assert_close(d_k, d_p, **BWD_TOL)
    assert torch.equal(d_k, B.blend_bwd(attrs, ranges, out_k, cot, tx, ty)), \
        "the backward kernel is not deterministic"
    fwd_ms = median_ms(lambda: B.blend_fwd(attrs, ranges, tx, ty), 20)
    fwd_plain_ms = median_ms(lambda: B.blend_fwd_plain(attrs, ranges, tx,
                                                       ty), 3)
    bwd_ms = median_ms(lambda: B.blend_bwd(attrs, ranges, out_k, cot, tx,
                                           ty), 20)
    bwd_plain_ms = median_ms(lambda: B.blend_bwd_plain(attrs, ranges, out_k,
                                                       cot, tx, ty), 3)
    print(f"[kernels] 256x256, {n} gaussians, {attrs.shape[1]} instance "
          f"slots, {saturated} saturated pixels")
    print(f"[kernels] blend_fwd max|err| {max_err(out_k, out_p):.3e}  "
          f"{fwd_ms:.4f} ms  plain {fwd_plain_ms:.4f} ms")
    print(f"[kernels] blend_bwd max|err| {max_err(d_k, d_p):.3e}  "
          f"{bwd_ms:.4f} ms  plain {bwd_plain_ms:.4f} ms  "
          f"deterministic: yes")


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


@torch.no_grad()
def write_scene(root, dev, seed=0):
    """A COLMAP scene written by the port's dataio/colmap.py: ring
    cameras, N_POINTS random initial points, and GT frames that the port
    renders from a separate random gaussian set."""
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
    images = {}
    for i, c in enumerate(cams):
        img = rasterize(gt["means"], gt["scales"], gt["rots"], gt["opacity"],
                        c.arrays(dev), WIDTH, HEIGHT,
                        torch.zeros(3, device=dev),
                        colors_precomp=gt["colors"]).image
        img8 = (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(img8).save(os.path.join(root, "images",
                                                f"{c.image_name}.png"))
        images[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat_to_qvec(c.R.T), c.T, 1,
            f"{c.image_name}.png", np.zeros((0, 2)),
            np.zeros(0, np.int64))
    pts = rng.uniform(-1, 1, (N_POINTS, 3))
    rgb = rng.integers(0, 256, (N_POINTS, 3)).astype(np.uint8)
    points = {i + 1: colmap.ColmapPoint3D(i + 1, pts[i], rgb[i], 0.1,
                                          np.zeros(0, np.int32),
                                          np.zeros(0, np.int32))
              for i in range(N_POINTS)}
    c0 = cams[0]
    intr = {1: colmap.ColmapCamera(1, "PINHOLE", WIDTH, HEIGHT, np.array(
        [c0.fx, c0.fy, WIDTH / 2, HEIGHT / 2]))}
    colmap.write_model(intr, images, points, os.path.join(root, "sparse/0"))


def phase_train(dev, root, card_line):
    from gssr_tpu_torch import train
    from gssr_tpu_torch.configs.cli import parse_config
    from gssr_tpu_torch.ops import blend as B
    t0 = time.perf_counter()
    write_scene(os.path.join(root, "scene"), dev)
    print(f"[train] scene written in {time.perf_counter() - t0:.1f} s")
    config = parse_config([
        "3dgs", "--source-path", os.path.join(root, "scene"),
        "--output-path", os.path.join(root, "out"),
        "--trainer.iterations", str(STEPS),
        "--trainer.test-iterations", str(STEPS),
        "--trainer.save-iterations", str(STEPS),
        "--trainer.log-interval", "1",
        "--scene.gaussians.oneup-sh-interval", "5",
        "--scene.gaussians.densify-from-iter", "10",
        "--scene.gaussians.densification-interval", "10"])
    for k in B.LAUNCHES:
        B.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train.main(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(B.LAUNCHES)

    scene, state = trainer.scene, trainer.scene.state
    hist = trainer.history
    losses = [h[1] for h in hist]
    assert len(hist) == STEPS and all(map(math.isfinite, losses)), losses
    # the sampler draws every camera once per epoch of N_CAMS steps:
    # compare whole epochs, first against last
    first = statistics.mean(losses[:N_CAMS])
    last_epoch = STEPS // N_CAMS * N_CAMS
    last = statistics.mean(losses[last_epoch - N_CAMS:last_epoch])
    assert last < first, (first, last)
    assert scene.gaussians.active_sh_degree(STEPS) == 3
    n0 = min(N_POINTS, state.active.shape[0])
    assert int(state.n_active) != n0, "densify changed nothing"
    ply = config.get_gaussian_dir() / f"iteration_{STEPS}" / \
        "point_cloud.ply"
    assert ply.exists() and ply.stat().st_size > 0, ply
    for k, n in launches.items():
        assert n >= STEPS, f"{k} launched {n} times in {STEPS} steps"
    step_ms = sorted(1e3 * (b[3] - a[3]) for a, b in zip(hist[1:], hist[2:]))
    med = statistics.median(step_ms)
    # the highest percentile with ten samples above it
    tail_n = len(step_ms) - 10
    tail = step_ms[tail_n - 1] if tail_n > 0 else float("nan")
    psnr = trainer.evals[STEPS]["eval_psnr"]
    print(f"[train] {STEPS} steps in {wall:.1f} s (build, eval and save "
          f"included); loss epoch 1 {first:.5f} -> epoch "
          f"{last_epoch // N_CAMS} {last:.5f}")
    print(f"[train] n_active {n0} -> {int(state.n_active)} of capacity "
          f"{state.active.shape[0]}; launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[train] median step {med:.2f} ms, p{100 * tail_n / len(step_ms):.0f}"
          f" {tail:.2f} ms (n={len(step_ms)}), "
          f"{WIDTH * HEIGHT / med / 1e3:.2f} Mpix/s, num_rendered "
          f"{hist[-1][2]}, eval PSNR {psnr:.3f} dB  | {card_line}")
    return trainer, launches


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

    # kernels only: an operator's row repeats the time of its kernels
    kernels = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{card_line}\n3 train steps, wall {wall_us / 1e3:.3f} ms, "
                f"device busy {busy / 1e3:.3f} ms\n")
        f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    print(f"[profile] 3 steps: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f} %)  | "
          f"{card_line}")
    for e in top:
        print(f"[profile] {dev_us(e) / 3e3:9.3f} ms/step  {e.count // 3:5d} "
              f"calls/step  {e.key[:90]}")


# ---------------------------------------------------------------------------
# 4. the kernels at the main path's own inputs
# ---------------------------------------------------------------------------

def phase_report(trainer, launches, dev):
    from types import SimpleNamespace

    from gssr_tpu_torch.ops import blend as B
    from gssr_tpu_torch.ops.sh import sh_to_color
    scene, state = trainer.scene, trainer.scene.state
    g, p = scene.gaussians, state.params
    cam_h = scene.dataloader.train_cameras[0]
    cam = cam_h.arrays(dev)
    with torch.no_grad():
        color = sh_to_color(3, g.get_features(p), p["xyz"], cam.campos)
        attrs, ranges, tx, ty = blend_inputs(
            p["xyz"], g.get_scaling(p), g.get_rotation(p),
            g.get_opacity(p)[:, 0], color, cam, scene.width, scene.height,
            active=state.active)
    out_k = B.blend_fwd(attrs, ranges, tx, ty)
    out_p = B.blend_fwd_plain(attrs, ranges, tx, ty)
    torch.testing.assert_close(out_k, out_p, **FWD_TOL)
    # the cotangent of the training loss itself, scaled to unit size: the
    # loss is a mean over every pixel channel, so its raw cotangent (~1e-7)
    # would leave every gradient far below the absolute tolerance
    f = out_k.clone().requires_grad_(True)
    image = (f[..., :3] + f[..., 3:4] * scene.background)[:scene.height,
                                                          :scene.width]
    loss = sum(scene.loss_terms(SimpleNamespace(image=image),
                                scene.gt_device(cam_h)).values())
    (cot,) = torch.autograd.grad(loss, f)
    cot = (cot / cot.abs().max()).contiguous()
    d_k = B.blend_bwd(attrs, ranges, out_k, cot, tx, ty)
    d_p = B.blend_bwd_plain(attrs, ranges, out_k, cot, tx, ty)
    # every live row must carry gradients well above the tolerance, so that
    # a zeroed or misplaced row cannot pass the comparison
    row_max = d_p[:B.LIVE_ATTRS].abs().amax(dim=1)
    assert bool((row_max > 100 * BWD_TOL["atol"]).all()), row_max.tolist()
    torch.testing.assert_close(d_k, d_p, **BWD_TOL)
    assert torch.equal(d_k, B.blend_bwd(attrs, ranges, out_k, cot, tx, ty))

    pairs = B.blend_pair_count(attrs, ranges, tx, ty)
    n_inst = attrs.shape[1]
    hw = out_k.shape[0] * out_k.shape[1]
    live_bytes = B.LIVE_ATTRS * n_inst * 4 + ranges.numel() * 4
    fwd_bytes = live_bytes + hw * 16
    bwd_bytes = live_bytes + 2 * hw * 16 + attrs.numel() * 4

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    rows = []
    for name, line, fn, plain, err, ops, nbytes in (
            ("blend_fwd", 158, lambda: B.blend_fwd(attrs, ranges, tx, ty),
             lambda: B.blend_fwd_plain(attrs, ranges, tx, ty),
             max_err(out_k, out_p), FWD_OPS_PER_PAIR * pairs, fwd_bytes),
            ("blend_bwd", 265,
             lambda: B.blend_bwd(attrs, ranges, out_k, cot, tx, ty),
             lambda: B.blend_bwd_plain(attrs, ranges, out_k, cot, tx, ty),
             max_err(d_k, d_p), BWD_OPS_PER_PAIR * pairs, bwd_bytes)):
        bound_ms, bound_by = bound(ops, nbytes)
        rows.append({
            "name": name, "route": "cuda",
            "source": "gssr_tpu_torch/csrc/blend.cu",
            "replaces": f"gssr_tpu/ops/blend_pallas.py:{line}",
            "launches": launches[name], "max_abs_err": err,
            "ms": median_ms(fn, 20), "plain_ms": median_ms(plain, 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    print(f"[report] main-path blend inputs: {tx * 16}x{ty * 16} padded, "
          f"{n_inst} instance slots, {pairs} (pixel, instance) pairs "
          f"before saturation")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None)
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
    phase_build()
    phase_kernels(dev)
    with tempfile.TemporaryDirectory() as root:
        trainer, launches = phase_train(dev, root, card_line)
        if args.profile:
            phase_profile(trainer, args.profile, card_line)
        rows = phase_report(trainer, launches, dev)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
