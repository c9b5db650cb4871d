"""Merge the tiles of a partitioned scene into one TSDF mesh:

    python -m gssr_tpu_torch.extract_mesh_split --source-path S \
        --runs-root O --method octree-2dgs [--voxel-size V] \
        [--sdf-trunc T] [--depth-trunc D] [--num-cluster K] [--out PLY] \
        [--eval-gt GT_PLY] [--machine.device cpu]

S holds the tile_XXXX/ directories of `python -m
gssr_tpu_torch.split_scene`, O the runs of `python -m
gssr_tpu_torch.train_split`. Each tile's newest run renders the cameras
whose centre lies in the tile's box.txt; all the renders are fused, tile
by tile and camera by camera, into one bounded volume centred at their
mean camera centre. The mesh is written to --out, by default
O/fused_mesh.ply. It runs on the device of the runs' configs (the CUDA
card unless they were trained on the CPU), or on the one
`--machine.device` names; without a card and without `--machine.device
cpu` it stops with an error.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

import numpy as np


def load_box(tile_dir: str):
    """box.txt's mx, Mx, my, My: the tile's unextended camera box."""
    with open(os.path.join(tile_dir, "box.txt")) as f:
        f.readline()
        return [float(v) for v in f.readline().split()]


def in_box_cameras(cameras, box):
    """The cameras whose centre lies in box (mx, Mx, my, My). The centre
    is -R^T t of the COLMAP pose in float64, computed as the partitioner
    computed the box from it, so that the cameras that define the box's
    edges lie inside it; their float32 `campos` can round out of it."""
    mx, Mx, my, My = box
    inside = []
    for c in cameras:
        x, y, _ = -c.R @ np.asarray(c.T, np.float64)
        if mx <= x <= Mx and my <= y <= My:
            inside.append(c)
    return inside


def find_run(runs_root: str, tile: str, method: str) -> Optional[str]:
    """The config.yml of the newest run of `method` on tile `tile`, under
    runs_root/<experiment>/<tile> (train_split's layout) or
    runs_root/<tile>."""
    cfgs = sorted(glob.glob(os.path.join(
        runs_root, "*", tile, method, "*", "config.yml"))) or sorted(
        glob.glob(os.path.join(runs_root, tile, method, "*", "config.yml")))
    return cfgs[-1] if cfgs else None


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source-path", required=True,
                    help="partitioned scene root containing tile_*/")
    ap.add_argument("--runs-root", required=True,
                    help="output root that contains the per-tile run dirs "
                         "(as train_split writes them)")
    ap.add_argument("--method", required=True)
    ap.add_argument("--voxel-size", type=float, default=0.01)
    ap.add_argument("--sdf-trunc", type=float, default=0.04)
    ap.add_argument("--depth-trunc", type=float, default=10.0)
    ap.add_argument("--num-cluster", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--eval-gt", default=None, metavar="GT_MESH_PLY",
                    help="ground-truth mesh to score F1/chamfer against")
    ap.add_argument("--eval-tau", type=float, nargs="+", default=[0.05])
    ap.add_argument("--machine.device", dest="device", default=None,
                    help="cuda or cpu (default: the runs' configs' device)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns {"mesh_path", "verts", "faces", "seconds" (render, fusion,
    mtet), "in_box" (tile -> the image names it rendered), "views" (the
    cameras, depth, rgb and alpha maps in fusion order), "volume"}."""
    from gssr_tpu_torch.extract_mesh import eval_setup
    from gssr_tpu_torch.utils.mesh_extract import (
        GaussianExtractor,
        clock,
        fuse_bounded,
        write_mesh_ply,
    )
    from gssr_tpu_torch.utils.mtet import keep_largest_clusters
    from gssr_tpu_torch.utils.tsdf import extract_mesh

    args = parse_args(argv)
    tiles = sorted(glob.glob(os.path.join(args.source_path, "tile_*")))
    if not tiles:
        raise SystemExit(f"error: no tile_* dirs under {args.source_path}")

    cams, rgbs, depths, alphas = [], [], [], []
    in_box, seconds, device = {}, {"render": 0.0}, None
    for tile_dir in tiles:
        name = os.path.basename(tile_dir)
        cfg = find_run(args.runs_root, name, args.method)
        if cfg is None:
            print(f"[warn] no run found for {name}, skipping")
            continue
        _, scene, _, _ = eval_setup(cfg, device=args.device)
        device = scene.device
        box_cams = in_box_cameras(scene.dataloader.train_cameras,
                                  load_box(tile_dir))
        print(f"{name}: {len(box_cams)} in-box cameras")
        ex = GaussianExtractor(scene, scene.state)
        ex.reconstruction(box_cams)
        cams += ex.cameras
        rgbs += ex.rgbmaps
        depths += ex.depthmaps
        alphas += ex.alphamaps
        in_box[name] = [c.image_name for c in box_cams]
        seconds["render"] += ex.seconds["render"]
        # the maps are on the host: the tile's model leaves the device
        # before the next tile's loads
        del ex, scene

    if not cams:
        raise SystemExit("error: no tile run rendered a camera")
    t0 = clock(device)
    vol = fuse_bounded(cams, depths, rgbs, alphas, device, args.voxel_size,
                       args.sdf_trunc, args.depth_trunc)
    t1 = clock(device)
    verts, faces, colors = extract_mesh(vol)
    seconds.update(fusion=t1 - t0, mtet=clock(device) - t1)
    if args.num_cluster > 0 and len(faces):
        verts, faces, colors = keep_largest_clusters(
            verts, faces, args.num_cluster, vert_attrs=np.asarray(colors))
    out = args.out or os.path.join(args.runs_root, "fused_mesh.ply")
    write_mesh_ply(out, np.asarray(verts), np.asarray(faces),
                   np.asarray(colors))
    print(f"saved {out} ({len(verts)} verts, {len(faces)} faces)")
    result = dict(mesh_path=out, verts=len(verts), faces=len(faces),
                  seconds=seconds, in_box=in_box,
                  views=(cams, depths, rgbs, alphas), volume=vol)

    if args.eval_gt:
        from gssr_tpu_torch.utils.mesh_eval import eval_mesh_files
        metrics = eval_mesh_files(out, args.eval_gt, taus=args.eval_tau)
        with open(os.path.join(os.path.dirname(out) or ".",
                               "mesh_metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        print("mesh eval vs", args.eval_gt)
        for k, v in metrics.items():
            print(f"  {k}: {v:.5f}")
        result["metrics"] = metrics
    return result


if __name__ == "__main__":
    main()
