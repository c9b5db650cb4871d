"""Extract a TSDF-fused mesh from a trained run of the PyTorch/CUDA port:

    python -m gssr_tpu_torch.extract_mesh --load-config <run>/config.yml \
        [--iteration N] [--unbounded] [--voxel-size V] [--depth-trunc D] \
        [--render-video [--video-frames N]] [--skip-mesh] \
        [--machine.device cpu]

The mesh is written to <run>/mesh_<iteration>/fused_mesh.ply, and
--render-video renders an elliptical fly-through of N frames into
render_traj.mp4 there (render_traj_frames/*.png without OpenCV). It runs on
the device of the run's config (the CUDA card unless the run was trained
on the CPU), or on the one `--machine.device` names; without a card and
without `--machine.device cpu` it stops with an error.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

import numpy as np


def eval_setup(config_path: str, iteration: Optional[int] = None,
               device: Optional[str] = None):
    """config.yml -> Config -> scene with the saved gaussians loaded."""
    from gssr_tpu_torch.configs.base import load_config_yaml
    from gssr_tpu_torch.configs.methods import build_scene
    config = load_config_yaml(config_path)
    if device is not None:
        config.machine.device = device
    dev = config.machine.torch_device()
    # the run's files live next to its config, wherever output_path said
    run_dir = Path(config_path).parent
    scene = build_scene(config, dev)
    gdir = run_dir / config.trainer.relative_gaussian_dir
    iters = [int(p.name.split("_")[-1]) for p in gdir.glob("iteration_*")]
    if not iters:
        raise FileNotFoundError(f"no saved gaussians under {gdir}")
    it = iteration or max(iters)
    ply = gdir / f"iteration_{it}" / "point_cloud.ply"
    scene.state = scene.load_gaussians(str(ply))
    return config, scene, run_dir, it


def render_video(scene, n_frames: int, out_dir: Path, seconds: dict) -> str:
    """Render an elliptical fly-through of n_frames through the scene's
    eval render, on its device, and write it into out_dir; adds the
    seconds it took under seconds["video"]. Returns the path written."""
    from gssr_tpu_torch.utils.mesh_extract import clock
    from gssr_tpu_torch.utils.render_paths import (
        create_video,
        generate_ellipse_path,
    )
    traj = generate_ellipse_path(scene.dataloader.train_cameras,
                                 n_frames=n_frames)
    print(f"rendering {len(traj)} fly-through frames ...")
    t0 = clock(scene.device)
    frames = [scene.eval_render(scene.state, c, step=10 ** 9).image
              .cpu().numpy() for c in traj]
    seconds["video"] = clock(scene.device) - t0
    path = create_video(frames, str(out_dir / "render_traj.mp4"))
    print(f"saved {path} ({len(frames)} frames)")
    return path


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--load-config", required=True)
    ap.add_argument("--iteration", type=int, default=None)
    ap.add_argument("--voxel-size", type=float, default=0.004)
    ap.add_argument("--sdf-trunc", type=float, default=0.02)
    ap.add_argument("--depth-trunc", type=float, default=3.0)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--unbounded", action="store_true")
    ap.add_argument("--num-cluster", type=int, default=1)
    ap.add_argument("--alpha-thres", type=float, default=0.5)
    ap.add_argument("--skip-images", action="store_true")
    ap.add_argument("--render-video", action="store_true",
                    help="render an elliptical fly-through video")
    ap.add_argument("--video-frames", type=int, default=120)
    ap.add_argument("--skip-mesh", action="store_true",
                    help="only export the rendered images and video")
    ap.add_argument("--export-test", action="store_true",
                    help="also render and export the eval split")
    ap.add_argument("--eval-gt", default=None, metavar="GT_MESH_PLY",
                    help="ground-truth mesh to score F1/chamfer against")
    ap.add_argument("--eval-tau", type=float, nargs="+", default=[0.05],
                    help="F-score distance threshold(s)")
    ap.add_argument("--machine.device", dest="device", default=None,
                    help="cuda or cpu (default: the run config's device)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns {"mesh_path", "verts", "faces", "seconds"} (seconds per
    stage: render, fusion, mtet; video with --render-video, whose path is
    under "video"); no mesh keys with --skip-mesh."""
    from gssr_tpu_torch.utils.mesh_extract import (
        GaussianExtractor,
        write_mesh_ply,
    )
    from gssr_tpu_torch.utils.mtet import keep_largest_clusters

    args = parse_args(argv)
    config, scene, run_dir, it = eval_setup(args.load_config, args.iteration,
                                            args.device)
    out_dir = run_dir / f"mesh_{it}"
    out_dir.mkdir(parents=True, exist_ok=True)

    extractor = GaussianExtractor(scene, scene.state)
    print(f"rendering {len(scene.dataloader.train_cameras)} cameras ...")
    extractor.reconstruction(scene.dataloader.train_cameras)
    if not args.skip_images:
        extractor.export_images(str(out_dir))
    if args.export_test and scene.dataloader.test_cameras:
        test_ex = GaussianExtractor(scene, scene.state)
        print(f"rendering {len(scene.dataloader.test_cameras)} "
              "test cameras ...")
        test_ex.reconstruction(scene.dataloader.test_cameras)
        test_dir = out_dir / "test"
        test_dir.mkdir(exist_ok=True)
        test_ex.export_images(str(test_dir))
    result = {"seconds": extractor.seconds}
    if args.render_video:
        result["video"] = render_video(scene, args.video_frames, out_dir,
                                       extractor.seconds)
    if args.skip_mesh:
        return result

    if args.unbounded:
        verts, faces, colors = extractor.extract_mesh_unbounded(
            args.resolution, alpha_thres=args.alpha_thres)
    else:
        verts, faces, colors = extractor.extract_mesh_bounded(
            voxel_size=args.voxel_size, sdf_trunc=args.sdf_trunc,
            depth_trunc=args.depth_trunc, alpha_thres=args.alpha_thres)
    print(f"raw mesh: {len(verts)} verts, {len(faces)} faces")
    if args.num_cluster > 0 and len(faces):
        verts, faces, colors = keep_largest_clusters(
            verts, faces, args.num_cluster, vert_attrs=np.asarray(colors))
    mesh_path = out_dir / "fused_mesh.ply"
    write_mesh_ply(str(mesh_path), np.asarray(verts), np.asarray(faces),
                   np.asarray(colors))
    print(f"saved {mesh_path} ({len(verts)} verts, {len(faces)} faces)")
    result.update(mesh_path=mesh_path, verts=len(verts), faces=len(faces))

    if args.eval_gt:
        from gssr_tpu_torch.utils.mesh_eval import eval_mesh_files
        metrics = eval_mesh_files(str(mesh_path), args.eval_gt,
                                  taus=args.eval_tau)
        with open(out_dir / "mesh_metrics.json", "w") as f:
            json.dump(metrics, f, indent=2)
        print("mesh eval vs", args.eval_gt)
        for k, v in metrics.items():
            print(f"  {k}: {v:.5f}")
        result["metrics"] = metrics
    return result


if __name__ == "__main__":
    main()
