"""COLMAP preprocessing: the photos in S/input to a scene the port trains on.

Feature extraction, exhaustive matching, mapping and undistortion:

    python -m gssr_tpu_torch.convert --source-path S [--camera OPENCV] \
        [--colmap-executable colmap] [--no-gpu] [--skip-matching] \
        [--use-aligner]

The photos are read from S/input; the undistorted scene is written to S
(S/images, S/sparse/0). Requires an external `colmap` binary on PATH.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def run(cmd):
    print("+", " ".join(cmd))
    rc = subprocess.call(cmd)
    if rc != 0:
        sys.exit(f"command failed with exit code {rc}: {' '.join(cmd)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source-path", "-s", required=True)
    ap.add_argument("--camera", default="OPENCV")
    ap.add_argument("--colmap-executable", default="colmap")
    ap.add_argument("--no-gpu", action="store_true")
    ap.add_argument("--skip-matching", action="store_true")
    ap.add_argument("--resize", action="store_true")
    ap.add_argument("--use-aligner", action="store_true",
                    help="run colmap model_orientation_aligner so the "
                         "ground plane is axis-aligned before VastGaussian "
                         "splitting; `python -m gssr_tpu_torch.split_scene "
                         "--auto-align` is the colmap-binary-free "
                         "equivalent")
    args = ap.parse_args(argv)

    colmap = args.colmap_executable
    if shutil.which(colmap) is None:
        sys.exit(f"colmap binary {colmap!r} not found on PATH")
    src = args.source_path
    use_gpu = "0" if args.no_gpu else "1"

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted/sparse"), exist_ok=True)
        run([colmap, "feature_extractor",
             "--database_path", os.path.join(src, "distorted/database.db"),
             "--image_path", os.path.join(src, "input"),
             "--ImageReader.single_camera", "1",
             "--ImageReader.camera_model", args.camera,
             "--SiftExtraction.use_gpu", use_gpu])
        run([colmap, "exhaustive_matcher",
             "--database_path", os.path.join(src, "distorted/database.db"),
             "--SiftMatching.use_gpu", use_gpu])
        run([colmap, "mapper",
             "--database_path", os.path.join(src, "distorted/database.db"),
             "--image_path", os.path.join(src, "input"),
             "--output_path", os.path.join(src, "distorted/sparse"),
             "--Mapper.ba_global_function_tolerance=0.000001"])

    run([colmap, "image_undistorter",
         "--image_path", os.path.join(src, "input"),
         "--input_path", os.path.join(src, "distorted/sparse/0"),
         "--output_path", src, "--output_type", "COLMAP"])

    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))
    print("done; scene ready at", src)


if __name__ == "__main__":
    main()
