"""Partition a large COLMAP scene into VastGaussian tiles:

    python -m gssr_tpu_torch.split_scene --source-path S [--output-path O] \
        [--num-col 4 --num-row 1] [--max-num-images 200] \
        [--extend-ratio 0.1] [--visibility-threshold 0.5] \
        [--transform-file T | --auto-align] [--no-copy-images]

Writes O/tile_XXXX/ (a COLMAP model under sparse/0, box.txt, and the
tile's images unless --no-copy-images), to train with `python -m
gssr_tpu_torch.train_split`. A host stage: it touches no device.
"""
from __future__ import annotations

import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source-path", required=True)
    ap.add_argument("--output-path", default=None)
    ap.add_argument("--num-col", type=int, default=None)
    ap.add_argument("--num-row", type=int, default=None)
    ap.add_argument("--max-num-images", type=int, default=200)
    ap.add_argument("--extend-ratio", type=float, default=0.1)
    ap.add_argument("--visibility-threshold", type=float, default=0.5)
    ap.add_argument("--transform-file", default=None)
    ap.add_argument("--auto-align", action="store_true",
                    help="estimate the ground-plane alignment from the "
                         "model (stands in for colmap "
                         "model_orientation_aligner) before partitioning")
    ap.add_argument("--no-copy-images", action="store_true")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Returns the tile directories."""
    from gssr_tpu_torch.utils.partition import split_scene
    args = parse_args(argv)
    tiles = split_scene(
        args.source_path, args.output_path, args.num_col, args.num_row,
        args.max_num_images, args.extend_ratio, args.visibility_threshold,
        args.transform_file, copy_images=not args.no_copy_images,
        auto_align=args.auto_align)
    print(f"wrote {len(tiles)} tiles:")
    for t in tiles:
        print(" ", t)
    return tiles


if __name__ == "__main__":
    main()
