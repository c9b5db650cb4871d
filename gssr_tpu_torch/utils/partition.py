"""VastGaussian scene partitioning, numpy and scipy only (port of
gssr_tpu/utils/partition.py, whose output it reproduces exactly).

The four stages: camera-position region division (a manual grid, or a
recursive median split), position-based data selection in the extended
box, visibility-based camera selection by the projected box's coverage of
the image, and coverage-based point selection; plus an optional
rotation-only alignment of the model, from a file or estimated from the
cameras. A polygon is clipped to the image by Sutherland-Hodgman, and the
outlier statistics of the points come from the 3-nearest-neighbour
distances of ops/knn.py.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from gssr_tpu_torch.dataio import colmap
from gssr_tpu_torch.ops.knn import mean_knn_dist2_host


def _cam_center(img: colmap.ColmapImage) -> np.ndarray:
    R = img.rotmat()
    return -R.T @ np.asarray(img.tvec)


def _w2c(img: colmap.ColmapImage) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = img.rotmat()
    m[:3, 3] = img.tvec
    return m


def transform_colmap(input_model: str, output_model: str,
                     transform_file: str):
    """Rotation-only coordinate alignment: the model's poses and points
    rotated by the (scale-normalised, translation-free) 4x4 transform in
    `transform_file`, written to output_model."""
    P = np.loadtxt(transform_file).reshape(4, 4)
    P[:3, 3] = 0
    R = P[:3, :3]
    scales = np.sqrt(np.sum(R * R, axis=1))
    P[:3, :3] = R / scales[:, None]

    cams, images, pts = colmap.read_model(input_model)
    images_new = {}
    for i, im in images.items():
        w2c = _w2c(im) @ np.linalg.inv(P)
        images_new[i] = colmap.ColmapImage(
            im.id, colmap.rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3],
            im.camera_id, im.name, im.xys, im.point3D_ids)
    pts_new = {}
    for i, p in pts.items():
        xyz = P[:3, :3] @ p.xyz + P[:3, 3]
        pts_new[i] = colmap.ColmapPoint3D(p.id, xyz, p.rgb, p.error,
                                          p.image_ids, p.point2D_idxs)
    os.makedirs(output_model, exist_ok=True)
    colmap.write_model(cams, images_new, pts_new, output_model)
    return cams, images_new, pts_new


def estimate_orientation_alignment(images: Dict) -> np.ndarray:
    """Estimate a rotation-only 4x4 transform that makes the ground plane
    the xy plane (world up -> +z), so the partitioner's xy camera-position
    grid cuts along the ground.

    Stands in for COLMAP's `model_orientation_aligner` stage when the
    colmap binary (or its Manhattan-frame estimate) is unavailable: world
    up is the consensus of
    the cameras' up axes (-y row of each w2c rotation), and the in-plane
    x axis is the dominant PCA direction of the camera centers projected
    onto the ground plane. Returns P with rows = the new world axes
    (applied as x' = P[:3,:3] @ x, matching transform_colmap).
    """
    ups, centers = [], []
    for im in images.values():
        R = im.rotmat()
        ups.append(-R[1])                    # R^T @ (0,-1,0): camera up
        centers.append(_cam_center(im))
    u = np.mean(np.stack(ups), axis=0)
    u = u / max(np.linalg.norm(u), 1e-12)
    C = np.stack(centers)
    C = C - C.mean(axis=0)
    Cp = C - (C @ u)[:, None] * u[None, :]   # project out the up component
    cov = Cp.T @ Cp
    evals, evecs = np.linalg.eigh(cov)
    e1 = evecs[:, -1]
    e1 = e1 - (e1 @ u) * u
    n = np.linalg.norm(e1)
    if n < 1e-9:                              # degenerate (e.g. one camera)
        e1 = np.array([1.0, 0.0, 0.0]) - u[0] * u
        e1 /= max(np.linalg.norm(e1), 1e-12)
    else:
        e1 = e1 / n
    e2 = np.cross(u, e1)
    P = np.eye(4)
    P[:3, :3] = np.stack([e1, e2, u])        # right-handed, det = +1
    return P


def region_division(images: Dict, num_col: Optional[int] = None,
                    num_row: Optional[int] = None,
                    max_num_images: int = 150) -> List[Dict]:
    """Stage (b): camera-position region division. Without num_col and
    num_row, halve along the longer extent until each part holds fewer
    than max_num_images; else a num_col x num_row grid, by x then y."""
    items = [{"image": im, "center": _cam_center(im)}
             for im in images.values()]
    list_tiles: List[List[Dict]] = []

    if num_col is None or num_row is None:
        def split(chunk):
            centers = np.stack([c["center"] for c in chunk])
            ext_x = centers[:, 0].max() - centers[:, 0].min()
            ext_y = centers[:, 1].max() - centers[:, 1].min()
            axis = 0 if ext_x > ext_y else 1
            chunk = sorted(chunk, key=lambda c: c["center"][axis])
            half = len(chunk) // 2
            for part in (chunk[:half], chunk[half:]):
                if len(part) < max_num_images:
                    list_tiles.append(part)
                else:
                    split(part)
        split(items)
    else:
        n = len(items)
        per_col = n // num_col
        by_x = sorted(items, key=lambda c: c["center"][0])
        for i in range(num_col):
            col = by_x[i * per_col: (i + 1) * per_col if i < num_col - 1
                       else n]
            m = len(col)
            per_tile = m // num_row
            by_y = sorted(col, key=lambda c: c["center"][1])
            for j in range(num_row):
                list_tiles.append(
                    by_y[j * per_tile: (j + 1) * per_tile
                         if j < num_row - 1 else m])

    tiles = []
    for tile in list_tiles:
        centers = np.stack([t["center"] for t in tile])
        tiles.append({
            "images": [t["image"] for t in tile],
            "box": np.array([centers[:, 0].min(), centers[:, 0].max(),
                             centers[:, 1].min(), centers[:, 1].max()]),
        })
    return tiles


def position_based_data_selection(tiles, images: Dict, points3d: Dict,
                                  ratio: float = 0.2):
    """Stage (c): include the cameras and points inside the extended box;
    the stored box stays unextended."""
    out = []
    for tile in tiles:
        mx, Mx, my, My = tile["box"]
        dw = (Mx - mx) * ratio / 2.0
        dh = (My - my) * ratio / 2.0
        bx = np.array([mx - dw, Mx + dw, my - dh, My + dh])
        imgs = [im for im in images.values()
                if bx[0] <= _cam_center(im)[0] <= bx[1]
                and bx[2] <= _cam_center(im)[1] <= bx[3]]
        pts = [p for p in points3d.values()
               if bx[0] <= p.xyz[0] <= bx[1] and bx[2] <= p.xyz[1] <= bx[3]]
        out.append({"images": imgs, "box": tile["box"], "points3D": pts})
    return out


def _clip_poly_to_rect(poly: np.ndarray, w: float, h: float) -> float:
    """Area of a convex polygon clipped to [0,w]x[0,h] (replaces shapely)."""
    def clip(pts, inside, intersect):
        out = []
        n = len(pts)
        for i in range(n):
            a, b = pts[i], pts[(i + 1) % n]
            ia, ib = inside(a), inside(b)
            if ia:
                out.append(a)
                if not ib:
                    out.append(intersect(a, b))
            elif ib:
                out.append(intersect(a, b))
        return out

    def x_cut(x0, keep_geq):
        def inside(p):
            return p[0] >= x0 if keep_geq else p[0] <= x0

        def inter(a, b):
            t = (x0 - a[0]) / (b[0] - a[0] + 1e-30)
            return (x0, a[1] + t * (b[1] - a[1]))
        return inside, inter

    def y_cut(y0, keep_geq):
        def inside(p):
            return p[1] >= y0 if keep_geq else p[1] <= y0

        def inter(a, b):
            t = (y0 - a[1]) / (b[1] - a[1] + 1e-30)
            return (a[0] + t * (b[0] - a[0]), y0)
        return inside, inter

    pts = [tuple(p) for p in poly]
    for inside, inter in (x_cut(0, True), x_cut(w, False),
                          y_cut(0, True), y_cut(h, False)):
        pts = clip(pts, inside, inter)
        if len(pts) < 3:
            return 0.0
    arr = np.asarray(pts)
    x, y = arr[:, 0], arr[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def visibility_based_camera_selection(tiles, images: Dict, cameras: Dict,
                                      threshold: float = 0.25):
    """Stage (d): add the outside cameras whose view covers the tile's
    bounding box."""
    from scipy.spatial import ConvexHull

    out = []
    for tile in tiles:
        cur_ids = {im.id for im in tile["images"]}
        mx, Mx, my, My = tile["box"]
        pts = np.stack([p.xyz for p in tile["points3D"]]) \
            if tile["points3D"] else np.zeros((1, 3))
        if len(pts) >= 4:
            d = np.sqrt(mean_knn_dist2_host(pts))
            keep = (d > d.mean() - 3 * d.std()) & (d < d.mean() + 3 * d.std())
            pts = pts[keep] if keep.any() else pts
        mz, Mz = pts[:, 2].min(), pts[:, 2].max()
        bbox = np.array([[x, y, z, 1.0] for x in (mx, Mx)
                         for y in (my, My) for z in (mz, Mz)])
        centers = np.stack([_cam_center(im) for im in tile["images"]])
        dists = np.stack([np.linalg.norm(centers - p[None, :3], axis=1)
                          for p in bbox])
        md = dists.max(axis=0).mean() * 1.2

        added = []
        for im in images.values():
            if im.id in cur_ids:
                continue
            intr = cameras[im.camera_id]
            if intr.model == "SIMPLE_PINHOLE":
                fx = fy = intr.params[0]
            else:
                fx, fy = intr.params[0], intr.params[1]
            K = np.array([[fx, 0, intr.width / 2.0],
                          [0, fy, intr.height / 2.0], [0, 0, 1]])
            cam_pts = (_w2c(im) @ bbox.T).T[:, :3]
            if (cam_pts[:, 2] <= 1e-6).any():
                continue
            uv = (K @ cam_pts.T).T
            uv = uv[:, :2] / uv[:, 2:3]
            try:
                hull = ConvexHull(uv)
            except (RuntimeError, ValueError):   # QhullError: degenerate
                continue
            area = _clip_poly_to_rect(uv[hull.vertices], intr.width,
                                      intr.height)
            ratio = area / (intr.width * intr.height)
            c = _cam_center(im)
            d = np.mean(np.sum(np.sqrt((bbox[:, :3] - c) ** 2), axis=1))
            if ratio > threshold and d < md:
                added.append(im)
        out.append({"images": added + tile["images"], "box": tile["box"],
                    "points3D": tile["points3D"]})
    return out


def coverage_based_point_selection(tiles, points3d: Dict):
    """Stage (e): a tile's points are the union of its images' tracks."""
    out = []
    for tile in tiles:
        ids = np.unique(np.concatenate(
            [im.point3D_ids[im.point3D_ids != -1]
             for im in tile["images"]])) if tile["images"] else []
        pts = [points3d[i] for i in ids if i in points3d]
        out.append({"images": tile["images"], "box": tile["box"],
                    "points3D": pts})
    return out


def split_scene(source_path: str, output_path: Optional[str] = None,
                num_col: Optional[int] = None, num_row: Optional[int] = None,
                max_num_images: int = 200, extend_ratio: float = 0.1,
                visibility_threshold: float = 0.5,
                transform_file: Optional[str] = None,
                copy_images: bool = True,
                auto_align: bool = False) -> List[str]:
    """The whole partitioning pipeline; writes tile_%04d/ COLMAP models and
    box.txt files. Returns the tile directory list.

    auto_align: when set (and no transform_file given), estimate the
    ground-plane alignment from the model itself (see
    estimate_orientation_alignment), persist it to
    output/align_transform.txt, and partition in the aligned frame —
    covering COLMAP's `model_orientation_aligner` stage for environments
    without a colmap binary."""
    output_path = output_path or source_path
    os.makedirs(output_path, exist_ok=True)

    if transform_file is None and auto_align:
        _, raw_images, _ = colmap.read_model(
            os.path.join(source_path, "sparse/0"))
        P = estimate_orientation_alignment(raw_images)
        transform_file = os.path.join(output_path, "align_transform.txt")
        np.savetxt(transform_file, P)

    if transform_file is not None:
        cams, images, pts = transform_colmap(
            os.path.join(source_path, "sparse/0"),
            os.path.join(output_path, "sparse/aligned"), transform_file)
    else:
        cams, images, pts = colmap.read_model(
            os.path.join(source_path, "sparse/0"))

    tiles = region_division(images, num_col, num_row, max_num_images)
    tiles = position_based_data_selection(tiles, images, pts,
                                          ratio=extend_ratio)
    tiles = visibility_based_camera_selection(tiles, images, cams,
                                              threshold=visibility_threshold)
    tiles = coverage_based_point_selection(tiles, pts)

    tile_dirs = []
    for i, tile in enumerate(tiles):
        name = f"tile_{i:04d}"
        tdir = os.path.join(output_path, name)
        sparse = os.path.join(tdir, "sparse/0")
        os.makedirs(sparse, exist_ok=True)
        colmap.write_model(cams, {im.id: im for im in tile["images"]},
                           {p.id: p for p in tile["points3D"]}, sparse)
        with open(os.path.join(tdir, "box.txt"), "w") as f:
            b = tile["box"]
            f.write("mx Mx my My\n")
            f.write(f"{b[0]} {b[1]} {b[2]} {b[3]}")
        if copy_images:
            img_dir = os.path.join(tdir, "images")
            os.makedirs(img_dir, exist_ok=True)
            for im in tile["images"]:
                src = os.path.join(source_path, "images", im.name)
                dst = os.path.join(img_dir, im.name)
                if os.path.exists(src) and not os.path.exists(dst):
                    shutil.copy(src, dst)
        tile_dirs.append(tdir)
    return tile_dirs
