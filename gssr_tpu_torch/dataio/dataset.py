"""Scene dataset: COLMAP parsing -> Camera lists + point cloud + extent
(port of gssr_tpu/dataio/dataset.py).

Host-side only (numpy + PIL). The seeded shuffle and random-pop camera
sampler are the reference's line for line, so both trainers see the same
camera order for the same seed.
"""
from __future__ import annotations

import os
import random
from collections import OrderedDict
from typing import List, NamedTuple

import numpy as np

from gssr_tpu_torch.cameras import Camera
from gssr_tpu_torch.configs.base import DataLoaderConfig
from gssr_tpu_torch.dataio import colmap
from gssr_tpu_torch.dataio.ply import (
    read_point_cloud_ply,
    write_point_cloud_ply,
)
from gssr_tpu_torch.utils.graphics import focal_to_fov


class PointCloud(NamedTuple):
    points: np.ndarray   # [N,3] float64
    colors: np.ndarray   # [N,3] float in [0,1]
    normals: np.ndarray  # [N,3]


class SceneData(NamedTuple):
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    point_cloud: PointCloud
    cameras_extent: float
    translate: np.ndarray


def nerfpp_norm(cameras: List[Camera]):
    """Camera-centroid radius normalization."""
    centers = np.stack([c.campos for c in cameras])
    center = centers.mean(axis=0)
    diagonal = np.max(np.linalg.norm(centers - center, axis=1))
    return {"translate": -center, "radius": float(diagonal * 1.1)}


def _target_resolution(w: int, h: int, resolution: int, scale: float = 1.0):
    """-1 caps the width at 1600px; 1/2/4/8 divide; other values set an
    absolute width."""
    if resolution in (1, 2, 4, 8):
        return round(w / (scale * resolution)), round(h / (scale * resolution))
    if resolution == -1:
        down = w / 1600 if w > 1600 else 1
    else:
        down = w / resolution
    s = float(down) * float(scale)
    return int(w / s), int(h / s)


def load_image(path: str, resolution) -> np.ndarray:
    from PIL import Image
    img = Image.open(path)
    if resolution is not None and img.size != tuple(resolution):
        img = img.resize(resolution)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    return arr


class LazyImage:
    """Load-on-demand GT frame with a process-wide bounded LRU, for scenes
    whose frames do not fit in host RAM as float32. Consumers only call
    np.asarray on camera.image, so __array__ is the whole interface."""

    __slots__ = ("path", "resolution")
    _cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
    cache_frames = 256

    def __init__(self, path: str, resolution):
        self.path = path
        self.resolution = tuple(resolution) if resolution else None

    def _load(self) -> np.ndarray:
        c = LazyImage._cache
        key = (self.path, self.resolution)
        arr = c.get(key)
        if arr is None:
            arr = load_image(self.path, self.resolution)
            c[key] = arr
            while len(c) > max(LazyImage.cache_frames, 1):
                c.popitem(last=False)
        else:
            c.move_to_end(key)
        return arr

    def __array__(self, dtype=None, copy=None):
        arr = self._load()
        return arr.astype(dtype) if dtype is not None else arr

    @property
    def shape(self):
        return self._load().shape


def read_colmap_scene(source_dir: str, images_dir: str = "images",
                      eval_split: bool = False, llffhold: int = 8,
                      resolution: int = -1, load_images: bool = True,
                      lazy_images: bool = False,
                      sparse_subdir: str = "sparse/0") -> SceneData:
    sparse = os.path.join(source_dir, sparse_subdir)
    cams, imgs, pts3d = colmap.read_model(sparse)

    cam_infos = []
    for iid in sorted(imgs.keys()):
        im = imgs[iid]
        intr = cams[im.camera_id]
        if intr.model == "SIMPLE_PINHOLE":
            fx = fy = intr.params[0]
        elif intr.model == "PINHOLE":
            fx, fy = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {intr.model}; undistort first")
        fovy = focal_to_fov(fy, intr.height)
        fovx = focal_to_fov(fx, intr.width)
        R = im.rotmat().T          # cam-to-world rotation
        T = np.array(im.tvec)
        image_path = os.path.join(source_dir, images_dir,
                                  os.path.basename(im.name))
        w, h = _target_resolution(intr.width, intr.height, resolution)
        cam_infos.append(Camera(
            uid=0, colmap_id=im.id,
            image_name=os.path.splitext(os.path.basename(im.name))[0],
            R=R, T=T, fovx=fovx, fovy=fovy, width=w, height=h,
            image_path=image_path))
    cam_infos.sort(key=lambda c: c.image_name)
    for i, c in enumerate(cam_infos):
        c.uid = i

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    norm = nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if os.path.exists(ply_path):
        points, colors, normals = read_point_cloud_ply(ply_path)
    else:
        ids = sorted(pts3d.keys())
        points = (np.stack([pts3d[i].xyz for i in ids]) if ids
                  else np.zeros((0, 3)))
        rgb = (np.stack([pts3d[i].rgb for i in ids]) if ids
               else np.zeros((0, 3), dtype=np.uint8))
        colors = rgb.astype(np.float64) / 255.0
        normals = np.zeros_like(points)
        try:
            write_point_cloud_ply(ply_path, points, rgb)
        except OSError:
            pass      # a read-only scene directory: the cache is optional
    pcd = PointCloud(points, colors, normals)

    if load_images:
        for c in train + test:
            if lazy_images:
                c.image = LazyImage(c.image_path, (c.width, c.height))
            else:
                c.image = load_image(c.image_path, (c.width, c.height))

    return SceneData(train, test, pcd, norm["radius"], norm["translate"])


class ColmapDataLoader:
    """Camera provider with a seeded random-pop sampler."""

    def __init__(self, config: DataLoaderConfig, source_dir: str,
                 eval: bool = False, seed: int = 0, load_images: bool = True):
        self.config = config
        self.source_dir = source_dir
        LazyImage.cache_frames = config.image_cache_frames
        scene = read_colmap_scene(
            source_dir, config.images, eval, config.llffhold,
            config.resolution, load_images=load_images,
            lazy_images=config.lazy_images)
        self.rng = random.Random(seed)
        if config.shuffle:
            self.rng.shuffle(scene.train_cameras)
            self.rng.shuffle(scene.test_cameras)
        self.train_cameras = scene.train_cameras
        self.test_cameras = scene.test_cameras
        self.point_cloud = scene.point_cloud
        self.cameras_extent = scene.cameras_extent
        self.background = np.array(
            [1.0, 1.0, 1.0] if config.white_background else [0.0, 0.0, 0.0],
            dtype=np.float32)
        self._stack: List[Camera] = []
        # the sampler is fully determined by (post-shuffle rng state,
        # number of draws), so resume replays the draws
        self._rng_state0 = self.rng.getstate()
        self.draws = 0

    def next_train(self) -> Camera:
        if not self._stack:
            self._stack = list(self.train_cameras)
        self.draws += 1
        return self._stack.pop(self.rng.randint(0, len(self._stack) - 1))

    def restore_sampler(self, draws: int):
        """Rewind to the post-init state and replay `draws` pops."""
        self.rng.setstate(self._rng_state0)
        self._stack = []
        self.draws = 0
        for _ in range(int(draws)):
            self.next_train()

    def get_training_callbacks(self):
        """The dataloader's before/after-iteration hooks: none by default
        (gssr_tpu's dataloader keeps the same hook)."""
        return []
