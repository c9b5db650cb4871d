"""The synthetic COLMAP scene a cell trains on, made from the run's seed.

A rewrite of chip_smoke.py::write_scene for the benchmark: `cameras` ring
cameras looking at the origin (60 degree horizontal field of view), `points`
initial SfM points uniform in [-1, 1]^3 with random colours, and one target
image per camera. The targets are smooth random images made here from the
seed (a sum of coloured sinusoids and gaussian blobs), not rendered by the
program under test. Points, colours and images come from one torch.Generator
on the device in a few large calls.

The points go to `sparse/0/points3D.ply` (which the port's loader reads in
place of the points of `points3D.bin`); `points3D.bin` holds none and the
images observe none, since the 3dgs and octree-2dgs cells need no tracks.
"""
from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

FOVX_DEG = 60.0
RING_RADIUS = 4.0
BLOBS = 48
WAVES = 6


@dataclass
class SceneCamera:
    """One camera as written: COLMAP's world-to-camera quaternion (w, x, y,
    z) and translation, and its pinhole intrinsics."""
    name: str
    qvec: np.ndarray
    tvec: np.ndarray
    fx: float
    fy: float
    width: int
    height: int


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """COLMAP's rotation -> quaternion (w, x, y, z), w >= 0."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    w, V = np.linalg.eigh(K)
    q = V[[3, 0, 1, 2], np.argmax(w)]
    return -q if q[0] < 0 else q


def ring_cameras(width: int, height: int, n: int) -> List[SceneCamera]:
    """n cameras on a ring of radius 4 around the origin, looking at it,
    their heights on a 0.3 cosine (chip_smoke.py's ring)."""
    f = width / (2.0 * math.tan(math.radians(FOVX_DEG) / 2.0))
    cams = []
    for i in range(n):
        ang = 2 * math.pi * i / n
        pos = np.array([RING_RADIUS * math.sin(ang), 0.3 * math.cos(3 * ang),
                        -RING_RADIUS * math.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, -1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R_w2c = np.stack([right, np.cross(fwd, right), fwd])
        cams.append(SceneCamera(f"cam{i:03d}", rotmat_to_qvec(R_w2c),
                                -R_w2c @ pos, f, f, width, height))
    return cams


@torch.no_grad()
def target_images(gen, n: int, width: int, height: int, device):
    """n smooth random RGB images [n, H, W, 3] uint8: per channel a sum of
    WAVES sinusoids and BLOBS gaussian blobs, squashed into [0, 1]."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)
    y = torch.linspace(0.0, 1.0, height, device=device)[:, None, None]
    x = torch.linspace(0.0, 1.0, width, device=device)[None, :, None]
    freq = 2.0 + 14.0 * u(n, WAVES, 2, 3)
    phase = 2 * math.pi * u(n, WAVES, 3)
    amp = u(n, WAVES, 3)
    centre = u(n, BLOBS, 2, 1)
    sigma = 0.01 + 0.08 * u(n, BLOBS, 1)
    weight = 2.0 * u(n, BLOBS, 3) - 1.0
    out = []
    for i in range(n):
        img = torch.zeros(height, width, 3, device=device)
        for k in range(WAVES):
            img += amp[i, k] * torch.sin(2 * math.pi * (freq[i, k, 0] * x
                                                       + freq[i, k, 1] * y)
                                         + phase[i, k])
        for k in range(BLOBS):
            d2 = (x - centre[i, k, 0]) ** 2 + (y - centre[i, k, 1]) ** 2
            img += weight[i, k] * torch.exp(-d2 / (2 * sigma[i, k] ** 2))
        out.append(torch.sigmoid(img))
    return (torch.stack(out) * 255.0).round().to(torch.uint8)


def write_points_ply(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """Binary little-endian PLY with x y z nx ny nz (float) red green blue
    (uchar), the points3D.ply layout."""
    n = len(xyz)
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    for i, k in enumerate("xyz"):
        rec[k] = xyz[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        rec[k] = rgb[:, i]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              + "".join(f"property float {k}\n"
                        for k in ("x", "y", "z", "nx", "ny", "nz"))
              + "".join(f"property uchar {k}\n"
                        for k in ("red", "green", "blue"))
              + "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def write_sparse(sparse: str, cams: List[SceneCamera]):
    """cameras.bin (one PINHOLE camera), images.bin (no 2-D points) and an
    empty points3D.bin, in COLMAP's binary format."""
    os.makedirs(sparse, exist_ok=True)
    c0 = cams[0]
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, c0.width, c0.height))
        f.write(struct.pack("<dddd", c0.fx, c0.fy, c0.width / 2,
                            c0.height / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, c in enumerate(cams):
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *c.qvec))
            f.write(struct.pack("<ddd", *c.tvec))
            f.write(struct.pack("<i", 1))
            f.write(f"{c.name}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 0))


def write_scene(root: str, seed: int, points: int, cameras: int, width: int,
                height: int, device) -> List[SceneCamera]:
    """Write the scene under root (images/, sparse/0/); returns its
    cameras."""
    from PIL import Image
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    xyz = (2.0 * torch.rand((points, 3), generator=gen, device=device)
           - 1.0).cpu().numpy()
    rgb = torch.randint(0, 256, (points, 3), generator=gen, device=device,
                        dtype=torch.int32).to(torch.uint8).cpu().numpy()
    imgs = target_images(gen, cameras, width, height, device).cpu().numpy()
    cams = ring_cameras(width, height, cameras)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for c, img in zip(cams, imgs):
        Image.fromarray(img).save(os.path.join(root, "images",
                                               f"{c.name}.png"),
                                  compress_level=1)
    sparse = os.path.join(root, "sparse", "0")
    write_sparse(sparse, cams)
    write_points_ply(os.path.join(sparse, "points3D.ply"), xyz, rgb)
    return cams


def read_points_ply(path: str):
    """(xyz [N, 3] float32, rgb [N, 3] uint8) of write_points_ply's file."""
    with open(path, "rb") as f:
        head = b""
        while not head.endswith(b"end_header\n"):
            head += f.readline()
        n = int(head.split(b"element vertex ")[1].split(b"\n")[0])
        rec = np.frombuffer(f.read(), dtype=[
            ("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("nx", "<f4"),
            ("ny", "<f4"), ("nz", "<f4"), ("red", "u1"), ("green", "u1"),
            ("blue", "u1")], count=n)
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], 1)
    rgb = np.stack([rec["red"], rec["green"], rec["blue"]], 1)
    return xyz, rgb


def read_image(root: str, cam: SceneCamera) -> np.ndarray:
    """A camera's target as float32 [H, W, 3] in [0, 1]."""
    from PIL import Image
    img = Image.open(os.path.join(root, "images", f"{cam.name}.png"))
    return np.asarray(img, dtype=np.float32) / 255.0


class Scene:
    """A written scene, as the references read it."""

    def __init__(self, root: str, cams: List[SceneCamera]):
        self.root = root
        self.cams = cams
        self.width, self.height = cams[0].width, cams[0].height
        self._by_name = {c.name: c for c in cams}

    def train_order(self) -> List[SceneCamera]:
        """The cameras in image-name order, the order a COLMAP loader
        numbers them in."""
        return sorted(self.cams, key=lambda c: c.name)

    def camera(self, name: str) -> SceneCamera:
        return self._by_name[name]

    def image(self, cam: SceneCamera) -> np.ndarray:
        return read_image(self.root, cam)

    def points(self):
        return read_points_ply(os.path.join(self.root, "sparse", "0",
                                            "points3D.ply"))
