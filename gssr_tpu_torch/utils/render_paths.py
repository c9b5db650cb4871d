"""Fly-through camera paths and video export (port of
gssr_tpu/utils/render_paths.py): a PCA-aligned elliptical camera path
through the scene, and a writer that makes an mp4 through OpenCV where it
can open the codec, or PNG frames through PIL where it cannot.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from gssr_tpu_torch.cameras import Camera


def transform_poses_pca(poses: np.ndarray):
    """Align c2w poses to their principal axes."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t_c = t - t_mean
    # eigh, not eig: the covariance is symmetric and eigh guarantees an
    # ORTHONORMAL eigenbasis even for (near-)degenerate spectra — e.g. a
    # circular capture ring has two equal eigenvalues, where eig may return
    # a skewed basis that shears every path camera
    eigval, eigvec = np.linalg.eigh(t_c.T @ t_c)
    inds = np.argsort(eigval)[::-1]
    rot = eigvec[:, inds].T
    if np.linalg.det(rot) < 0:
        rot = np.diag([1, 1, -1]) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    poses_rec = transform @ np.concatenate(
        [poses[:, :3, :], np.tile(np.eye(4)[3], (len(poses), 1, 1))], 1)
    # no scale normalisation: a scaled transform would make the inverse
    # non-rigid, putting a uniform scale into the path cameras' rotations
    # (and thus their rendered depths)
    transform = np.concatenate([transform, np.eye(4)[3:]], 0)
    return poses_rec, transform


def focus_point_fn(poses: np.ndarray) -> np.ndarray:
    """Least-squares focus point of the camera rays."""
    dirs, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - dirs * np.transpose(dirs, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def generate_ellipse_path(cameras: List[Camera], n_frames: int = 120,
                          z_variation: float = 0.0, z_phase: float = 0.0):
    """Elliptical fly-through through the scene, returned as a list of
    Camera objects sharing the first camera's intrinsics."""
    c2ws = np.stack([np.linalg.inv(c.w2c.astype(np.float64))
                     for c in cameras])
    pose_rec, transform = transform_poses_pca(c2ws)
    center = focus_point_fn(pose_rec)
    offset = np.array([center[0], center[1], 0])
    sc = np.percentile(np.abs(pose_rec[:, :3, 3] - offset), 90, axis=0)
    zlow, zhigh = (np.percentile(pose_rec[:, 2, 3], q) for q in (10, 90))

    positions = []
    for theta in np.linspace(0, 2 * np.pi, n_frames, endpoint=False):
        p = np.array([
            center[0] + sc[0] * np.cos(theta),
            center[1] + sc[1] * np.sin(theta),
            zlow + z_variation * (zhigh - zlow)
            * 0.5 * (1 + np.sin(theta + z_phase))])
        positions.append(p)

    inv_transform = np.linalg.inv(transform)
    cams = []
    ref = cameras[0]
    up = np.array([0.0, 0.0, 1.0])
    for i, p in enumerate(positions):
        fwd = center - p
        fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right) + 1e-12
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, p
        c2w = inv_transform @ c2w
        w2c = np.linalg.inv(c2w)
        cams.append(Camera(
            uid=i, colmap_id=i, image_name=f"path_{i:05d}",
            R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=ref.fovx, fovy=ref.fovy,
            width=ref.width, height=ref.height))
    return cams


def create_video(frames: List[np.ndarray], path: str, fps: int = 30):
    """Write frames ([H,W,3] float in [0,1]) as an mp4 through OpenCV, or,
    where OpenCV is missing or cannot open the codec, as PNG frames in
    <path without its suffix>_frames/. Returns the path written."""
    frames8 = [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in frames]
    h, w = frames8[0].shape[:2]
    try:
        import cv2
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
        opened = vw.isOpened()
    except ImportError:
        opened = False
    if opened:
        for f in frames8:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
        return path
    from PIL import Image
    d = os.path.splitext(path)[0] + "_frames"
    os.makedirs(d, exist_ok=True)
    for i, f in enumerate(frames8):
        Image.fromarray(f).save(os.path.join(d, f"{i:05d}.png"))
    return d
