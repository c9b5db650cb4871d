"""The port's fly-through path and video writer against gssr_tpu's: the
elliptical path through the same ring of cameras, and the mp4 (or PNG
frames, without OpenCV) the writer leaves."""
import math
import os
import sys

import numpy as np
import pytest


def _ring(Camera, n=12, radius=4.0, height=-1.0):
    """Cameras of one package's Camera class on a ring, looking at the
    origin (tests/test_render_paths.py's ring)."""
    cams = []
    for i in range(n):
        ang = 2 * math.pi * i / n
        pos = np.array([radius * math.sin(ang), height + 0.3 * math.cos(ang),
                        -radius * math.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, -1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R_w2c = np.stack([right, np.cross(fwd, right), fwd])
        cams.append(Camera(uid=i, colmap_id=i, image_name=f"c{i}",
                           R=R_w2c.T, T=-R_w2c @ pos,
                           fovx=math.radians(60), fovy=math.radians(45),
                           width=64, height=48))
    return cams


@pytest.mark.parametrize("n_frames,z_variation", [(30, 0.0), (17, 0.5)])
def test_ellipse_path_matches_gssr_tpu(n_frames, z_variation):
    from gssr_tpu.cameras import Camera as JCamera
    from gssr_tpu.utils.render_paths import generate_ellipse_path as j_path
    from gssr_tpu_torch.cameras import Camera as TCamera
    from gssr_tpu_torch.utils.render_paths import (
        generate_ellipse_path as t_path,
    )
    kw = dict(n_frames=n_frames, z_variation=z_variation, z_phase=0.3)
    jt, tt = j_path(_ring(JCamera), **kw), t_path(_ring(TCamera), **kw)
    assert len(tt) == len(jt) == n_frames
    for a, b in zip(jt, tt):
        for f in ("R", "T", "fovx", "fovy", "width", "height"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=0, atol=1e-10, err_msg=f)
        assert b.image_name == a.image_name
    # a path that goes round the scene, with rigid rotations
    centers = np.stack([c.campos for c in tt])
    assert np.sum(np.ptp(centers, axis=0) > 1.0) >= 2
    for c in tt:
        np.testing.assert_allclose(c.R.T @ c.R, np.eye(3), atol=1e-8)


@pytest.mark.parametrize("with_cv2", [True, False])
def test_create_video_writes_its_frames(with_cv2, tmp_path, monkeypatch):
    from gssr_tpu_torch.utils.render_paths import create_video
    if not with_cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)    # import fails
    frames = [np.full((32, 48, 3), v, np.float32) for v in (0.1, 0.5, 0.9)]
    out = create_video(frames, str(tmp_path / "v.mp4"), fps=5)
    if out.endswith(".mp4"):
        assert with_cv2 and os.path.getsize(out) > 0
    else:
        # without OpenCV (or its codec): one PNG per frame
        assert out == str(tmp_path / "v_frames")
        from PIL import Image
        names = sorted(os.listdir(out))
        assert names == ["00000.png", "00001.png", "00002.png"]
        img = np.asarray(Image.open(os.path.join(out, names[1])))
        assert img.shape == (32, 48, 3) and (img == 127).all()
    if not with_cv2:
        assert not out.endswith(".mp4")
