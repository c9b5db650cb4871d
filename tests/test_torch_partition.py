"""The port's VastGaussian partitioner against gssr_tpu's: every stage on
the same model, and split_scene as a whole on the same scene, in four
cases (a column grid, the automatic halving, the estimated alignment and
an alignment file). Ids and counts must be equal and floats equal bit for
bit; the box and alignment files are compared as text."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

CASES = {
    # the model as written: the ring's cameras all at y = 0, so the boxes
    # hold no point and the visibility stage adds no camera
    "grid": dict(num_col=2, num_row=1, visibility_threshold=0.3),
    # in the ground-plane frame, as --auto-align partitions: the tiles hold
    # points and the visibility stage adds cameras
    "auto": dict(max_num_images=7, auto_align=True,
                 visibility_threshold=0.05),
    "auto_align": dict(num_col=1, num_row=2, auto_align=True,
                       visibility_threshold=0.1),
    # two halvings in a tilted frame: tiles with no point, with fewer than
    # four, and with more
    "transform_file": dict(max_num_images=4, transform_file=True,
                           visibility_threshold=0.05),
}
N_TILES = {"grid": 2, "auto": 2, "auto_align": 2, "transform_file": 4}


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from synthetic import write_synthetic_colmap_scene
    d = tmp_path_factory.mktemp("scene")
    write_synthetic_colmap_scene(str(d), n_cams=12, n_pts=96, width=32,
                                 height=32, gt_mode="noise")
    return str(d)


def _transform_file(d):
    """A rotation about a tilted axis, with a scale and a translation the
    alignment must drop."""
    c, s = np.cos(0.7), np.sin(0.7)
    P = np.eye(4)
    P[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.array(
        [[1, 0, 0], [0, np.cos(0.4), -np.sin(0.4)],
         [0, np.sin(0.4), np.cos(0.4)]]) * 1.5
    P[:3, 3] = [0.3, -0.2, 1.0]
    path = os.path.join(d, "transform.txt")
    np.savetxt(path, P)
    return path


def _assert_images(a, b):
    """Two lists of ColmapImage (gssr_tpu's, the port's): same images in
    the same order, equal bit for bit."""
    assert [im.id for im in a] == [im.id for im in b]
    for x, y in zip(a, b):
        assert (x.name, x.camera_id) == (y.name, y.camera_id)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(np.asarray(getattr(y, f)),
                                          np.asarray(getattr(x, f)),
                                          err_msg=f)


def _assert_points(a, b):
    assert [p.id for p in a] == [p.id for p in b]
    for x, y in zip(a, b):
        assert x.error == y.error
        for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            np.testing.assert_array_equal(np.asarray(getattr(y, f)),
                                          np.asarray(getattr(x, f)),
                                          err_msg=f)


def _assert_tiles(a, b, points=True):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y["box"], x["box"])
        _assert_images(x["images"], y["images"])
        if points:
            _assert_points(x["points3D"], y["points3D"])


def _assert_models(a_dir, b_dir):
    from gssr_tpu.dataio import colmap
    (ca, ia, pa), (cb, ib, pb) = (colmap.read_model(d)
                                  for d in (a_dir, b_dir))
    assert sorted(ca) == sorted(cb)
    for k in ca:
        assert (ca[k].model, ca[k].width, ca[k].height) == \
            (cb[k].model, cb[k].width, cb[k].height)
        np.testing.assert_array_equal(cb[k].params, ca[k].params)
    _assert_images([ia[k] for k in sorted(ia)], [ib[k] for k in sorted(ib)])
    _assert_points([pa[k] for k in sorted(pa)], [pb[k] for k in sorted(pb)])


@pytest.mark.parametrize("case", list(CASES))
def test_each_stage_matches_gssr_tpu(case, scene_dir, tmp_path):
    from gssr_tpu.dataio import colmap as jcolmap
    from gssr_tpu.utils import partition as jp
    from gssr_tpu_torch.dataio import colmap as tcolmap
    from gssr_tpu_torch.utils import partition as tp
    kw = dict(CASES[case])
    sparse = os.path.join(scene_dir, "sparse/0")
    transform = None
    if kw.pop("auto_align", False):
        _, ji, _ = jcolmap.read_model(sparse)
        _, ti, _ = tcolmap.read_model(sparse)
        P = jp.estimate_orientation_alignment(ji)
        np.testing.assert_array_equal(tp.estimate_orientation_alignment(ti),
                                      P)
        transform = str(tmp_path / "align.txt")
        np.savetxt(transform, P)
    if kw.pop("transform_file", False):
        transform = _transform_file(str(tmp_path))
    if transform is None:
        jm, tm = jcolmap.read_model(sparse), tcolmap.read_model(sparse)
    else:
        jm = jp.transform_colmap(sparse, str(tmp_path / "j"), transform)
        tm = tp.transform_colmap(sparse, str(tmp_path / "t"), transform)
        _assert_models(str(tmp_path / "j"), str(tmp_path / "t"))
    (jc, ji, jpts), (tc, ti, tpts) = jm, tm
    vis = kw.pop("visibility_threshold")

    jt = jp.region_division(ji, kw.get("num_col"), kw.get("num_row"),
                            kw.get("max_num_images", 150))
    tt = tp.region_division(ti, kw.get("num_col"), kw.get("num_row"),
                            kw.get("max_num_images", 150))
    _assert_tiles(jt, tt, points=False)
    assert len(tt) == N_TILES[case]
    jt = jp.position_based_data_selection(jt, ji, jpts, ratio=0.1)
    tt = tp.position_based_data_selection(tt, ti, tpts, ratio=0.1)
    _assert_tiles(jt, tt)
    n_cams = sum(len(t["images"]) for t in tt)
    jt = jp.visibility_based_camera_selection(jt, ji, jc, threshold=vis)
    tt = tp.visibility_based_camera_selection(tt, ti, tc, threshold=vis)
    _assert_tiles(jt, tt)
    if case != "grid":
        assert sum(len(t["images"]) for t in tt) > n_cams
    jt = jp.coverage_based_point_selection(jt, jpts)
    tt = tp.coverage_based_point_selection(tt, tpts)
    _assert_tiles(jt, tt)


@pytest.mark.parametrize("case", list(CASES))
def test_split_scene_matches_gssr_tpu(case, scene_dir, tmp_path):
    from gssr_tpu.utils.partition import split_scene as j_split
    from gssr_tpu_torch.utils.partition import split_scene as t_split
    kw = dict(CASES[case])
    if kw.pop("transform_file", False):
        kw["transform_file"] = _transform_file(str(tmp_path))
    jdirs = j_split(scene_dir, str(tmp_path / "j"), **kw)
    tdirs = t_split(scene_dir, str(tmp_path / "t"), **kw)
    assert [os.path.basename(d) for d in tdirs] == \
        [os.path.basename(d) for d in jdirs]
    assert len(tdirs) == N_TILES[case]
    for jd, td in zip(jdirs, tdirs):
        _assert_models(os.path.join(jd, "sparse/0"),
                       os.path.join(td, "sparse/0"))
        with open(os.path.join(jd, "box.txt")) as a, \
                open(os.path.join(td, "box.txt")) as b:
            assert b.read() == a.read()
        assert sorted(os.listdir(os.path.join(td, "images"))) == \
            sorted(os.listdir(os.path.join(jd, "images")))
        assert os.listdir(os.path.join(td, "images"))
    if case in ("auto", "auto_align"):
        with open(tmp_path / "j" / "align_transform.txt") as a, \
                open(tmp_path / "t" / "align_transform.txt") as b:
            assert b.read() == a.read()
    if case != "grid":
        _assert_models(str(tmp_path / "j" / "sparse/aligned"),
                       str(tmp_path / "t" / "sparse/aligned"))


def test_polygon_clip_matches_gssr_tpu():
    from gssr_tpu.utils.partition import _clip_poly_to_rect as j_clip
    from gssr_tpu_torch.utils.partition import _clip_poly_to_rect as t_clip
    from scipy.spatial import ConvexHull
    rng = np.random.default_rng(3)
    polys = [rng.uniform(-40, 70, 2) + rng.uniform(0, 40, (8, 2))
             for _ in range(60)] + [rng.uniform(-50, 80, (8, 2))
                                    for _ in range(10)]
    areas = []
    for pts in polys:
        poly = pts[ConvexHull(pts).vertices]
        areas.append(t_clip(poly, 32.0, 24.0))
        assert areas[-1] == j_clip(poly, 32.0, 24.0)
    # outside, straddling and covering polygons all occur
    assert min(areas) == 0.0 and max(areas) == 32.0 * 24.0
    assert any(0 < a < 32.0 * 24.0 for a in areas)
