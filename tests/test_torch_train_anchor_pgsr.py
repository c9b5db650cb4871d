"""The anchor planar methods in the port track gssr_tpu (its Pallas planar
kernels in interpret mode) step for step: `scaffold-pgsr` and
`octree-pgsr` (three levels) over 10 steps with the two-camera step from
step 7 (multi_view_from 6): the neighbour's render with its own prefilter
and level gate, and the normal, geo and NCC losses. Each step starts both
sides from gssr_tpu's state (track_gssr_tpu's `resync`): on a two-camera
step an offset's gradient can be the difference of geo and NCC terms 80
times its size, which Adam then scales to a full-size update, so two
float implementations that agree step by step drift apart over several
such steps. (From one step's shared state the statistics still differ by
up to 1e-4 of their largest value, through the normal loss's
normalisation of near-zero depth-normal cross products, against the 2e-4
tolerance; 1.6e-4 with the two-camera step from step 5.)
The neighbour picks are recorded on both sides and must agree; with 4
cameras and num_multi_view 5 every camera lists itself among its
neighbours, as in gssr_tpu, and the test scene's 32 x 32 pixels stay below
num_sample, so both NCC samples take every pixel
(tests/test_torch_train_octree.py::track_gssr_tpu states the tolerances).
Also: a gssr_tpu scaffold-pgsr checkpoint resumes in the port.
"""
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_train_octree import configure, track_gssr_tpu  # noqa: E402

MULTI_VIEW_FROM = 6


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from synthetic import write_synthetic_colmap_scene
    d = tmp_path_factory.mktemp("scene_anchor_pgsr")
    write_synthetic_colmap_scene(str(d), n_cams=4, n_pts=64, width=32,
                                 height=32)
    return str(d)


@pytest.mark.parametrize("method", ["scaffold-pgsr", "octree-pgsr"])
def test_anchor_planar_training_tracks_gssr_tpu(scene_dir, tmp_path, method):
    history, grown, _, dropped, picks = track_gssr_tpu(
        method, scene_dir, str(tmp_path), resync=True,
        multi_view_from=MULTI_VIEW_FROM)
    assert grown > 0, grown
    multi = [h for step, h in enumerate(history, 1)
             if step > MULTI_VIEW_FROM]
    assert all("geo_loss" not in h for h in history[:MULTI_VIEW_FROM])
    assert len(picks) == len(multi) > 0
    assert all("ncc_loss" in h and "normal_loss" in h for h in multi)
    assert max(h["geo_loss"] for h in multi) > 0
    assert max(h["ncc_loss"] for h in multi) > 0
    if method.startswith("octree"):
        assert dropped > 0, "the LOD mask dropped no active anchor"


def test_a_gssr_tpu_scaffold_pgsr_checkpoint_resumes_in_the_port(
        scene_dir, tmp_path):
    """The state, the neighbour draws and the sampler resume where
    gssr_tpu stopped, and the port trains on."""
    from gssr_tpu.configs.methods import get_method_config as j_config
    from gssr_tpu.engine.trainer import Trainer as JTrainer
    from gssr_tpu_torch import train
    from gssr_tpu_torch.configs.methods import get_method_config as t_config
    from gssr_tpu_torch.engine.trainer import Trainer as TTrainer

    jt = JTrainer(configure(j_config("scaffold-pgsr"), scene_dir,
                            str(tmp_path / "j")))
    jt.setup()
    js = jt.scene
    for _ in range(3):
        js.dataloader.next_train()
        js.key_host_choice(js.dataloader.train_cameras[0].near_ids)
    jt.save_checkpoint(js.state, 3)

    tc = configure(t_config("scaffold-pgsr"), scene_dir,
                   str(tmp_path / "t"), multi_view_from=3)
    tc.machine.device = "cpu"
    tc.trainer.load_ckpt_dir = str(jt.ckpt_dir)
    tt = TTrainer(tc)
    tt.setup()
    ts = tt.scene
    assert tt.start_step == 3
    for i, (a, b) in enumerate(zip(jax.tree.leaves(js.state),
                                   ts.state_to_numpy(ts.state))):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f"leaf {i}")
    ids = js.dataloader.train_cameras[1].near_ids
    assert ts.key_host_choice(ids) == js.key_host_choice(ids)
    assert ts.dataloader.next_train().image_name == \
        js.dataloader.next_train().image_name

    tc.trainer.iterations = 6
    tc.trainer.test_iterations = [6]
    tc.trainer.save_iterations = [6]
    tc.trainer.log_interval = 1
    trainer = train.main(tc)
    assert [h[0] for h in trainer.history] == [4, 5, 6]
    assert all(np.isfinite(h[1]) for h in trainer.history)
    assert all("geo_loss" in h[4] for h in trainer.history)
