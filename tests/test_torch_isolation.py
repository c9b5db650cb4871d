"""gssr_tpu_torch stands alone: it imports neither jax nor gssr_tpu.

The import check runs in a subprocess, because tests/conftest.py imports
jax into the test process itself.
"""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gssr_tpu_torch")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import gssr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gssr_tpu_torch.__path__,
                                               "gssr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "gssr_tpu"))
assert not leaked, leaked
for must in ("ops.blend", "ops.blend2d", "ops.projection2d", "ops.rasterize2d",
             "ops.sampling", "models.twod", "scene.twodgs", "utils.tsdf",
             "utils.mtet", "utils.mesh_eval", "utils.mesh_extract",
             "extract_mesh", "ops.blend_pgsr", "ops.rasterize_pgsr",
             "models.pgsr", "scene.pgsr", "dataio.view_selection",
             "ops.voxel", "models.scaffold", "models.interop",
             "scene.scaffold", "scene.octree", "models.octree",
             "scene.scaffold_2dgs", "scene.octree_2dgs",
             "scene.scaffold_pgsr", "scene.octree_pgsr", "utils.partition",
             "utils.render_paths", "split_scene", "train_split",
             "extract_mesh_split", "convert", "parallel.comm",
             "parallel.launch", "parallel.sharded", "ops.band"):
    assert "gssr_tpu_torch." + must in names, (must, names)
assert len(names) >= 50, names
print(len(names))
"""


def test_port_modules_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_never_name_jax_or_the_reference():
    bad = re.compile(r"^\s*(import jax|from jax)|\bgssr_tpu\.", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    hits = []
    for path in files:
        with open(path) as f:
            hits += [f"{path}: {m.group(0)}" for m in bad.finditer(f.read())]
    assert not hits, hits
