"""Nothing the harness loads is jax, jaxlib, flax or the JAX package, by
whole top-level name: gssr_tpu_torch passes, gssr_tpu does not."""
import subprocess
import sys
import types

from portbench import harness


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gssr_tpu_torch_fake.x",
                        types.ModuleType("x"))
    assert "gssr_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "gssr_tpu.fake", types.ModuleType("y"))
    assert "gssr_tpu" in harness.banned_modules()


def test_harness_and_program_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness, calibrate, counts, tracing, scene\n"
        "bench = harness.benchmark()\n"
        "for w in bench['workloads']:\n"
        "    c = harness.Cell.named(w['name'])\n"
        "    harness.reference(c.config)\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    harness.metric_reader(m['name'])\n"
        "import gssr_tpu_torch.train, gssr_tpu_torch.engine.trainer\n"
        "import gssr_tpu_torch.configs.methods as M\n"
        "import gssr_tpu_torch.scene.vanilla, gssr_tpu_torch.scene.octree_2dgs\n"
        "print(','.join(harness.banned_modules()))\n"
        % str(harness.CHECKOUT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "", out.stdout
