"""parallel/launch.py and parallel/comm.py: the launcher's environment
contract (the counterpart of gssr_tpu's tests/test_parallel.py launch
test), torchrun's variables, a group of one, and spawn's ranks with the
exact collectives and a failing rank. The inits run in subprocesses, so
that no group outlives its test."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_VARS = ("GSSR_COORDINATOR", "GSSR_NUM_PROCESSES", "GSSR_PROCESS_ID",
               "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(code, **env_vars):
    env = {k: v for k, v in os.environ.items()
           if k not in LAUNCH_VARS + ("PYTHONPATH",)}
    env.update(PYTHONPATH=REPO, **env_vars)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


_INIT = """
import torch
torch.set_num_threads(1)
from gssr_tpu_torch.configs.base import MachineConfig
from gssr_tpu_torch.parallel import comm
from gssr_tpu_torch.parallel.launch import (
    maybe_initialize_distributed, shutdown_distributed)
m = MachineConfig(device="cpu", num_hosts=3, host_rank=2, dist_init={flag})
assert maybe_initialize_distributed(m) is True
assert (m.num_hosts, m.host_rank) == (1, 0)
assert comm.backend() == "gloo" and comm.world() == 1
assert maybe_initialize_distributed(m) is True      # idempotent
x = torch.tensor([[1.5, -0.0]])
assert torch.equal(comm.all_gather(x), x)
shutdown_distributed()
shutdown_distributed()                               # idempotent
assert not comm.group_up()
print("ok", flush=True)
"""


def test_no_launch_without_environment_or_flag(monkeypatch):
    from gssr_tpu_torch.configs.base import MachineConfig
    from gssr_tpu_torch.parallel import comm
    from gssr_tpu_torch.parallel.launch import maybe_initialize_distributed
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    m = MachineConfig(device="cpu", num_hosts=3, host_rank=2)
    assert maybe_initialize_distributed(m) is False
    assert (m.num_hosts, m.host_rank) == (3, 2)      # untouched
    assert not comm.group_up() and comm.world() == 1


def test_one_process_group_through_the_gssr_environment():
    p = _run(_INIT.format(flag=False),
             GSSR_COORDINATOR=f"127.0.0.1:{_free_port()}",
             GSSR_NUM_PROCESSES="1", GSSR_PROCESS_ID="0")
    assert p.returncode == 0 and "ok" in p.stdout, p.stdout + p.stderr
    assert "torch.distributed up: 1 processes, backend gloo" in p.stdout


def test_torchrun_variables_are_read():
    p = _run(_INIT.format(flag=False), RANK="0", WORLD_SIZE="1",
             LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
             MASTER_PORT=str(_free_port()))
    assert p.returncode == 0 and "ok" in p.stdout, p.stdout + p.stderr


def test_dist_init_alone_makes_a_group_of_one():
    p = _run(_INIT.format(flag=True))
    assert p.returncode == 0 and "ok" in p.stdout, p.stdout + p.stderr


def _collectives():
    import torch

    from gssr_tpu_torch.parallel import comm
    torch.set_num_threads(1)
    r = comm.rank()
    x = torch.tensor([[r + 0.5, -0.0], [float("nan"), 1e-30 * (r + 1)]])
    flags = torch.tensor([r == 0, True])
    ints = torch.tensor([r, -7], dtype=torch.int32)
    y = (torch.arange(4.0) * (r + 1)).requires_grad_(True)
    z = comm.gather_shards(y.reshape(2, 2))
    (grad,) = torch.autograd.grad(
        (z * torch.arange(8.0).reshape(4, 2)).sum(), y)
    cols = comm.all_gather_cols([torch.full((2,), r + 0.25),
                                 torch.full((2, 3), r, dtype=torch.int32)])
    return dict(x=comm.all_gather(x).numpy(),
                flags=comm.all_gather(flags).numpy(),
                ints=comm.all_gather(ints).numpy(), grad=grad.numpy(),
                z=z.detach().numpy(), cols=[c.numpy() for c in cols],
                max=comm.all_reduce(torch.tensor(float(r)), "max").item(),
                sums=[t.numpy() for t in comm.all_reduce_many(
                    [torch.tensor([1.0, r]), torch.tensor(2.0)])])


def test_spawned_ranks_gather_bit_for_bit(tmp_path):
    from gssr_tpu_torch.parallel.launch import spawn
    out = spawn(_collectives, 2, "gloo", "cpu", str(tmp_path), timeout=300)
    for r, o in enumerate(out):
        want = np.array([[0.5, -0.0], [np.nan, 1e-30],
                         [1.5, -0.0], [np.nan, 2e-30]], np.float32)
        assert o["x"].tobytes() == want.tobytes()      # -0.0 and NaN too
        np.testing.assert_array_equal(o["flags"], [True, True, False, True])
        np.testing.assert_array_equal(o["ints"], [0, -7, 1, -7])
        np.testing.assert_array_equal(o["z"], [[0, 1], [2, 3], [0, 2],
                                               [4, 6]])
        # the backward is this rank's rows of the cotangent, unsummed
        np.testing.assert_array_equal(o["grad"],
                                      np.arange(8.0)[4 * r:4 * r + 4])
        np.testing.assert_array_equal(o["cols"][0], [0.25, 0.25, 1.25,
                                                     1.25])
        assert o["cols"][1].dtype == np.int32
        np.testing.assert_array_equal(o["cols"][1][:, 0], [0, 0, 1, 1])
        assert o["max"] == 1.0
        np.testing.assert_array_equal(o["sums"][0], [2.0, 1.0])
        assert o["sums"][1] == 4.0


def test_spawn_raises_with_a_failing_rank(tmp_path):
    import torch_parallel_ranks as ranks

    from gssr_tpu_torch.parallel.launch import spawn
    with pytest.raises(RuntimeError, match="rank one fails"):
        spawn(ranks.fail, 2, "gloo", "cpu", str(tmp_path), ("rank one fails",),
              timeout=300)
