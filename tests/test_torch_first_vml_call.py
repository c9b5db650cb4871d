"""oneMKL's vector math (VML) and the first parallel torch.exp of a process.

On the CPU, torch.exp, torch.log and their kin call VML, which picks its
CPU code path on its first call and caches it in a static,
`mkl_vml_serv_cpu_detect.vml_cpu_type`, without a lock: it writes -1, the
raw CPU id, then the kernel table's index. A thread that reads the static
between the last two writes runs its call with a low-accuracy kernel. When
a process's first VML call is a parallel one, such as the plain surfel
forward's exp over [tiles, 256, 128] values, one OpenMP thread's share can
come out wrong by up to 1.5e-4 relative, for that call only.

`import gssr_tpu_torch` makes one VML call on the importing thread, so the
static holds its final value before any parallel call can race it. The
first test reads the static in fresh processes; the second starts fresh
processes together and holds each one's first parallel exp against its
second (tests/torch_first_vml_repro.py).
"""
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB = os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cpu.so")
STATIC = "mkl_vml_serv_cpu_detect.vml_cpu_type"
ANCHOR = "vmsExp"


def _offsets():
    """The static's and an exported VML function's offsets in libtorch_cpu,
    from its symbol table; None where torch carries no oneMKL VML."""
    if not os.path.exists(LIB) or shutil.which("nm") is None:
        return None
    out = subprocess.run(["nm", LIB], capture_output=True, text=True).stdout
    syms = {}
    for line in out.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[2] in (STATIC, ANCHOR):
            syms[parts[2]] = int(parts[0], 16)
    return syms if len(syms) == 2 else None


_PROBE = """
import ctypes, sys
import torch
lib, static, anchor, mode = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
if mode == "port":
    import gssr_tpu_torch
elif mode == "exp":
    torch.exp(torch.zeros(16))
base = ctypes.cast(ctypes.CDLL(lib).vmsExp, ctypes.c_void_p).value - anchor
print(ctypes.c_int.from_address(base + static).value)
"""


def _cpu_type_after(mode, syms):
    p = subprocess.run(
        [sys.executable, "-c", _PROBE, LIB, str(syms[STATIC]),
         str(syms[ANCHOR]), mode],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert p.returncode == 0, p.stderr
    return int(p.stdout.split()[-1])


def test_importing_the_port_chooses_vmls_code_path():
    """A fresh process that has only imported torch has not chosen VML's
    code path (-1); one VML call chooses it; importing gssr_tpu_torch
    chooses it too, so no later call of the port can be the racing first
    one."""
    syms = _offsets()
    if syms is None:
        pytest.skip("this torch build carries no oneMKL VML symbols")
    assert _cpu_type_after("none", syms) == -1
    chosen = _cpu_type_after("exp", syms)
    assert chosen != -1
    assert _cpu_type_after("port", syms) == chosen


def test_a_first_parallel_exp_after_import_equals_the_second():
    """Eight fresh processes, started together, each import the port and
    then make their first parallel exp, one share per intra-op thread at
    the plain forwards' shape: it equals their second, bit for bit
    (tests/torch_first_vml_repro.py; with `--first none` in place of the
    import, 8 processes at a time, some come out unequal)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_first_vml_repro import run
    assert [r["unequal"] for r in run(8, 8, "port")] == [0] * 8
