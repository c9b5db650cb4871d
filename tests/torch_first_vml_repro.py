"""The first parallel torch.exp of fresh processes, held against their second.

    python tests/torch_first_vml_repro.py [--processes N] [--parallel P]
                                          [--first none|exp|port]

Starts N fresh processes, P at a time. Each one makes a first call before
its first parallel exp: nothing (`none`, torch alone), one exp of 16 values
on its own thread (`exp`), or `import gssr_tpu_torch` (`port`). Its first
parallel exp covers [4, 256, 128] exponents, the plain surfel forward's
shape at 32 x 32, one share per intra-op thread. The script prints how many
processes got a first exp unequal to their second, bit for bit, and the
largest relative difference. With `none` and `exp` it runs no code of the
port; it never imports jax.
"""
import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import json, sys
import numpy as np
import torch
if sys.argv[1] == "exp":
    torch.exp(torch.zeros(16))
elif sys.argv[1] == "port":
    import gssr_tpu_torch
rng = np.random.default_rng(0)
x = np.where(rng.random(131072) < 0.95, rng.uniform(-20.0, 0.0, 131072),
             rng.uniform(-800.0, -90.0, 131072)).astype(np.float32)
x = torch.from_numpy(x).reshape(4, 256, 128)
first = torch.exp(x)
second = torch.exp(x)
rel = ((first - second).abs() / second.clamp(min=1e-30)).max().item()
print(json.dumps({"unequal": int((first != second).sum()), "rel": rel}))
"""


def one(first: str) -> dict:
    p = subprocess.run([sys.executable, "-c", CHILD, first], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": REPO})
    if p.returncode != 0:
        raise RuntimeError(p.stderr)
    return json.loads(p.stdout.splitlines()[-1])


def run(processes: int, parallel: int, first: str) -> list[dict]:
    """One result per process: elements unequal and the largest relative
    difference between its first and second parallel exp."""
    with ThreadPoolExecutor(parallel) as pool:
        return list(pool.map(one, [first] * processes))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=160)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--first", choices=("none", "exp", "port"), default="none")
    a = ap.parse_args(argv)
    res = run(a.processes, a.parallel, a.first)
    wrong = [r for r in res if r["unequal"]]
    print(json.dumps({"first": a.first, "processes": a.processes,
                      "parallel": a.parallel, "wrong": len(wrong),
                      "max_rel": max((r["rel"] for r in res), default=0.0)}))


if __name__ == "__main__":
    main()
