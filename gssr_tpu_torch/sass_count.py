"""Instruction counts of the built blend kernels, from `cuobjdump -sass`.

    python -m gssr_tpu_torch.sass_count

Builds the kernels as ops/_kernels.py does (nvcc; no card needed) and
prints, per kernel of each library, its SASS instruction count and how many
of those are shared loads (LDS), shuffles (SHFL) and MUFU operations, for
the whole kernel and for each loop of at least 16 instructions (a loop: the
instructions from a backward branch's target to the branch). The counts are
static: they say what one pass of a loop issues, not how often it runs.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

from gssr_tpu_torch.ops import _kernels

LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
BACK_EDGE = re.compile(r"\bBRA(?:\.\w+)*\s+(?:!?U?P\w+\s*,\s*)?0x([0-9a-f]+)")
KINDS = ("LDS", "SHFL", "MUFU")
MIN_LOOP = 16


def mix(ops) -> dict:
    """Instruction count of (address, instruction) pairs, and how many are
    of each of KINDS."""
    opcodes = [re.sub(r"^@!?U?P\w+\s+", "", op).split()[0] for _, op in ops]
    return {"instructions": len(opcodes),
            **{k: sum(op.startswith(k) for op in opcodes) for k in KINDS}}


def parse(text: str) -> dict:
    """Kernel name -> mix of the whole kernel, with "loops": the mix of
    each loop of at least MIN_LOOP instructions, from `cuobjdump -sass`
    text."""
    kernels = {}
    for part in text.split("Function : ")[1:]:
        ops = [(int(m.group(1), 16), m.group(2))
               for m in map(LINE.search, part.splitlines()) if m]
        loops = []
        for addr, op in ops:
            b = BACK_EDGE.search(op)
            if b and int(b.group(1), 16) <= addr:
                body = [x for x in ops if int(b.group(1), 16) <= x[0] <= addr]
                if len(body) >= MIN_LOOP:
                    loops.append(mix(body))
        kernels[part.split(None, 1)[0]] = {**mix(ops), "loops": loops}
    return kernels


def main() -> int:
    cuobjdump = Path(_kernels._nvcc()).with_name("cuobjdump")
    for src, lib in _kernels.build()["libs"].items():
        text = subprocess.run([str(cuobjdump), "-sass", str(lib["path"])],
                              capture_output=True, text=True,
                              check=True).stdout
        for kernel, c in parse(text).items():
            whole = {k: v for k, v in c.items() if k != "loops"}
            print(f"[sass] {src} {kernel}: {whole}; loops {c['loops']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
