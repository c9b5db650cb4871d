"""The C entry points of gssr_tpu_torch/csrc/*.cu against the ctypes table
that binds them (ops/_kernels.py::SOURCES), and the wrappers' launch
counters against the entry points.

No CUDA compiler or card is needed: the sources are parsed as text. An entry
point missing on either side, or an argument of another kind than its
binding says (ctypes would pass a pointer or a 64-bit count cut to 32 bits
without a word), fails here and not first on the card.
"""
import ctypes
import re
from pathlib import Path

import pytest

from gssr_tpu_torch.ops import (_kernels, binning, blend, blend2d,
                                blend_pgsr, projection)

CSRC = Path(_kernels.__file__).resolve().parent.parent / "csrc"
KIND = {ctypes.c_void_p: "pointer", ctypes.c_int64: "int64",
        ctypes.c_int: "int32"}
SCALARS = {("long", "long"): "int64", ("int",): "int32"}


def _param(text: str):
    """(kind, name) of one C parameter, e.g. 'const float* attrs'."""
    name = re.findall(r"\w+", text)[-1]
    if "*" in text:
        return "pointer", name
    words = tuple(w for w in re.findall(r"\w+", text)[:-1] if w != "const")
    return SCALARS[words], name


def entry_points(source: str) -> dict:
    """name -> (return type, [(kind, name) per parameter]) of every function
    defined in the source's extern "C" block."""
    text = (CSRC / source).read_text()
    block = re.search(r'extern "C" \{(.*)\}\s*// extern "C"', text, re.S)
    assert block, f'{source} has no extern "C" block'
    body = re.sub(r"//[^\n]*", "", block.group(1))
    found = {}
    for m in re.finditer(r"([\w*]+)\s+(gssr_\w+)\s*\(([^)]*)\)\s*\{", body):
        found[m.group(2)] = (m.group(1), [_param(p)
                                          for p in m.group(3).split(",")])
    return found


def test_sources_are_the_csrc_files():
    assert set(_kernels.SOURCES) == {p.name for p in CSRC.glob("*.cu")}


@pytest.mark.parametrize("source", sorted(_kernels.SOURCES))
def test_entry_points_match_their_bindings(source):
    """Each entry point returns the int error code, takes the stream last,
    and takes before it exactly the kinds its binding declares; no entry
    point is left unbound and no binding names a missing one."""
    defined = entry_points(source)
    bound = _kernels.SOURCES[source]
    assert set(defined) == set(bound)
    for name, (ret, params) in defined.items():
        assert ret == "int", name
        assert params[-1] == ("pointer", "stream"), (name, params)
        assert [k for k, _ in params[:-1]] == [KIND[t] for t in bound[name]], \
            (name, params)


@pytest.mark.parametrize("module",
                         [binning, blend, blend2d, blend_pgsr, projection],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_launch_counters_name_entry_points(module):
    """Every kernel a wrapper counts has its entry point, gssr_<key>, in the
    source bound for that module."""
    source = Path(module.__file__).stem + ".cu"
    defined = entry_points(source)
    assert module.LAUNCHES
    for key in module.LAUNCHES:
        assert f"gssr_{key}" in defined, (key, sorted(defined))


def _sass_text(name, ops):
    """A kernel's `cuobjdump -sass` listing: one instruction per 16 bytes,
    each with its encoding comment and a second encoding line."""
    lines = [f"\t\tFunction : {name}", '\t.headerflags\t@"EF_CUDA_SM90"']
    for i, op in enumerate(ops):
        lines += [f"        /*{16 * i:04x}*/                   {op} ;"
                  f"          /* 0x000fe40000000800 */",
                  " " * 80 + "/* 0x000fe40000000f00 */"]
    return "\n".join(lines) + "\n"


def test_sass_count_finds_loops_and_kinds():
    """sass_count.parse counts a kernel's instructions and its shared loads,
    shuffles and MUFU operations (a predicate before an opcode included),
    and reports a loop (from a backward branch's target to the branch)
    only with at least MIN_LOOP instructions; a forward branch is none."""
    from gssr_tpu_torch import sass_count
    body = (["FADD R2, R2, R3"] * 14 + ["@!P1 LDS R4, [R5]",
            "SHFL.BFLY PT, R6, R7, 0x1, 0x1f", "MUFU.EX2 R8, R9",
            "@P0 BRA 0x20"])
    short = ["IADD3 R1, R1, 0x1, RZ", "ISETP.NE.AND P0, PT, R1, R2, PT",
             "@P0 BRA 0x140"]
    looped = ["S2R R0, SR_TID.X", "@P2 BRA 0x170"] + body + short + ["EXIT"]
    text = (_sass_text("k_loop", looped)
            + _sass_text("k_flat", ["S2R R0, SR_TID.X", "EXIT"]))
    found = sass_count.parse(text)
    assert found == {
        "k_loop": {"instructions": 24, "LDS": 1, "SHFL": 1, "MUFU": 1,
                   "loops": [{"instructions": 18, "LDS": 1, "SHFL": 1,
                              "MUFU": 1}]},
        "k_flat": {"instructions": 2, "LDS": 0, "SHFL": 0, "MUFU": 0,
                   "loops": []}}
