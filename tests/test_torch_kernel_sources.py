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

from gssr_tpu_torch.ops import _kernels, blend, blend2d, blend_pgsr

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


@pytest.mark.parametrize("module", [blend, blend2d, blend_pgsr],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_launch_counters_name_entry_points(module):
    """Every kernel a wrapper counts has its entry point, gssr_<key>, in the
    source bound for that module."""
    source = Path(module.__file__).stem + ".cu"
    defined = entry_points(source)
    assert module.LAUNCHES
    for key in module.LAUNCHES:
        assert f"gssr_{key}" in defined, (key, sorted(defined))
