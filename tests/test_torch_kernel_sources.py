"""The C entry points of gssr_tpu_torch/csrc/*.cu against the ctypes table
that binds them (ops/_kernels.py::SOURCES), the wrappers' launch counters
against the entry points, the blend wrappers' shared input check
(ops/blend_launch.py), and chip_smoke.py's yardstick, which holds every
kernel against the parent commit's build through those counters.

No CUDA compiler or card is needed: the sources are parsed as text. An entry
point missing on either side, or an argument of another kind than its
binding says (ctypes would pass a pointer or a 64-bit count cut to 32 bits
without a word), fails here and not first on the card.
"""
import ctypes
import re
from pathlib import Path

import pytest
import torch

from gssr_tpu_torch.ops import (_kernels, binning, blend, blend2d,
                                blend_pgsr, projection, sh)

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
                         [binning, blend, blend2d, blend_pgsr, projection, sh],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_launch_counters_name_entry_points(module):
    """Every kernel a wrapper counts has its entry point, gssr_<key>, in the
    source bound for that module."""
    source = Path(module.__file__).stem + ".cu"
    defined = entry_points(source)
    assert module.LAUNCHES
    for key in module.LAUNCHES:
        assert f"gssr_{key}" in defined, (key, sorted(defined))


def test_no_entry_point_binding_or_counter_names_a_second_design():
    """Each kernel has one design in the source: no entry point, binding or
    launch counter names a numbered second one (`*_v<n>`); the parent
    commit's build is the yardstick (chip_smoke.py --yardstick)."""
    names = set()
    for source, entries in _kernels.SOURCES.items():
        names |= set(entries) | set(entry_points(source))
    for module in (binning, blend, blend2d, blend_pgsr, projection, sh):
        names |= set(module.LAUNCHES)
    assert names and not [n for n in names if re.search(r"_v\d+$", n)], names


def test_the_yardstick_reaches_every_entry_point():
    """chip_smoke.py's yardstick sees a kernel held through the launch
    counter that moved under the parent's table: every entry point but
    the occupancy ones has its counter among those kernel_table restores,
    and every counter there names an entry point. (On the card, the run
    fails unless each of them was held.)"""
    import chip_smoke
    entries = [n for es in _kernels.SOURCES.values() for n in es]
    keys = chip_smoke.kernel_keys(entries)
    assert keys and not [k for k in keys if k.endswith("_occupancy")]
    assert keys == {k for c in chip_smoke.kernel_counts() for k in c}


@pytest.fixture
def own_table(monkeypatch):
    """A stand-in for _kernels' table, so that nothing is built; every
    launch count is put back afterwards."""
    own = {"gssr_blend_fwd": 1.0, "gssr_bin_expand": 1.0,
           "gssr_blend_fwd_occupancy": None}
    monkeypatch.setattr(_kernels, "_fns", own)
    counts = [(c, dict(c)) for c in (binning.LAUNCHES, blend.LAUNCHES)]
    yield own
    for c, was in counts:
        c.update(was)


def _launch(key):
    """A stand-in wrapper call: one launch of entry point gssr_<key> from
    the table in force, counted; its result is what the table holds."""
    counts = next(c for c in (binning.LAUNCHES, blend.LAUNCHES) if key in c)
    counts[key] += 1
    return torch.tensor([_kernels.load()[f"gssr_{key}"]])


@pytest.mark.parametrize("raises", [False, True], ids=["exits", "raises"])
def test_kernel_table_swaps_and_restores(own_table, raises):
    """Inside kernel_table the wrappers find the given table; on the way
    out, by return or by an exception, _kernels' own table and every
    LAUNCHES count are as they were, and the moved counters are named."""
    import chip_smoke
    before = [dict(c) for c in chip_smoke.kernel_counts()]
    parent = {"gssr_blend_fwd": 2.0, "gssr_bin_expand": 2.0}
    try:
        with chip_smoke.kernel_table(parent) as moved:
            assert _kernels.load() is parent
            assert _launch("blend_fwd") == 2.0
            _launch("bin_expand")
            if raises:
                raise RuntimeError("a wrapper failed")
    except RuntimeError:
        assert raises
    assert _kernels.load() is own_table
    assert [dict(c) for c in chip_smoke.kernel_counts()] == before
    assert moved == {"blend_fwd", "bin_expand"}


@pytest.mark.parametrize("parent, held", [
    ({"gssr_blend_fwd": 1.0}, {"blend_fwd"}),
    ({"gssr_blend_fwd": 2.0}, None),
    ({"gssr_bin_expand": 1.0}, set()),
], ids=["equal", "differs", "parent-lacks-it"])
def test_yardstick_holds_each_call_against_the_parents(own_table, parent,
                                                       held):
    """Yardstick.equal makes the call again on the parent's table: an
    equal result holds its kernel, a different one fails, and a kernel
    the parent lacks runs this tree's on both sides and is not held.
    Yardstick.turns times the parent's table in the first and last turns
    and restores the counts."""
    import chip_smoke
    yard = chip_smoke.Yardstick(parent)
    assert yard.keys == chip_smoke.kernel_keys(parent)
    fn = lambda: _launch("blend_fwd")           # noqa: E731
    if held is None:
        with pytest.raises(AssertionError, match="parent's build"):
            yard.equal(fn, fn(), "case")
        return
    yard.equal(fn, fn(), "case")
    assert yard.held == held
    on_parent = []

    def timer(f):
        on_parent.append(_kernels.load() is not own_table)
        return [float(f())]

    before = dict(blend.LAUNCHES)
    ms, parent_ms = yard.turns(fn, timer)
    assert on_parent == [True, False, False, True]
    assert (ms, parent_ms) == (1.0, parent.get("gssr_blend_fwd", 1.0))
    assert blend.LAUNCHES == before


@pytest.mark.parametrize("fault", ["rows", "chunk", "maps", "none"])
@pytest.mark.parametrize("module", [blend, blend2d, blend_pgsr],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_blend_wrappers_check_their_inputs(module, fault):
    """Every blend family's wrappers go through the one input check of
    ops/blend_launch.py, with its own row counts and maps' name: a wrong
    attribute row count, an instance count off the chunk, a map of the
    wrong shape each raise its ValueError before any launch; inputs that
    pass reach the launch of gssr_<family>_bwd, which takes CUDA tensors
    only. (Meta tensors: neither a card nor a build is needed.)"""
    from gssr_tpu_torch.ops.blend_launch import CHUNK
    fam = module._TILES
    rows, out_rows, tx, ty = fam.attr_rows, fam.out_rows, 2, 1
    meta = dict(dtype=torch.float32, device="meta")
    attrs = torch.empty((rows - (fault == "rows"),
                         2 * CHUNK + 8 * (fault == "chunk")), **meta)
    ranges = torch.empty(tx * ty + 1, dtype=torch.int32, device="meta")
    maps = torch.empty((ty * 16, tx * 16, out_rows), **meta)
    cot = torch.empty((ty * 16, tx * 16 + 16 * (fault == "maps"),
                       out_rows), **meta)
    want = {
        "rows": f"attrs must be float32 [{rows}, I] with I a multiple of "
                f"{CHUNK}, got torch.float32 ({rows - 1}, {2 * CHUNK})",
        "chunk": f"attrs must be float32 [{rows}, I] with I a multiple of "
                 f"{CHUNK}, got torch.float32 ({rows}, {2 * CHUNK + 8})",
        "maps": f"{fam.maps_name} must be float32 ({ty * 16}, {tx * 16}, "
                f"{out_rows})",
        "none": f"gssr_{fam.name}_bwd runs on CUDA tensors, got meta",
    }[fault]
    bwd = getattr(module, f"{fam.name}_bwd")
    before = dict(module.LAUNCHES)
    with pytest.raises(ValueError) as err:
        bwd(attrs, ranges, maps, cot, tx, ty)
    assert str(err.value) == want
    assert fam.maps_name == {"blend": "blend maps", "blend2d": "surfel blend maps",
                        "blend_pgsr": "planar blend maps"}[fam.name]
    assert module.LAUNCHES == before


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
