"""The renders' SH colour (gssr_tpu_torch/ops/sh.py): the autograd Function
of csrc/sh.cu's kernel pair, its plain versions and its callers.

On the CPU the Function runs through the plain versions (the eager chain
forward, autograd's gradients of it backward), and must give the chain's
colour and gradients, dense and contiguous, at degrees 0-3, on
chip_smoke.sh_cases' inputs: a mean at the camera centre, rgb + 0.5
exactly 0 and on either side of it, K = 16 below degree 3, models of a
lower degree, C = 0. The `cuda` test holds the
kernels to the same on the card: the forward bit for bit, the backward at
atol 1e-6 / rtol 1e-5 (its direction gradient sums in another order) and
bit for bit from run to run.
"""
import math

import numpy as np
import pytest
import torch

from chip_smoke import SH_BWD_TOL, sh_cases
from gssr_tpu_torch.ops import _kernels
from gssr_tpu_torch.ops import sh as S

CASES = list(sh_cases())


@pytest.fixture
def no_launch(monkeypatch):
    """_kernels.launch raises: a CPU path that reaches a kernel fails."""
    def launch(name, *args):
        raise AssertionError(f"{name} launched on the CPU path")
    monkeypatch.setattr(_kernels, "launch", launch)


def _leaves(case):
    deg, means, f_dc, f_rest, campos, d_color = case
    return deg, [t.clone().requires_grad_() for t in (means, f_dc, f_rest)], \
        campos, d_color


@pytest.mark.parametrize("form", ["pair", "tensor"])
def test_cpu_tensors_take_the_plain_chain(no_launch, form):
    """sh_to_color on CPU tensors is the eager chain, from the pair or from
    one [C,K,3] tensor, forward and backward, and counts no launch."""
    deg, (means, f_dc, f_rest), campos, d_color = _leaves(
        sh_cases()["degree 3, K = 16"])
    before = dict(S.LAUNCHES)
    sh = (f_dc, f_rest) if form == "pair" else torch.cat([f_dc, f_rest], 1)
    color = S.sh_to_color(deg, sh, means, campos)
    want = S.sh_to_color_plain(deg, torch.cat([f_dc, f_rest], 1), means,
                               campos)
    assert torch.equal(color, want)
    got = torch.autograd.grad(color, (means, f_dc, f_rest), d_color)
    ref = torch.autograd.grad(want, (means, f_dc, f_rest), d_color)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert S.LAUNCHES == before


def test_sh_cases_hit_their_edges():
    """Each degree's edge rows are what they claim: a zero direction, and
    rgb + 0.5 exactly 0, below 0 and above 0 in every channel."""
    for name, (deg, means, f_dc, f_rest, campos, _) in sh_cases().items():
        if not means.shape[0]:
            continue
        assert torch.equal(means[0], campos), name
        sh = torch.cat([f_dc, f_rest], 1)
        dirs = means[1:4] - campos
        dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
        rgb = S.eval_sh(deg, sh[1:4], dirs) + 0.5
        assert (rgb[0] == 0).all() and (rgb[1] < 0).all() \
            and (rgb[2] > 0).all(), (name, rgb)


@pytest.mark.parametrize("case", CASES)
def test_function_gradients_are_autograds(no_launch, case):
    """SHColor on CPU tensors: the eager chain's colour, and autograd's
    gradients of it within SH_BWD_TOL (clamp's gradient passing where rgb
    >= 0, the norm's zero at v = 0); d_f_rest dense, contiguous and zero
    past the degree."""
    deg, (means, f_dc, f_rest), campos, d_color = _leaves(sh_cases()[case])
    color = S.SHColor.apply(means, f_dc, f_rest, campos, deg)
    want = S.sh_to_color_plain(deg, torch.cat([f_dc, f_rest], 1), means,
                               campos)
    assert torch.equal(color, want)
    got = torch.autograd.grad(color, (means, f_dc, f_rest), d_color)
    ref = torch.autograd.grad(want, (means, f_dc, f_rest), d_color,
                              allow_unused=True, materialize_grads=True)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, **SH_BWD_TOL)
    d_rest = got[2]
    assert d_rest.is_contiguous()
    assert not d_rest[:, (deg + 1) ** 2 - 1:].any()
    if means.shape[0]:
        # the tie passes the gradient, the row below it does not
        assert (got[1][1] != 0).all() and not got[1][2].any()
        if deg:
            assert math.isfinite(float(got[0][0].abs().max()))
            assert got[0][0].abs().max() > 1e6    # 1 / (|v| + 1e-12)


@pytest.mark.parametrize("raster", ["rasterize", "rasterize2d",
                                    "rasterize_pgsr"])
def test_rasterizers_take_the_coefficient_pair(raster):
    """Each SH rasterizer renders the pair (f_dc, f_rest) as it renders
    their concatenation, and hands each its slice of the gradient."""
    import importlib
    from gssr_tpu_torch.cameras import Camera
    mod = importlib.import_module(f"gssr_tpu_torch.ops.{raster}")
    fn = {"rasterize": "rasterize", "rasterize2d": "rasterize_2d",
          "rasterize_pgsr": "rasterize_pgsr"}[raster]
    rng = np.random.default_rng(5)
    n, w, h = 40, 48, 32
    means = torch.tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32)
    dim = 2 if raster == "rasterize2d" else 3
    scales = torch.tensor(np.exp(rng.uniform(-3, -2, (n, dim))),
                          dtype=torch.float32)
    rots = torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32)
    opac = torch.tensor(rng.uniform(0.3, 0.8, n), dtype=torch.float32)
    sh = torch.tensor(rng.normal(0, 0.3, (n, 16, 3)), dtype=torch.float32)
    cam = Camera(uid=0, colmap_id=0, image_name="sh", R=np.eye(3),
                 T=np.array([0.0, 0.0, 3.0]), fovx=math.radians(70),
                 fovy=math.radians(55), width=w, height=h).arrays("cpu")
    bg = torch.tensor([0.1, 0.2, 0.3])
    images, grads = [], []
    for form in ("tensor", "pair"):
        leaves = [sh.clone().requires_grad_()] if form == "tensor" else [
            sh[:, :1].clone().requires_grad_(),
            sh[:, 1:].clone().requires_grad_()]
        coeffs = leaves[0] if form == "tensor" else tuple(leaves)
        out = getattr(mod, fn)(means, scales, rots, opac, cam, w, h, bg,
                               sh_coeffs=coeffs, sh_degree=3)
        images.append(out.image)
        g = torch.autograd.grad(out.image.square().sum(), leaves)
        grads.append(torch.cat(g, 1))
    assert torch.equal(images[0], images[1])
    assert grads[0].abs().max() > 0
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_sh_kernels_match_plain_on_the_card(case):
    """csrc/sh.cu's forward equals the eager chain on the card bit for bit;
    its backward is autograd's of the chain within SH_BWD_TOL and the same
    bits from run to run; one launch each, none for C = 0; the Function
    gives the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison "
                    "at the cells' inputs too")
    dev = torch.device("cuda")
    deg, *ts = sh_cases()[case]
    means, f_dc, f_rest, campos, d_color = (t.to(dev) for t in ts)
    n = means.shape[0]
    before = dict(S.LAUNCHES)
    color = S.sh_fwd(deg, means, f_dc, f_rest, campos)
    assert torch.equal(color, S.sh_to_color_plain(
        deg, torch.cat([f_dc, f_rest], 1), means, campos))
    got = S.sh_bwd(deg, means, f_dc, f_rest, campos, d_color)
    assert S.LAUNCHES == {k: v + (n > 0) for k, v in before.items()}
    ref = S.sh_bwd_plain(deg, means, f_dc, f_rest, campos, d_color)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, **SH_BWD_TOL)
    assert all(torch.equal(a, b) for a, b in zip(
        got, S.sh_bwd(deg, means, f_dc, f_rest, campos, d_color)))
    assert not got[2][:, (deg + 1) ** 2 - 1:].any()
    leaves = [t.clone().requires_grad_() for t in (means, f_dc, f_rest)]
    out = S.sh_to_color(deg, tuple(leaves[1:]), leaves[0], campos)
    assert torch.equal(out, color)
    for a, b in zip(torch.autograd.grad(out, leaves, d_color), got):
        assert torch.equal(a, b)
