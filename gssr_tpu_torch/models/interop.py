"""GS-SR MLP checkpoints to and from the scaffold model (port of
gssr_tpu/models/interop.py).

GS-SR writes its decode MLPs either as one state-dict file
`checkpoints.pth` (unite mode) or as one torch.jit trace per MLP (split
mode: opacity_mlp.pt, cov_mlp.pt, color_mlp.pt, and feature_bank_mlp.pt /
embedding_appearance.pt where present). Each is Sequential(Linear, ReLU,
Linear[, activation]). torch's Linear keeps its weight [out, in], and the
model multiplies h @ w1 with w1 [in, out], so the import is a transpose.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict

import torch

_HEADS = (("op", "opacity_mlp"), ("cov", "cov_mlp"), ("col", "color_mlp"))


def _from_sequential(sd, prefix: str, device) -> Dict[str, torch.Tensor]:
    """A Sequential(Linear, ReLU, Linear, ...) state-dict -> the model's
    <prefix>_w1, _b1, _w2, _b2."""
    f = lambda t: t.detach().to(device, torch.float32)   # noqa: E731
    return {f"{prefix}_w1": f(sd["0.weight"]).T.contiguous(),
            f"{prefix}_b1": f(sd["0.bias"]),
            f"{prefix}_w2": f(sd["2.weight"]).T.contiguous(),
            f"{prefix}_b2": f(sd["2.bias"])}


def load_gs_sr_mlp_checkpoint(path: str, mlp):
    """GS-SR's MLP weights from directory `path` (checkpoints.pth, else the
    split-mode traces) over a copy of `mlp`, a dict built with the
    matching config. Every field's shape is checked; the appearance table
    needs only the same width (camera counts may differ: it is cut or
    zero-padded to mlp's rows)."""
    dev = mlp["op_w1"].device
    unite = os.path.join(path, "checkpoints.pth")
    if os.path.exists(unite):
        ckpt = torch.load(unite, map_location="cpu", weights_only=True)
        sds = {p: ckpt[name] for p, name in _HEADS}
        if "feature_bank_mlp" in ckpt:
            sds["fb"] = ckpt["feature_bank_mlp"]
        app_sd = ckpt.get("appearance")
        app = app_sd["embedding.weight"] if app_sd is not None else None
    else:
        def traced(fname):
            return dict(torch.jit.load(os.path.join(path, fname),
                                       map_location="cpu").state_dict())
        sds = {p: traced(f"{name}.pt") for p, name in _HEADS}
        if os.path.exists(os.path.join(path, "feature_bank_mlp.pt")):
            sds["fb"] = traced("feature_bank_mlp.pt")
        app = None
        if os.path.exists(os.path.join(path, "embedding_appearance.pt")):
            app = traced("embedding_appearance.pt")["embedding.weight"]

    updates = {}
    for prefix, sd in sds.items():
        updates.update(_from_sequential(sd, prefix, dev))
    if app is not None:
        cur = mlp["appearance"]
        app = app.detach().to(dev, torch.float32)
        if cur.shape[1] != app.shape[1]:
            raise ValueError(f"appearance width mismatch: checkpoint "
                             f"{app.shape[1]} vs config {cur.shape[1]}")
        if app.shape[0] < cur.shape[0]:
            app = torch.cat([app, app.new_zeros(
                (cur.shape[0] - app.shape[0], app.shape[1]))])
        updates["appearance"] = app[:cur.shape[0]]
    for name, val in updates.items():
        cur = mlp[name]
        if name != "appearance" and cur.shape != val.shape:
            raise ValueError(
                f"MLP field {name}: checkpoint shape {tuple(val.shape)} != "
                f"config shape {tuple(cur.shape)}; check feat_dim, "
                f"n_offsets, appearance_dim and view_dim against the GS-SR "
                f"run")
    return {**mlp, **updates}


def _sequential(mlp, prefix: str):
    """The model's <prefix> pair as a Sequential(Linear, ReLU, Linear)
    state-dict on the CPU (the inverse transpose of _from_sequential)."""
    f = lambda k: mlp[f"{prefix}_{k}"].detach().cpu()     # noqa: E731
    return OrderedDict([("0.weight", f("w1").T.contiguous()),
                        ("0.bias", f("b1").clone()),
                        ("2.weight", f("w2").T.contiguous()),
                        ("2.bias", f("b2").clone())])


def save_gs_sr_mlp_checkpoint(path: str, mlp, use_feat_bank: bool = False):
    """The MLP as GS-SR's unite-mode `path`/checkpoints.pth, which GS-SR's
    load_mlp_checkpoints reads: the three heads, the feature bank with
    use_feat_bank, the appearance embedding where it has a width.
    load_gs_sr_mlp_checkpoint(path, mlp) gives mlp back exactly. Returns
    the file's path."""
    ckpt = {name: _sequential(mlp, p) for p, name in _HEADS}
    if use_feat_bank:
        ckpt["feature_bank_mlp"] = _sequential(mlp, "fb")
    if mlp["appearance"].shape[1] > 0:
        ckpt["appearance"] = OrderedDict(
            [("embedding.weight", mlp["appearance"].detach().cpu().clone())])
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "checkpoints.pth")
    torch.save(ckpt, out)
    return out
