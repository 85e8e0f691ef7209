"""Checkpoints: flax → PyTorch parameter conversion and back.

The in-repo checkpoints (``airslam_tpu/checkpoints/*.npz``) are ``/``-flattened
flax parameter trees, all float32. They are read as plain npz files here,
without flax, and converted to ``state_dict``s of the port's modules:

- Dense ``kernel`` (in, out) → Linear ``weight`` (out, in);
- Conv ``kernel`` HWIO → Conv2d ``weight`` OIHW;
- LayerNorm ``scale`` → ``weight``;
- PLNet's fused convs are concatenated once here, at load time: convPa+convDa
  (one 512-wide 3×3 conv) and the seven trunk heads (one 154-wide 3×3 conv),
  in the channel order of ``airslam_tpu/models/plnet.py``.

The ``*_to_flax`` functions invert them (the fused convs split again), and
:func:`save_npz` writes the JAX package's ``/``-flattened layout, so a
checkpoint the port trains loads in the JAX ``FeatureDetector``.
``AIRSLAM_CHECKPOINT_DIR`` overrides the shipped folder file by file, as in
the JAX package (``airslam_tpu/models/weights.py:63-71``).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

_CHECKPOINT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "..", "..", "airslam_tpu", "checkpoints")

# trunk heads fused into one conv, in output-channel order (plnet.py:219-221)
TRUNK_HEADS = (("junc_heat", 1), ("junc_off", 2), ("line_pred", 12),
               ("line_logit", 3), ("loi", 128), ("loi_thin", 4),
               ("loi_aux", 4))
BACKBONE_CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
                  "conv4a", "conv4b", "conv5a", "conv5b")


def checkpoint_path(name: str) -> str:
    """Path of a checkpoint: in ``AIRSLAM_CHECKPOINT_DIR`` where that holds
    the file, else the shipped one (the JAX package's checkpoint folder)."""
    override = os.environ.get("AIRSLAM_CHECKPOINT_DIR")
    if override and os.path.exists(os.path.join(override, name)):
        return os.path.join(override, name)
    return os.path.normpath(os.path.join(_CHECKPOINT_DIR, name))


def load_npz(path: str) -> Dict[str, Any]:
    """Load a ``/``-flattened npz into a nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def save_npz(path: str, tree: Dict[str, Any]):
    """Write a nested dict of arrays as a ``/``-flattened npz (the JAX
    package's ``save_params`` layout, compressed)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(tree, "")
    np.savez_compressed(path, **flat)


def load_model_dir(model_dir, matcher: int = 0):
    """(detector tree, matcher tree) a CLI's ``--model_dir`` gives: its
    ``plnet.npz`` and ``lightglue.npz`` (``matcher`` 0) or ``superglue.npz``
    (1), in the JAX layout, each None where the directory lacks the file (or
    no directory is given), so the shipped checkpoint is used
    (``apps/visual_odometry.py:60-72``)."""

    def read(name):
        path = os.path.join(model_dir, name) if model_dir else None
        return load_npz(path) if path and os.path.exists(path) else None

    return read("plnet.npz"), read("lightglue.npz" if matcher == 0 else "superglue.npz")


def _params(tree):
    return tree["params"] if "params" in tree else tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable, contiguous copy


def _conv(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))  # HWIO → OIHW


def _dense(node, prefix, out, bias=True):
    out[prefix + ".weight"] = _t(np.asarray(node["kernel"]).T)
    if bias:
        out[prefix + ".bias"] = _t(node["bias"])


def plnet_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX ``PLNet`` params → ``state_dict`` of :class:`models.plnet.PLNet`."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    for name in BACKBONE_CONVS:
        sd[f"backbone.{name}.weight"] = _conv(p["backbone"][name]["kernel"])
        sd[f"backbone.{name}.bias"] = _t(p["backbone"][name]["bias"])
    pd_k = np.concatenate([p["convPa"]["kernel"], p["convDa"]["kernel"]], -1)
    sd["convPDa.weight"] = _conv(pd_k)
    sd["convPDa.bias"] = _t(np.concatenate([p["convPa"]["bias"],
                                            p["convDa"]["bias"]]))
    for name in ("convPb", "convDb"):
        sd[f"{name}.weight"] = _conv(p[name]["kernel"])
        sd[f"{name}.bias"] = _t(p[name]["bias"])
    trunk = p["line_trunk"]
    for name in ("fuse0", "fuse2"):
        sd[f"line_trunk.{name}.weight"] = _conv(trunk[name]["kernel"])
        sd[f"line_trunk.{name}.bias"] = _t(trunk[name]["bias"])
    sd["heads.weight"] = _conv(np.concatenate(
        [p[n]["kernel"] for n, _ in TRUNK_HEADS], -1))
    sd["heads.bias"] = _t(np.concatenate([p[n]["bias"] for n, _ in TRUNK_HEADS]))
    return sd


def loi_s1_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX ``LoiHeadS1`` params → ``state_dict`` of
    :class:`models.plnet.LoiHeadS1`. ``t_fwd``/``t_rev`` are copied
    bit-exactly (their LSBs are not those of ``arange/31``)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    for name in ("fc2_0", "fc2_2", "fc2_4", "fc2_res", "fc2_head"):
        _dense(p[name], name, sd)
    sd["t_fwd"] = _t(p["t_fwd"])
    sd["t_rev"] = _t(p["t_rev"])
    return sd


def import_plnet_s1(onnx_path: str) -> Dict[str, Any]:
    """The upstream ``plnet_s1.onnx``'s initializers as the JAX ``LoiHeadS1``
    parameter tree (``airslam_tpu/models/weights.py::import_plnet_s1``), which
    :func:`loi_s1_from_flax` loads: the Linear weights (out, in) transposed
    to Dense kernels (in, out), and the graph's exact sampling ramps."""
    from airslam_tpu_torch.models.onnx_import import load_onnx

    w, _ = load_onnx(onnx_path)

    def lin(prefix):
        return {"kernel": np.ascontiguousarray(w[f"{prefix}.weight"].T),
                "bias": np.ascontiguousarray(w[f"{prefix}.bias"])}

    return {"params": {
        "fc2_0": lin("fc2.0"), "fc2_2": lin("fc2.2"), "fc2_4": lin("fc2.4"),
        "fc2_res": lin("fc2_res.0"), "fc2_head": lin("fc2_head"),
        # the ramps' LSBs are not those of arange/31
        "t_fwd": np.ascontiguousarray(w["onnx::Mul_1141"].reshape(-1)),
        "t_rev": np.ascontiguousarray(w["onnx::Mul_1142"].reshape(-1))}}


def loi_fast_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX fast ``LoiHead`` params (``fc1``, ``fc2``, ``score``, ``delta``) →
    ``state_dict`` of :class:`models.plnet.LoiHead`."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    for name in ("fc1", "fc2", "score", "delta"):
        _dense(p[name], name, sd)
    return sd


def superpoint_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX ``SuperPoint`` params (``superpoint.npz``: ``backbone/conv{1..4}{a,b}``,
    ``convPa/Pb``, ``convDa/Db``) → ``state_dict`` of
    :class:`models.superpoint.SuperPoint`."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    for name, node in p["backbone"].items():
        sd[f"backbone.{name}.weight"] = _conv(node["kernel"])
        sd[f"backbone.{name}.bias"] = _t(node["bias"])
    for name in ("convPa", "convPb", "convDa", "convDb"):
        sd[f"{name}.weight"] = _conv(p[name]["kernel"])
        sd[f"{name}.bias"] = _t(p[name]["bias"])
    return sd


def lightglue_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX ``LightGlue`` params → ``state_dict`` of
    :class:`models.lightglue.LightGlue`."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    _dense(p["rotary"]["freqs"], "rotary.freqs", sd, bias=False)
    for name in ("input_proj", "final_proj", "matchability"):
        _dense(p[name], name, sd)

    def update(node, prefix):
        sd[prefix + ".ln.weight"] = _t(node["ln"]["scale"])
        sd[prefix + ".ln.bias"] = _t(node["ln"]["bias"])
        _dense(node["fc1"], prefix + ".fc1", sd)
        _dense(node["fc2"], prefix + ".fc2", sd)

    layers = sum(1 for k in p if k.startswith("self"))
    for i in range(layers):
        s, c = p[f"self{i}"], p[f"cross{i}"]
        _dense(s["qkv"], f"self_blocks.{i}.qkv", sd)
        _dense(s["proj"], f"self_blocks.{i}.proj", sd)
        update(s["update"], f"self_blocks.{i}.update")
        for name in ("to_qk", "to_v", "proj"):
            _dense(c[name], f"cross_blocks.{i}.{name}", sd)
        update(c["update"], f"cross_blocks.{i}.update")
    return sd


def superglue_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX ``SuperGlue`` params (``superglue.npz``: ``kenc``, ``self{i}``,
    ``cross{i}``, ``final_proj``, ``bin_score``; 273 arrays) →
    ``state_dict`` of :class:`models.superglue.SuperGlue`."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    k = p["kenc"]
    for i in range(4):
        _dense(k[f"fc{i}"], f"kenc.fc.{i}", sd)
        sd[f"kenc.ln.{i}.weight"] = _t(k[f"ln{i}"]["scale"])
        sd[f"kenc.ln.{i}.bias"] = _t(k[f"ln{i}"]["bias"])
    _dense(k["out"], "kenc.out", sd)
    layers = sum(1 for name in p if name.startswith("self"))
    for kind in ("self", "cross"):
        for i in range(layers):
            node, prefix = p[f"{kind}{i}"], f"{kind}_layers.{i}"
            for name in ("q", "k", "v", "merge", "mlp1", "mlp2"):
                _dense(node[name], f"{prefix}.{name}", sd)
            sd[f"{prefix}.mlp_ln.weight"] = _t(node["mlp_ln"]["scale"])
            sd[f"{prefix}.mlp_ln.bias"] = _t(node["mlp_ln"]["bias"])
    _dense(p["final_proj"], "final_proj", sd)
    sd["bin_score"] = _t(p["bin_score"]).reshape(())
    return sd


def _a(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().float().cpu().numpy())


def _conv_back(w) -> np.ndarray:
    return np.ascontiguousarray(_a(w).transpose(2, 3, 1, 0))  # OIHW → HWIO


def _node(sd, prefix):
    return {"kernel": _conv_back(sd[prefix + ".weight"]), "bias": _a(sd[prefix + ".bias"])}


def _dense_node(sd, prefix):
    return {"kernel": np.ascontiguousarray(_a(sd[prefix + ".weight"]).T),
            "bias": _a(sd[prefix + ".bias"])}


def plnet_to_flax(sd) -> Dict[str, Any]:
    """``state_dict`` of :class:`models.plnet.PLNet` → the JAX ``PLNet``
    params ``{"params": ...}``; the inverse of :func:`plnet_from_flax`, the
    fused ``convPDa`` and ``heads`` split into their logical convs."""
    p: Dict[str, Any] = {"backbone": {n: _node(sd, f"backbone.{n}") for n in BACKBONE_CONVS}}
    pd_k, pd_b = _conv_back(sd["convPDa.weight"]), _a(sd["convPDa.bias"])
    p["convPa"] = {"kernel": np.ascontiguousarray(pd_k[..., :256]), "bias": pd_b[:256].copy()}
    p["convDa"] = {"kernel": np.ascontiguousarray(pd_k[..., 256:]), "bias": pd_b[256:].copy()}
    for name in ("convPb", "convDb"):
        p[name] = _node(sd, name)
    p["line_trunk"] = {n: _node(sd, f"line_trunk.{n}") for n in ("fuse0", "fuse2")}
    hk, hb = _conv_back(sd["heads.weight"]), _a(sd["heads.bias"])
    i0 = 0
    for name, f in TRUNK_HEADS:
        p[name] = {"kernel": np.ascontiguousarray(hk[..., i0:i0 + f]), "bias": hb[i0:i0 + f].copy()}
        i0 += f
    return {"params": p}


def loi_s1_to_flax(sd) -> Dict[str, Any]:
    """``state_dict`` of :class:`models.plnet.LoiHeadS1` → the JAX
    ``LoiHeadS1`` params; the inverse of :func:`loi_s1_from_flax`."""
    p = {name: _dense_node(sd, name)
         for name in ("fc2_0", "fc2_2", "fc2_4", "fc2_res", "fc2_head")}
    p["t_fwd"], p["t_rev"] = _a(sd["t_fwd"]), _a(sd["t_rev"])
    return {"params": p}


def loi_fast_to_flax(sd) -> Dict[str, Any]:
    """``state_dict`` of :class:`models.plnet.LoiHead` → the JAX fast
    ``LoiHead`` params; the inverse of :func:`loi_fast_from_flax`."""
    return {"params": {name: _dense_node(sd, name) for name in ("fc1", "fc2", "score", "delta")}}


def superpoint_to_flax(sd) -> Dict[str, Any]:
    """``state_dict`` of :class:`models.superpoint.SuperPoint` → the JAX
    ``SuperPoint`` params; the inverse of :func:`superpoint_from_flax`."""
    names = sorted({k.split(".")[1] for k in sd if k.startswith("backbone.")})
    p: Dict[str, Any] = {"backbone": {n: _node(sd, f"backbone.{n}") for n in names}}
    for name in ("convPa", "convPb", "convDa", "convDb"):
        p[name] = _node(sd, name)
    return {"params": p}


def _ln_node(sd, prefix):
    return {"scale": _a(sd[prefix + ".weight"]), "bias": _a(sd[prefix + ".bias"])}


def lightglue_to_flax(sd) -> Dict[str, Any]:
    """``state_dict`` of :class:`models.lightglue.LightGlue` → the JAX
    ``LightGlue`` params ``{"params": ...}``; the inverse of
    :func:`lightglue_from_flax` (205 arrays at 9 layers)."""
    p: Dict[str, Any] = {"rotary": {"freqs": {"kernel": np.ascontiguousarray(
        _a(sd["rotary.freqs.weight"]).T)}}}
    for name in ("input_proj", "final_proj", "matchability"):
        p[name] = _dense_node(sd, name)

    def update(prefix):
        return {"ln": _ln_node(sd, prefix + ".ln"), "fc1": _dense_node(sd, prefix + ".fc1"),
                "fc2": _dense_node(sd, prefix + ".fc2")}

    layers = len({k.split(".")[1] for k in sd if k.startswith("self_blocks.")})
    for i in range(layers):
        s, c = f"self_blocks.{i}", f"cross_blocks.{i}"
        p[f"self{i}"] = {"qkv": _dense_node(sd, s + ".qkv"), "proj": _dense_node(sd, s + ".proj"),
                         "update": update(s + ".update")}
        p[f"cross{i}"] = {name: _dense_node(sd, f"{c}.{name}") for name in ("to_qk", "to_v", "proj")}
        p[f"cross{i}"]["update"] = update(c + ".update")
    return {"params": p}


def superglue_to_flax(sd) -> Dict[str, Any]:
    """``state_dict`` of :class:`models.superglue.SuperGlue` → the JAX
    ``SuperGlue`` params ``{"params": ...}`` with ``bin_score`` (the tree of
    a module with Sinkhorn iterations, as trained); the inverse of
    :func:`superglue_from_flax` (273 arrays at 9 layers)."""
    k = {f"fc{i}": _dense_node(sd, f"kenc.fc.{i}") for i in range(4)}
    k.update({f"ln{i}": _ln_node(sd, f"kenc.ln.{i}") for i in range(4)})
    k["out"] = _dense_node(sd, "kenc.out")
    p: Dict[str, Any] = {"kenc": k}
    layers = len({key.split(".")[1] for key in sd if key.startswith("self_layers.")})
    for kind in ("self", "cross"):
        for i in range(layers):
            prefix = f"{kind}_layers.{i}"
            node = {name: _dense_node(sd, f"{prefix}.{name}")
                    for name in ("q", "k", "v", "merge", "mlp1", "mlp2")}
            node["mlp_ln"] = _ln_node(sd, prefix + ".mlp_ln")
            p[f"{kind}{i}"] = node
    p["final_proj"] = _dense_node(sd, "final_proj")
    p["bin_score"] = _a(sd["bin_score"]).reshape(())
    return {"params": p}
