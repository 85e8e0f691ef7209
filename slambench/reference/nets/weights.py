"""Checkpoint reading for the plain reference: a copy of the flax →
PyTorch converters of ``airslam_tpu_torch/models/weights.py``
(``load_npz``, ``plnet_from_flax``, ``loi_s1_from_flax``,
``superpoint_from_flax``, ``lightglue_from_flax``). The reference reads
the shipped ``airslam_tpu/checkpoints/*.npz`` files itself, by path, with
no override: the same raw files the program reads, and nothing the
program made from them."""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

CHECKPOINT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "airslam_tpu", "checkpoints"))

TRUNK_HEADS = (("junc_heat", 1), ("junc_off", 2), ("line_pred", 12),
               ("line_logit", 3), ("loi", 128), ("loi_thin", 4),
               ("loi_aux", 4))
BACKBONE_CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
                  "conv4a", "conv4b", "conv5a", "conv5b")


def checkpoint(name: str) -> Dict[str, Any]:
    """The shipped checkpoint ``name`` as a nested dict of arrays."""
    return load_npz(os.path.join(CHECKPOINT_DIR, name))


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
