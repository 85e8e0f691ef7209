"""Port checkpoint loading: the flax → PyTorch conversions carry every array
of the shipped checkpoints, bit-exactly, into the port's modules; and the
port imports nothing of JAX."""

import ast
import os

import numpy as np
import pytest
import torch

from airslam_tpu.models import weights as jax_weights
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.models.lightglue import LightGlue
from airslam_tpu_torch.models.plnet import PLNet, LoiHeadS1
from airslam_tpu_torch.models.superpoint import SuperPoint

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def test_load_npz_equals_flax_loader():
    """The flax-free loader gives the same nested tree as the JAX package's
    ``load_params`` (exact)."""
    path = wio.checkpoint_path("plnet_s0.npz")
    ours = _flat(wio.load_npz(path))
    ref = _flat(jax_weights.load_params(path))
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


def _plnet_back(sd):
    """Invert plnet_from_flax: state_dict → flat flax arrays."""
    def hwio(w):
        return w.numpy().transpose(2, 3, 1, 0)

    out = {}
    for name in wio.BACKBONE_CONVS:
        out[f"backbone/{name}/kernel"] = hwio(sd[f"backbone.{name}.weight"])
        out[f"backbone/{name}/bias"] = sd[f"backbone.{name}.bias"].numpy()
    pd, pdb = hwio(sd["convPDa.weight"]), sd["convPDa.bias"].numpy()
    out["convPa/kernel"], out["convDa/kernel"] = pd[..., :256], pd[..., 256:]
    out["convPa/bias"], out["convDa/bias"] = pdb[:256], pdb[256:]
    for name in ("convPb", "convDb"):
        out[f"{name}/kernel"] = hwio(sd[f"{name}.weight"])
        out[f"{name}/bias"] = sd[f"{name}.bias"].numpy()
    for name in ("fuse0", "fuse2"):
        out[f"line_trunk/{name}/kernel"] = hwio(sd[f"line_trunk.{name}.weight"])
        out[f"line_trunk/{name}/bias"] = sd[f"line_trunk.{name}.bias"].numpy()
    hk, hb, i0 = hwio(sd["heads.weight"]), sd["heads.bias"].numpy(), 0
    for name, f in wio.TRUNK_HEADS:
        out[f"{name}/kernel"], out[f"{name}/bias"] = hk[..., i0:i0 + f], hb[i0:i0 + f]
        i0 += f
    return {"params/" + k: v for k, v in out.items()}


def _dense_back(sd):
    """Invert the Dense/LayerNorm conversions of a state_dict."""
    out = {}
    for k, v in sd.items():
        path = k.replace(".", "/")
        for blk, name in (("self_blocks", "self"), ("cross_blocks", "cross")):
            if path.startswith(blk + "/"):
                i, rest = path[len(blk) + 1:].split("/", 1)
                path = f"{name}{i}/{rest}"
        a = v.numpy()
        if path.endswith("/weight") and a.ndim == 2:
            out[path[:-len("weight")] + "kernel"] = a.T
        elif path.endswith("ln/weight"):
            out[path[:-len("weight")] + "scale"] = a
        else:
            out[path] = a
    return {"params/" + k: v for k, v in out.items()}


def _conv_back(sd):
    """Invert the plain conv conversions of a state_dict (OIHW → HWIO)."""
    out = {}
    for k, v in sd.items():
        path, leaf = k.rsplit(".", 1)
        a = v.numpy()
        out[path.replace(".", "/") + ("/kernel" if leaf == "weight" else "/bias")] = (
            a.transpose(2, 3, 1, 0) if leaf == "weight" else a)
    return {"params/" + k: v for k, v in out.items()}


@pytest.mark.parametrize("which", ["plnet", "loi", "lightglue", "superpoint"])
def test_round_trip_every_array(which):
    """Every array of plnet_s0.npz / lightglue.npz / superpoint.npz survives
    the conversion and loads into the port's module (exact: the conversions
    only transpose, concatenate and rename)."""
    if which == "superpoint":
        tree = wio.load_npz(wio.checkpoint_path("superpoint.npz"))
        sd, back, model = wio.superpoint_from_flax(tree), _conv_back, SuperPoint()
        ref = _flat(tree)
    elif which == "lightglue":
        tree = wio.load_npz(wio.checkpoint_path("lightglue.npz"))
        sd, back, model = wio.lightglue_from_flax(tree), _dense_back, LightGlue()
        ref = _flat(tree)
    else:
        tree = wio.load_npz(wio.checkpoint_path("plnet_s0.npz"))[which]
        ref = _flat(tree)
        if which == "plnet":
            sd, back, model = wio.plnet_from_flax(tree), _plnet_back, PLNet()
        else:
            sd, back, model = wio.loi_s1_from_flax(tree), _dense_back, LoiHeadS1()
    got = back(sd)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    model.load_state_dict(sd)  # strict: every module parameter is covered


def test_checkpoint_counts():
    assert len(_flat(wio.load_npz(wio.checkpoint_path("plnet_s0.npz")))) == 58
    assert len(_flat(wio.load_npz(wio.checkpoint_path("lightglue.npz")))) == 205
    assert len(_flat(wio.load_npz(wio.checkpoint_path("superpoint.npz")))) == 24


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_port_imports_no_jax():
    """No file of the port, and not chip_smoke.py nor the port's CLIs and
    applications, imports jax, flax or the JAX package."""
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "profile_torch_frontend.py"),
             os.path.join(REPO, "apps", "visual_odometry_torch.py"),
             os.path.join(REPO, "apps", "map_refinement_torch.py"),
             os.path.join(REPO, "apps", "relocalization_torch.py"),
             os.path.join(REPO, "apps", "train_plnet_torch.py"),
             os.path.join(REPO, "apps", "train_matcher_torch.py"),
             os.path.join(REPO, "apps", "make_synth_dataset_torch.py"),
             os.path.join(REPO, "apps", "benchmark_system_torch.py"),
             os.path.join(REPO, "apps", "evaluate_torch.py")]
    for root, _, names in os.walk(os.path.join(REPO, "airslam_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    walked = {os.path.relpath(f, os.path.join(REPO, "airslam_tpu_torch")) for f in files}
    # every module of the ported slices is among the walked files
    for mod in ("ops/attention.py", "backend/triangulate.py", "io/config.py", "io/dataset.py",
                "io/publisher.py", "io/serialization.py", "io/trajectory.py",
                "core/lie.py", "backend/residuals.py", "backend/gn.py", "backend/windows.py",
                "backend/pose_gn.py", "models/superpoint.py", "frontend/lines.py",
                "slam/landmarks.py", "slam/frame.py", "slam/map.py",
                "pipelines/map_builder.py", "entry.py", "utils/native.py",
                "loopclosure/vocabulary.py", "loopclosure/database.py", "backend/global_ba.py",
                "pipelines/map_refiner.py", "pipelines/map_user.py", "models/superglue.py",
                "backend/pnp.py", "ops/match.py", "frontend/synthgen.py",
                "parallel/train_plnet.py", "utils/timing.py", "parallel/training.py",
                "parallel/mesh.py", "parallel/frontend.py", "parallel/pipeline.py",
                "parallel/sharded_ba.py"):
        assert mod in walked, mod
    assert len(files) > 37
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "flax", "jaxlib", "airslam_tpu"), (path, mod)
