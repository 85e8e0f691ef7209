"""The frozen copies of the renderer, the trajectory and the map scene
reproduce themselves from a seed, and another seed gives other inputs of
the same sizes."""

import json
import os

import numpy as np
import torch

from _helpers import ROOT
from slambench.traffic import map_scene, render3d, stereo_stream
from slambench.traffic.trajectory import traj_position


def _cfg(name):
    with open(os.path.join(ROOT, "slambench", "configs", name + ".json")) as f:
        return json.load(f)


def _traffic(cell):
    with open(os.path.join(ROOT, "slambench", "workloads", cell + ".json")) as f:
        return json.load(f)["traffic"]


def test_world_and_render_reproduce_from_a_seed():
    def world(seed):
        g = torch.Generator().manual_seed(seed)
        return render3d.make_world3d(render3d.world3d_draws(g)), render3d.texture_draws(g)

    (w1, t1), (w2, t2), (w3, _) = world(5), world(5), world(6)
    assert all(torch.equal(a, b) for a, b in zip(w1, w2)) and torch.equal(t1["theta"], t2["theta"])
    assert not torch.equal(w1.segments, w3.segments)
    eye = torch.eye(3).expand(1, 3, 3)
    img = [render3d.render_view3d(w, eye, torch.tensor([[0.0, 0.0, -1.0]]), 450, 450, 376, 240,
                                  48, 64) for w in (w1, w2)]
    assert torch.equal(img[0], img[1]) and img[0].min() >= 0 and img[0].max() <= 1


def test_stereo_stream_reproduces_and_the_seed_draws_only_the_noise():
    cfg = _cfg("vo_euroc")
    tr = dict(_traffic("vo_euroc.fast"), frames=2)
    a = stereo_stream.generate(tr, cfg["camera"], 2 ** 31 + 3, "cpu")
    b = stereo_stream.generate(tr, cfg["camera"], 2 ** 31 + 3, "cpu")
    c = stereo_stream.generate(tr, cfg["camera"], 7, "cpu")
    assert a.images.dtype == np.uint8 and a.images.shape == (2, 2, 480, 752)
    assert np.array_equal(a.images, b.images) and np.array_equal(a.gt_Twc, c.gt_Twc)
    diff = np.abs(a.images.astype(int) - c.images.astype(int))
    # two draws of sensor noise of σ = 0.01 (2.55 grey levels): the same world
    assert 0 < diff.mean() <= 4 and diff.max() <= 40


def test_trajectory_time_scale_slows_the_same_path():
    t = np.arange(40) * 0.05
    fast = traj_position(t * 0.125)
    assert np.allclose(fast[8], traj_position(0.05)) and np.isclose(fast[-1, 2] / t[-1], 0.3)


def test_map_scene_reproduces_from_a_seed_at_fixed_sizes():
    cfg = _cfg("mr_euroc")
    tr = dict(_traffic("mr_euroc.map1000"), keyframes=50, points=500)
    a, b, c = (map_scene.generate(tr, cfg["camera"], s) for s in (2 ** 31 + 5, 2 ** 31 + 5, 9))
    for k in a:
        assert np.array_equal(a[k], b[k])
        assert a[k].shape == c[k].shape
    assert not np.array_equal(a["pts"], c["pts"])
    w = map_scene.table_width(a["pidx"], a["ok"], 500)
    table = map_scene.obs_table(a["pidx"], a["ok"], 500, w)
    n = len(a["pidx"])
    for p in range(500):  # each point keeps its valid observations, in order
        want = np.nonzero(a["ok"] & (a["pidx"] == p))[0][:w]
        got = table[p][table[p] < n]
        assert np.array_equal(got, want)


def test_a_long_corridor_renders_what_lies_ahead_of_the_cameras():
    """The draw distance keeps every segment and dot a camera of the batch
    sees in front of it within that distance, and nothing behind them all."""
    g = torch.Generator().manual_seed(2 ** 31 + 9)
    world = render3d.make_world3d(render3d.world3d_draws(g, 181, 1209),
                                  extent=render3d.WORLD_EXTENT[:2] + ((2.0, 70.0),))
    cam_z = np.array([30.0, 30.5, 31.0])
    near = stereo_stream._ahead(world, cam_z, 18.0)
    seg_z = world.segments[..., 2].min(dim=1).values
    want = (seg_z > 30.25) & (seg_z < 49.0)
    assert torch.equal(near.segments, world.segments[want])
    assert torch.equal(near.blobs, world.blobs[(world.blobs[:, 2] > 30.25)
                                               & (world.blobs[:, 2] < 49.0)])
    assert 0 < len(near.blobs) < len(world.blobs) and near.blob_shade.shape == near.blobs.shape[:1]
