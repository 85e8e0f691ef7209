"""The port's rendered 3D world (``airslam_tpu_torch/frontend/synthgen.py``'s
``World3D`` part, ``apps/make_synth_dataset_torch.py``,
``apps/benchmark_system_torch.py``) against the JAX package on the CPU.

The JAX draws are rebuilt from the JAX keys (``scripts/make_torch_oracle.py``'s
``jax_world3d_draws`` / ``jax_texture_draws``) and handed to the port, with
JAX in float32 as its applications run. Gates: the world bit-equal (the
segments' far ends within a per-element bound of three roundings, see
``_far_end_bound``); renders
within 1e-5 on the sequences' poses (identity rotations: the projections
are exact products in both packages, so what differs is the transcendental
functions' last ulps and the summation order); on a rotated pose within
5e-5, since XLA's 3×3 products round otherwise than PyTorch's by one ulp of
a pixel coordinate (3e-5 px at 400 px), which a stroke's unit-slope edge
carries into the image; the trajectories, IMU, hard-query poses and inverse
maps equal.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airslam_tpu.frontend import synthgen as J
from airslam_tpu_torch.frontend import synthgen as T

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTR = (450.0, 450.0, 376.0, 240.0)


def _load(name, *parts):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MTO = _load("make_torch_oracle", "scripts", "make_torch_oracle.py")
BENCH = _load("benchmark_system_torch", "apps", "benchmark_system_torch.py")
MSD = _load("make_synth_dataset_torch", "apps", "make_synth_dataset_torch.py")


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):  # the JAX applications' precision; conftest turns x64 on
        yield


def _t(d):
    return {k: torch.as_tensor(np.array(v)) for k, v in d.items()}


def _worlds(seed):
    key = jax.random.PRNGKey(seed)
    return J.make_world3d(key), T.make_world3d(_t(MTO.jax_world3d_draws(key)))


def _theta(seed):
    return torch.as_tensor(np.array(MTO.jax_texture_draws(jax.random.PRNGKey(seed + 31))["theta"]))


def _far_end_bound(draws, b):
    """Per-element bound on the far ends' gap between the two packages,
    ``L·ulp(v) + ulp(v·L) + ulp(b)``, from the three roundings that
    ``b = a + v·L`` makes after ``a`` (bit-equal in both):

    - the unit direction ``v``: XLA fuses its norm, whose square root then
      differs from an exact one in the last ulp for 0.7 % of vectors
      (measured on 200k normals), so a component may differ by one ulp of
      ``v``, which the length ``L`` (≤ 3 m) carries: ``L·ulp(v)``;
    - the product ``v·L``, rounded once in each package, lands on either
      side of a rounding boundary: ``ulp(v·L)``;
    - the sum ``a + v·L``, rounded once, likewise: ``ulp(b)``.

    ``v`` is formed in float64 from the draws (the ulp of its float32
    neighbour is what either package's ``v`` has)."""
    d = np.asarray(draws["seg_dir"], np.float64)
    d = d * (1.0 - np.eye(3)[np.asarray(draws["seg_axis"])] * 0.95)
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    length = np.asarray(draws["seg_length"], np.float64)

    def ulp(x):
        return np.spacing(np.abs(x).astype(np.float32)).astype(np.float64)

    return length * ulp(v) + ulp(v * length) + ulp(b)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_make_world3d_equals_jax(seed):
    """Bit-equal but for the segments' far ends, which stay within the
    per-element bound of :func:`_far_end_bound` (a flat 5e-7 m failed on
    some hosts: an end of |b| = 8.28 m is one ulp, 9.5e-7 m, from JAX's);
    their start points are bit-equal. Prints the largest gap / bound."""
    key = jax.random.PRNGKey(seed)
    draws = MTO.jax_world3d_draws(key)
    jw, tw = J.make_world3d(key), T.make_world3d(_t(draws))
    for name, a, b in zip(jw._fields, jw, tw):
        if name == "segments":
            a, b = np.asarray(a), b.numpy()
            assert np.array_equal(a[:, 0], b[:, 0])
            gap = np.abs(a[:, 1].astype(np.float64) - b[:, 1])
            bound = _far_end_bound(draws, b[:, 1])
            print(f"seed {seed}: far ends' largest gap / bound {(gap / bound).max():.3f}, "
                  f"largest gap {gap.max():.3e} m")
            assert (gap <= bound).all(), (gap / bound).max()
        else:
            assert np.array_equal(np.asarray(a), b.numpy()), name


def test_world3d_draws_shapes_and_ranges():
    """The port's own draws: another world than JAX's for the same seed, from
    the same distributions (the extent, the shades' ranges)."""
    w = T.make_world3d(T.world3d_draws(torch.Generator().manual_seed(0)))
    assert w.segments.shape == (48, 2, 3) and w.blobs.shape == (320, 3)
    lo = torch.tensor([e[0] for e in T.WORLD_EXTENT])
    hi = torch.tensor([e[1] for e in T.WORLD_EXTENT])
    assert bool(((w.segments[:, 0] >= lo) & (w.segments[:, 0] <= hi)).all())
    assert bool(((w.blobs >= lo) & (w.blobs <= hi)).all())
    seg_len = (w.segments[:, 1] - w.segments[:, 0]).norm(dim=-1)
    assert bool(((seg_len > 0.8 - 1e-5) & (seg_len < 3.0 + 1e-5)).all())
    assert bool(((w.seg_shade.abs() >= 0.25) & (w.seg_shade.abs() < 0.55)).all())
    assert bool(((w.blob_shade.abs() >= 0.3) & (w.blob_shade.abs() < 0.6)).all())
    theta = T.texture_draws(torch.Generator().manual_seed(0))["theta"]
    assert theta.shape == (2, 5, 3) and 0 <= float(theta.min()) and float(theta.max()) < 6.28318


def test_octave_noise_equals_jax():
    rng = np.random.default_rng(0)
    u = rng.uniform(-5, 20, (64, 96)).astype(np.float32)
    v = rng.uniform(-5, 20, (64, 96)).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(31), 1)
    want = np.asarray(J._octave_noise(jnp.asarray(u), jnp.asarray(v), key))
    theta = _theta(0)[1]  # the back wall's: fold_in(key, 1)
    got = T._octave_noise(torch.as_tensor(u), torch.as_tensor(v), theta).numpy()
    assert np.abs(got - want).max() <= 1e-5


def _pose_7():
    """The right camera of frame 7 of 40 on the loop trajectory (stride 2):
    its world-to-camera translation (the rotation is the identity)."""
    pos = BENCH.traj_position(0.7, "loop", 4.0)
    return (-pos - np.array([0.11, 0.0, 0.0])).astype(np.float32)


def _render_pair(tw, jw, size, texture, noise):
    """(port, JAX) renders of one view at ``_pose_7``: the port's of world
    ``tw``, JAX's of ``jw``."""
    h, w = size
    tcw = _pose_7()
    key = jax.random.PRNGKey(5) if noise else None
    want = np.asarray(J.render_view3d(jw, jnp.eye(3, dtype=jnp.float32), jnp.asarray(tcw),
                                      *INTR, h, w, key, texture=texture,
                                      texture_key=jax.random.PRNGKey(31)))
    nz = torch.as_tensor(np.array(jax.random.normal(key, (h, w))))[None] if noise else None
    got = T.render_view3d(tw, torch.eye(3)[None], torch.as_tensor(tcw)[None], *INTR, h, w,
                          noise=nz, texture=texture, texture_theta=_theta(0))
    assert got.shape == (1, h, w) and got.dtype == torch.float32
    return got[0].numpy(), want


@pytest.mark.parametrize("noise", (False, True), ids=("clean", "noise"))
@pytest.mark.parametrize("texture", (0.0, 0.1))
@pytest.mark.parametrize("size", ((60, 94), (480, 752)), ids=("60x94", "480x752"))
def test_render_view3d_equals_jax(size, texture, noise):
    """The render alone: one view on a pose of the loop trajectory, the port
    handed the JAX world's own arrays, so that the world's known gap (see
    ``test_make_world3d_equals_jax``) stays out of it."""
    jw, _ = _worlds(0)
    tw = T.World3D(*(torch.from_numpy(np.array(a)) for a in jw))
    got, want = _render_pair(tw, jw, size, texture, noise)
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("noise", (False, True), ids=("clean", "noise"))
@pytest.mark.parametrize("texture", (0.0, 0.1))
def test_render_view3d_of_the_rebuilt_world(texture, noise):
    """The port's own world, rebuilt from the JAX draws, rendered at 480×752
    against the JAX render of the JAX world. The worlds differ only in some
    segments' far ends (``test_make_world3d_equals_jax``): at this seed by at
    most 2.4e-7 m. A stroke is the image of its segment: a point of the
    segment moves by at most as far as the moved end, and a point at depth z
    and (x, y) = (X/z, Y/z) moves on the image by at most f/z·√(1 + x² + y²)
    times that (the largest singular value of the projection's Jacobian),
    wherever the stroke meets the image. The stroke's alpha
    ``clip(1.8 - d)`` has slope 1 in the distance d, and a stroke's shade is
    below 0.55. So a pixel moves by at most the render's own gate (1e-5,
    ``test_render_view3d_equals_jax``) plus, summed over the strokes whose
    far end moved, that end's move · the largest f/z·√(1 + x² + y²) over the
    stroke's points in the image · 1 · 0.55. At this pose three ends move
    and the bound is 3.2e-5, against the 1.97e-5 measured. The 8-bit images must
    also meet the card's gate (``chip_smoke.E2E_GATES``): at most 1 grey
    level apart, on at most 1e-3 of the pixels."""
    h, w = 480, 752
    jw, tw = _worlds(0)
    got, want = _render_pair(tw, jw, (h, w), texture, noise)
    fx, fy, cx, cy = INTR
    segs = np.asarray(jw.segments, np.float64) + _pose_7()  # the camera frame (R = I)
    gap = np.linalg.norm(np.asarray(jw.segments, np.float64) - tw.segments.numpy(),
                         axis=-1).max(axis=1)
    s = np.linspace(0.0, 1.0, 4001)[:, None]
    bound = 1e-5
    for (a, b), moved in zip(segs[gap > 0], gap[gap > 0]):
        if a[2] <= 0.25 or b[2] <= 0.25:
            continue  # not drawn
        p = a + s * (b - a)
        x, y = p[:, 0] / p[:, 2], p[:, 1] / p[:, 2]
        u, v = fx * x + cx, fy * y + cy
        seen = (u > -2) & (u < w + 2) & (v > -2) & (v < h + 2)  # alpha reaches 1.8 px out
        if seen.any():
            gain = (max(fx, fy) / p[:, 2] * np.sqrt(1.0 + x * x + y * y))[seen].max()
            bound += moved * gain * 1.0 * 0.55
    assert np.abs(got - want).max() <= bound
    u8 = [np.clip(im * 255.0, 0, 255).astype(np.uint8).astype(np.int16) for im in (got, want)]
    d = np.abs(u8[0] - u8[1])
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_render_view3d_rotated_pose_and_batch():
    """A hard query's rotated pose, alone and batched with a sequence pose:
    the batch renders each view as alone (bit-equal)."""
    from scipy.spatial.transform import Rotation

    h, w = 120, 188
    jw, tw = _worlds(1)
    Rwc = (Rotation.from_euler("y", 0.12) * Rotation.from_euler("x", -0.04)).as_matrix()
    pos = np.array([0.25, 0.03, 2.0])
    Rcw = Rwc.T.astype(np.float32)
    tcw = (-Rwc.T @ pos).astype(np.float32)
    want = np.asarray(J.render_view3d(jw, jnp.asarray(Rcw), jnp.asarray(tcw), *INTR, h, w,
                                      None, texture=0.1, texture_key=jax.random.PRNGKey(32)))
    one = T.render_view3d(tw, torch.as_tensor(Rcw)[None], torch.as_tensor(tcw)[None], *INTR,
                          h, w, texture=0.1, texture_theta=_theta(1))
    assert np.abs(one[0].numpy() - want).max() <= 5e-5
    both = T.render_view3d(tw, torch.stack([torch.eye(3), torch.as_tensor(Rcw)]),
                           torch.tensor([[0.0, 0.0, -0.5], tcw.tolist()]), *INTR, h, w,
                           texture=0.1, texture_theta=_theta(1))
    assert torch.equal(both[1], one[0])


def test_dark_transform_on_a_render():
    jw, tw = _worlds(0)
    tcw = np.array([0.0, 0.0, -1.0], np.float32)
    img = T.render_view3d(tw, torch.eye(3)[None], torch.as_tensor(tcw)[None], *INTR, 60, 94)
    key = jax.random.PRNGKey(2000)
    want = np.asarray(J.dark_transform(key, jnp.asarray(img[0].numpy())))
    got = T.dark_transform(img, {"noise": torch.as_tensor(
        np.array(jax.random.normal(key, (60, 94))))[None]})
    assert np.abs(got[0].numpy() - want).max() <= 1e-6


@pytest.mark.parametrize("traj", ("forward", "loop", "wide"))
def test_trajectories_equal_jax(traj):
    from apps import benchmark_system as jbench
    from apps import make_synth_dataset as jmsd

    t = np.arange(-1, 1601) / 200.0
    assert np.array_equal(BENCH.traj_position(t, traj, 8.0), jbench.traj_position(t, traj, 8.0))
    assert np.array_equal(MSD.traj_accel(np.maximum(t, 0), traj, 8.0),
                          jmsd.traj_accel(np.maximum(t, 0), traj, 8.0))


def test_make_sequence_equals_jax():
    """``make_sequence`` with JAX's world, texture and noise: the JAX
    function's jitted render, 3 frames of the loop at 60×94."""
    from apps import benchmark_system as jbench

    n, h, w = 3, 60, 94
    ts_j, L_j, R_j, gt_j = jbench.make_sequence(n, h, w, seed=0, stride=2, traj="loop",
                                                texture=0.1)
    key = jax.random.PRNGKey(0)
    draws = {"world": T.make_world3d(_t(MTO.jax_world3d_draws(key))), "texture": _theta(0),
             "noise": torch.as_tensor(MTO.jax_sequence_noise(0, n, h, w)["noise"])}
    ts, L, R, gt = BENCH.make_sequence(n, h, w, draws, stride=2, traj="loop", texture=0.1)
    assert np.array_equal(ts, ts_j) and all(np.array_equal(a, b) for a, b in zip(gt, gt_j))
    assert np.abs(L - L_j).max() <= 1e-5 and np.abs(R - R_j).max() <= 1e-5


def test_hard_queries_equal_jax(tmp_path):
    """The hard queries' poses and ``gt_tum.txt`` equal the JAX app's (the
    same numpy draws); the port renders its own images of them."""
    from apps import make_synth_dataset as jmsd

    n_frames, n = 12, 3
    ts = np.arange(n_frames) * 0.1
    gt = []
    for k in range(n_frames):
        Tw = np.eye(4)
        Tw[:3, 3] = BENCH.traj_position(ts[k], "loop", 1.2)
        gt.append(Tw)
    jdir = jmsd.render_hard_queries(str(tmp_path / "jax"), 0, ts, gt, n, 48, 75)
    draws = {"world": _worlds(0)[1], "texture": _theta(0)}
    tdir = MSD.render_hard_queries(str(tmp_path / "torch"), 0, ts, gt, n, 48, 75, draws,
                                   torch.Generator().manual_seed(1000))
    with open(os.path.join(jdir, "gt_tum.txt")) as a, open(os.path.join(tdir, "gt_tum.txt")) as b:
        assert a.read() == b.read()
    assert sorted(os.listdir(os.path.join(jdir, "data"))) == sorted(
        os.listdir(os.path.join(tdir, "data")))


def test_distorted_inverse_maps_equal_jax():
    """The inverse warps of ``--distort_camera``: the JAX app's cv2 maps over
    its camera's rectification, rebuilt from the JAX ``Camera``."""
    import cv2

    from airslam_tpu.core.camera import Camera as JCamera

    yaml = os.path.join(REPO, "configs", "camera", "synth_stereo_distorted.yaml")
    h, w = 480, 752
    intr, baseline, maps = MSD.inverse_maps(yaml, h, w)
    cam = JCamera(yaml)
    rect = cam.rect
    assert intr == (cam.fx, cam.fy, cam.cx, cam.cy) and baseline == cam.bf / cam.fx
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    pix = np.stack([xs, ys], -1).reshape(-1, 1, 2)
    for side, i in (("cam0", "0"), ("cam1", "1")):
        want = cv2.undistortPoints(pix, rect["K" + i], rect["D" + i], R=rect["R" + i],
                                   P=rect["P" + i][:3, :3]).reshape(h, w, 2).astype(np.float32)
        assert np.array_equal(maps[side], want), side
    with pytest.raises(ValueError):
        MSD.inverse_maps(os.path.join(REPO, "configs", "camera", "synth_stereo.yaml"), h, w)


def test_distort_is_exact_bilinear():
    """The inverse warp samples bilinearly in exact arithmetic with the
    border replicated (OpenCV 5's ``remap``; the JAX app's tree on this
    OpenCV): against a float64 numpy reference over the distorted rig's
    inverse map, within 1e-6."""
    _, _, maps = MSD.inverse_maps(
        os.path.join(REPO, "configs", "camera", "synth_stereo_distorted.yaml"), 480, 752)
    img = np.random.default_rng(0).uniform(0, 1, (2, 480, 752)).astype(np.float32)
    got = MSD.distort(img, maps["cam1"], "cpu")
    x, y = maps["cam1"][..., 0].astype(np.float64), maps["cam1"][..., 1].astype(np.float64)
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = x - x0, y - y0

    def tap(yy, xx):
        return img[:, np.clip(yy, 0, 479).astype(int), np.clip(xx, 0, 751).astype(int)]

    want = (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
            + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)
    assert got.shape == img.shape and np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("side", ["cam0", "cam1"])
def test_distort_matches_the_jax_apps_remap(side):
    """The port's inverse warp against the call the JAX app makes
    (``cv2.remap``, INTER_LINEAR, BORDER_REPLICATE; apps/make_synth_dataset.py)
    on the distorted rig's inverse maps, within 1e-6 (float32 rounding)."""
    import cv2

    _, _, maps = MSD.inverse_maps(
        os.path.join(REPO, "configs", "camera", "synth_stereo_distorted.yaml"), 480, 752)
    img = np.random.default_rng(1).uniform(0, 1, (2, 480, 752)).astype(np.float32)
    got = MSD.distort(img, maps[side], "cpu")
    want = np.stack([cv2.remap(v, maps[side][..., 0], maps[side][..., 1], cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_REPLICATE) for v in img])
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-6
