"""Port ops vs the JAX package on the CPU: remap (kernel R's plain version),
the camera's rectification grids, the LOI samplers (kernels B/T's plain
version), detection and wireframe decode, descriptor sampling, and the
mutual match. Inputs come from numpy seeds and go to both sides."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airslam_tpu.models import plnet as jax_plnet
from airslam_tpu.ops import bilerp_pallas, remap_tiled
from airslam_tpu.ops import detect as jdet
from airslam_tpu.ops import gridsample as jgs
from airslam_tpu.ops import match as jmatch
from airslam_tpu.ops import wireframe as jwf
from airslam_tpu_torch.ops import bilerp, detect, gridsample, match, remap, wireframe

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EUROC_YAML = os.path.join(REPO, "configs", "camera", "euroc.yaml")


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _np(t):
    return t.detach().cpu().numpy()


# -- kernel R's plain version ------------------------------------------------


def _random_smooth_grid(rng, ho, wo, amp):
    """Identity + smooth low-frequency deviation (tests/test_remap_tiled.py)."""
    gy, gx = np.mgrid[0:ho, 0:wo].astype(np.float64)
    fy = amp * np.sin(gy / 37.0) * np.cos(gx / 53.0)
    fx = amp * np.cos(gy / 41.0) * np.sin(gx / 29.0)
    return np.stack([gx + fx + rng.randn(), gy + fy + rng.randn()],
                    axis=-1).astype(np.float32)


@pytest.mark.parametrize("amp", [0.0, 3.5, 17.0])
def test_remap_matches_jax_and_tiled_kernel(amp):
    """atol 1e-5, the JAX suite's tolerance for the tiled kernel; the two
    gather formulations agree exactly in practice."""
    rng = np.random.RandomState(int(amp * 10) + 1)
    h, w = 96, 256
    img = rng.rand(h, w).astype(np.float32)
    grid = _random_smooth_grid(rng, h, w, amp)
    got = _np(gridsample.remap(_t(img), _t(grid)))
    want = np.asarray(jgs.remap(jnp.asarray(img), jnp.asarray(grid)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    plan = remap_tiled.build_plan(grid, (h, w), tile=(8, 128))
    tiled = np.asarray(remap_tiled.remap_planned(jnp.asarray(img), plan, interpret=True))
    np.testing.assert_allclose(got, tiled, rtol=0, atol=1e-5)


def test_remap_batched_wrapper_and_out_of_bounds():
    """The kernel wrapper's CPU route (both views, one grid each) equals the
    plain version per view, including taps beyond every border."""
    rng = np.random.RandomState(7)
    h, w = 64, 128
    imgs = rng.rand(2, h, w).astype(np.float32)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    grids = np.stack([np.stack([gx * 1.3 - 20.0, gy * 1.4 - 15.0], -1),
                      _random_smooth_grid(rng, h, w, 5.0)]).astype(np.float32)
    got = _np(remap.remap(_t(imgs), _t(grids)))
    for i in range(2):
        want = np.asarray(jgs.remap(jnp.asarray(imgs[i]), jnp.asarray(grids[i])))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5)
    one = _np(remap.remap(_t(imgs[1]), _t(grids[1])))
    np.testing.assert_array_equal(one, got[1])


# -- camera ------------------------------------------------------------------


def test_undistort_rectify_map_matches_opencv():
    """The numpy radtan grid equals cv2.initUndistortRectifyMap within 1e-3 px
    (both in f64, stored f32) on the EuRoC rig, with stereoRectify's R/P and
    with R = I, P = K."""
    cv2 = pytest.importorskip("cv2")
    from airslam_tpu_torch.core.camera import Camera, undistort_rectify_map

    cam = Camera(EUROC_YAML)
    r = cam.rect
    size = (cam.image_width, cam.image_height)
    for K, D, R, P in ((r["K0"], r["D0"], r["R0"], r["P0"]),
                       (r["K1"], r["D1"], r["R1"], r["P1"]),
                       (r["K0"], r["D0"], np.eye(3), r["K0"])):
        m1, m2 = cv2.initUndistortRectifyMap(K, D, R, P[:3, :3], size, cv2.CV_32FC1)
        got = undistort_rectify_map(K, D, R, P, size)
        assert np.abs(got - np.stack([m1, m2], -1)).max() <= 1e-3


def test_camera_matches_jax_camera():
    """Same YAML → same maps (exact: both call OpenCV identically), same
    rectified intrinsics; chip_smoke.py's EuRoC constants are the YAML's."""
    from airslam_tpu.core.camera import Camera as JaxCamera
    from airslam_tpu_torch.core.camera import Camera

    import chip_smoke

    ours, ref = Camera(EUROC_YAML), JaxCamera(EUROC_YAML)
    np.testing.assert_array_equal(ours.map_left, ref.map_left)
    np.testing.assert_array_equal(ours.map_right, ref.map_right)
    assert (ours.fx, ours.fy, ours.cx, ours.cy, ours.bf) == (ref.fx, ref.fy, ref.cx, ref.cy, ref.bf)
    import yaml

    text = "\n".join(l for l in open(EUROC_YAML).read().splitlines()
                     if not l.startswith("%YAML"))
    node = yaml.safe_load(text)
    for cam in ("cam0", "cam1"):
        intr, dist = chip_smoke.EUROC[cam]
        assert intr == node[cam]["intrinsics"]
        assert dist == [float(v) for v in node[cam]["distortion_coeffs"]]
    left, right = ours.rectify_maps(device="cpu")
    np.testing.assert_array_equal(_np(left), ref.map_left)
    intr = ours.intrinsics()
    p = np.asarray([[0.3, -0.2, 4.0], [1.0, 0.5, 9.0]])
    want = np.asarray(ref.intrinsics(jnp.float64).stereo_project(jnp.asarray(p)))
    np.testing.assert_allclose(_np(intr.stereo_project(_t(p))), want, rtol=1e-12)


# -- kernels B/T's plain version ---------------------------------------------


def _points(rng, shape, lo=-1.5, hi=129.5):
    return rng.uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("c", [4, 128])
def test_bilerp_f32_matches_pallas_and_onnx(c):
    """f32 maps: plain version vs the Pallas kernel (interpret) and the
    einsum oracle at 2e-6 (the JAX suite's tolerance; only the sum order
    differs), points beyond both borders included."""
    rng = np.random.RandomState(0)
    fmap = rng.randn(128, 128, c).astype(np.float32)
    x, y = _points(rng, (300,)), _points(rng, (300,))
    got = _np(bilerp.bilerp_points(_t(fmap), _t(x), _t(y)))
    pallas = np.asarray(bilerp_pallas.bilerp_points(jnp.asarray(fmap), jnp.asarray(x),
                                                    jnp.asarray(y), interpret=True))
    onnx = np.asarray(jax_plnet._onnx_bilerp(jnp.asarray(fmap), jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == (300, c)
    np.testing.assert_allclose(got, pallas, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, onnx, rtol=2e-6, atol=2e-6)
    got_t = _np(bilerp.bilerp_points_t(_t(fmap), _t(x), _t(y)))
    assert got_t.shape == (c, 300)
    np.testing.assert_array_equal(got_t.T, got)


def test_bilerp_bf16_matches_pallas():
    """bf16 maps at the thin/aux shape: the plain version follows the Pallas
    kernels (bf16 y-weights, f32 accumulation). Both sides share the same
    rounded weights, so 1e-5 of the map's max (the card's tolerance) holds;
    the rules the port rejects (the einsum's bf16 rows, no rounding) miss
    the Pallas result by more than that, so the test tells them apart."""
    rng = np.random.RandomState(1)
    fmap = rng.randn(128, 128, 4).astype(np.float32)
    fb = jnp.asarray(fmap, jnp.bfloat16)
    fmap_bf = _t(np.array(fb.astype(jnp.float32))).to(torch.bfloat16)
    tol = 1e-5 * float(fmap_bf.float().abs().max())
    x, y = _points(rng, (512, 30), 0, 127), _points(rng, (512, 30), 0, 127)
    got = _np(bilerp.bilerp_points_t(fmap_bf, _t(x), _t(y)))
    want = np.asarray(bilerp_pallas.bilerp_points_t(fb, jnp.asarray(x), jnp.asarray(y),
                                                    interpret=True))
    assert got.shape == want.shape == (4, 512, 30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    rows = _np(bilerp.bilerp_points(fmap_bf, _t(x), _t(y)))
    want_rows = np.asarray(bilerp_pallas.bilerp_points(fb, jnp.asarray(x), jnp.asarray(y),
                                                       interpret=True))
    np.testing.assert_allclose(rows, want_rows, rtol=0, atol=tol)
    einsum_rows = np.asarray(jax_plnet._onnx_bilerp(fb, jnp.asarray(x), jnp.asarray(y)),
                             np.float32).reshape(rows.shape)
    unrounded = _np(bilerp.bilerp_points(fmap_bf.float(), _t(x), _t(y)))
    assert np.abs(einsum_rows - want_rows).max() > 10 * tol
    assert np.abs(unrounded - want_rows).max() > 10 * tol


def test_bilerp_border_semantics_and_tail():
    """Far-border samples carry zero total weight (the taps add when
    x0 == x1); below-0 samples extrapolate; a 13-point tail. 1e-6."""
    fmap = np.full((128, 128, 4), 3.0, np.float32)
    x = np.asarray([127.0, 127.5, -0.5, 5.0, 63.2], np.float32)
    y = np.asarray([5.0, 5.0, 5.0, 127.0, 31.7], np.float32)
    got = _np(bilerp.bilerp_points(_t(fmap), _t(x), _t(y)))
    want = np.asarray(bilerp_pallas.bilerp_points(jnp.asarray(fmap), jnp.asarray(x),
                                                  jnp.asarray(y), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert abs(got[0, 0]) < 1e-6 and abs(got[3, 0]) < 1e-6
    rng = np.random.RandomState(2)
    fm = rng.randn(128, 128, 4).astype(np.float32)
    xt, yt = _points(rng, (13,), 0, 127), _points(rng, (13,), 0, 127)
    np.testing.assert_allclose(
        _np(bilerp.bilerp_points(_t(fm), _t(xt), _t(yt))),
        np.asarray(bilerp_pallas.bilerp_points(jnp.asarray(fm), jnp.asarray(xt),
                                               jnp.asarray(yt), interpret=True)),
        rtol=2e-6, atol=2e-6)


# -- detection / wireframe / descriptors -------------------------------------


def _sparse_heat(rng, h, w, density):
    return (rng.rand(h, w) * (rng.rand(h, w) < density)).astype(np.float32)


def test_topk_keypoints_and_nms():
    """Masked outputs equal exactly (ties only among masked zero slots)."""
    rng = np.random.RandomState(3)
    heat = _sparse_heat(rng, 512, 512, 0.001) * 0.02
    got = detect.topk_keypoints(_t(heat), 0.004, 4, 400)
    want = jdet.topk_keypoints(jnp.asarray(heat), 0.004, 4, 400)
    m = np.asarray(want.mask)
    assert 0 < m.sum() < 400
    np.testing.assert_array_equal(_np(got.mask), m)
    np.testing.assert_array_equal(_np(got.xy)[m], np.asarray(want.xy)[m])
    np.testing.assert_array_equal(_np(got.score), np.asarray(want.score))
    dense = rng.rand(128, 128).astype(np.float32)
    np.testing.assert_array_equal(_np(detect.simple_nms(_t(dense), 1)),
                                  np.asarray(jdet.simple_nms(jnp.asarray(dense), 1)))


def _wireframe_inputs(rng):
    jheat = _sparse_heat(rng, 128, 128, 0.012)
    joff = rng.rand(128, 128, 2).astype(np.float32)
    juncs = jwf.decode_junctions(jnp.asarray(jheat), jnp.asarray(joff), 300)
    jxy = np.asarray(juncs.xy)[np.asarray(juncs.mask)]
    p, nj = 3000, min(20, len(jxy))  # few junctions: many duplicate pairs
    a, b = rng.randint(0, nj, p), rng.randint(0, nj, p)
    lp = np.concatenate([jxy[a], jxy[b]], -1) + rng.randn(p, 4) * 0.5
    lp[::7] = rng.uniform(200, 300, (len(lp[::7]), 4))  # far from every junction
    return jheat, joff, juncs, lp.astype(np.float32), rng.randn(p).astype(np.float32)


def test_decode_match_dedup_vs_jax():
    """decode_junctions, match_proposals and dedup_pairs on shared inputs:
    masked outputs equal exactly."""
    rng = np.random.RandomState(4)
    jheat, joff, juncs, lp, logit = _wireframe_inputs(rng)
    got_j = wireframe.decode_junctions(_t(jheat), _t(joff), 300)
    m = np.asarray(juncs.mask)
    np.testing.assert_array_equal(_np(got_j.mask), m)
    np.testing.assert_array_equal(_np(got_j.xy)[m], np.asarray(juncs.xy)[m])

    tj = wireframe.Junctions(*(_t(np.asarray(a)) for a in juncs))
    keep, jmin, jmax = wireframe.match_proposals(_t(lp), _t(logit), tj, 5.0)
    wk, wmin, wmax = jwf.match_proposals(jnp.asarray(lp), jnp.asarray(logit), juncs, 5.0)
    k = np.asarray(wk)
    assert 100 < k.sum() < len(k)
    np.testing.assert_array_equal(_np(keep), k)
    np.testing.assert_array_equal(_np(jmin)[k], np.asarray(wmin)[k])
    np.testing.assert_array_equal(_np(jmax)[k], np.asarray(wmax)[k])

    got = wireframe.dedup_pairs(keep, jmin, jmax, tj, 300, 512, line_pred=_t(lp))
    want = jwf.dedup_pairs(wk, wmin, wmax, juncs, 300, 512, line_pred=jnp.asarray(lp))
    v = np.asarray(want.mask)
    assert 0 < v.sum() < 512
    np.testing.assert_array_equal(_np(got.mask), v)
    for g, w in ((got.pairs, want.pairs), (got.lines, want.lines),
                 (got.prop_lines, want.prop_lines)):
        np.testing.assert_array_equal(_np(g)[v], np.asarray(w)[v])


def test_gate_lines_and_junction_keypoints_vs_jax():
    """gate_lines is elementwise (all outputs equal); the junction keypoints
    equal on their mask."""
    rng = np.random.RandomState(5)
    n = 512
    lines = rng.uniform(-2, 130, (n, 4)).astype(np.float32)
    lines[:100] = np.round(lines[:100])  # shared endpoints → duplicate pixels
    scores = rng.rand(n).astype(np.float32)
    cmask = rng.rand(n) < 0.8
    args = ((512, 512), 4, 0.75, 50.0)
    got = wireframe.gate_lines(_t(lines), _t(scores), _t(cmask), *args)
    want = jwf.gate_lines(jnp.asarray(lines), jnp.asarray(scores), jnp.asarray(cmask), *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    heat = rng.rand(512, 512).astype(np.float32)
    gj = wireframe.collect_junction_keypoints(got, _t(heat), 256)
    wj = jwf.collect_junction_keypoints(want, jnp.asarray(heat), 256)
    m = np.asarray(wj.mask)
    assert 0 < m.sum() <= 256
    np.testing.assert_array_equal(_np(gj.mask), m)
    np.testing.assert_array_equal(_np(gj.xy)[m], np.asarray(wj.xy)[m])
    np.testing.assert_array_equal(_np(gj.score), np.asarray(wj.score))


def test_sample_descriptors_vs_jax():
    """Same align-corners arithmetic; 1e-6 (sum order of the norm only)."""
    rng = np.random.RandomState(6)
    desc = rng.randn(256, 64, 64).astype(np.float32)
    kpts = rng.uniform(-3, 515, (400, 2)).astype(np.float32)
    kpts[:4] = [[0, 0], [511, 511], [-1, 600], [4, 508]]
    got = _np(gridsample.sample_descriptors(_t(desc), _t(kpts), 8))
    want = np.asarray(jgs.sample_descriptors(jnp.asarray(desc), jnp.asarray(kpts), 8))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mutual_match_exact():
    """Identical scores → identical matches (argmax takes the first index on
    both sides; ties planted)."""
    rng = np.random.RandomState(8)
    s = np.log(rng.rand(400, 380).astype(np.float32) * 0.5)
    s[10, :] = s[10, 5]  # a tied row
    np.fill_diagonal(s[:380], 0.0)
    m0, m1 = rng.rand(400) < 0.9, rng.rand(380) < 0.9
    got = match.mutual_match(_t(s), _t(m0), _t(m1), 0.1)
    want = jmatch.mutual_match(jnp.asarray(s), jnp.asarray(m0), jnp.asarray(m1), 0.1)
    assert np.asarray(want.mask).sum() > 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
