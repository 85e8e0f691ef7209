"""The port's tracking slice on the CPU against the JAX package on the same
stored stereo pairs: SuperPoint, the detector with SuperPoint keypoints, the
batched matcher, the line bookkeeping, the host data model, and the slice as
a whole (JAX ``MapBuilder`` and the port's through the same method sequence).
Networks run in float32 on both sides; tolerances are stated per test."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from airslam_tpu.frontend import lines as jlines
from airslam_tpu.models import weights as jax_weights
from airslam_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from airslam_tpu.slam.frame import Frame as JaxFrame
from airslam_tpu_torch.frontend import lines
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.models.superpoint import SuperPoint
from airslam_tpu_torch.pipelines.map_builder import KeyframeConfig, MapBuilder
from airslam_tpu_torch.slam.frame import Frame
from airslam_tpu_torch.slam.landmarks import LandmarkType, Mapline, Mappoint
from airslam_tpu_torch.slam.map import Map

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _oracle_script():
    """scripts/make_torch_oracle.py as a module: the JAX side of the slice is
    driven by the functions that wrote the stored tracking oracle."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_oracle", os.path.join(REPO, "scripts", "make_torch_oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def frames():
    return chip_smoke.oracle_pairs()[0]


@pytest.fixture(scope="module")
def camera_values():
    return chip_smoke.tracking_oracle()[0]


@pytest.fixture(scope="module")
def port_builder_factory(camera_values):
    """Port builders share one detector and one matcher (checkpoint loads)."""
    first = chip_smoke.tracking_builder(camera_values, torch.float32, "cpu")

    def make(dtype=torch.float64):
        return MapBuilder(first.camera, first.detector, first.matcher, device="cpu", dtype=dtype)

    return make


@pytest.fixture(scope="module")
def jax_side(frames):
    """The JAX builder initialised on pair 0, and its frontend outputs
    (features, stereo pairs, temporal matches) for pairs 1 and 2."""
    script = _oracle_script()
    builder = script.jax_builder()
    first = builder.add_input(0.0, frames[0][0], frames[0][1])
    assert builder.init
    fronts = {i: script.jax_frontend(builder, frames[i]) for i in (1, 2)}
    return script, builder, first, fronts


# ---------------------------------------------------------------------------
# SuperPoint and the detector
# ---------------------------------------------------------------------------


def test_superpoint_vs_flax():
    """Shipped weights, a narrow 64×96 input, float32: scores, logits and
    descriptors within 1e-5 (convolution sums in another order)."""
    rng = np.random.RandomState(0)
    x = rng.rand(2, 64, 96).astype(np.float32)
    params = jax_weights.load_params(jax_weights.checkpoint_path("superpoint.npz"))
    want = JaxSuperPoint(dtype=jnp.float32).apply(params, jnp.asarray(x)[..., None])
    model = SuperPoint()
    model.load_state_dict(wio.superpoint_from_flax(
        wio.load_npz(wio.checkpoint_path("superpoint.npz"))))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)[:, None])
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(np.linalg.norm(got["descriptors"].numpy(), axis=-1), 1.0,
                               atol=1e-5)


def test_detector_use_superpoint_default_and_vs_jax(frames, port_builder_factory, jax_side):
    """``use_superpoint`` defaults to True as in the JAX config; on pair 1 the
    port's detections agree with the JAX detector's: keypoints (1e-2 px for
    ≥ 99 %), descriptors of the coinciding keypoints (1e-4), line and junction
    agreement at the f32 gates of the frontend slice."""
    from airslam_tpu.frontend.detector import DetectorConfig as JaxDetectorConfig
    from airslam_tpu_torch.frontend.detector import DetectorConfig

    assert DetectorConfig().use_superpoint is JaxDetectorConfig().use_superpoint is True
    detector = port_builder_factory().detector
    assert detector.superpoint is not None
    got = detector.detect(frames[1], detect_junctions=True)
    want = jax_side[3][1]  # (f0, f1, pairs, temporal) of pair 1
    for view in (0, 1):
        ref = want[view]
        kp_ref = np.asarray(ref.keypoints)[np.asarray(ref.kp_mask)]
        mask = got.kp_mask[view].numpy()
        kp = got.keypoints[view].numpy()[mask]
        assert abs(len(kp) - len(kp_ref)) <= 2
        d = np.linalg.norm(kp_ref[:, None] - kp[None], axis=-1)
        near = d.min(axis=1) <= 1e-2
        assert near.mean() >= 0.99
        desc = got.kp_desc[view].numpy()[mask][d.argmin(axis=1)[near]]
        desc_ref = np.asarray(ref.kp_desc)[np.asarray(ref.kp_mask)][near]
        np.testing.assert_allclose(desc, desc_ref, rtol=0, atol=1e-4)
        assert chip_smoke._lines_agree(
            np.asarray(ref.lines)[np.asarray(ref.line_mask)],
            got.lines[view].numpy()[got.line_mask[view].numpy()], 3.0) >= 0.90
        assert chip_smoke._pts_agree(
            np.asarray(ref.junctions)[np.asarray(ref.junc_mask)],
            got.junctions[view].numpy()[got.junc_mask[view].numpy()], 2.0) >= 0.90


# ---------------------------------------------------------------------------
# the batched matcher
# ---------------------------------------------------------------------------


def test_batched_matcher_equals_per_pair(port_builder_factory, jax_side):
    """ONE forward pass over (B, N, …) gives, for each pair, what the pair
    alone gives: the same index pairs, scores within 1e-5 (batched matrix
    products may sum in another order); and the JAX matcher's index pairs."""
    matcher = port_builder_factory().matcher
    _, jbuilder, first, fronts = jax_side
    f0, f1, stereo_ref, temporal_ref = fronts[1]
    pairs = [(f0, f1), (first, f0), (f1, f0)]
    batched = matcher.matching_points_batched(pairs)
    assert len(batched) == 3
    for (a, b), (got_pairs, got_sc) in zip(pairs, batched):
        one_pairs, one_sc = matcher.matching_points(a, b)
        np.testing.assert_array_equal(got_pairs, one_pairs)
        np.testing.assert_allclose(got_sc, one_sc, rtol=0, atol=1e-5)
        assert len(got_pairs) > 50
    np.testing.assert_array_equal(batched[0][0], stereo_ref)
    np.testing.assert_array_equal(batched[1][0], temporal_ref)
    # match() takes the JAX signature, scores included, and any batch shape
    m = matcher.match(f0.keypoints, f0.kp_scores, f0.kp_desc, f0.kp_mask,
                      f1.keypoints, f1.kp_scores, f1.kp_desc, f1.kp_mask)
    assert tuple(m.idx1.shape) == (400,)
    np.testing.assert_array_equal(np.nonzero(m.mask.numpy())[0], stereo_ref[:, 0])
    assert matcher.matching_points_batched([]) == []


# ---------------------------------------------------------------------------
# line bookkeeping: exact against JAX
# ---------------------------------------------------------------------------


def _table(pairs, k):
    idx1 = np.full(k, -1, np.int32)
    msk = np.zeros(k, bool)
    idx1[pairs[:, 0]] = pairs[:, 1]
    msk[pairs[:, 0]] = True
    return idx1, msk


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_frame_relations_and_line_matches_vs_jax(jax_side, dtype):
    """On the JAX detections of pair 1: the point-on-line relation, the
    stereo line match and the temporal line match equal JAX's, entry by
    entry."""
    _, _, first, fronts = jax_side
    f0, f1, stereo, temporal = fronts[1]
    idx1, msk = _table(np.asarray(stereo), 400)
    args = [np.asarray(a) for a in (f0.lines, f0.line_mask, f0.keypoints, f0.kp_mask,
                                    f1.lines, f1.line_mask, f1.keypoints, f1.kp_mask)]
    args = [a.astype(dtype) if a.dtype.kind == "f" else a for a in args]
    rel_ref, lm_ref = jlines.frame_relations(*args, idx1, msk)
    rel, lm = lines.frame_relations(*(torch.from_numpy(a) for a in args),
                                    torch.from_numpy(idx1), torch.from_numpy(msk))
    np.testing.assert_array_equal(rel.numpy(), np.asarray(rel_ref))
    np.testing.assert_array_equal(lm.numpy(), np.asarray(lm_ref))
    assert rel.numpy().sum() > 50 and (lm.numpy() >= 0).sum() > 5

    idx1, msk = _table(np.asarray(temporal), 400)
    want = jlines.match_lines_by_points(first.points_on_lines, np.asarray(rel_ref), idx1, msk)
    got = lines.match_lines_by_points(torch.from_numpy(first.points_on_lines), rel,
                                      torch.from_numpy(idx1), torch.from_numpy(msk))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).sum() > 5


def test_triangulate_stereo_lines_vs_jax(jax_side, camera_values):
    """The first keyframe's stereo line triangulation (1e-9 in f64)."""
    from airslam_tpu_torch.core.camera import Camera

    _, jbuilder, first, _ = jax_side
    cam = Camera(node=chip_smoke.camera_node(camera_values))
    want_e, want_ok = jlines.triangulate_stereo_lines(
        jnp.asarray(first.lines, jnp.float64), jnp.asarray(first.lines_right),
        jnp.asarray(first.lines_right_valid), jnp.asarray(first.Twc[:3, :3]),
        jnp.asarray(first.Twc[:3, 3]), jbuilder.map._intr, cam.min_x_diff, cam.max_x_diff)
    t = lambda a: torch.as_tensor(np.array(a, np.float64))
    got_e, got_ok = lines.triangulate_stereo_lines(
        t(first.lines), t(first.lines_right), torch.as_tensor(first.lines_right_valid),
        t(first.Twc[:3, :3]), t(first.Twc[:3, 3]), cam.intrinsics(), cam.min_x_diff,
        cam.max_x_diff)
    ok = np.asarray(want_ok)
    np.testing.assert_array_equal(got_ok.numpy(), ok)
    assert ok.sum() > 3
    np.testing.assert_allclose(got_e.numpy()[ok], np.asarray(want_e)[ok], rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------------
# the host data model
# ---------------------------------------------------------------------------


def test_frame_vs_jax_frame(jax_side, camera_values):
    """``Frame`` built from tensors holds what the JAX ``Frame`` built from
    the same arrays holds, and gates the stereo matches identically."""
    from airslam_tpu_torch.core.camera import Camera

    f0, f1, stereo, _ = jax_side[3][1]
    cam = Camera(node=chip_smoke.camera_node(camera_values))
    as_tensors = type(f0)(*(torch.from_numpy(np.array(a)) for a in f0))
    ours, ref = Frame(3, 0.15, as_tensors, cam), JaxFrame(3, 0.15, f0, cam)
    assert ours.add_right_features(f1, stereo, cam) == ref.add_right_features(f1, stereo, cam) > 90
    for name in ("keypoints", "kp_scores", "kp_desc", "kp_mask", "lines", "line_mask",
                 "junctions", "junc_mask", "u_right", "depth", "track_ids", "mappoint_ids",
                 "lines_right", "lines_right_valid", "points_on_lines", "Twc"):
        got, want = getattr(ours, name), getattr(ref, name)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    i = int(np.nonzero(ours.depth > 0)[0][0])
    np.testing.assert_array_equal(ours.keypoint_position(i), ref.keypoint_position(i))
    np.testing.assert_array_equal(ours.back_project(i, cam), ref.back_project(i, cam))
    assert ours.back_project(int(np.nonzero(ours.depth <= 0)[0][0]), cam) is None
    assert ours.valid_keypoint_count() == ref.valid_keypoint_count()
    assert ours.valid_line_count() == ref.valid_line_count()
    T = np.eye(4)
    T[:3, 3] = [1.0, 2.0, 3.0]
    ours.set_pose(T)
    np.testing.assert_array_equal(ours.imu_pose(cam.Tcb), T @ cam.Tcb)
    assert ours.add_right_features(f1, np.zeros((0, 2), np.int32), cam) == 0


def test_mappoint_and_mapline_behaviour():
    """The landmark records go through the same life as the JAX package's
    under the same calls (exact: host numpy on both sides)."""
    from airslam_tpu.slam import landmarks as jl

    def state(obj):
        return {k: (v.name if hasattr(v, "name") else v) for k, v in vars(obj).items()}

    def same(a, b):
        sa, sb = state(a), state(b)
        assert sa.keys() == sb.keys()
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)

    pts = [Mappoint(7, descriptor=np.ones(4)), jl.Mappoint(7, descriptor=np.ones(4))]
    assert pts[0].type == LandmarkType.UNTRIANGULATED and not pts[0].is_valid
    for step in (lambda m: m.set_position([1.0, 2.0, 3.0]), lambda m: m.add_observer(0, 11),
                 lambda m: m.add_observer(1, 12), lambda m: m.remove_observer(0),
                 lambda m: m.remove_observer(5), lambda m: m.set_bad(),
                 lambda m: m.set_position([0.0, 0.0, 1.0])):
        for m in pts:
            step(m)
        same(*pts)
    assert pts[0].type == LandmarkType.BAD and pts[0].observers == {1: 12}
    same(Mappoint(1, position=[1, 2, 3]), jl.Mappoint(1, position=[1, 2, 3]))

    mpls = [Mapline(3), jl.Mapline(3)]
    assert not mpls[0].is_valid and not mpls[0].endpoints_valid
    for step in (lambda m: m.set_endpoints([0.0, 0.0, 1.0, 0.001, 0.0, 1.0]),  # too short
                 lambda m: m.set_endpoints([0.0, 0.0, 1.0, 1.0, 0.0, 1.0]),
                 lambda m: m.add_observer(0, 5), lambda m: m.endpoint_status.update({0: 1}),
                 lambda m: m.set_line3d([0.0, 0.0, 2.0, 0.0, 4.0, 0.0]),
                 lambda m: m.set_endpoints(np.arange(6.0), update_line=False),
                 lambda m: m.remove_observer(0), lambda m: m.set_bad()):
        for m in mpls:
            step(m)
        same(*mpls)
    assert mpls[0].type == LandmarkType.BAD and mpls[0].endpoint_status == {}


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_initialised(frames, port_builder_factory):
    def make(dtype):
        builder = port_builder_factory(dtype)
        first = builder.add_input(0.0, frames[0][0], frames[0][1])
        assert builder.init and first.good_stereo_points >= 90
        return builder

    return make


def test_initialisation_vs_jax(jax_side, port_initialised):
    """Pair 0 through ``add_input`` on both sides: the same keyframe, the same
    map (mappoint positions 1e-3 m, mapline endpoints 1e-2 m: f64 geometry of
    f32 features that agree to about 1e-4 px, amplified by depth² / bf)."""
    _, jbuilder, jfirst, _ = jax_side
    builder = port_initialised(torch.float64)
    ours = builder.last_keyframe
    assert ours.good_stereo_points == jfirst.good_stereo_points
    np.testing.assert_array_equal(ours.track_ids, jfirst.track_ids)
    np.testing.assert_array_equal(ours.line_track_ids, jfirst.line_track_ids)
    np.testing.assert_array_equal(ours.points_on_lines, jfirst.points_on_lines)
    np.testing.assert_array_equal(ours.lines_right_valid, jfirst.lines_right_valid)
    np.testing.assert_array_equal(ours.Twc, jfirst.Twc)
    assert builder.map.mappoints.keys() == jbuilder.map.mappoints.keys()
    for tid, mpt in jbuilder.map.mappoints.items():
        got = builder.map.mappoints[tid]
        assert got.is_valid == mpt.is_valid and got.observers == mpt.observers
        if mpt.is_valid:
            np.testing.assert_allclose(got.position, mpt.position, rtol=0, atol=1e-3)
    assert builder.map.maplines.keys() == jbuilder.map.maplines.keys()
    for tid, mpl in jbuilder.map.maplines.items():
        got = builder.map.maplines[tid]
        assert got.is_valid == mpl.is_valid and got.endpoint_status == mpl.endpoint_status
        if mpl.endpoints_valid:
            np.testing.assert_allclose(got.endpoints, mpl.endpoints, rtol=0, atol=1e-2)
    assert builder.map.covisibility == jbuilder.map.covisibility
    assert len(builder.trajectory) == 1


def _track_both(jax_side, builder, frames, i, pnp):
    """Pair ``i`` through the same method sequence on both sides. ``pnp``:
    a fixed (Twc, n) injected into both, or None for each side's own
    ``_solve_pnp``."""
    script, jbuilder, _, fronts = jax_side
    f0, f1, stereo, temporal = fronts[i]
    want = script.jax_track(jbuilder, 0.05 * i, f0, f1, stereo, temporal, pnp=pnp)
    if pnp is not None:
        builder._solve_pnp = lambda cur, matched: pnp
    try:
        got = builder.track_frame(0.05 * i, frames[i][0], frames[i][1])
    finally:
        builder.__dict__.pop("_solve_pnp", None)
    return got, want


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tracking_slice_vs_jax_fixed_pnp(jax_side, port_initialised, frames, dtype):
    """Initialise, then `_build_frame` → `_track_frame` → `_keyframe_check` on
    pairs 1 and 2 with the stored oracle's PnP pose injected on both sides,
    so that OpenCV's RANSAC draws are not what is compared. f64 geometry:
    pose 1e-5 m / 1e-6; f32 geometry (the card's type): 1e-3 m / 1e-3; equal
    inlier flags, count, keyframe decision and line matches."""
    _, _, stored = chip_smoke.tracking_oracle()
    builder = port_initialised(dtype)
    t_tol, r_tol = (1e-5, 1e-6) if dtype == torch.float64 else (1e-3, 1e-3)
    for i in (1, 2):
        pnp = (stored[i]["pnp_raw_Twc"], int(stored[i]["pnp_inliers"]))
        got, want = _track_both(jax_side, builder, frames, i, pnp)
        np.testing.assert_allclose(want["pnp_Twc"], pnp[0], atol=1e-12)
        np.testing.assert_allclose(got.Twc[:3, 3], want["Twc"][:3, 3], rtol=0, atol=t_tol)
        np.testing.assert_allclose(got.Twc[:3, :3], want["Twc"][:3, :3], rtol=0, atol=r_tol)
        assert got.num_inliers == int(want["num_inliers"]) > builder.kf_config.lost_num_match
        np.testing.assert_array_equal(np.asarray(got.inlier_flags, np.int32).reshape(-1, 2),
                                      want["inlier_flags"])
        assert got.keyframe_decision == int(want["keyframe_decision"])
        np.testing.assert_array_equal(got.line_matches, want["line_matches"])
        # the live JAX run reproduces the stored oracle
        np.testing.assert_array_equal(want["matches"], stored[i]["matches"])
        assert int(want["num_inliers"]) == int(stored[i]["num_inliers"])
        np.testing.assert_allclose(want["Twc"], stored[i]["Twc"], atol=1e-6)
    # inlier track ids were handed on to the tracked frame
    cur = builder.last_tracked_frame
    assert (cur.track_ids >= 0).sum() >= got.num_inliers
    assert (cur.line_track_ids >= 0).sum() == (got.line_matches >= 0).sum()


def test_tracking_slice_vs_jax_real_pnp(jax_side, port_initialised, frames):
    """The same with each side's own ``_solve_pnp`` (OpenCV on both): the
    pose-only solve lands on the same pose from either start (1e-3 m)."""
    builder = port_initialised(torch.float32)
    got, want = _track_both(jax_side, builder, frames, 1, None)
    assert int(want["pnp_inliers"]) >= 8
    np.testing.assert_allclose(got.Twc[:3, 3], want["Twc"][:3, 3], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.Twc[:3, :3], want["Twc"][:3, :3], rtol=0, atol=1e-3)
    assert abs(got.num_inliers - int(want["num_inliers"])) <= 2
    assert got.keyframe_decision == int(want["keyframe_decision"])


def test_track_features_stops_at_the_second_keyframe(jax_side, port_initialised):
    """``track_features`` runs the whole per-frame logic and no longer stops:
    the second frame becomes the second keyframe, its insertion runs the
    local BA, and the pose lands on the stored JAX VO run's (1e-3 m: f32
    against f64 geometry). The device PnP runs on the keyframe's matches;
    the VI arm of the pose-only solve runs."""
    builder = port_initialised(torch.float32)
    f0, f1, stereo, temporal = jax_side[3][1]
    n_before = len(builder._trajectory)
    ran = []
    builder.map.on_local_ba = lambda f: ran.append(f.frame_id)
    frame = builder.track_features(0.05, f0, f1, stereo, temporal_matches=temporal)
    assert builder.map.keyframe_ids == [0, frame.frame_id] and ran == [frame.frame_id]
    assert builder.last_keyframe is frame and frame.previous_frame.frame_id == 0
    assert len(builder._trajectory) == n_before + 1
    ts, Twc = builder.trajectory[-1]
    assert ts == 0.05 and np.array_equal(Twc, frame.Twc)
    vo = np.load(chip_smoke.VO_ORACLE)
    assert bool(vo["is_keyframe"][1])
    np.testing.assert_allclose(frame.Twc[:3, 3], vo["Twc"][1][:3, 3], rtol=0, atol=1e-3)
    np.testing.assert_allclose(frame.Twc[:3, :3], vo["Twc"][1][:3, :3], rtol=0, atol=1e-3)
    builder.map.check_map()
    # the pose-only solve with the IMU factor to keyframe 0 runs (F=2, the
    # current frame's pose, velocity and biases free): a still IMU against
    # the 0.12 m the camera saw
    from airslam_tpu_torch.core.imu import ImuData, Preintegration

    pre = Preintegration(noise=(1e-3, 1e-2, 1e-5, 1e-4), dtype=torch.float32, device="cpu")
    pre.add_batch([ImuData(0.005 * i, np.zeros(3), np.array([0.0, 0.0, 9.81]))
                   for i in range(12)], 0.0, 0.05)
    builder.preintegration = pre
    matched = [(i, builder.map.mappoints[int(t)]) for i, t in enumerate(frame.mappoint_ids)
               if t >= 0 and builder.map.mappoints[int(t)].is_valid]
    # the device-resident RANSAC PnP lands on the keyframe's pose
    Twc_pnp, n_pnp = builder._solve_pnp_jax(frame, matched)
    assert n_pnp > 100 and np.abs(Twc_pnp[:3, 3] - frame.Twc[:3, 3]).max() < 1e-2
    n_in, flags = builder._pose_only(frame, matched, imu_ref=builder.map.keyframes[0])
    assert len(flags) == len(matched) > 100 and n_in > builder.kf_config.lost_num_match
    assert np.isfinite(frame.Twc).all() and np.isfinite(frame.velocity).all()


def test_keyframe_check_and_lost_paths(port_initialised, jax_side):
    """The keyframe policy's branches, and the paths of a frame with no or
    too few matches."""
    builder = port_initialised(torch.float32)
    ref = builder.last_keyframe
    f0, f1, stereo, temporal = jax_side[3][1]
    cur = builder._build_frame(0.05, f0, f1, stereo)
    few = np.asarray(temporal)[:20]
    assert builder._keyframe_check(ref, cur, few) == 0  # under min_num_match
    assert builder._keyframe_check(ref, cur, np.asarray(temporal)[:60]) == 1  # under max_num_match
    loose = KeyframeConfig(tracking_point_rate=0.1, tracking_parallax_rate=10.0)
    builder.kf_config = loose
    assert builder._keyframe_check(ref, cur, np.asarray(temporal)) == 2
    builder.kf_config = KeyframeConfig(tracking_point_rate=0.1, tracking_parallax_rate=1e-4)
    assert builder._keyframe_check(ref, cur, np.asarray(temporal)) == 1  # parallax
    builder.kf_config = KeyframeConfig()
    # no matches: PnP keeps the last pose, nothing is solved
    n, flags, lm = builder._track(ref, cur, np.zeros((0, 2), np.int32))
    assert n == 0 and flags == [] and (lm == -1).all()
    np.testing.assert_array_equal(cur.Twc, builder.last_tracked_frame.Twc)
    res = builder.track_frame_features(0.05, f0, f1, stereo, np.asarray(temporal)[:6])
    assert res.num_inliers <= builder.kf_config.lost_num_match
    assert res.keyframe_decision == 0


def test_uninitialised_and_deviceless_builder(monkeypatch, camera_values, port_builder_factory):
    """``track_frame`` needs a keyframe; and the builder, the map and the
    tracking entry points resolve their device as every entry point of the
    port does: an error without a card unless the CPU is asked for."""
    builder = port_builder_factory(torch.float32)
    with pytest.raises(RuntimeError, match="initialised"):
        builder.track_frame(0.0, np.zeros((480, 752), np.float32), np.zeros((480, 752), np.float32))
    few = builder.add_input(0.0, np.zeros((480, 752), np.float32),
                            np.zeros((480, 752), np.float32))
    assert not builder.init and few.good_stereo_points < 90  # a blank pair does not initialise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: MapBuilder(builder.camera, builder.detector, builder.matcher),
                 lambda: Map(builder.camera),
                 lambda: chip_smoke.tracking_builder(camera_values, torch.float32, None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
