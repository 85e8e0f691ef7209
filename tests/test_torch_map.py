"""The port's map and pipeline against the JAX package's, on the CPU in
float64: the synthetic feature stream of tests/test_vo_pipeline.py and the
line stream of tests/test_vo_lines.py go through ``track_features`` of BOTH
builders (descriptor-identity matcher, no networks), which runs keyframe
insertion, multi-view triangulation, mapline fits, the sliding-window local
BA, its write-back and the endpoint maintenance at every keyframe."""

import numpy as np
import pytest
import torch

from airslam_tpu.pipelines.map_builder import KeyframeConfig as JKeyframeConfig
from airslam_tpu.pipelines.map_builder import MapBuilder as JMapBuilder
from airslam_tpu_torch.core.camera import Intrinsics
from airslam_tpu_torch.core.imu import ImuData
from airslam_tpu_torch.frontend.detector import FrameFeatures
from airslam_tpu_torch.io import publisher as pub
from airslam_tpu_torch.ops.match import Matches
from airslam_tpu_torch.parallel.pipeline import PipelinedRunner
from airslam_tpu_torch.pipelines.map_builder import KeyframeConfig, MapBuilder
from airslam_tpu_torch.slam import map as tmap
from tests import test_vo_lines as jlines
from tests import test_vo_pipeline as jvo

torch.set_num_threads(2)

POSE_TOL = 1e-6  # same f64 arithmetic on both sides; sums differ in order only


class Camera(jvo.FakeCamera):
    """The synthetic camera with the port's intrinsics."""

    def intrinsics(self):
        return Intrinsics(self.fx, self.fy, self.cx, self.cy, self.bf,
                          self.image_width, self.image_height)

    def rectify_maps(self, device=None):
        return None, None


class Matcher(jvo.FakeMatcher):
    """The descriptor-identity matcher, answering in tensors."""

    def match(self, *args, **kw):
        m = super().match(*args, **kw)
        return Matches(*(torch.as_tensor(np.asarray(a)) for a in m))

    def matching_points(self, f0, f1, outlier_rejection=False, threshold=None):
        m = jvo.FakeMatcher.match(self, f0.keypoints, f0.kp_scores, f0.kp_desc, f0.kp_mask,
                                  f1.keypoints, f1.kp_scores, f1.kp_desc, f1.kp_mask)
        i0 = np.nonzero(m.mask)[0]
        return np.stack([i0, m.idx1[i0]], -1).astype(np.int32), m.score[i0]


def _builders(**kf):
    jb = JMapBuilder(jvo.FakeCamera(), detector=None, matcher=jvo.FakeMatcher(),
                     kf_config=JKeyframeConfig(**kf))
    tb = MapBuilder(Camera(), detector=None, matcher=Matcher(), kf_config=KeyframeConfig(**kf),
                    device="cpu", dtype=torch.float64)
    return jb, tb


def _assert_same_map(jb, tb, pose_tol=POSE_TOL):
    jm, tm = jb.map, tb.map
    assert jm.keyframe_ids == tm.keyframe_ids
    assert len(tm.keyframe_ids) >= 3
    for fid in jm.keyframe_ids:
        np.testing.assert_allclose(tm.keyframes[fid].Twc, jm.keyframes[fid].Twc, atol=pose_tol)
        np.testing.assert_array_equal(tm.keyframes[fid].mappoint_ids,
                                      jm.keyframes[fid].mappoint_ids)
        np.testing.assert_array_equal(tm.keyframes[fid].mapline_ids,
                                      jm.keyframes[fid].mapline_ids)
    for (tj, Tj), (tt, Tt) in zip(jb.trajectory, tb.trajectory):
        assert tj == tt
        np.testing.assert_allclose(Tt, Tj, atol=pose_tol)
    assert len(jb.trajectory) == len(tb.trajectory)

    assert sorted(jm.mappoints) == sorted(tm.mappoints)
    for tid, jp in jm.mappoints.items():
        tp = tm.mappoints[tid]
        assert tp.type.value == jp.type.value, tid
        assert tp.observers == jp.observers, tid
        if jp.is_valid:
            np.testing.assert_allclose(tp.position, jp.position, atol=1e-5)
    assert sorted(jm.maplines) == sorted(tm.maplines)
    for lid, jl in jm.maplines.items():
        tl = tm.maplines[lid]
        assert tl.type.value == jl.type.value, lid
        assert tl.observers == jl.observers, lid
        if jl.is_valid:
            # a Plücker line is defined up to sign (an eigenvector's sign
            # decides the order of the fitted endpoints)
            err = min(np.abs(tl.line3d - jl.line3d).max(), np.abs(tl.line3d + jl.line3d).max())
            assert err < 1e-5, lid
    assert tm.covisibility == jm.covisibility
    tm.check_map()


@pytest.fixture(scope="module")
def point_stream():
    """14 frames of the synthetic point world through both builders."""
    jb, tb = _builders(min_init_stereo_feature=50, max_num_match=60, tracking_point_rate=0.5)
    pts, desc = jvo.make_world()
    ba_frames = []
    tb.map.on_local_ba = lambda f: ba_frames.append(f.frame_id)
    for i, Twc in enumerate(jvo.circle_trajectory(14)):
        fl, fr, pairs = jvo.render_features(pts, desc, Twc, jvo.FakeCamera(),
                                            np.random.RandomState(42))
        jb.track_features(float(i) * 0.1, fl, fr, pairs)
        tb.track_features(float(i) * 0.1, fl, fr, pairs)
    return jb, tb, ba_frames


def test_point_stream_same_keyframes_poses_and_landmarks(point_stream):
    jb, tb, _ = point_stream
    _assert_same_map(jb, tb)


def test_local_ba_runs_once_per_keyframe_after_the_first(point_stream):
    _, tb, ba_frames = point_stream
    assert ba_frames == tb.map.keyframe_ids[1:]


def test_point_stream_window_has_fixed_observers(point_stream):
    """The stream is long enough that the last window has five keyframes and
    fixed observers outside it (what three frames cannot show)."""
    _, tb, _ = point_stream
    m = tb.map
    last = m.keyframes[m.keyframe_ids[-1]]
    window = m._window_frames(last)
    assert len(window) == tmap.WINDOW_SIZE and len(m.keyframe_ids) > tmap.WINDOW_SIZE
    ids = {f.frame_id for f in window}
    outside = {fid for p in m.mappoints.values() if p.is_valid and ids & set(p.observers)
               for fid in p.observers if fid not in ids}
    assert outside


def test_line_stream_same_keyframes_poses_and_landmarks():
    """8 frames of the line world, a keyframe at every frame: stereo line
    triangulation, mapline fits from mappoints, line terms in the BA, the
    endpoint maintenance."""
    jb, tb = _builders(min_init_stereo_feature=50, max_num_match=500, tracking_point_rate=2.0)
    segments, pts, desc, _ = jlines.make_line_world()
    for i in range(8):
        T = np.eye(4)
        T[:3, 3] = [0.05 * i, 0.01 * i, 0.1 * i]
        fl, fr, pairs = jlines.render(segments, pts, desc, T, jvo.FakeCamera())
        jb.track_features(i * 0.1, fl, fr, pairs)
        tb.track_features(i * 0.1, fl, fr, pairs)
    _assert_same_map(jb, tb)
    good = [l for l in tb.map.maplines.values() if l.is_valid]
    assert len(good) >= 4
    for lid, jl in jb.map.maplines.items():
        tl = tb.map.maplines[lid]
        assert tl.endpoints_valid == jl.endpoints_valid
        if jl.endpoints_valid:
            swapped = np.concatenate([tl.endpoints[3:], tl.endpoints[:3]])
            err = min(np.abs(tl.endpoints - jl.endpoints).max(),
                      np.abs(swapped - jl.endpoints).max())
            assert err < 1e-5, lid


def test_map_f32_close_to_f64(point_stream):
    """The card's configuration (float32 map) on the same stream: the same
    keyframes, poses within the local-BA gate of the f64 run (0.02 m)."""
    jb, _, _ = point_stream
    _, tb = _builders(min_init_stereo_feature=50, max_num_match=60, tracking_point_rate=0.5)
    tb = MapBuilder(Camera(), None, Matcher(), kf_config=tb.kf_config, device="cpu",
                    dtype=torch.float32)
    pts, desc = jvo.make_world()
    for i, Twc in enumerate(jvo.circle_trajectory(14)):
        fl, fr, pairs = jvo.render_features(pts, desc, Twc, jvo.FakeCamera(),
                                            np.random.RandomState(42))
        tb.track_features(float(i) * 0.1, fl, fr, pairs)
    assert tb.map.keyframe_ids == jb.map.keyframe_ids
    for (_, Tj), (_, Tt) in zip(jb.trajectory, tb.trajectory):
        assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() < 0.02
        assert np.abs(Tt[:3, :3] - Tj[:3, :3]).max() < 5e-3


def _rendered(n=8):
    pts, desc = jvo.make_world(seed=21)
    rng = np.random.RandomState(77)
    return [jvo.render_features(pts, desc, T, jvo.FakeCamera(), rng)
            for T in jvo.circle_trajectory(n)]


class _StubDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i):
        z = np.zeros((480, 752), np.float32)
        return i * 0.1, z, z, None


def test_pipelined_runner_equals_sequential_loop_and_jax():
    rendered = _rendered()
    kf = dict(min_init_stereo_feature=50, max_num_match=60, tracking_point_rate=0.5)

    class StubDetector:
        """Hands out the precomputed pairs in call order, as tensors."""

        def __init__(self):
            self.i = 0

        def detect(self, images, detect_junctions=False):
            fl, fr, _ = rendered[self.i]
            self.i += 1
            return FrameFeatures(*(torch.stack([torch.as_tensor(a), torch.as_tensor(b)])
                                   for a, b in zip(fl, fr)))

    jb, seq = _builders(**kf)
    for i, (fl, fr, pairs) in enumerate(rendered):
        jb.track_features(i * 0.1, fl, fr, pairs)
        seq.track_features(i * 0.1, fl, fr, pairs)

    pipe = MapBuilder(Camera(), StubDetector(), Matcher(), kf_config=KeyframeConfig(**kf),
                      device="cpu", dtype=torch.float64)
    progress = []
    assert PipelinedRunner(pipe).run(_StubDataset(len(rendered)), progress=progress.append) == 8
    assert progress == list(range(8))
    assert len(pipe.trajectory) == len(seq.trajectory) == len(jb.trajectory)
    for (_, T0), (_, T1), (_, T2) in zip(seq.trajectory, pipe.trajectory, jb.trajectory):
        np.testing.assert_allclose(T1, T0, atol=1e-9)
        np.testing.assert_allclose(T1, T2, atol=POSE_TOL)
    assert pipe.map.keyframe_ids == seq.map.keyframe_ids


def test_publisher_gets_every_tracked_frame():
    rendered = _rendered(6)
    p = pub.Publisher()
    got = {"frame_pose": [], "keyframe": [], "map": [], "mapline": []}
    for topic, sink in got.items():
        p.register(topic, sink.append)
    tb = MapBuilder(Camera(), None, Matcher(), publisher=p, device="cpu", dtype=torch.float64,
                    kf_config=KeyframeConfig(min_init_stereo_feature=50, max_num_match=60,
                                             tracking_point_rate=0.5))
    for i, (fl, fr, pairs) in enumerate(rendered):
        tb.track_features(i * 0.1, fl, fr, pairs)
    p.shutdown()
    # the initialising frame returns before the publish, as in the JAX builder
    assert len(got["frame_pose"]) == 5
    assert got["keyframe"][-1].ids == tb.map.keyframe_ids
    assert got["map"][-1].points.shape[1] == 3
    np.testing.assert_allclose(got["frame_pose"][-1].pose, tb.last_tracked_frame.Twc)


def test_what_waits_raises_and_names_its_queue():
    """An IMU camera runs the VI arm (it raised until the stereo-inertial
    slice): the rows between frames are preintegrated and handed to the
    keyframe, the second keyframe's insertion runs the local BA and an IMU
    initialization attempt (which waits for 3 s and 10 keyframes), and once
    the IMU runs the window carries IMU factors with velocities and biases
    free. Nothing waits any more: the device PnP of stage 3 runs on the
    keyframe's matches."""
    rendered = _rendered(2)
    cam = Camera()
    cam.use_imu = True
    cam.gyr_noise, cam.acc_noise, cam.gyr_walk, cam.acc_walk = 1e-3, 1e-2, 1e-5, 1e-4
    tb = MapBuilder(cam, None, Matcher(), device="cpu", dtype=torch.float64,
                    kf_config=KeyframeConfig(min_init_stereo_feature=50, min_num_match=1000))
    tb.track_features(0.0, *rendered[0])
    rows = [ImuData(0.005 * i, np.zeros(3), np.array([0.0, 0.0, 9.81])) for i in range(22)]
    tb.track_features(0.1, *rendered[1], imu_batch=rows)
    m = tb.map
    assert m.keyframe_ids == [0, 1] and not m.imu_initialized
    kf = m.keyframes[1]
    assert tb.preintegration is None and kf.preintegration.valid()
    assert kf.preintegration.dT == pytest.approx(0.1) and kf.preintegration.dtype == torch.float64
    m.imu_initialized = True
    frames = [m.keyframes[1], m.keyframes[0]]
    problem, _ = m._build_problem(frames, np.array([False, True]),
                                  [p for p in m.mappoints.values() if p.is_valid], [])
    assert problem.imu is not None and problem.imu.idx_i.tolist() == [1]
    assert problem.imu.idx_j.tolist() == [0] and problem.vel_fixed.tolist() == [False, True]
    # nothing waits any more: the device PnP (stage 3) runs on the keyframe's matches
    matched = [(i, m.mappoints[int(t)]) for i, t in enumerate(kf.mappoint_ids)
               if t >= 0 and m.mappoints[int(t)].is_valid]
    Twc, n_pnp = tb._solve_pnp_jax(kf, matched)
    assert n_pnp >= 8 and np.abs(Twc[:3, 3] - kf.Twc[:3, 3]).max() < 1e-2
    assert (tmap.WINDOW_SIZE, tmap.MAX_FIXED_FRAMES) == (5, 10)
    assert tmap._bucket(65) == 128 and tmap._pow2_bucket(9) == 16


def test_vo_path_over_the_stored_sequence(tmp_path):
    """The slice as a whole, as ``chip_smoke.py`` drives it on the card: the
    port's ``MapBuilder.add_input`` (float32 networks and map,
    ``use_flash=True``, on the CPU the kernels' plain versions) over the 8
    stored frames against the JAX ``MapBuilder``'s stored run (f32 networks,
    f64 geometry): the same keyframes, every pose within 0.02 m and 5e-3 (the
    ``PARITY_TPU.json`` local-BA gates; measured here about 7e-4 m), landmark
    counts within 5 %; then the trajectory and the map are written and read."""
    import chip_smoke
    from airslam_tpu_torch.core.camera import Camera as YamlCamera
    from airslam_tpu_torch.entry import vo_map_builder
    from airslam_tpu_torch.io.serialization import load_map, save_map
    from airslam_tpu_torch.io.trajectory import ate_rmse, load_tum
    from airslam_tpu_torch.ops.attention import flash_mha

    cam, frames, rec = chip_smoke.vo_oracle()
    assert frames.shape == (8, 2, 480, 752) and rec["keyframe_ids"].tolist() == [0, 1, 3, 5, 7]
    builder = vo_map_builder(YamlCamera(node=chip_smoke.camera_node(cam)), dtype=torch.float32,
                             device="cpu", use_flash=True)
    assert builder.matcher.model.use_flash and flash_mha.launches == 0
    gates = chip_smoke.VO_GATES["f32"]
    for i in range(len(frames)):
        f = builder.add_input(float(rec["timestamps"][i]), frames[i][0], frames[i][1])
        assert np.abs(f.Twc[:3, 3] - rec["Twc"][i][:3, 3]).max() <= gates["t"], i
        assert np.abs(f.Twc[:3, :3] - rec["Twc"][i][:3, :3]).max() <= gates["R"], i
    m = builder.map
    assert m.keyframe_ids == rec["keyframe_ids"].tolist()
    kf = np.stack([m.keyframes[f].Twc for f in m.keyframe_ids])
    assert np.abs(kf[:, :3, 3] - rec["keyframe_Twc"][:, :3, 3]).max() <= gates["t"]
    assert np.abs(kf[:, :3, :3] - rec["keyframe_Twc"][:, :3, :3]).max() <= gates["R"]
    traj = np.stack([T for _, T in builder.trajectory])
    assert np.abs(traj[:, :3, 3] - rec["trajectory"][:, :3, 3]).max() <= gates["t"]
    n_pts = sum(p.is_valid for p in m.mappoints.values())
    n_lns = sum(l.is_valid for l in m.maplines.values())
    assert abs(n_pts - int(rec["n_mappoints"])) <= gates["count_rel"] * int(rec["n_mappoints"])
    assert abs(n_lns - int(rec["n_maplines"])) <= gates["count_rel"] * int(rec["n_maplines"])
    assert ate_rmse(builder.trajectory, list(zip(rec["timestamps"], rec["gt_Twc"]))) < 0.01
    assert flash_mha.launches == 0  # CPU tensors: the plain version, no launch
    builder.save_trajectory(str(tmp_path / "trajectory_v0.txt"))
    builder.save_keyframe_trajectory(str(tmp_path / "kf.txt"))
    assert len(load_tum(str(tmp_path / "trajectory_v0.txt"))) == 8
    assert len(load_tum(str(tmp_path / "kf.txt"))) == 5
    m.check_map()
    save_map(m, str(tmp_path / "AirSLAM_mapv0.bin"))
    back, _ = load_map(str(tmp_path / "AirSLAM_mapv0.bin"), device="cpu")
    assert back.keyframe_ids == m.keyframe_ids and len(back.maplines) == len(m.maplines)
