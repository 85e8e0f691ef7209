"""Entry points of the port.

:class:`FrontendStep` — the stereo frontend step: rectify → PLNet + stage-1
LOI head → LightGlue → mutual match, on one 752×480 pair. Port of
``__graft_entry__.py:entry``'s ``frontend_step`` (the JAX package's flagship
program, ``use_superpoint=False``, ``loi_head="s1"``, ``matcher=0``) plus the
rectify step of ``MapBuilder.rectify`` (``pipelines/map_builder.py:100-121``),
which on the card is kernel R.

:func:`vo_map_builder` — the visual-odometry ``MapBuilder`` as
``configs/visual_odometry/vo_euroc.yaml`` sets it up (SuperPoint keypoints,
PLNet lines and junctions, LightGlue). ``add_input`` initialises it on the
first frame with enough stereo points and from then on tracks every frame,
inserts keyframes and runs the local BA; ``track_frame`` runs the per-frame
tracking path alone against the last keyframe.

:func:`dryrun_multichip` — every multi-device path of the port on a mesh of
n entries, each against its single-device run (``__graft_entry__.py:109-316``,
steps (a) to (e)), one OK line each.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from airslam_tpu_torch import resolve_device
from airslam_tpu_torch.frontend.detector import DetectorConfig, FeatureDetector
from airslam_tpu_torch.frontend.matcher import MatcherConfig, PointMatcher
from airslam_tpu_torch.ops.remap import remap
from airslam_tpu_torch.pipelines.map_builder import MapBuilder
from airslam_tpu_torch.utils.timing import span


class FrontendStep(nn.Module):
    """Detect both stereo views and match them, with the shipped checkpoints
    (``plnet_s0.npz``, ``lightglue.npz``).

    ``dtype`` is the compute dtype (``torch.bfloat16`` is the production
    program, ``torch.float32`` the same program in f32). ``device``: ``cuda``
    unless the caller passes another; raises without a card."""

    def __init__(self, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.detector = FeatureDetector(
            DetectorConfig(max_keypoints=400, use_superpoint=False, dtype=dtype),
            device=self.device)
        self.matcher = PointMatcher(MatcherConfig(dtype=dtype), device=self.device)
        # registered so .parameters() / .to() see the whole program
        self.plnet = self.detector.plnet
        self.loi = self.detector.loi
        self.lightglue = self.matcher.model

    @torch.no_grad()
    def forward(self, stereo_pair):
        """stereo_pair: (2, 480, 752) grayscale in [0, 1]. Returns entry()'s
        11-tuple: (kp0, kp1, idx1, match_score, lines0, line_mask0, kp_desc0,
        kp_mask0, junctions (2, J, 2), junc_desc (2, J, 256), junc_mask (2, J))."""
        pair = torch.as_tensor(stereo_pair, dtype=torch.float32, device=self.device)
        feats = self.detector.detect(pair, detect_junctions=True)
        f0 = type(feats)(*(t[0] for t in feats))
        f1 = type(feats)(*(t[1] for t in feats))
        m = self.matcher.match(f0.keypoints, f0.kp_scores, f0.kp_desc, f0.kp_mask,
                               f1.keypoints, f1.kp_scores, f1.kp_desc, f1.kp_mask)
        return (f0.keypoints, f1.keypoints, m.idx1, m.score, f0.lines,
                f0.line_mask, f0.kp_desc, f0.kp_mask, feats.junctions,
                feats.junc_desc, feats.junc_mask)

    def rectify(self, left, right, grids):
        """Rectify a raw stereo pair: ``grids`` is the (left, right) pair of
        (H, W, 2) source grids, or both stacked as (2, H, W, 2). Both views go
        through kernel R in one launch on the card. Returns (left, right)."""
        if not torch.is_tensor(grids):
            grids = torch.stack([torch.as_tensor(g) for g in grids])
        grids = grids.to(self.device, torch.float32).contiguous()
        images = torch.stack([torch.as_tensor(left), torch.as_tensor(right)])
        with span("rectify"):
            out = remap(images.to(self.device, torch.float32).contiguous(), grids)
        return out[0], out[1]


def vo_map_builder(camera, dtype=torch.bfloat16, device=None, use_flash: bool = False,
                   **builder_args) -> MapBuilder:
    """The tracking pipeline with the shipped checkpoints (``plnet_s0.npz``,
    ``superpoint.npz``, ``lightglue.npz``): 400 SuperPoint keypoints, 512
    lines, networks in ``dtype``, geometry in float32. ``camera``: a
    :class:`core.camera.Camera`. ``use_flash``: LightGlue's attention through
    the fused kernel (``MatcherConfig.use_flash``). ``device``: ``cuda`` unless the caller passes
    another; raises without a card."""
    device = resolve_device(device)
    detector = FeatureDetector(DetectorConfig(max_keypoints=400, use_superpoint=True,
                                              dtype=dtype), device=device)
    matcher = PointMatcher(MatcherConfig(dtype=dtype, use_flash=use_flash), device=device)
    return MapBuilder(camera, detector, matcher, device=device, **builder_args)


# ---------------------------------------------------------------------------
# the multi-device dry run
# ---------------------------------------------------------------------------

_INTR = (450.0, 450.0, 376.0, 240.0, 45.0, 752, 480)  # fx fy cx cy bf w h


def _rotvec(v):
    """Rodrigues: the rotation matrix of rotation vector ``v``."""
    theta = float(np.linalg.norm(v))
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float64)
    if theta < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(theta) / theta * K + (1.0 - np.cos(theta)) / theta ** 2 * (K @ K)


def point_scene(f: int, p: int, rng):
    """A forward-moving stereo rig over ``f`` frames and ``p`` points in
    front of it with their (u, v, u_r) observations: the port's copy of the
    JAX tests' ``make_point_scene`` (tests/synthetic.py), in numpy."""
    fx, fy, cx, cy, bf, w, h = _INTR
    Rwb, twb = np.zeros((f, 3, 3)), np.zeros((f, 3))
    R, t = np.eye(3), np.zeros(3)
    for i in range(f):
        Rwb[i], twb[i] = R, t
        R = R @ _rotvec(rng.randn(3) * 0.02)
        t = t + R @ np.array([0.3, 0, 0.05 * rng.randn()])
    pts = np.stack([rng.uniform(-3, 3, p) + np.mean(twb[:, 0]), rng.uniform(-2, 2, p),
                    rng.uniform(4, 10, p)], axis=-1)
    obs, mask = np.zeros((p, f, 3)), np.zeros((p, f), bool)
    for i in range(f):
        pc = (pts - twb[i]) @ Rwb[i]
        z = pc[:, 2]
        u, v = pc[:, 0] / z * fx + cx, pc[:, 1] / z * fy + cy
        obs[:, i] = np.stack([u, v, u - bf / z], -1)
        mask[:, i] = (z > 0.2) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return {"Rwb": Rwb, "twb": twb, "points": pts, "obs": obs, "mask": mask}


def window_problem(scene, twb=None, points=None, pose_fixed=None, n_lines=1, imu=None,
                   vel_fixed=None, dtype=torch.float32, device="cpu", Rwb=None):
    """The window ``BAProblem`` of a :func:`point_scene` (the JAX tests'
    ``build_problem``), its poses and points replaced by ``Rwb`` / ``twb`` /
    ``points`` where given: frame 0 fixed unless ``pose_fixed`` says otherwise,
    ``n_lines`` fixed unobserved lines, velocities and biases fixed unless
    ``vel_fixed`` says otherwise; ``imu``: :func:`imu_chain`'s factors."""
    from airslam_tpu_torch.backend import gn

    f, p = scene["Rwb"].shape[0], scene["points"].shape[0]
    if pose_fixed is None:
        pose_fixed = np.arange(f) == 0
    z = np.zeros((f, 3))
    prob = {
        "frames": gn.FrameStates(scene["Rwb"] if Rwb is None else Rwb,
                                 scene["twb"] if twb is None else twb, z, z, z),
        "pose_fixed": pose_fixed,
        "vel_fixed": np.ones(f, bool) if vel_fixed is None else vel_fixed,
        "points": scene["points"] if points is None else points,
        "point_fixed": np.zeros(p, bool), "point_obs": scene["obs"],
        "point_obs_mask": scene["mask"],
        "lines": np.tile([1.0, 0, 0, 0, 1.0, 0], (n_lines, 1)),
        "line_fixed": np.ones(n_lines, bool), "line_obs": np.zeros((n_lines, f, 8)),
        "line_obs_stereo": np.zeros((n_lines, f), bool),
        "line_obs_mask": np.zeros((n_lines, f), bool),
        "line_obs_sigma": np.ones((n_lines, f)), "Rwg": np.eye(3), "gravity_free": 0.0,
        "imu": imu, "Rcb": np.eye(3), "tcb": np.zeros(3), "g_value": 9.81}

    class _Leaves:
        def __init__(self, d):
            self.__dict__.update(d)

    return gn.problem_from_numpy(_Leaves(prob), dtype, device)


def imu_chain(idx_i, idx_j):
    """Static IMU factors chaining frames ``idx_i`` → ``idx_j`` (the JAX
    dry run's ``_synthetic_imu_chain``: consistent values, for a sharded
    against single-device check), as numpy leaves."""
    from airslam_tpu_torch.backend import gn

    k = len(idx_i)
    z3, z33 = np.zeros((k, 3)), np.zeros((k, 3, 3))
    return gn.IMUFactors(
        idx_i=np.asarray(idx_i), idx_j=np.asarray(idx_j), dR=np.tile(np.eye(3), (k, 1, 1)),
        dV=np.full((k, 3), 0.01), dP=np.full((k, 3), 0.1), JRg=z33, JVg=z33, JVa=z33, JPg=z33,
        JPa=z33, bg_lin=z3, ba_lin=z3, dT=np.full(k, 0.25),
        info=np.tile(np.eye(9) * 50.0, (k, 1, 1)), info_walk=np.tile(np.eye(6) * 1e4, (k, 1, 1)),
        mask=np.ones(k, bool))


def _intrinsics():
    from airslam_tpu_torch.core.camera import Intrinsics

    return Intrinsics(*_INTR)


def dryrun_mesh(n_devices: int, device=None):
    """The mesh of :func:`dryrun_multichip`: the real cards first (when
    ``device`` is CUDA), then ``device`` repeated up to ``n_devices``
    entries."""
    from airslam_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    devs = []
    if dev.type == "cuda":
        devs = [torch.device("cuda", i) for i in range(min(n_devices, torch.cuda.device_count()))]
    devs += [dev] * (n_devices - len(devs))
    return devs


class _RecordingBuilder:
    """The ``MapBuilder`` contract :class:`MeshPipelinedRunner` reads,
    recording what tracking would consume, in order (the detection is the
    real mesh path)."""

    _match_detected = MapBuilder._match_detected

    def __init__(self, detector):
        self.detector = detector
        self.got = []

    def rectify(self, left, right):
        return torch.stack([torch.as_tensor(left), torch.as_tensor(right)])

    def _stereo_and_temporal(self, f0, f1):
        return None, None

    def track_features(self, ts, f0, f1, pairs, imu=None, temporal_matches=None):
        self.got.append((ts, np.asarray(f0.keypoints), np.asarray(f1.keypoints)))


class _Frames:
    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames) // 2

    def get(self, i):
        return float(i), self.frames[2 * i], self.frames[2 * i + 1], None


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Every multi-device path of the port on a mesh of ``n_devices``
    entries (:func:`dryrun_mesh`), each against the single-device run on the
    same inputs, in float32, one printed line per step as the JAX
    ``dryrun_multichip`` prints: (a) the sharded sparse GlobalBA, (b) the
    sharded window BA, (c) frame-parallel detection over an uneven batch
    (padded), (d) :class:`MeshPipelinedRunner` over 3 stereo frames with a
    partial chunk, (e) one dp/tp LightGlue training step. On CUDA it adds
    the JAX dry run's production shapes: detection of 5 frames at 752×480
    with 400 keypoints, the F = 15 / P = 256 / L = 32 window with an IMU
    chain, and the dim-256 / 9-layer matcher at 128 keypoints; elsewhere
    the matcher step runs at dim 64 / 2 layers.
    Gates: 1e-4 (m) for the BAs, 1e-2 px for keypoints, a finite loss that
    agrees with the single-device step within 1e-4 relative. Returns the
    measured gaps by step."""
    from airslam_tpu_torch.backend import gn, global_ba as gba, windows
    from airslam_tpu_torch.models.lightglue import LightGlue
    from airslam_tpu_torch.parallel import training
    from airslam_tpu_torch.parallel.frontend import sharded_detect
    from airslam_tpu_torch.parallel.mesh import make_mesh
    from airslam_tpu_torch.parallel.pipeline import MeshPipelinedRunner

    devs = dryrun_mesh(n_devices, device)
    dev = devs[0]
    production = dev.type == "cuda"
    mesh, mesh1 = make_mesh(devices=devs), make_mesh(tp=1, devices=devs)
    intr, cfg = _intrinsics(), gn.BAConfig()
    gaps = {}

    def gate(name, err, tol, line):
        gaps[name] = err
        if not err < tol:
            raise RuntimeError(f"dryrun {name} diverged from single-device: {err} (gate {tol})")
        print(line, flush=True)

    # ---- (a) sharded sparse GlobalBA vs single-device ----------------------
    rng = np.random.RandomState(0)
    scene = point_scene(4, 64, rng)
    tp = scene["twb"].copy()
    tp[1:] += rng.randn(3, 3) * 0.05
    pts0 = scene["points"] + rng.randn(64, 3) * 0.05
    prob = window_problem(scene, twb=tp, points=pts0, device=dev)
    sp = gba.dense_to_sparse(prob)
    ref = gba.global_ba(sp, intr, cfg, iters1=2, iters2=3, chunk=32)[0]
    out = gba.global_ba(sp, intr, cfg, iters1=2, iters2=3, chunk=32, mesh=mesh1)[0]
    err = float((out.twb - ref.twb).abs().max())
    gate("sparse-globalba", err, 1e-4,
         f"dryrun sparse-globalba OK: max|dt|={err:.2e} vs single-device")

    # ---- (b) sharded window BA vs single-device ----------------------------
    refw = windows.local_ba(prob, intr, cfg, iters1=2, iters2=3)[0]
    outw = windows.local_ba(prob, intr, cfg, iters1=2, iters2=3, mesh=mesh1)[0]
    err = float((outw.frames.twb - refw.frames.twb).abs().max())
    gate("window-ba", err, 1e-4, f"dryrun window-ba OK: max|dt|={err:.2e} vs single-device")

    # ---- (c) frame-parallel detect vs single-device -------------------------
    det = FeatureDetector(DetectorConfig(max_keypoints=64, max_lines=32, max_proposals=512),
                          device=dev)
    frames = rng.rand(3, 120, 188).astype(np.float32)
    refd, outd = det.detect(frames), sharded_detect(det, frames, mesh)
    err = float((outd.keypoints - refd.keypoints).abs().max())
    gate("sharded-detect", err, 1e-2,
         f"dryrun sharded-detect OK: max|dkp|={err:.2e} px vs single-device")
    if production:
        det_prod = FeatureDetector(DetectorConfig(max_keypoints=400), device=dev)
        frames_prod = rng.rand(5, 480, 752).astype(np.float32)  # 5 % n != 0
        ref2, out2 = det_prod.detect(frames_prod), sharded_detect(det_prod, frames_prod, mesh)
        err = float((out2.keypoints - ref2.keypoints).abs().max())
        gate("sharded-detect-prod", err, 1e-2,
             "dryrun sharded-detect-prod OK: 5 frames @752x480, 400 kpts, uneven remainder "
             f"padded; max|dkp|={err:.2e} px")

        scene15 = point_scene(15, 256, rng)
        fixed15 = np.arange(15) < 10
        prob15 = window_problem(scene15, pose_fixed=fixed15, n_lines=32, vel_fixed=fixed15,
                                imu=imu_chain(np.arange(10, 14), np.arange(11, 15)), device=dev)
        refw2 = windows.local_ba(prob15, intr, cfg, iters1=1, iters2=2)[0]
        outw2 = windows.local_ba(prob15, intr, cfg, iters1=1, iters2=2, mesh=mesh1)[0]
        err = float((outw2.frames.twb - refw2.frames.twb).abs().max())
        gate("window-ba-prod", err, 1e-4, "dryrun window-ba-prod OK: F=15/P=256/L=32 + IMU "
             f"chain, max|dt|={err:.2e} vs single-device")

    # ---- (d) mesh-pipelined map builder vs the sequential loop -------------
    frames6 = rng.rand(6, 120, 188).astype(np.float32)  # 3 stereo frames
    rb = _RecordingBuilder(det)
    runner = MeshPipelinedRunner(rb, mesh)
    runner.run(_Frames(frames6))
    refp = det.detect(frames6, detect_junctions=True)
    if [ts for ts, _, _ in rb.got] != [0.0, 1.0, 2.0]:
        raise RuntimeError(f"dryrun mesh-pipeline: consumption order {[g[0] for g in rb.got]}")
    err = max(float(np.abs(k - refp.keypoints[2 * j + s].cpu().numpy()).max())
              for j, (_, k0, k1) in enumerate(rb.got) for s, k in ((0, k0), (1, k1)))
    gate("mesh-pipeline", err, 1e-2, f"dryrun mesh-pipeline OK: max|dkp|={err:.2e} px over 3 "
         f"frames (chunk={runner.chunk}, partial-chunk padding exercised)")

    # ---- (e) the dp/tp matcher training step --------------------------------
    dim, layers, n_kpts = (256, 9, 128) if production else (64, 2, 32)
    dp = mesh.shape["dp"]
    losses = []
    for m in (None, mesh):
        model = LightGlue(dim=dim, heads=4, layers=layers)
        state = training.init_train_state(model, lr=1e-3, seed=0)  # a CPU generator
        model.to(dev)
        batch = training.make_batch(training.perm_draws(
            torch.Generator().manual_seed(1), 2 * dp, n_kpts, dim=dim))
        losses.append(training.make_train_step(state, m)(tuple(b.to(dev) for b in batch)))
    loss, loss1 = float(losses[1]), float(losses[0])
    err = abs(loss - loss1) / abs(loss1)
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: non-finite training loss {loss}")
    gate("matcher-step", err, 1e-4, f"dryrun_multichip OK: mesh={mesh.shape} dim{dim}/"
         f"{layers}-layer matcher step loss={loss:.4f} (single-device {loss1:.4f})")
    return gaps
