"""Stage 2 of the port (``airslam_tpu_torch/pipelines/map_refiner.py``, the
map's global BA and pose-graph corrections, mapv1 files, the refinement
CLI) against the JAX package's, on the feature-stream maps of
tests/test_refinement.py (the corridor loop, map (a)) and
tests/test_pose_graph_refinement.py (the same map with drift, map (b)), and
the mapline-merge cases of tests/test_mapline_merge.py.

The port's ``MapBuilder`` (float64, CPU) builds map (a) once; both packages
then refine the same mapv0 file in float64 (JAX x64). Tolerance 1e-6 (m and
rotation entries) for poses, loop transforms, corrections and mappoints: the
same float64 arithmetic summed in other orders; counts and ids equal. The
stored JAX oracle (``tests/data/torch_refine_oracle.npz``, which the card's
phase reads) is held to the same tolerances here."""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from airslam_tpu.core import lie as jlie
from airslam_tpu.io import serialization as jser
from airslam_tpu.loopclosure.database import Database as JDatabase
from airslam_tpu.loopclosure.vocabulary import train_vocabulary as jtrain
from airslam_tpu.pipelines.map_refiner import MapRefiner as JMapRefiner
from airslam_tpu_torch.core import lie as tlie
from airslam_tpu_torch.io import serialization as tser
from airslam_tpu_torch.loopclosure.database import Database as TDatabase
from airslam_tpu_torch.loopclosure.vocabulary import train_vocabulary as ttrain
from airslam_tpu_torch.pipelines.map_refiner import MapRefiner as TMapRefiner
from tests import test_mapline_merge as jmerge
from tests.test_vo_pipeline import FakeMatcher

torch.set_num_threads(2)
TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "tests", "data", "torch_refine_oracle.npz")


@pytest.fixture(scope="module")
def mapv0(tmp_path_factory):
    """Map (a) from the port's builder, written as a mapv0 file."""
    m, clean = chip_smoke.corridor_map()
    path = str(tmp_path_factory.mktemp("refine") / "AirSLAM_mapv0.bin")
    tser.save_map(m, path)
    return path, m, clean


def _load_both(path):
    jm, _ = jser.load_map(path)
    tm, _ = tser.load_map(path, device="cpu", dtype=torch.float64)
    return jm, tm


def _vocs(m):
    desc = np.concatenate([m.keyframes[f].kp_desc[m.keyframes[f].kp_mask]
                           for f in m.keyframe_ids])[::3]
    return jtrain(desc, k=6, depth=3, seed=1), ttrain(desc, k=6, depth=3, seed=1)


def _refiners(jm, tm):
    jv, tv = _vocs(tm)
    np.testing.assert_array_equal(tv.weights.numpy(), np.asarray(jv.weights))
    jr, tr = JMapRefiner(jm, FakeMatcher(), jv), TMapRefiner(tm, chip_smoke.IdMatcher(), tv)
    jr.n_pose_only = 0
    solve = jr._pose_only

    def counted(*args):
        jr.n_pose_only += 1
        return solve(*args)

    jr._pose_only = counted
    return jr, tr


def _same_loops(jr, tr, tol=TOL):
    assert [(l.query_id, l.loop_id) for l in tr.loop_pairs] == \
        [(l.query_id, l.loop_id) for l in jr.loop_pairs]
    for a, b in zip(jr.loop_pairs, tr.loop_pairs):
        np.testing.assert_allclose(b.Rlq, a.Rlq, atol=tol)
        np.testing.assert_allclose(b.tlq, a.tlq, atol=tol)


def _same_maps(jm, tm, tol=TOL):
    assert tm.keyframe_ids == jm.keyframe_ids
    for f in jm.keyframe_ids:
        np.testing.assert_allclose(tm.keyframes[f].Twc, jm.keyframes[f].Twc, atol=tol)
        np.testing.assert_array_equal(tm.keyframes[f].mappoint_ids, jm.keyframes[f].mappoint_ids)
    assert sorted(tm.mappoints) == sorted(jm.mappoints)
    for i, jp in jm.mappoints.items():
        tp = tm.mappoints[i]
        assert tp.type.value == jp.type.value and tp.observers == jp.observers, i
        if jp.is_valid:
            np.testing.assert_allclose(tp.position, jp.position, atol=tol)
    assert sorted(tm.maplines) == sorted(jm.maplines)
    assert tm.covisibility == jm.covisibility
    tm.check_map()


def test_port_map_matches_the_stored_jax_map(mapv0):
    """The port's builder gives the JAX builder's map (a) (the digest the
    card's phase checks first): keyframe ids, poses, valid mappoints."""
    _, m, _ = mapv0
    z = np.load(ORACLE)
    assert m.keyframe_ids == z["a_kf_ids"].tolist()
    np.testing.assert_allclose(np.stack([m.keyframes[f].Twc for f in m.keyframe_ids]),
                               z["a_kf_Twc"], atol=TOL)
    valid = sorted(i for i, p in m.mappoints.items() if p.is_valid)
    assert valid == z["a_mp_ids"].tolist()
    np.testing.assert_allclose(np.stack([m.mappoints[i].position for i in valid]),
                               z["a_mp_pos"], atol=TOL)


@pytest.fixture(scope="module")
def refined(mapv0):
    path, _, _ = mapv0
    jm, tm = _load_both(path)
    jr, tr = _refiners(jm, tm)
    n_j = jr.run(pose_graph_min_mappoints=10 ** 9)
    n_t = tr.run(pose_graph_min_mappoints=10 ** 9)
    assert n_t == n_j
    return jr, tr


def test_refiner_matches_jax_on_the_corridor_map(refined):
    jr, tr = refined
    assert len(tr.loop_pairs) >= 1 and not tr.pose_graph_ran
    _same_loops(jr, tr)
    assert (tr.n_merged_mappoints, tr.n_merged_maplines) == \
        (jr.n_merged_mappoints, jr.n_merged_maplines)
    assert tr.n_pose_only == jr.n_pose_only
    assert tr.merged_mappoints == jr.merged_mappoints
    _same_maps(jr.map, tr.map)
    for f in jr.map.keyframe_ids:
        assert tr.map.keyframes[f].bow_vector.keys() == jr.map.keyframes[f].bow_vector.keys()
        np.testing.assert_array_equal(tr.map.keyframes[f].word_of_features,
                                      np.asarray(jr.map.keyframes[f].word_of_features))
    assert list(tr.stage_ms) == ["loop_detection", "merge_map", "global_map_optimization",
                                 "build_junction_database"]


def test_refiner_matches_the_stored_oracle(refined):
    """What the card's phase holds the float32 run to, held here in float64."""
    _, tr = refined
    z = np.load(ORACLE)
    assert [[l.query_id, l.loop_id] for l in tr.loop_pairs] == z["a_loop"].tolist()
    np.testing.assert_allclose(np.stack([l.Rlq for l in tr.loop_pairs]), z["a_Rlq"], atol=TOL)
    np.testing.assert_allclose(np.stack([l.tlq for l in tr.loop_pairs]), z["a_tlq"], atol=TOL)
    assert [tr.n_merged_mappoints, tr.n_merged_maplines] == z["a_n_merged"].tolist()
    assert tr.n_pose_only == int(z["a_n_pose_only"])
    m = tr.map
    np.testing.assert_allclose(np.stack([m.keyframes[f].Twc for f in m.keyframe_ids]),
                               z["a_refined_Twc"], atol=TOL)
    assert chip_smoke.refined_ate(m) < 0.05


def test_mapv1_loads_in_the_other_package(refined, tmp_path):
    jr, tr = refined
    tr.save(str(tmp_path / "port_v1.bin"))
    jr.save(str(tmp_path / "jax_v1.bin"))
    jm, jdbs = jser.load_map(str(tmp_path / "port_v1.bin"))
    tm, tdbs = tser.load_map(str(tmp_path / "jax_v1.bin"), device="cpu", dtype=torch.float64)
    assert "point" in jdbs and "point" in tdbs
    jdb, tdb = JDatabase(jr.database.voc), TDatabase(tr.database.voc)
    jdb.load_state_dict(jdbs["point"])
    tdb.load_state_dict(tdbs["point"])
    for f in tr.map.keyframe_ids:
        vec = tr.map.keyframes[f].bow_vector
        assert jm.keyframes[f].bow_vector == vec
        assert tm.keyframes[f].bow_vector.keys() == jr.map.keyframes[f].bow_vector.keys()
        assert jdb.query(vec) == tdb.query(vec) == tr.database.query(vec)
    _same_maps(jm, tr.map, 0.0)
    _same_maps(jr.map, tm, 0.0)


def test_pose_graph_branch_matches_jax_on_the_drifted_map(mapv0):
    """Map (b): the drift injected through each package's
    ``apply_pose_corrections``, then the pose-graph branch taken: the same
    loops, the pose graph's corrections within 1e-6, the whole run's poses,
    and the ATE falls as tests/test_pose_graph_refinement.py requires."""
    path, _, clean = mapv0
    jm, tm = _load_both(path)
    ids = tm.keyframe_ids
    drift = {f: chip_smoke.drift_T(k / (len(ids) - 1)) @ tm.keyframes[f].Twc
             for k, f in enumerate(ids)}
    jm.apply_pose_corrections(copy.deepcopy(drift))
    tm.apply_pose_corrections(copy.deepcopy(drift))
    _same_maps(jm, tm)
    for i, jl in jm.maplines.items():
        if jl.is_valid:
            np.testing.assert_allclose(tm.maplines[i].line3d, jl.line3d, atol=TOL)
    jr, tr = _refiners(jm, tm)
    got = {}
    for name, m in (("jax", jm), ("port", tm)):
        apply = m.apply_pose_corrections

        def record(c, name=name, apply=apply):
            got[name] = copy.deepcopy(c)
            apply(c)

        m.apply_pose_corrections = record

    def ate(m):
        return np.sqrt(np.mean([np.sum((m.keyframes[f].Twc[:3, 3] - clean[f][:3, 3]) ** 2)
                                for f in ids]))

    before = ate(tm)
    assert jr.run(pose_graph_min_mappoints=1) == tr.run(pose_graph_min_mappoints=1) >= 1
    assert tr.pose_graph_ran and jr.pose_graph_ran
    _same_loops(jr, tr)
    for f in ids:
        np.testing.assert_allclose(got["port"][f], got["jax"][f], atol=TOL)
    _same_maps(jm, tm)
    after = ate(tm)
    assert after < 0.25 * before and after < 0.03
    z = np.load(ORACLE)
    np.testing.assert_allclose(np.stack([got["port"][f] for f in ids]), z["b_corrections"],
                               atol=TOL)
    np.testing.assert_allclose([before, after], z["b_ate"][[0, 2]], atol=TOL)
    assert tr.n_pose_only == int(z["b_n_pose_only"])


def test_sparse_global_ba_on_the_map_matches_jax(mapv0):
    """The map's sparse global BA (the path past ``DENSE_BA_MAX_FRAMES``)
    on map (a) in both packages: the same auto table width, problem and
    write-back, poses and mappoints within 1e-6, the same landmarks."""
    path, _, _ = mapv0
    jm, tm = _load_both(path)
    out = {}
    for name, m in (("jax", jm), ("port", tm)):
        frames = [m.keyframes[f] for f in reversed(m.keyframe_ids)]
        fixed = np.zeros(len(frames), bool)
        fixed[-1] = True
        mpts = [p for p in m.mappoints.values() if p.is_valid and p.observers]
        mpls = [l for l in m.maplines.values() if l.is_valid and l.observers]
        prob, layout = m._build_sparse_problem(frames, fixed, mpts, mpls)
        out[name] = (np.asarray(prob.point_obs_table), layout[1:])
        m._sparse_global_ba(frames, fixed, mpts, mpls, 5, 5)
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    _same_maps(jm, tm)


def _merge_map(pkg, share_counts, offset):
    """tests/test_mapline_merge.py's two-line map, built with ``pkg``'s
    classes (the JAX package's or the port's)."""
    if pkg == "jax":
        return jmerge._build_map(share_counts, offset)
    from airslam_tpu_torch.frontend.detector import FrameFeatures
    from airslam_tpu_torch.slam.frame import Frame
    from airslam_tpu_torch.slam.landmarks import Mapline, Mappoint
    from airslam_tpu_torch.slam.map import Map

    cam = chip_smoke.StreamCamera()
    m = Map(cam, device="cpu", dtype=torch.float64)
    K, L = jmerge.K, jmerge.L
    p1, p2 = np.array([-1.0, 0.0, 6.0]), np.array([1.0, 0.5, 6.0])
    off = np.asarray([0.0, offset, 0.0])
    frames = []
    for fid in range(4):
        feats = FrameFeatures(
            keypoints=np.zeros((K, 2)), kp_scores=np.zeros(K), kp_desc=np.zeros((K, 256)),
            kp_mask=np.ones(K, bool), lines=np.zeros((L, 4)), line_scores=np.zeros(L),
            line_mask=np.ones(L, bool), junctions=np.zeros((4, 2)), junc_scores=np.zeros(4),
            junc_desc=np.zeros((4, 256)), junc_mask=np.zeros(4, bool))
        fr = Frame(fid, fid * 0.1, feats, camera=cam)
        T = np.eye(4)
        T[:3, 3] = [0.1 * fid, 0.05 * fid, 0.2 * fid]
        fr.Twc = T
        m.keyframes[fid] = fr
        m.keyframe_ids.append(fid)
        frames.append(fr)
    lines = []
    for lid, (a, b) in enumerate([(p1, p2), (p1 + off, p2 + off)]):
        ln = Mapline(lid)
        ln.set_line3d(tlie.line_from_endpoints(torch.as_tensor(a), torch.as_tensor(b)).numpy())
        ln.endpoints = np.concatenate([a, b])
        ln.endpoints_valid = True
        lines.append(ln)
    m.maplines = {0: lines[0], 1: lines[1]}
    for lid, fids, (a, b) in ((0, (0, 1), (p1, p2)), (1, (2, 3), (p1 + off, p2 + off))):
        for fid in fids:
            frames[fid].lines[0] = jmerge._project_segment(cam, frames[fid].Twc, a, b)
            frames[fid].mapline_ids[0] = lid
            frames[fid].line_track_ids[0] = lid
            lines[lid].add_observer(fid, 0)
    for j in range(share_counts):
        mpt = Mappoint(j, position=p1 + (p2 - p1) * (j + 1) / (share_counts + 1))
        for fid in (0, 2):
            mpt.add_observer(fid, j)
            frames[fid].mappoint_ids[j] = j
            frames[fid].points_on_lines[0, j] = True
        m.mappoints[j] = mpt
    return m


@pytest.mark.parametrize("share,offset,n_left", [(5, 0.0, 1), (3, 0.0, 1), (3, 2.0, 2),
                                                 (5, 2.0, 1)])
def test_mapline_merge_cases_match_jax(share, offset, n_left):
    out = {}
    for pkg, cls in (("jax", JMapRefiner), ("port", TMapRefiner)):
        m = _merge_map(pkg, share, offset)
        r = cls.__new__(cls)
        r.map = m
        r.merge_maplines()
        out[pkg] = m
    jm, tm = out["jax"], out["port"]
    assert len(tm.maplines) == len(jm.maplines) == n_left
    for i, jl in jm.maplines.items():
        tl = tm.maplines[i]
        assert tl.observers == jl.observers
        err = min(np.abs(tl.line3d - jl.line3d).max(), np.abs(tl.line3d + jl.line3d).max())
        assert err < TOL
        np.testing.assert_allclose(tl.endpoints, jl.endpoints, atol=TOL)
    for f in jm.keyframe_ids:
        np.testing.assert_array_equal(tm.keyframes[f].mapline_ids, jm.keyframes[f].mapline_ids)


def test_junction_database_words_equal(mapv0):
    """Keyframes given junction descriptors (one numpy seed): both packages
    train the same junction vocabulary (k 10, depth 3, seed 0) and give each
    keyframe the same junction words and BoW vector."""
    path, _, _ = mapv0
    jm, tm = _load_both(path)
    rng = np.random.RandomState(4)
    for f in tm.keyframe_ids:
        d = rng.randn(8, 256).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        mask = rng.rand(8) > 0.25
        for m in (jm, tm):
            m.keyframes[f].junc_desc, m.keyframes[f].junc_mask = d.copy(), mask.copy()
    jr, tr = _refiners(jm, tm)
    jr.build_junction_database()
    tr.build_junction_database()
    for a, b in zip(jr.junction_database.voc.levels, tr.junction_database.voc.levels):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for f in tm.keyframe_ids:
        np.testing.assert_array_equal(tm.keyframes[f].junction_words,
                                      np.asarray(jm.keyframes[f].junction_words))
        jv, tv = jm.keyframes[f].junction_bow_vector, tm.keyframes[f].junction_bow_vector
        assert tv.keys() == jv.keys() and max(abs(tv[k] - jv[k]) for k in jv) < 1e-6


def test_map_utilities_match_jax(mapv0, tmp_path):
    """``update_mappoint_descriptor``, ``map_scale``, ``export_text`` and the
    single-landmark triangulations give the JAX package's results."""
    path, _, _ = mapv0
    jm, tm = _load_both(path)
    assert tm.map_scale() == pytest.approx(jm.map_scale(), abs=1e-12)
    for i in list(jm.mappoints)[:60]:
        assert tm.update_mappoint_descriptor(tm.mappoints[i]) == \
            jm.update_mappoint_descriptor(jm.mappoints[i])
        np.testing.assert_array_equal(tm.mappoints[i].descriptor, jm.mappoints[i].descriptor)
        if len(jm.mappoints[i].observers) >= 2:
            assert tm.triangulate_mappoint(tm.mappoints[i]) == \
                jm.triangulate_mappoint(jm.mappoints[i])
            np.testing.assert_allclose(tm.mappoints[i].position, jm.mappoints[i].position,
                                       atol=TOL)
    jm.export_text(str(tmp_path / "jax"))
    tm.export_text(str(tmp_path / "port"))
    for rel in ["mappoints.txt"] + [f"frames/{f}.txt" for f in tm.keyframe_ids[:3]]:
        with open(tmp_path / "jax" / rel) as a, open(tmp_path / "port" / rel) as b:
            assert a.read() == b.read(), rel


def _cli(app, root, voc, *extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "apps", app), "--config_path",
         os.path.join(REPO, "configs", "map_refinement", "mr_euroc.yaml"), "--map_root",
         str(root), "--voc_path", str(voc), *extra],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = {}
    for ln in res.stdout.splitlines():
        if ln.startswith("loop pairs:"):
            out["loops"] = int(ln.split()[-1])
        if ln.startswith("merged mappoints:"):
            out["merged"] = (int(ln.split()[2]), int(ln.split()[-1]))
    return out


def test_refinement_cli_matches_the_jax_cli(mapv0, tmp_path):
    """``apps/map_refinement_torch.py --device cpu`` and
    ``apps/map_refinement.py --device cpu`` (LightGlue, float32 both) on the
    stream map (a) with one vocabulary file: equal loop and merge counts,
    trajectory_v1 within 1e-4 m, and the port's four outputs written."""
    import shutil

    path, m, _ = mapv0
    voc = tmp_path / "voc.npz"
    desc = np.concatenate([m.keyframes[f].kp_desc[m.keyframes[f].kp_mask]
                           for f in m.keyframe_ids])
    ttrain(desc, k=10).save(str(voc))
    runs = {}
    for name, app, extra in (("jax", "map_refinement.py", ("--device", "cpu")),
                             ("port", "map_refinement_torch.py", ("--device", "cpu"))):
        root = tmp_path / name
        root.mkdir()
        shutil.copy(path, root / "AirSLAM_mapv0.bin")
        runs[name] = _cli(app, root, voc, *extra)
    assert runs["port"] == runs["jax"] and runs["port"]["loops"] >= 1
    a = np.loadtxt(tmp_path / "jax" / "trajectory_v1.txt")
    b = np.loadtxt(tmp_path / "port" / "trajectory_v1.txt")
    np.testing.assert_array_equal(b[:, 0], a[:, 0])
    assert np.abs(b[:, 1:4] - a[:, 1:4]).max() < 1e-4
    assert (tmp_path / "port" / "AirSLAM_mapv1.bin").exists()
    jm, dbs = jser.load_map(str(tmp_path / "port" / "AirSLAM_mapv1.bin"))
    assert "point" in dbs and len(jm.keyframes) == len(m.keyframes)


def test_refinement_cli_runs_on_cuda_by_default(mapv0):
    """Without ``--device`` the CLI asks for the card and, where there is
    none, raises instead of running on the CPU."""
    sys.path.insert(0, os.path.join(REPO, "apps"))
    import map_refinement_torch

    args = map_refinement_torch.parse_args(["--config_path", "x.yaml", "--map_root", "."])
    assert args.device is None and not args.use_flash
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            map_refinement_torch.main(["--config_path", os.path.join(
                REPO, "configs", "map_refinement", "mr_euroc.yaml"), "--map_root",
                os.path.dirname(mapv0[0])])


def test_outlier_rejection_keeps_the_matches_when_opencv_raises(monkeypatch):
    """OpenCV 4.13 raises on exact correspondences of a pure translation,
    where 5.0 returns a model keeping every match: the matcher then keeps
    every match instead of failing the refinement."""
    import cv2

    from airslam_tpu_torch.frontend import matcher as tmatcher

    rng = np.random.RandomState(0)
    p0 = (rng.rand(40, 2) * [752, 480]).astype(np.float32)
    i0, i1, sc = np.arange(40), np.arange(40)[::-1].copy(), np.ones(40)
    kept = tmatcher._reject_outliers(p0, p0 + [3.0, 0.0], i0, i1, sc)
    assert len(kept[0]) == 40  # a pure shift: every match fits the model

    def broken(*args):
        raise cv2.error("OpenCV(4.13.0) matrix.cpp:764: error: (-215:Assertion failed)")

    monkeypatch.setattr(cv2, "findFundamentalMat", broken)
    got = tmatcher._reject_outliers(p0, p0 + [3.0, 0.0], i0, i1, sc)
    for a, b in zip(got, (i0, i1, sc)):
        np.testing.assert_array_equal(a, b)
