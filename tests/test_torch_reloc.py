"""Stage 3 (relocalization) of the port against the JAX package on the CPU.

(a) ``tests/test_junction_reloc.py``'s junction map, built and refined by
    the JAX package in f64, saved with the JAX ``save_map`` and loaded by
    both packages (the port in f64): the five scenarios of that file with the
    same stub matchers on both sides (the junction re-rank, the bootstrap
    wide-baseline query with recovery on and off, the scrambled-geometry
    reject, projection recovery, matcher recovery's union and its ablation):
    equal ``ok`` and ``last_stats``, ``Twc`` within 1e-9 (the same OpenCV in
    one process). ``junction_connections``, ``_junction_score`` and
    ``Map.search_by_projection`` equal on the same inputs.
(b) The image path on the stored JAX CLI run
    (``tests/data/torch_reloc_oracle.npz``): the port in f32 on 2 queries, on
    its own detection and on the JAX detector's stored features: the same
    ``ok``, candidate and group counts and deputy order, pair counts within
    5 %, poses within 1e-3 m / 1e-3; then the port's CLI on those queries.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from airslam_tpu.frontend.detector import FrameFeatures as JaxFeatures
from airslam_tpu.io.serialization import load_map as jax_load_map
from airslam_tpu.loopclosure.database import Database as JaxDatabase
from airslam_tpu.loopclosure.vocabulary import Vocabulary as JaxVocabulary
from airslam_tpu.loopclosure.vocabulary import train_vocabulary
from airslam_tpu.pipelines import map_user as jmu
from airslam_tpu.pipelines.map_builder import KeyframeConfig, MapBuilder
from airslam_tpu.pipelines.map_refiner import MapRefiner
from airslam_tpu.slam.frame import Frame as JaxFrame
from airslam_tpu_torch.frontend.detector import FrameFeatures
from airslam_tpu_torch.io.serialization import load_map
from airslam_tpu_torch.loopclosure.database import Database
from airslam_tpu_torch.loopclosure.vocabulary import Vocabulary
from airslam_tpu_torch.pipelines import map_user as tmu
from airslam_tpu_torch.slam.frame import Frame
from tests.test_junction_reloc import (TruncatingMatcher, WindowedMatcher, add_junctions)
from tests.test_vo_lines import make_line_world, render
from tests.test_vo_pipeline import FakeCamera, FakeMatcher

import chip_smoke

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_QUERIES = 2  # stored queries whose JAX detector features the oracle keeps
IMAGE_GATES = {"pairs_rel": 0.05, "t": 1e-3, "R": 1e-3}


# ---------------------------------------------------------------------------
# (a) the junction map, both packages on one file
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def junction_files(tmp_path_factory):
    """tests/test_junction_reloc.py's ``junction_map`` fixture (the JAX
    builder and refiner), written as a mapv1 with its databases and both
    vocabularies."""
    cam = FakeCamera()
    builder = MapBuilder(cam, detector=None, matcher=FakeMatcher(),
                         kf_config=KeyframeConfig(min_init_stereo_feature=50, max_num_match=500,
                                                  tracking_point_rate=2.0))
    segments, pts, desc, _ = make_line_world(seed=3)
    rng = np.random.RandomState(9)
    jbank = rng.randn(2 * len(segments), 256).astype(np.float32)
    jbank /= np.linalg.norm(jbank, axis=1, keepdims=True)
    for i in range(8):
        T = np.eye(4)
        T[:3, 3] = [0.04 * i, 0.01 * i, 0.08 * i]
        fl, fr, pairs = render(segments, pts, desc, T, cam)
        builder.track_features(i * 0.1, add_junctions(fl, jbank, segments, T, cam), fr, pairs)
    m = builder.map
    all_desc = np.concatenate([m.keyframes[f].kp_desc[m.keyframes[f].kp_mask]
                               for f in m.keyframe_ids])
    refiner = MapRefiner(m, FakeMatcher(), train_vocabulary(all_desc[::2], k=6, depth=3, seed=2))
    refiner.run(pose_graph_min_mappoints=10 ** 9)
    root = tmp_path_factory.mktemp("junction_map")
    refiner.save(str(root / "AirSLAM_mapv1.bin"))
    refiner.database.voc.save(str(root / "point_voc.npz"))
    refiner.junction_database.voc.save(str(root / "junction_voc.npz"))
    return str(root)


@pytest.fixture(scope="module")
def both_maps(junction_files):
    """(JAX map, point db, junction db), (port map f64 CPU, point db, junction db)."""
    path = os.path.join(junction_files, "AirSLAM_mapv1.bin")
    jm, jdbs = jax_load_map(path)
    tm, tdbs = load_map(path, device="cpu", dtype=torch.float64)
    out = []
    for m, dbs, db_cls, voc_cls, kw in ((jm, jdbs, JaxDatabase, JaxVocabulary, {}),
                                        (tm, tdbs, Database, Vocabulary, {"device": "cpu"})):
        pdb = db_cls(voc_cls.load(os.path.join(junction_files, "point_voc.npz"), **kw))
        pdb.load_state_dict(dbs["point"])
        jdb = db_cls(voc_cls.load(os.path.join(junction_files, "junction_voc.npz"), **kw))
        jdb.load_state_dict(dbs["junction"])
        out.append((m, pdb, jdb))
    return out


def _query(m, frame_cls, feats_cls, fid, kf_index=2, scramble=False, stereo=True):
    """tests/test_junction_reloc.py's query: keyframe ``kf_index``'s features
    (keypoints permuted over the valid slots when ``scramble``)."""
    kf = m.keyframes[m.keyframe_ids[kf_index]]
    kp = kf.keypoints.copy()
    if scramble:
        rng = np.random.RandomState(41)
        valid = np.nonzero(kf.kp_mask)[0]
        kp[valid] = kf.keypoints[valid[rng.permutation(len(valid))]]
    feats = feats_cls(keypoints=kp, kp_scores=kf.kp_scores, kp_desc=kf.kp_desc,
                      kp_mask=kf.kp_mask, lines=kf.lines, line_scores=kf.line_scores,
                      line_mask=kf.line_mask, junctions=kf.junctions,
                      junc_scores=kf.junc_scores, junc_desc=kf.junc_desc,
                      junc_mask=kf.junc_mask)
    q = frame_cls(fid, 0.0, feats, m.camera)
    if stereo:
        q.u_right = kf.u_right.copy()
        q.depth = kf.depth.copy()
    return q, kf


# scenario -> (matcher, MapUser options, query options, stubbed methods)
SCENARIOS = {
    "junction_rerank": (FakeMatcher, dict(min_inlier_num=30, pose_refinement=True), {}, ()),
    "bootstrap_wide_baseline": (lambda: TruncatingMatcher(keep=15),
                                dict(min_inlier_num=30, pose_refinement=True), {}, ()),
    "bootstrap_strict": (lambda: TruncatingMatcher(keep=15),
                         dict(min_inlier_num=30, pose_refinement=True,
                              projection_recovery=False), {}, ()),
    "geometric_garbage": (FakeMatcher, dict(min_inlier_num=30, pose_refinement=True),
                          dict(scramble=True), ()),
    "matcher_recovery_union": (lambda: WindowedMatcher(width=12),
                               dict(min_inlier_num=30, pose_refinement=True),
                               dict(stereo=False), ("_recover_matches",)),
    "matcher_recovery_ablation": (lambda: WindowedMatcher(width=12),
                                  dict(min_inlier_num=30, pose_refinement=True),
                                  dict(stereo=False), ("_recover_matches", "_matcher_recovery")),
}
# what tests/test_junction_reloc.py asserts of each scenario's JAX run
ACCEPTED = {"junction_rerank": True, "bootstrap_wide_baseline": True, "bootstrap_strict": False,
            "geometric_garbage": False, "matcher_recovery_union": True,
            "matcher_recovery_ablation": False}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_relocalize_frame_scenarios_vs_jax(both_maps, scenario):
    """``relocalize_frame`` on the same map file and the same query with the
    same stub matcher: equal ``ok`` and ``last_stats``, ``Twc`` within 1e-9."""
    make_matcher, opts, qopts, stubbed = SCENARIOS[scenario]
    runs = []
    for (m, pdb, jdb), mod, frame_cls, feats_cls in (
            (both_maps[0], jmu, JaxFrame, JaxFeatures), (both_maps[1], tmu, Frame, FrameFeatures)):
        user = mod.MapUser(m, detector=None, matcher=make_matcher(), point_db=pdb,
                           junction_db=jdb, **opts)
        for name in stubbed:
            setattr(user, name, lambda *a, **k: {})
        q, kf = _query(m, frame_cls, feats_cls, 999990, **qopts)
        ok, Twc = user.relocalize_frame(q)
        runs.append((ok, Twc, user.last_stats, kf))
    (jok, jT, jstats, kf), (tok, tT, tstats, _) = runs
    assert jok == ACCEPTED[scenario] and tok == jok
    assert tstats == jstats
    np.testing.assert_allclose(tT, jT, rtol=0, atol=1e-9)
    if jok:
        assert np.linalg.norm(tT[:3, 3] - kf.Twc[:3, 3]) < 0.03


def test_projection_recovery_vs_jax(both_maps):
    """``_recover_matches`` at the keyframe's pose with no prior matches and
    with five of them: the same keypoint → mappoint claims."""
    out = []
    for (m, pdb, jdb), mod, frame_cls, feats_cls in (
            (both_maps[0], jmu, JaxFrame, JaxFeatures), (both_maps[1], tmu, Frame, FrameFeatures)):
        user = mod.MapUser(m, detector=None, matcher=FakeMatcher(), point_db=pdb,
                           junction_db=jdb)
        q, kf = _query(m, frame_cls, feats_cls, 888888, stereo=False)
        rec = user._recover_matches(q, kf.Twc, kf, matched={})
        some = dict(list(rec.items())[:5])
        rec2 = user._recover_matches(q, kf.Twc, kf, matched=some)
        out.append(({qi: mp.id for qi, mp in rec.items()},
                    {qi: mp.id for qi, mp in rec2.items()}))
    assert len(out[0][0]) >= 10
    assert out[1] == out[0]


def test_junction_graph_score_and_projection_search_vs_jax(both_maps):
    """``junction_connections`` of every keyframe and of seeded random
    junctions, ``_junction_score`` of the query against every keyframe, and
    ``Map.search_by_projection`` (tests/test_vo_pipeline.py:227's case, then
    every valid mappoint into a keyframe, thr 1 and 2) equal on both sides."""
    (jm, jpdb, jjdb), (tm, tpdb, tjdb) = both_maps
    for fid in jm.keyframe_ids:
        a, b = jm.keyframes[fid], tm.keyframes[fid]
        assert (tmu.junction_connections(b.junctions, b.junc_mask, b.lines, b.line_mask)
                == jmu.junction_connections(a.junctions, a.junc_mask, a.lines, a.line_mask))
    rng = np.random.RandomState(5)
    jxy = rng.rand(40, 2) * 60
    lines = np.concatenate([jxy[rng.randint(0, 40, 30)], jxy[rng.randint(0, 40, 30)]], 1)
    lines += rng.randn(*lines.shape)
    jmask, lmask = rng.rand(40) > 0.2, rng.rand(30) > 0.2
    conns = tmu.junction_connections(jxy, jmask, lines, lmask)
    assert conns == jmu.junction_connections(jxy, jmask, lines, lmask)
    assert sum(len(c) for c in conns) > 10

    ju = jmu.MapUser(jm, None, FakeMatcher(), jpdb, jjdb)
    tu = tmu.MapUser(tm, None, FakeMatcher(), tpdb, tjdb)
    qj, _ = _query(jm, JaxFrame, JaxFeatures, 777777)
    qt, _ = _query(tm, Frame, FrameFeatures, 777777)
    jvec, jwids, _ = jjdb.frame_to_bow(qj.junc_desc, qj.junc_mask)
    tvec, twids, _ = tjdb.frame_to_bow(qt.junc_desc, qt.junc_mask)
    assert tvec == jvec and np.array_equal(np.asarray(twids), np.asarray(jwids))
    qc = jmu.junction_connections(qj.junctions, qj.junc_mask, qj.lines, qj.line_mask)
    scores = [(tu._junction_score(f, tvec, twids, qc), ju._junction_score(f, jvec, jwids, qc))
              for f in jm.keyframe_ids]
    assert all(a == b for a, b in scores) and max(a for a, _ in scores) > 0.5

    mpt = next(p for p in jm.mappoints.values() if p.is_valid and len(p.observers) >= 3)
    fid = next(iter(mpt.observers))
    good = tm.search_by_projection(tm.keyframes[fid], [tm.mappoints[mpt.id]], thr=1)
    assert [(i, p.id) for i, p in good] == [(mpt.observers[fid], mpt.id)]
    for thr in (1, 2):
        for fid in jm.keyframe_ids[::3]:
            want = jm.search_by_projection(jm.keyframes[fid], list(jm.mappoints.values()), thr=thr)
            got = tm.search_by_projection(tm.keyframes[fid], list(tm.mappoints.values()), thr=thr)
            assert [(i, p.id) for i, p in got] == [(i, p.id) for i, p in want]
            assert len(want) > 10


# ---------------------------------------------------------------------------
# (b) the image path against the stored JAX CLI run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def image_user(tmp_path_factory):
    """The port CLI's relocalizer (f32, CPU) on the stored map, and the
    oracle. Each call of ``matching_points_batched`` records its keyframes."""
    sys.path.insert(0, os.path.join(REPO, "apps"))
    import relocalization_torch

    z = chip_smoke.reloc_oracle()
    root = str(tmp_path_factory.mktemp("reloc"))
    map_root, qdir, names = chip_smoke.write_reloc_tree(z, root, queries=range(N_QUERIES))
    args = relocalization_torch.parse_args([
        "--config_path", os.path.join(REPO, "configs", "relocalization", "reloc_euroc.yaml"),
        "--map_root", map_root, "--query_folder", qdir, "--device", "cpu", "--use_flash"])
    user, _ = relocalization_torch.build(args)
    calls = []
    batched = user.matcher.matching_points_batched

    def record(pairs, *a, **k):
        calls.append([kf.frame_id for _, kf in pairs])
        return batched(pairs, *a, **k)

    user.matcher.matching_points_batched = record
    return user, calls, z, root


def _gate_query(user, calls, z, i, ok, Twc):
    import json

    want = json.loads(str(z["stats"][i]))
    got = user.last_stats
    assert bool(ok) == bool(z["ok"][i]) and ok
    assert got["n_candidates"] == want["n_candidates"]
    assert got["n_groups"] == want["n_groups"]
    assert calls[0] == [d for d in z["deputies"][i].tolist() if d >= 0]
    for a, b in zip(got["pair_counts"], want["pair_counts"]):
        assert abs(a - b) <= IMAGE_GATES["pairs_rel"] * b, (got, want)
    np.testing.assert_allclose(Twc[:3, 3], z["Twc"][i][:3, 3], rtol=0, atol=IMAGE_GATES["t"])
    np.testing.assert_allclose(Twc[:3, :3], z["Twc"][i][:3, :3], rtol=0, atol=IMAGE_GATES["R"])


@pytest.mark.parametrize("source", ["port_detector", "jax_features"])
def test_image_queries_vs_the_jax_cli(image_user, source):
    """The first two stored queries through the port (f32, CPU, the fused
    attention's plain version): from the PNG through the port's detector, and
    from the JAX detector's stored features through ``relocalize_frame``
    (which tells detection drift from relocalization logic). The JAX run's
    ``ok``, candidate and group counts and deputy order; pair counts within
    5 %; poses within 1e-3 m / 1e-3."""
    import cv2

    user, calls, z, root = image_user
    names = [str(n) for n in z["query_names"]]
    for i in range(N_QUERIES):
        calls.clear()
        if source == "port_detector":
            img = cv2.imread(os.path.join(root, "queries", names[i]), cv2.IMREAD_GRAYSCALE)
            ok, Twc = user.relocalize_image(img.astype(np.float32) / 255.0)
        else:
            feats = FrameFeatures(*(z[f"q{i}_{k}"] for k in FrameFeatures._fields))
            ok, Twc = user.relocalize_frame(Frame(20_000_000 + i, 0.0, feats, user.map.camera))
        _gate_query(user, calls, z, i, ok, Twc)


def test_reloc_cli_on_the_stored_queries(image_user, tmp_path):
    """``apps/relocalization_torch.py --device cpu`` as a subprocess on the two
    stored queries: recall 2 / 2, and its trajectory within 1e-3 m of the
    JAX CLI's poses of those queries."""
    _, _, z, root = image_user
    traj = str(tmp_path / "reloc.txt")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "apps", "relocalization_torch.py"),
         "--config_path", os.path.join(REPO, "configs", "relocalization", "reloc_euroc.yaml"),
         "--map_root", os.path.join(root, "map"), "--query_folder",
         os.path.join(root, "queries"), "--traj_path", traj, "--device", "cpu", "--diagnose"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "recall: 2 / 2 = 1.000" in res.stdout
    assert sum(ln.startswith("diag ") for ln in res.stdout.splitlines()) == 2
    got = np.loadtxt(traj, ndmin=2)
    np.testing.assert_allclose(got[:, 1:4], z["cli_traj"][:N_QUERIES, 1:4], rtol=0, atol=1e-3)
