"""The port's frontend slice (FrontendStep, f32, CPU) vs the JAX package's
``entry(dtype=float32)`` on pair 0 of the stored oracle, with the f32 gates
chip_smoke.py applies on the card; the stored oracle is reproduced by the
JAX program; and the entry points refuse to run without a card unless asked
for the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import entry
from airslam_tpu_torch.core.camera import Camera
from airslam_tpu_torch.entry import FrontendStep
from airslam_tpu_torch.frontend.detector import FeatureDetector
from airslam_tpu_torch.frontend.matcher import PointMatcher

torch.set_num_threads(2)
EUROC_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "camera", "euroc.yaml")
STORED = (0, 1, 2, 4, 5, 7, 8, 10)  # the entry() slots the oracle keeps


def test_frontend_slice_f32_vs_jax_entry():
    frames, refs = chip_smoke.oracle_pairs()
    pair = frames[0]
    fn, args = entry(dtype=jnp.float32)
    plp, loip, lgp, _ = args
    live = jax.jit(fn)(plp, loip, lgp, jnp.asarray(pair, jnp.float32))
    live = {f"o{j}": np.asarray(o) for j, o in enumerate(live)}

    # the JAX program reproduces the stored oracle: masks equal, coordinates
    # within 1e-4 px (the fixture was written by the same program)
    for j in STORED:
        want, got = refs[0][f"o{j}"], live[f"o{j}"]
        if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=f"o{j}")
    for j, m in ((0, live["o7"]), (4, live["o5"]), (8, live["o10"])):
        np.testing.assert_allclose(live[f"o{j}"][m], refs[0][f"o{j}"][m], atol=1e-4)

    step = FrontendStep(dtype=torch.float32, device="cpu")
    out = step(torch.from_numpy(pair))
    assert [tuple(o.shape) for o in out] == [v.shape for v in live.values()]
    m = chip_smoke.frontend_metrics(live, chip_smoke._outputs_np(out))
    for k, gate in chip_smoke.F32_GATES.items():
        assert m[k] >= gate, (k, m[k], gate)


def test_rectify_path_on_cpu():
    """rectify → the same values as the plain remap of each view with the
    EuRoC grids chip_smoke.py builds (CPU route of kernel R)."""
    from airslam_tpu_torch.ops.gridsample import remap as remap_plain

    frames, _ = chip_smoke.oracle_pairs()
    grids = torch.from_numpy(chip_smoke.euroc_grids())
    step = FrontendStep(dtype=torch.float32, device="cpu")
    left, right = step.rectify(frames[0][0], frames[0][1], grids)
    for got, img, g in ((left, frames[0][0], grids[0]), (right, frames[0][1], grids[1])):
        np.testing.assert_array_equal(got.numpy(), remap_plain(torch.from_numpy(img), g).numpy())


def test_entry_points_raise_without_a_card(monkeypatch):
    """Without a GPU and without device="cpu" every entry point raises; none
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (FrontendStep, FeatureDetector, PointMatcher,
                 lambda: Camera(EUROC_YAML).rectify_maps()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_point_matcher_vs_jax():
    """matching_points (with and without the RANSAC rejection) and its
    batched form on the port's f32 detections of pair 0: the same index
    pairs as the JAX PointMatcher on the same features, scores within 1e-4."""
    from airslam_tpu.frontend.matcher import MatcherConfig as JaxMatcherConfig
    from airslam_tpu.frontend.matcher import PointMatcher as JaxPointMatcher
    from airslam_tpu.models.weights import checkpoint_path, load_params
    from airslam_tpu_torch.frontend.detector import DetectorConfig

    frames, _ = chip_smoke.oracle_pairs()
    feats = FeatureDetector(DetectorConfig(max_keypoints=400, use_superpoint=False),
                            device="cpu").detect(frames[0])
    f0, f1 = (type(feats)(*(t[i] for t in feats)) for i in range(2))
    ours = PointMatcher(device="cpu")
    ref = JaxPointMatcher(JaxMatcherConfig(max_keypoints=400),
                          params=load_params(checkpoint_path("lightglue.npz")))
    jf0, jf1 = (type(f)(*(np.asarray(t) for t in f)) for f in (f0, f1))
    for rejection in (False, True):
        got_pairs, got_sc = ours.matching_points(f0, f1, outlier_rejection=rejection)
        want_pairs, want_sc = ref.matching_points(jf0, jf1, outlier_rejection=rejection)
        assert len(want_pairs) > 50
        np.testing.assert_array_equal(got_pairs, want_pairs)
        np.testing.assert_allclose(got_sc, want_sc, rtol=0, atol=1e-4)
    batched = ours.matching_points_batched([(f0, f1), (f1, f0)])
    np.testing.assert_array_equal(batched[0][0], ours.matching_points(f0, f1)[0])
    np.testing.assert_array_equal(batched[1][0], ours.matching_points(f1, f0)[0])
