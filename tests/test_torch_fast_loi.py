"""The port's fast stage-1 head (``models/plnet.py::LoiHead`` with
``_bilinear_lookup``), the detector with ``loi_head="fast"``, and
``detect_junctions`` (the detector's and ``parallel/frontend.sharded_detect``'s
default, False, as in the JAX package), against the JAX package on the CPU.

No weights ship for the fast head, so the JAX ``FeatureDetector``'s seeded
initialisation is carried across (``loi_fast_from_flax``). Gates: the head
alone in float32 within 1e-5 (scores; the adjusted lines too, beside two f32
ulps of the coordinates the delta is added to); in bfloat16 within
3e-2 (the stage-1 head's bf16 rule, ``tests/test_torch_loi.py``: both MLPs
run in bf16, with other rounding points); the whole detector in float32 with
the same line, keypoint and junction masks, keypoints within 1e-4 px and
lines within 1e-3 px (scores near the threshold aside, a line moves by the
head's f32 rounding times the 752/128 scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airslam_tpu.frontend.detector import DetectorConfig as JDetectorConfig
from airslam_tpu.models import plnet as jplnet
from airslam_tpu.parallel import frontend as jfrontend
from airslam_tpu.parallel import mesh as jmesh
from airslam_tpu_torch.frontend.detector import DetectorConfig, FeatureDetector
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.models.plnet import LOI_POINTS, LoiHead, _bilinear_lookup
from airslam_tpu_torch.parallel import mesh as tmesh
from airslam_tpu_torch.parallel.frontend import sharded_detect

import chip_smoke
from scripts import make_torch_oracle as mto

torch.set_num_threads(2)
FIELDS = ("keypoints", "kp_scores", "kp_desc", "kp_mask", "lines", "line_scores", "line_mask")
JUNC = ("junctions", "junc_scores", "junc_desc", "junc_mask")


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):  # the JAX detector's precision; conftest turns x64 on
        yield


@pytest.fixture(scope="module")
def fast_params():
    """The JAX fast head's parameters as ``FeatureDetector(seed=0)`` draws
    them."""
    with jax.enable_x64(False):
        return mto.jax_fast_detector(0).params["loi"]


def _head_inputs(rng, n_views, n_lines, dtype):
    maps = [rng.randn(n_views, 128, 128, c).astype(np.float32) for c in (128, 4, 4)]
    # ends on, inside and beyond the borders (the lookup clamps)
    lines = rng.uniform(-3.0, 131.0, (n_views, n_lines, 4)).astype(np.float32)
    lines[:, :8] = np.array([0.0, 0.0, 127.0, 127.0], np.float32)
    tmaps = [torch.from_numpy(m).to(dtype) for m in maps]
    return lines, maps, tmaps


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fast_head_equals_jax(fast_params, dtype):
    """Two views of 512 candidate lines through one head call against
    ``jax.vmap`` of the JAX ``LoiHead`` on the same maps and weights: f32
    1e-5, bf16 3e-2 on the scores and the adjusted lines. The batched call
    equals the head run view by view (1e-6)."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    lines, maps, tmaps = _head_inputs(np.random.RandomState(5), 2, 512, tdt)
    head = LoiHead(dtype=tdt)
    head.load_state_dict(wio.loi_fast_from_flax(fast_params))
    tl = torch.from_numpy(lines)
    with torch.no_grad():
        got, got_lines = head(tl, tl, *tmaps)
        one = [head(tl[v], tl[v], *(m[v] for m in tmaps)) for v in range(2)]
    assert got.shape == (2, 512) and got.dtype == torch.float32
    assert got_lines.shape == (2, 512, 4) and got_lines.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), torch.stack([o[0] for o in one]).numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_lines.numpy(), torch.stack([o[1] for o in one]).numpy(),
                               rtol=0, atol=1e-6)

    jhead = jplnet.LoiHead(dtype=jdt)
    jmaps = [jnp.asarray(m, jdt) for m in maps]
    want, want_lines = jax.vmap(lambda ln, a, b, c: jhead.apply(fast_params, ln, ln, a, b, c))(
        jnp.asarray(lines), *jmaps)
    tol = 1e-5 if dtype == "f32" else 3e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=0, atol=tol)
    # the delta is added to coordinates up to 131: two f32 ulps of them beside
    np.testing.assert_allclose(got_lines.numpy(), np.asarray(want_lines, np.float32),
                               rtol=2.0 ** -22, atol=tol)


def test_bilinear_lookup_equals_jax():
    """The border-clamped lookup alone, f32 and bf16 maps (the bf16 values
    promoted with the f32 weights, as JAX promotes them): 1e-6, and a batch
    of views equals each view alone bit for bit. ``LOI_POINTS`` is JAX's."""
    assert LOI_POINTS == jplnet.LOI_POINTS == 16
    rng = np.random.RandomState(2)
    fmap = rng.randn(3, 128, 128, 8).astype(np.float32)
    pts = rng.uniform(-4.0, 132.0, (3, 50, 16, 2)).astype(np.float32)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tm = torch.from_numpy(fmap).to(tdt)
        got = _bilinear_lookup(tm, torch.from_numpy(pts))
        assert got.dtype == torch.float32
        for v in range(3):
            want = jplnet._bilinear_lookup(jnp.asarray(fmap[v], jdt), jnp.asarray(pts[v]))
            np.testing.assert_allclose(got[v].numpy(), np.asarray(want, np.float32), rtol=0,
                                       atol=1e-6)
            assert torch.equal(got[v], _bilinear_lookup(tm[v], torch.from_numpy(pts[v])))


def test_fast_weights_round_trip_and_oracle(fast_params):
    """``loi_fast_to_flax`` inverts ``loi_fast_from_flax``, and the stored
    oracle's parameters are the JAX head's for seed 0."""
    sd = wio.loi_fast_from_flax(fast_params)
    assert tuple(sd["fc1.weight"].shape) == (1024, 544) and tuple(sd["fc2.weight"].shape) == (
        512, 1024)
    back = wio.loi_fast_to_flax(sd)["params"]
    for name in ("fc1", "fc2", "score", "delta"):
        for leaf in ("kernel", "bias"):
            assert np.array_equal(back[name][leaf], np.asarray(fast_params["params"][name][leaf]))
    stored = chip_smoke.tools_loi_params(np.load(chip_smoke.TOOLS_ORACLE))
    for name in ("fc1", "fc2", "score", "delta"):
        for leaf in ("kernel", "bias"):
            assert np.array_equal(stored["params"][name][leaf],
                                  np.asarray(fast_params["params"][name][leaf]))


def test_fast_detector_seeded_init():
    """Without ``loi`` parameters the fast head is drawn from a
    ``torch.Generator`` seeded by ``seed``: the same seed gives the same
    weights, another seed others; kernels have flax's ``lecun_normal``
    spread (truncated normal of variance 1 / fan_in), biases are zero."""
    cfg = DetectorConfig(loi_head="fast", use_superpoint=False, max_keypoints=64)
    a, b = (FeatureDetector(cfg, device="cpu", seed=s).loi for s in (0, 0))
    c = FeatureDetector(cfg, device="cpu", seed=1).loi
    assert isinstance(a, LoiHead)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.fc1.weight, c.fc1.weight)
    assert abs(float(a.fc1.weight.detach().std()) - (1.0 / 544) ** 0.5) < 0.05 * (1.0 / 544) ** 0.5
    assert float(a.fc1.bias.detach().abs().max()) == 0.0
    with pytest.raises(ValueError):
        FeatureDetector(DetectorConfig(loi_head="wide"), device="cpu")


def test_fast_detector_equals_jax(fast_params):
    """The detector with the fast head and the JAX seeded weights on pair 0
    of the frontend oracle (480×752, 400 keypoints, line threshold 0.5, both
    views, junctions asked for) against the JAX detector: the same masks,
    keypoints within 1e-4 px, lines within 1e-3 px, junctions within 1e-4
    px; and the stored JAX run (``torch_tools_oracle.npz``) at the card's
    f32 gates."""
    frames, _ = chip_smoke.oracle_pairs()
    cfg = mto.TOOLS["fast_cfg"]
    det = FeatureDetector(DetectorConfig(loi_head="fast", use_superpoint=False, **cfg),
                          device="cpu", params={"loi": fast_params})
    got = det.detect(frames[0], detect_junctions=True)
    jdet = mto.jax_fast_detector(0, **cfg)
    want = jdet.detect(frames[0], detect_junctions=True)
    for name in ("kp_mask", "line_mask", "junc_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert int(got.line_mask.sum()) > 50
    lm = got.line_mask.numpy()
    assert np.abs(got.lines.numpy() - np.asarray(want.lines))[lm].max() <= 1e-3
    assert np.abs(got.keypoints.numpy() - np.asarray(want.keypoints)).max() <= 1e-4
    jm = got.junc_mask.numpy()
    assert np.abs(got.junctions.numpy() - np.asarray(want.junctions))[jm].max() <= 1e-4
    z = np.load(chip_smoke.TOOLS_ORACLE)
    for v in range(2):
        m = chip_smoke.detection_metrics(chip_smoke.tools_detection(z, f"fast0_{v}_"),
                                         {k: getattr(got, k)[v].numpy()
                                          for k in chip_smoke.TOOLS_FIELDS})
        assert all(m[k] >= g for k, g in chip_smoke.DETECT_GATES.items()), m


def test_detect_junctions_false_leaves_the_rest(fast_params):
    """``detect(..., detect_junctions=False)`` (the default) gives every
    non-junction field equal to the ``True`` run and zero junction fields of
    JAX's shapes and types: (max_junctions, 2), (J,), (J, 256) float32 and an
    all-false (J,) mask; both heads."""
    frames, _ = chip_smoke.oracle_pairs()
    pair = frames[1]
    for cfg in (DetectorConfig(use_superpoint=False, max_keypoints=128),
                DetectorConfig(loi_head="fast", use_superpoint=False, max_keypoints=128)):
        det = FeatureDetector(cfg, device="cpu", params={"loi": fast_params}
                              if cfg.loi_head == "fast" else None)
        off, on = det.detect(pair), det.detect(pair, detect_junctions=True)
        for name in FIELDS:
            assert torch.equal(getattr(off, name), getattr(on, name)), name
        assert bool(on.junc_mask.any())
        j = cfg.max_junctions
        for name, shape, dtype in zip(JUNC, ((2, j, 2), (2, j), (2, j, 256), (2, j)),
                                      (torch.float32,) * 3 + (torch.bool,)):
            t = getattr(off, name)
            assert tuple(t.shape) == shape and t.dtype == dtype and not bool(t.any()), name
    jcfg = JDetectorConfig(use_superpoint=False, max_keypoints=128)
    want = mto.jax_fast_detector(0, max_keypoints=128)  # any head: the junction fields
    want = want.detect(pair)
    for name in JUNC:
        a = np.asarray(getattr(want, name))
        assert a.shape == tuple(getattr(off, name).shape) and not a.any(), name
    assert jcfg.max_junctions == DetectorConfig().max_junctions


def test_sharded_detect_default_detects_no_junctions():
    """``sharded_detect(det, frames, mesh)`` with its default arguments on
    the 8-device CPU meshes, against the JAX call: zero junction fields as
    JAX's (the port detected junctions here whatever the caller asked), the
    keypoints within 1e-2 px (the JAX dry run's gate) and the same masks."""
    from airslam_tpu.frontend.detector import FeatureDetector as JFeatureDetector
    from airslam_tpu.models import weights as jw

    cfg = dict(max_keypoints=64, max_lines=32, max_proposals=512)
    params, _ = jw.load_default_frontend(use_superpoint=True)
    jdet = JFeatureDetector(JDetectorConfig(**cfg), params=params)
    tdet = FeatureDetector(DetectorConfig(**cfg), device="cpu")
    frames = np.random.RandomState(0).rand(3, 120, 188).astype(np.float32)
    want = jfrontend.sharded_detect(jdet, frames, jmesh.make_mesh(8))
    got = sharded_detect(tdet, frames, tmesh.make_mesh(devices=["cpu"] * 8))
    for name in JUNC:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape and not w.any(), name
        assert not g.any(), f"the port's sharded_detect returned {name} the JAX call does not"
    np.testing.assert_array_equal(got.kp_mask.numpy(), np.asarray(want.kp_mask))
    valid = got.kp_mask.numpy()
    assert np.abs(got.keypoints.numpy() - np.asarray(want.keypoints))[valid].max() <= 1e-2
