"""SuperGlue (``matcher: 1``) of the port against the JAX package on the CPU:
``log_sinkhorn`` in f64, the network with the shipped ``superglue.npz`` in
f32, and the matcher on the frontend oracle's pairs against the live JAX
matcher and the stored JAX matches (``tests/data/torch_reloc_oracle.npz``).
Inputs come from numpy seeds or the stored files."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airslam_tpu.frontend.matcher import MatcherConfig as JaxMatcherConfig
from airslam_tpu.frontend.matcher import PointMatcher as JaxPointMatcher
from airslam_tpu.models.lightglue import normalize_keypoints as jax_normalize
from airslam_tpu.models.superglue import SuperGlue as JaxSuperGlue
from airslam_tpu.models.weights import load_params
from airslam_tpu.ops import match as jmatch
from airslam_tpu_torch.frontend.matcher import PointMatcher
from airslam_tpu_torch.io.config import SG_SINKHORN_ITERS, RelocalizationConfigs
from airslam_tpu_torch.models import superglue as tsg
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.ops import match as tmatch

import chip_smoke

torch.set_num_threads(2)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("case", ["full", "masked", "padded_rows", "batched"])
def test_log_sinkhorn_vs_jax_f64(case):
    """The transport plan in f64 within 1e-10: every key valid, masked keys on
    both sides, whole padded rows, and a batch of two (each entry against the
    JAX function on its own)."""
    rng = np.random.RandomState({"full": 0, "masked": 1, "padded_rows": 2, "batched": 3}[case])
    lead = (2,) if case == "batched" else ()
    n0, n1 = 13, 9
    scores = rng.randn(*lead, n0, n1) * 3.0
    m0 = np.ones(lead + (n0,), bool)
    m1 = np.ones(lead + (n1,), bool)
    if case in ("masked", "batched"):
        m0 = rng.rand(*lead, n0) > 0.3
        m1 = rng.rand(*lead, n1) > 0.3
    if case == "padded_rows":
        m0[9:] = False
        m1[6:] = False
    bin_score = 1.2846214
    got = _np(tmatch.log_sinkhorn(torch.as_tensor(scores), torch.as_tensor(m0),
                                  torch.as_tensor(m1), torch.tensor(bin_score, dtype=torch.float64),
                                  SG_SINKHORN_ITERS))
    for b in np.ndindex(*lead):
        want = np.asarray(jmatch.log_sinkhorn(jnp.asarray(scores[b]), jnp.asarray(m0[b]),
                                              jnp.asarray(m1[b]), jnp.asarray(bin_score),
                                              SG_SINKHORN_ITERS))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def sg_params():
    return load_params(wio.checkpoint_path("superglue.npz"))


def _sg_pair(rng, n=64, n_valid=50):
    kpts = [rng.rand(n, 2).astype(np.float32) * [752, 480] for _ in range(2)]
    scores = [rng.rand(n).astype(np.float32) for _ in range(2)]
    desc = [rng.randn(n, 256).astype(np.float32) for _ in range(2)]
    desc = [d / np.linalg.norm(d, axis=1, keepdims=True) for d in desc]
    masks = [np.arange(n) < n_valid, np.arange(n) < n_valid - 7]
    return kpts, scores, desc, masks


@pytest.mark.parametrize("iters", [0, SG_SINKHORN_ITERS])
def test_superglue_scores_vs_flax(sg_params, iters):
    """The network with the shipped weights: 273 arrays converted, raw scores
    and the Sinkhorn log-plan within 1e-4 in f32 on padded inputs."""
    assert len(np.load(wio.checkpoint_path("superglue.npz")).files) == 273
    rng = np.random.RandomState(4)
    kpts, scores, desc, masks = _sg_pair(rng)
    nk = [np.asarray(jax_normalize(jnp.asarray(k), 752, 480, 0.7)) for k in kpts]
    want = np.asarray(JaxSuperGlue(sinkhorn_iterations=iters).apply(
        sg_params, nk[0], scores[0], desc[0], masks[0], nk[1], scores[1], desc[1], masks[1]))
    model = tsg.SuperGlue(sinkhorn_iterations=iters)
    model.load_state_dict(wio.superglue_from_flax(wio.load_npz(
        wio.checkpoint_path("superglue.npz"))))
    model.eval()
    t = torch.as_tensor
    with torch.no_grad():
        got = _np(model(t(nk[0]), t(scores[0]), t(desc[0]), t(masks[0]),
                        t(nk[1]), t(scores[1]), t(desc[1]), t(masks[1])))
    valid = masks[0][:, None] & masks[1][None, :]
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def port_frontend():
    """The stage-3 configuration's detector and SuperGlue matcher of the port
    (f32, CPU)."""
    from airslam_tpu_torch.frontend.detector import FeatureDetector

    cfg = RelocalizationConfigs.load("configs/relocalization/reloc_euroc.yaml")
    det = FeatureDetector(cfg.detector, device="cpu")
    sg = PointMatcher(dataclasses.replace(cfg.matcher, matcher=1,
                                          sinkhorn_iterations=SG_SINKHORN_ITERS), device="cpu")
    return det, sg


def test_superglue_matcher_vs_jax_on_the_oracle_pairs(sg_params, port_frontend):
    """``PointMatcher(matcher=1)`` (threshold 0.2, scale 0.7, the config's
    Sinkhorn default 20) on the port detector's features of the frontend
    oracle's 3 pairs, against the JAX ``PointMatcher(matcher=1)`` on the same
    features: ≥ 0.99 of the matches agree per pair, their scores within 1e-4;
    a batched pass equals the pairs one by one. Then the card's gate on the
    CPU: the stored JAX matches (JAX detector) reproduced behind the port's
    detector, agreement ≥ 0.9 and count delta ≤ 0.1."""
    from airslam_tpu_torch.io.config import parse_matcher_config

    assert parse_matcher_config({"point_matcher": {"matcher": 1}}).sinkhorn_iterations == 20
    det, port = port_frontend
    assert (port.threshold, port.norm_scale) == (0.2, 0.7)
    jm = JaxPointMatcher(JaxMatcherConfig(matcher=1, sinkhorn_iterations=SG_SINKHORN_ITERS),
                         params=sg_params)
    frames, _ = chip_smoke.oracle_pairs()
    args_all = []
    for i in range(frames.shape[0]):
        f = det.detect(frames[i])
        args = tuple(_np(getattr(f, k)[v]) for v in (0, 1)
                     for k in ("keypoints", "kp_scores", "kp_desc", "kp_mask"))
        args_all.append(args)
        m = port.match(*(torch.as_tensor(a) for a in args))
        live = jm.match(*args)
        got = np.where(_np(m.mask), _np(m.idx1), -1)
        want = np.where(np.asarray(live.mask), np.asarray(live.idx1), -1)
        sel = (got >= 0) | (want >= 0)
        agree = float((got[sel] == want[sel]).mean())
        assert sel.sum() > 20 and agree >= 0.99, (i, agree)
        same = (got == want) & (got >= 0)
        np.testing.assert_allclose(_np(m.score)[same], np.asarray(live.score)[same],
                                   rtol=0, atol=1e-4)
    batched = port.match(*(torch.stack([torch.as_tensor(a[k]) for a in args_all])
                           for k in range(8)))
    for i, args in enumerate(args_all):
        m = port.match(*(torch.as_tensor(a) for a in args))
        np.testing.assert_array_equal(_np(batched.idx1[i]), _np(m.idx1))
    agree, n_port, n_jax = chip_smoke.superglue_agreement(chip_smoke.reloc_oracle(), det, port)
    assert np.mean(agree) >= chip_smoke.RELOC_GATES["sg_agree"], agree
    assert abs(n_port - n_jax) / n_jax <= chip_smoke.RELOC_GATES["sg_count"], (n_port, n_jax)
