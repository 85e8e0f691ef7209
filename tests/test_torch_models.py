"""Port models vs the JAX package on the CPU in f32: PLNet's heads and the
stage-1 LOI head with the shipped weights, LightGlue with a random flax init
and with the shipped weights. Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from airslam_tpu.models import plnet as jplnet
from airslam_tpu.models.lightglue import LightGlue as JaxLightGlue
from airslam_tpu_torch.frontend.detector import resize_to_detect
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.models.lightglue import LightGlue
from airslam_tpu_torch.models.plnet import PLNet, LoiHeadS1

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def s0():
    return wio.load_npz(wio.checkpoint_path("plnet_s0.npz"))


def test_resize_antialias_matches_jax():
    """752×480 → 512²: jax.image.resize's bilinear antialiases on a
    downscale; F.interpolate(antialias=True) matches it to 1e-6."""
    rng = np.random.RandomState(0)
    imgs = rng.rand(2, 480, 752).astype(np.float32)
    got = _np(resize_to_detect(_t(imgs)))[:, 0]
    want = np.asarray(jax.image.resize(jnp.asarray(imgs)[..., None], (2, 512, 512, 1),
                                       "bilinear"))[..., 0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_stem_and_score_pixel_orders():
    """The 2×2 space-to-depth stem is pixel_unshuffle (channel 2a+b) and the
    8×8 score depth-to-space is pixel_shuffle (channel 8r+s) — exact."""
    rng = np.random.RandomState(1)
    x = rng.rand(1, 8, 8, 1).astype(np.float32)
    eye4 = np.zeros((2, 2, 1, 4), np.float32)
    for a in range(2):
        for b in range(2):
            eye4[a, b, 0, 2 * a + b] = 1.0
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(eye4), (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = _np(F.pixel_unshuffle(_t(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1))
    np.testing.assert_array_equal(got, want)
    prob = rng.rand(1, 3, 5, 64).astype(np.float32)
    want = prob.reshape(1, 3, 5, 8, 8).transpose(0, 1, 3, 2, 4).reshape(1, 24, 40)
    got = _np(F.pixel_shuffle(_t(prob).permute(0, 3, 1, 2), 8)[:, 0])
    np.testing.assert_array_equal(got, want)


def test_plnet_heads_match_jax(s0):
    """Every PLNet output in f32 with the shipped weights at 256², atol 1e-4
    (conv sum order differs between XLA:CPU and oneDNN; line_pred, which is
    scaled ×8 into 128-grid pixels, also gets rtol 1e-5). ``kp_logits``, the
    training output, included."""
    rng = np.random.RandomState(2)
    img = rng.rand(1, 256, 256, 1).astype(np.float32)
    want = jplnet.PLNet().apply(s0["plnet"], jnp.asarray(img))
    model = PLNet()
    model.load_state_dict(wio.plnet_from_flax(s0["plnet"]))
    with torch.no_grad():
        got = model(_t(img).permute(0, 3, 1, 2))
    assert set(got) == set(want)
    for k in got:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(_np(got[k]), w, rtol=1e-5, atol=1e-4, err_msg=k)


def test_loi_s1_scores_match_jax(s0):
    """LoiHeadS1 scores in f32 with the shipped weights (junction endpoint
    path), 1e-5: the samplers share the corner arithmetic and only sum
    orders differ."""
    rng = np.random.RandomState(3)
    loi = rng.randn(128, 128, 128).astype(np.float32)
    thin = rng.randn(128, 128, 4).astype(np.float32)
    aux = rng.randn(128, 128, 4).astype(np.float32)
    junc = rng.uniform(-1, 129, (300, 2)).astype(np.float32)
    pairs = rng.randint(0, 300, (512, 2)).astype(np.int32)
    pairs[:3] = [[299, 0], [5, 5], [300, -1]]  # clipped indices included
    jcl = junc[np.clip(pairs, 0, 299)]
    lines = np.concatenate([jcl[:, 0], jcl[:, 1]], -1)
    props = (lines + rng.randn(512, 4)).astype(np.float32)
    want, _ = jplnet.LoiHeadS1().apply(
        s0["loi"], jnp.asarray(lines), jnp.asarray(props), jnp.asarray(loi),
        jnp.asarray(thin), jnp.asarray(aux), junc_xy=jnp.asarray(junc),
        pair_idx=jnp.asarray(pairs))
    head = LoiHeadS1()
    head.load_state_dict(wio.loi_s1_from_flax(s0["loi"]))
    with torch.no_grad():
        got, _ = head(_t(lines), _t(props), _t(loi), _t(thin), _t(aux),
                      junc_xy=_t(junc), pair_idx=_t(pairs).long())
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)


def _lg_inputs(rng, n0, n1, dim):
    def side(n):
        k = rng.uniform(-0.25, 0.25, (n, 2)).astype(np.float32)
        d = rng.randn(n, dim).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        m = rng.rand(n) < 0.85
        return k, d, m
    return side(n0) + side(n1)


def _run_lg(jax_model, params, model, args):
    want = jax_model.apply(params, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = model(*(_t(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-4)


def test_lightglue_small_random_init():
    """2 layers, dim 64, a random flax init converted; scores and logits at
    atol 1e-4 (f32 matmul sum orders)."""
    rng = np.random.RandomState(4)
    args = _lg_inputs(rng, 48, 40, 64)
    jm = JaxLightGlue(dim=64, heads=4, layers=2)
    params = jm.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = LightGlue(dim=64, heads=4, layers=2)
    model.load_state_dict(wio.lightglue_from_flax(tree))
    _run_lg(jm, params, model, args)


def test_lightglue_shipped_weights_64_tokens():
    """Full size (dim 256, 4 heads, 9 layers) with lightglue.npz on 64
    tokens per side, atol 1e-4."""
    rng = np.random.RandomState(5)
    args = _lg_inputs(rng, 64, 64, 256)
    tree = wio.load_npz(wio.checkpoint_path("lightglue.npz"))
    model = LightGlue()
    model.load_state_dict(wio.lightglue_from_flax(tree))
    _run_lg(JaxLightGlue(), tree, model, args)
