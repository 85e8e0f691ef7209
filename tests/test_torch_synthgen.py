"""The port's synthetic-shapes generator (``airslam_tpu_torch/frontend/synthgen.py``)
against the JAX one, stage by stage, on three seeds.

The JAX draws are rebuilt from the same key splits
(``scripts/make_torch_oracle.py``'s ``jax_*_draws``) and handed to the
port's deterministic functions, with JAX in float32 as the trainer runs it.
Gates: images ≤ 1e-5; masks exact; segments and corners bit-equal, except
where a polygon vertex enters: its ``cos``/``sin`` (glibc's ``cosf``/``sinf``
under XLA on the CPU, PyTorch's own vectorised ones) may differ by one f32
ulp, which the radius (≤ 130 px, ×1.15 warped) carries to ≤ 1e-5 px, so
the polygon vertices and edges are held to one ulp of their value plus
1e-5. The port's affine products repeat XLA's (one fused multiply-add per
output); under ``vmap`` XLA rounds the warp's batched product otherwise
(the JAX batch forms differ from the JAX function key by key by up to
1.2e-4 px on warped corners), so the batch forms are held bit-equal to the
JAX function key by key and within 1.25e-4 px (two ulps at 512-1024 px) of
the JAX batch forms.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airslam_tpu.frontend import synthgen as J
from airslam_tpu_torch.frontend import synthgen as T

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1, 2)
POLY_SEGS = slice(J.N_SEG, J.N_SEG + J.N_POLY_V)  # polygon edges among the segments
POLY_CORNERS = slice(2 * J.N_SEG, 2 * J.N_SEG + J.N_POLY_V)  # polygon vertices among the corners


def _oracle_script():
    spec = importlib.util.spec_from_file_location(
        "make_torch_oracle", os.path.join(REPO, "scripts", "make_torch_oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MTO = _oracle_script()


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):  # the trainer's precision; conftest turns x64 on
        yield


def _t(d):
    """Nested numpy/JAX draws → torch, with a batch of one."""
    if isinstance(d, dict):
        return {k: _t(v) for k, v in d.items()}
    return torch.as_tensor(np.asarray(d))[None]


def _batch(d):
    return {k: torch.as_tensor(v) for k, v in d.items()} if not isinstance(
        next(iter(d.values())), dict) else {k: _batch(v) for k, v in d.items()}


def _ulp_close(want, got, err_msg=""):
    """Within one float32 ulp of the JAX value plus 1e-5, elementwise."""
    want = np.asarray(want, np.float32)
    diff = np.abs(got.astype(np.float64) - want)
    assert np.all(diff <= np.spacing(np.abs(want)) + 1e-5), (err_msg, float(diff.max()))


def _check_segments(want, got):
    want, got = np.asarray(want), got.numpy()
    for part in (slice(0, J.N_SEG), slice(POLY_SEGS.stop, None)):
        np.testing.assert_array_equal(got[part], want[part])
    _ulp_close(want[POLY_SEGS], got[POLY_SEGS], "polygon edges")


def _check_scene(want, got, i=0):
    np.testing.assert_allclose(got.image[i].numpy(), np.asarray(want.image), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.corner_mask[i].numpy(), np.asarray(want.corner_mask))
    np.testing.assert_array_equal(got.segment_mask[i].numpy(), np.asarray(want.segment_mask))
    _check_segments(want.segments, got.segments[i])
    wc, gc = np.asarray(want.corners), got.corners[i].numpy()
    for part in (slice(0, POLY_CORNERS.start), slice(POLY_CORNERS.stop, None)):
        np.testing.assert_array_equal(gc[part], wc[part])
    _ulp_close(wc[POLY_CORNERS], gc[POLY_CORNERS], "polygon vertices")


def _check_shapes(want, got):
    _check_segments(want.segments, got.segments[0])
    for f in ("segment_mask", "fill_shade", "stroke", "checker_origin", "checker_basis",
              "checker_shade"):
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("tri_verts", "quad_verts"):
        _ulp_close(getattr(want, f), getattr(got, f)[0].numpy(), f)


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_shapes(seed):
    key = jax.random.PRNGKey(seed)
    got = T.sample_shapes(_t(MTO.jax_shape_draws(key)))
    _check_shapes(J.sample_shapes(key), got)
    assert got.segments.shape == (1, T.MAX_SEGMENTS, 4)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_affine_and_warp(seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    A, t = J.random_affine(k2)
    gA, gt = T.random_affine(_t(MTO.jax_affine_draws(k2)))
    np.testing.assert_array_equal(gA[0].numpy(), np.asarray(A))
    np.testing.assert_array_equal(gt[0].numpy(), np.asarray(t))
    want = J.warp_shapes(J.sample_shapes(k1), A, t)
    got = T.warp_shapes(T.sample_shapes(_t(MTO.jax_shape_draws(k1))), gA, gt)
    _check_shapes(want, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_render_from_shapes(seed):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    A, t = J.random_affine(k3)  # a warped scene: the checker basis is not diagonal
    want = J.render_from_shapes(k2, J.warp_shapes(J.sample_shapes(k1), A, t))
    shapes = T.sample_shapes(_t(MTO.jax_shape_draws(k1)))
    shapes = T.warp_shapes(shapes, *T.random_affine(_t(MTO.jax_affine_draws(k3))))
    got = T.render_from_shapes(shapes, _t(MTO.jax_render_draws(k2)))
    _check_scene(want, got)
    assert int(got.corner_mask.sum()) > 0 and int(got.segment_mask.sum()) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_photometric_augment_and_dark_transform(seed):
    """On one JAX-rendered image handed to both; strength 1 and 0.5."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    img = J.render_scene(k1).image
    timg = torch.as_tensor(np.asarray(img))[None]
    for strength in (1.0, 0.5):
        want = J.photometric_augment(k2, img, strength)
        got = T.photometric_augment(timg, _t(MTO.jax_augment_draws(k2)), strength)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=1e-5)
    want = J.dark_transform(k3, img)
    got = T.dark_transform(timg, {"noise": torch.as_tensor(
        np.asarray(jax.random.normal(k3, img.shape)))[None]})
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_render_scene(seed):
    key = jax.random.PRNGKey(seed)
    for augment in (0.0, 1.0):
        got = T.render_scene(_t(MTO.jax_scene_draws(key, augment=augment)), augment=augment)
        _check_scene(J.render_scene(key, augment=augment), got)


@pytest.mark.parametrize("seed", SEEDS)
def test_render_pair_with_affine(seed):
    """Both views, augmented independently, and the affine; ``render_pair``
    returns the same two views."""
    key = jax.random.PRNGKey(seed)
    w0, w1, A, t = J.render_pair_with_affine(key, augment=1.0)
    d = _t(MTO.jax_pair_draws(key, augment=1.0))
    g0, g1, gA, gt = T.render_pair_with_affine(d, augment=1.0)
    _check_scene(w0, g0)
    _check_scene(w1, g1)
    np.testing.assert_array_equal(gA[0].numpy(), np.asarray(A))
    np.testing.assert_array_equal(gt[0].numpy(), np.asarray(t))
    p0, p1 = T.render_pair(d, augment=1.0)
    assert torch.equal(p0.image, g0.image) and torch.equal(p1.corners, g1.corners)


@pytest.mark.parametrize("seed", [5, 6])
def test_render_pair_with_affine_view(seed):
    """``render_pair_with_affine(view=2)`` from the rebuilt JAX draws (the
    strength v of ``fold_in(key, 23)``): the affine bit-equal, both views'
    corners bit-equal, masks equal, images ≤ 1e-5. Polygon vertices within
    one ulp plus 2e-5 px: their cos/sin are glibc's under XLA (one ulp
    from PyTorch's), which the radius (≤ 130 px) carries to 1e-5 px, and the
    widened warp (scale ≤ 1.3, x and y mixed by the rotation) to 1.3·√2 of
    that; seed 5's view 1 has a vertex 1.5e-5 px apart."""
    key = jax.random.PRNGKey(seed)
    w0, w1, A, t = J.render_pair_with_affine(key, augment=1.0, view=2.0)
    d = _t(MTO.jax_pair_draws(key, augment=1.0, view=2.0))
    assert 1.0 <= float(d["affine"]["v"]) <= 2.0
    g0, g1, gA, gt = T.render_pair_with_affine(d, augment=1.0)
    np.testing.assert_array_equal(gA[0].numpy(), np.asarray(A))
    np.testing.assert_array_equal(gt[0].numpy(), np.asarray(t))
    for w, g in ((w0, g0), (w1, g1)):
        np.testing.assert_allclose(g.image[0].numpy(), np.asarray(w.image), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(g.corner_mask[0].numpy(), np.asarray(w.corner_mask))
        wc, gc = np.asarray(w.corners), g.corners[0].numpy()
        for part in (slice(0, POLY_CORNERS.start), slice(POLY_CORNERS.stop, None)):
            np.testing.assert_array_equal(gc[part], wc[part])
        diff = np.abs(gc[POLY_CORNERS] - wc[POLY_CORNERS])
        assert np.all(diff <= np.spacing(np.abs(wc[POLY_CORNERS])) + 2e-5)


def _check_vmapped(want, got, i):
    np.testing.assert_allclose(got.image[i].numpy(), np.asarray(want.image[i]), rtol=0, atol=1e-5)
    for f in ("corner_mask", "segment_mask"):
        np.testing.assert_array_equal(getattr(got, f)[i].numpy(), np.asarray(getattr(want, f)[i]))
    for f in ("corners", "segments"):
        np.testing.assert_allclose(getattr(got, f)[i].numpy(), np.asarray(getattr(want, f)[i]),
                                   rtol=0, atol=1.25e-4, err_msg=f)


@pytest.mark.parametrize("seed", SEEDS)
def test_batch_forms(seed):
    """``render_batch``/``render_pair_batch``: the port's batch of two
    (drawn per key and stacked) against the JAX function key by key and
    against the JAX ``vmap`` over the split keys."""
    key = jax.random.PRNGKey(seed)
    keys = jax.random.split(key, 2)
    got = T.render_scene(_batch(MTO.batch_draws([MTO.jax_scene_draws(k) for k in keys])))
    want = J.render_batch(key, 2)
    g0, g1 = T.render_pair(_batch(MTO.batch_draws([MTO.jax_pair_draws(k) for k in keys])))
    w0, w1 = J.render_pair_batch(key, 2)
    for i in range(2):
        _check_scene(J.render_scene(keys[i]), got, i)
        u0, u1 = J.render_pair(keys[i])
        _check_scene(u0, g0, i)
        _check_scene(u1, g1, i)
        for w, g in ((want, got), (w0, g0), (w1, g1)):
            _check_vmapped(w, g, i)


@pytest.mark.parametrize("n", [4, 32])
def test_upsample_matches_jax_image_resize(n):
    """The background grids' bilinear upscale to 512²: F.interpolate
    against ``jax.image.resize`` at 1e-6."""
    g = np.random.RandomState(n).uniform(0.35, 0.85, (n, n)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(g), (512, 512), "bilinear")
    got = T._upsample(torch.as_tensor(g)[None], 512)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("stage", ["shapes", "affine", "render", "augment", "scene", "pair"])
def test_draws_match_the_jax_draws_in_shape_and_range(stage):
    """The port's draw functions give the JAX draws' names, shapes (with a
    batch), dtypes and ranges."""
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    port, ref = {
        "shapes": (lambda: T.shape_draws(gen, 3), lambda: MTO.jax_shape_draws(key)),
        "affine": (lambda: T.affine_draws(gen, 3), lambda: MTO.jax_affine_draws(key)),
        "render": (lambda: T.render_draws(gen, 3), lambda: MTO.jax_render_draws(key)),
        "augment": (lambda: T.augment_draws(gen, 3), lambda: MTO.jax_augment_draws(key)),
        "scene": (lambda: T.scene_draws(gen, 3, augment=1.0),
                  lambda: MTO.jax_scene_draws(key, augment=1.0)),
        "pair": (lambda: T.pair_draws(gen, 3, augment=1.0),
                 lambda: MTO.jax_pair_draws(key, augment=1.0)),
    }[stage]
    got, want = port(), ref()

    def flat(d, pre=""):
        out = {}
        for k, v in d.items():
            out.update(flat(v, pre + k + "/") if isinstance(v, dict) else {pre + k: v})
        return out

    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    bounds = {"p1": (24, 488), "p2": (24, 488), "fill_shade": (-0.45, 0.45),
              "stroke": (-0.5, 0.5), "pitch": (44, 80), "origin": (-80, 0), "delta": (0.1, 0.3),
              "theta": (-0.35, 0.35), "scale": (0.85, 1.15), "shift": (-40, 40),
              "bg": (0.35, 0.85), "bg_noise": (-0.04, 0.04), "strength": (0.15, 1.0),
              "center": (0.3, 0.7), "tri_radius": (40, 110), "quad_radius": (50, 130),
              "tri_center": (102.4, 409.6), "quad_center": (102.4, 409.6),
              "tri_base": (0, 6.28), "quad_base": (0, 6.28), "tri_jitter": (-0.35, 0.35),
              "quad_jitter": (-0.35, 0.35)}
    for k, v in got.items():
        w = np.asarray(want[k])
        assert tuple(v.shape) == (3,) + w.shape and v.dtype == torch.float32, k
        lo, hi = bounds.get(k.split("/")[-1], (0.0, 1.0) if "noise" not in k
                            and "dir" not in k else (-np.inf, np.inf))
        assert float(v.min()) >= lo and float(v.max()) <= hi, k
