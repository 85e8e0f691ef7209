"""The stage-1 LOI head's sampling in one call (``ops.bilerp.loi_features``,
the CUDA kernel's plain version on the CPU) and the head and detector that
run it once per frame, against the sampling they replaced and against the
JAX package. Inputs come from numpy seeds (``chip_smoke.loi_inputs``: points
on and beyond the borders, out-of-range pair indices)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from airslam_tpu.models import plnet as jplnet
from airslam_tpu.ops import bilerp_pallas
from airslam_tpu_torch.frontend.detector import DetectorConfig, FeatureDetector
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.models.plnet import LoiHeadS1
from airslam_tpu_torch.ops import bilerp

torch.set_num_threads(2)


def _np(t):
    return t.detach().float().cpu().numpy()


@pytest.fixture(scope="module")
def s0():
    return wio.load_npz(wio.checkpoint_path("plnet_s0.npz"))


@pytest.mark.parametrize("n_views", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_loi_features_plain_equals_the_unfused_composition(n_views, dtype):
    """Bit for bit the sampling the head ran before: per view kernel B's
    function at the junctions, the clamped gathers, kernel T's on both
    4-channel maps, the channel-major flatten, the concatenations and casts
    (``chip_smoke.loi_unfused``, whose B and T take their plain versions
    here); ``res_in`` is the row's tail."""
    ops = chip_smoke.loi_inputs(np.random.RandomState(n_views), n_views, 512, 300, dtype)
    got = bilerp.loi_features_plain(*ops)
    assert got.shape == (n_views, 512, 496) and got.dtype == dtype
    old = chip_smoke.loi_unfused(*ops)
    assert torch.equal(got, torch.stack([feats for feats, _ in old]))
    assert torch.equal(got[..., 256:], torch.stack([res for _, res in old]))
    assert torch.equal(bilerp.loi_features(*ops), got)  # a CPU tensor takes the plain version
    wide = bilerp.loi_features(*ops, out_dtype=torch.float32)
    assert torch.equal(wide.to(dtype), got)


def test_loi_features_bf16_columns_match_the_pallas_kernels():
    """bf16 maps, f32 output: the endpoint columns equal the Pallas
    ``bilerp_points`` (interpret mode) at the junctions − 0.5 gathered by the
    clipped pair indices, the thin and aux columns ``bilerp_points_t`` at the
    JAX head's interior points, flattened channel-major. 1e-5 of the map's
    max, the card's tolerance (both sides round the row weights to bf16 and
    sum in f32)."""
    ops = chip_smoke.loi_inputs(np.random.RandomState(7), 2, 128, 300, torch.bfloat16)
    got = _np(bilerp.loi_features_plain(*ops, out_dtype=torch.float32))
    loi, thin, aux, junc, pairs, lines, props, t_fwd, t_rev = (
        jnp.asarray(_np(t)) if t.dtype != torch.int64 else jnp.asarray(t.numpy()) for t in ops)
    loi, thin, aux = (m.astype(jnp.bfloat16) for m in (loi, thin, aux))
    tol = 1e-5 * float(jnp.abs(loi.astype(jnp.float32)).max())
    for v in range(2):
        f_junc = bilerp_pallas.bilerp_points(loi[v], junc[v, :, 0] - 0.5, junc[v, :, 1] - 0.5,
                                             interpret=True)
        idx = jnp.clip(pairs[v], 0, junc.shape[1] - 1)
        cols = [f_junc[idx[:, 0]], f_junc[idx[:, 1]]]
        for fmap, seg in ((thin[v], lines[v]), (aux[v], props[v])):
            x = seg[:, 0:1] * t_fwd[None, :] + seg[:, 2:3] * t_rev[None, :] - 0.5
            y = seg[:, 1:2] * t_fwd[None, :] + seg[:, 3:4] * t_rev[None, :] - 0.5
            out = bilerp_pallas.bilerp_points_t(fmap, x, y, interpret=True)  # (C, L, T)
            cols.append(out.transpose(1, 0, 2).reshape(seg.shape[0], -1))
        want = np.asarray(jnp.concatenate(cols, axis=-1), np.float32)
        np.testing.assert_allclose(got[v], want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batched_loi_head_matches_jax_vmap(s0, dtype):
    """Two views through one head call against ``jax.vmap`` of the JAX
    ``LoiHeadS1`` with the shipped weights. f32: 1e-5, as for one view. bf16:
    0.03 on the scores — the JAX head samples bf16 maps through its CPU
    einsum, which rounds the rows to bf16 where the port (and the TPU
    kernels) sum them in f32, and both MLPs run in bf16; the gap measured
    here is 0.017. The batched call equals the head run view by view (1e-6:
    the MLP over 2·L rows instead of L)."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    ops = chip_smoke.loi_inputs(np.random.RandomState(11), 2, 512, 300, tdt)
    loi, thin, aux, junc, pairs, lines, props = ops[:7]
    head = LoiHeadS1(dtype=tdt)
    head.load_state_dict(wio.loi_s1_from_flax(s0["loi"]))
    with torch.no_grad():
        got, got_lines = head(lines, props, loi, thin, aux, junc_xy=junc, pair_idx=pairs)
        one = [head(lines[v], props[v], loi[v], thin[v], aux[v], junc_xy=junc[v],
                    pair_idx=pairs[v])[0] for v in range(2)]
    assert got.shape == (2, 512) and got.dtype == torch.float32 and got_lines is lines
    np.testing.assert_allclose(_np(got), _np(torch.stack(one)), rtol=0, atol=1e-6)

    def jx(t):
        if t.dtype == torch.int64:
            return jnp.asarray(t.numpy())
        return jnp.asarray(_np(t), jdt if t.dtype == torch.bfloat16 else jnp.float32)

    jhead = jplnet.LoiHeadS1(dtype=jdt)
    want, _ = jax.vmap(lambda *a: jhead.apply(s0["loi"], *a[:5], junc_xy=a[5], pair_idx=a[6]))(
        jx(lines), jx(props), jx(loi), jx(thin), jx(aux), jx(junc), jx(pairs))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=0,
                               atol=1e-5 if dtype == "f32" else 3e-2)


def test_split_detect_batch_matches_the_frontend_oracle():
    """The detector with the per-view decode split around one head call, f32
    on the CPU, on the stored oracle's three pairs (the JAX package's
    entry()): the same line and junction masks, the lines within 6.2e-5 px
    (one f32 ulp at 256-512 px) and the junctions exactly, as before the
    split."""
    frames, refs = chip_smoke.oracle_pairs()
    det = FeatureDetector(DetectorConfig(max_keypoints=400, use_superpoint=False), device="cpu")
    for pair, ref in zip(frames, refs):
        f = det.detect(pair, detect_junctions=True)
        np.testing.assert_array_equal(_np(f.line_mask[0]) > 0, ref["o5"])
        np.testing.assert_allclose(_np(f.lines[0]), ref["o4"], rtol=0, atol=6.2e-5)
        np.testing.assert_array_equal(_np(f.junc_mask) > 0, ref["o10"])
        np.testing.assert_array_equal(_np(f.junctions)[ref["o10"]], ref["o8"][ref["o10"]])
