"""Kernel F's arithmetic on the CPU: the port's ``flash_mha_plain`` and ``mha``
against the JAX package's ``flash_mha`` (the Pallas kernel in interpret mode)
and ``mha`` on the same numpy-seeded inputs, and ``LightGlue(use_flash=True)``
of both packages. On a CPU tensor ``flash_mha`` takes the plain version; the
CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: float32 1e-5 (sum orders differ; the ``PARITY_TPU.json`` gate);
bfloat16 2e-2 of the output's max (p is rounded to bf16 before the second
product, and the two frameworks round the bf16 product sums at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airslam_tpu.models.lightglue import LightGlue as JaxLightGlue
from airslam_tpu.ops.attention import _flash_call
from airslam_tpu.ops.attention import flash_mha as jflash_mha
from airslam_tpu.ops.attention import mha as jmha
from airslam_tpu_torch.frontend.matcher import MatcherConfig
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.models.lightglue import LightGlue
from airslam_tpu_torch.ops import attention
from airslam_tpu_torch.ops.attention import flash_mha, flash_mha_plain, mha
from tests.test_torch_models import _lg_inputs

torch.set_num_threads(2)
F32_TOL = 1e-5
BF16_REL = 2e-2


def _qkv(seed, h, nq, nk, d, lead=()):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*lead, h, n, d).astype(np.float32) for n in (nq, nk, nk))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _np(t):
    return t.float().numpy()


def _jax_flash(q, k, v, mask=None, dtype=jnp.float32):
    out = jflash_mha(jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
                     kv_mask=None if mask is None else jnp.asarray(mask), interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("nq,nk,n_valid", [(128, 128, None), (128, 128, 77), (77, 300, 290),
                                           (128, 128, 0)],
                         ids=["unmasked", "masked", "nq!=nk", "all-masked"])
def test_flash_plain_f32_vs_jax(nq, nk, n_valid):
    q, k, v = _qkv(1, 2, nq, nk, 64)
    mask = None if n_valid is None else np.arange(nk) < n_valid
    got = _np(flash_mha_plain(_t(q), _t(k), _t(v), None if mask is None else _t(mask, torch.bool)))
    np.testing.assert_allclose(got, _jax_flash(q, k, v, mask), rtol=0, atol=F32_TOL)
    want_mha = np.asarray(jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               kv_mask=None if mask is None else jnp.asarray(mask)))
    np.testing.assert_allclose(got, want_mha, rtol=0, atol=F32_TOL)
    got_mha = _np(mha(_t(q), _t(k), _t(v), None if mask is None else _t(mask, torch.bool)))
    np.testing.assert_allclose(got_mha, want_mha, rtol=0, atol=F32_TOL)
    if n_valid == 0:  # masked keys are −1e9, not −inf: the plain mean of v, finite
        np.testing.assert_allclose(got, np.broadcast_to(v.mean(-2, keepdims=True), got.shape),
                                   rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("n_valid", [None, 100, 0], ids=["unmasked", "masked", "all-masked"])
def test_flash_plain_bf16_vs_jax(n_valid):
    q, k, v = _qkv(2, 4, 128, 128, 64)
    mask = None if n_valid is None else np.arange(128) < n_valid
    bf = torch.bfloat16
    got = flash_mha_plain(_t(q, bf), _t(k, bf), _t(v, bf),
                          None if mask is None else _t(mask, torch.bool))
    assert got.dtype == bf
    want = _jax_flash(q, k, v, mask, jnp.bfloat16)
    assert np.abs(_np(got) - want).max() <= BF16_REL * np.abs(want).max()


def _bf16(x):
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _tiled_flash_np(q, k, v, mask, bf16):
    """Kernel F's order of work in numpy (f32): 64-key tiles, logits divided
    by √D, masked keys −1e9, a running row maximum and sum, p rounded to v's
    type against the running maximum, the accumulator rescaled per tile, the
    division by the row sum last, the output in q's type. Returns the output
    and the number of tiles."""
    d, nk = q.shape[-1], k.shape[-2]
    m = np.full(q.shape[:-1], -np.inf, np.float32)
    l = np.zeros(q.shape[:-1], np.float32)
    acc = np.zeros(q.shape, np.float32)
    tiles = 0
    for k0 in range(0, nk, 64):
        s = np.matmul(q, np.swapaxes(k[:, k0:k0 + 64], -1, -2)) / np.float32(np.sqrt(d))
        s = np.where(mask[None, None, k0:k0 + 64], s, np.float32(-1e9)).astype(np.float32)
        m_new = np.maximum(m, s.max(-1))
        alpha = np.exp(m - m_new)
        p = np.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        p = _bf16(p) if bf16 else p
        acc = acc * alpha[..., None] + np.matmul(p, v[:, k0:k0 + 64])
        m = m_new
        tiles += 1
    out = acc / l[..., None]
    return (_bf16(out) if bf16 else out), tiles


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_valid", [371, 0], ids=["masked-tail", "all-masked"])
def test_kernel_tile_order_vs_pallas_interpret(bf16, n_valid):
    """The new kernel's key-tile order holds the gates against the Pallas
    kernel itself (``_flash_call`` in interpret mode) at the path's head
    shape (4, 400, 64): f32 1e-5, bf16 2e-2 of the output's max; the bf16
    rounding of p against the running maximum is the only extra error."""
    q, k, v = _qkv(9, 4, 400, 400, 64)
    if bf16:
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    mask = np.arange(400) < n_valid
    got, tiles = _tiled_flash_np(q, k, v, mask, bf16)
    assert tiles == 7
    dt = jnp.bfloat16 if bf16 else jnp.float32
    want = np.asarray(_flash_call(jnp.asarray(q, dt), jnp.asarray(k, dt), jnp.asarray(v, dt),
                                  jnp.asarray(mask.astype(np.int32)[None]),
                                  interpret=True).astype(jnp.float32))
    tol = BF16_REL * np.abs(want).max() if bf16 else F32_TOL
    assert np.abs(got - want).max() <= tol
    if n_valid == 0:  # every key masked: the mean of v
        mean_v = np.broadcast_to(v.mean(-2, keepdims=True), got.shape)
        assert np.abs(got - mean_v).max() <= (2e-2 if bf16 else F32_TOL)


def test_flash_plain_casts_follow_the_kernel():
    """k goes to q's type, p is rounded to v's type before the second
    product, the output comes in q's type (mixed f32 q/k with bf16 v)."""
    q, k, v = _qkv(3, 2, 64, 96, 32)
    bf = torch.bfloat16
    out = flash_mha_plain(_t(q), _t(k, bf), _t(v, bf))
    assert out.dtype == torch.float32
    want = np.asarray(jflash_mha(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                                 jnp.asarray(v, jnp.bfloat16), interpret=True))
    # f32 logits on both sides; p and v in bf16 → products agree to bf16 rounding of p
    assert np.abs(_np(out) - want).max() <= 2e-3 * np.abs(want).max()
    kq = _t(k, bf).float()  # what "k in q's type" holds
    logits = torch.einsum("hqd,hkd->hqk", _t(q), kq) / np.sqrt(32)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    ref = torch.einsum("hqk,hkd->hqd", p.to(bf).float(), _t(v, bf).float()) / p.sum(-1, keepdim=True)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=1e-5)


def test_batched_equals_per_entry_and_masks_are_per_entry():
    q, k, v = _qkv(4, 4, 50, 60, 64, lead=(3,))
    mask = np.stack([np.arange(60) < n for n in (60, 31, 0)])
    out = flash_mha_plain(_t(q), _t(k), _t(v), _t(mask, torch.bool))
    for b in range(3):
        one = flash_mha_plain(_t(q[b]), _t(k[b]), _t(v[b]), _t(mask[b], torch.bool))
        np.testing.assert_allclose(_np(out[b]), _np(one), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(out[b]), _jax_flash(q[b], k[b], v[b], mask[b]),
                                   rtol=0, atol=F32_TOL)


def test_masked_keys_have_no_influence():
    q, k, v = _qkv(5, 2, 64, 64, 64)
    mask = _t(np.arange(64) < 20, torch.bool)
    a = flash_mha_plain(_t(q), _t(k), _t(v), mask)
    k2, v2 = _t(k).clone(), _t(v).clone()
    k2[:, 20:], v2[:, 20:] = 999.0, -999.0
    np.testing.assert_allclose(_np(flash_mha_plain(_t(q), k2, v2, mask)), _np(a), atol=1e-6)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_no_launch():
    q, k, v = _qkv(6, 2, 33, 47, 32, lead=(2,))
    mask = _t(np.arange(47) < 40, torch.bool).expand(2, 47)
    before = flash_mha.launches
    got = flash_mha(_t(q), _t(k), _t(v), mask)
    assert flash_mha.launches == before
    assert torch.equal(got, flash_mha_plain(_t(q), _t(k), _t(v), mask))
    assert attention.HEAD_DIMS == (32, 64)


def test_kernel_operands_are_views_unless_a_row_misses_16_bytes():
    """What the kernel's 16-byte copies need, decided on the host: LightGlue's
    views of (B, N, 3·H·D) projections pass as they are; a view whose rows
    start off 16 bytes, or whose leading dimensions do not merge, is copied
    once and counted."""
    before = flash_mha.copies
    qkv = torch.zeros(2, 400, 3 * 256, dtype=torch.bfloat16)
    for part in qkv.chunk(3, dim=-1):
        view = attention._bhnd(part.reshape(2, 400, 4, 64).transpose(-3, -2))
        assert view.data_ptr() == part.data_ptr() and tuple(view.stride()) == (307200, 64, 768, 1)
    assert flash_mha.copies == before
    odd = torch.zeros(2, 400, 257)[..., 1:].reshape(2, 400, 4, 64).transpose(-3, -2)
    copy = attention._bhnd(odd)
    assert copy.is_contiguous() and torch.equal(copy, odd) and flash_mha.copies == before + 1
    unmerged = torch.zeros(4, 3, 2, 8, 64).transpose(0, 2)
    assert attention._bhnd(unmerged).shape == (6, 4, 8, 64) and flash_mha.copies == before + 2


def _lg_both(jm, params, model, args):
    want = jm.apply(params, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = model(*(_t(a, torch.bool if a.dtype == bool else torch.float32) for a in args))
    return got, want


@pytest.mark.parametrize("shipped", [False, True], ids=["2-layers", "shipped-weights"])
def test_lightglue_use_flash_vs_flax(shipped):
    """The port's LightGlue with ``use_flash=True`` (36 fused attention calls
    at full depth, on the CPU their plain version) against the flax module
    with ``use_flash=True`` (whose ``flash_mha`` takes ``mha`` off the TPU) and
    against the port's own default path: scores and logits ≤ 1e-4 in f32."""
    rng = np.random.RandomState(7)
    if shipped:
        args = _lg_inputs(rng, 64, 56, 256)
        tree = wio.load_npz(wio.checkpoint_path("lightglue.npz"))
        jm, kw = JaxLightGlue(use_flash=True), {}
    else:
        args = _lg_inputs(rng, 48, 40, 64)
        kw = dict(dim=64, heads=4, layers=2)
        jm = JaxLightGlue(use_flash=True, **kw)
        tree = jax.tree_util.tree_map(
            np.asarray, jm.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args)))
    model = LightGlue(use_flash=True, **kw)
    model.load_state_dict(wio.lightglue_from_flax(tree))
    calls = []
    plain = attention.flash_mha_plain

    def counting(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    attention.flash_mha_plain = counting
    try:
        got, want = _lg_both(jm, tree, model, args)
    finally:
        attention.flash_mha_plain = plain
    assert len(calls) == (36 if shipped else 8)  # layers × (2 self + 2 cross)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-4)
    default = LightGlue(**kw)
    default.load_state_dict(model.state_dict())
    with torch.no_grad():
        ref = default(*(_t(a, torch.bool if a.dtype == bool else torch.float32) for a in args))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), _np(r), rtol=0, atol=1e-4)


def test_use_flash_is_off_by_default_and_reaches_the_model():
    assert MatcherConfig().use_flash is False
    assert LightGlue(dim=64, heads=4, layers=1).self_blocks[0].use_flash is False
    m = LightGlue(dim=64, heads=4, layers=1, use_flash=True)
    assert m.self_blocks[0].use_flash and m.cross_blocks[0].use_flash
