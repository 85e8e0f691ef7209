"""The port's CUDA kernels (R, B, T, loi_features and its backward B+T′, P,
F) against their plain PyTorch versions, the stereo-inertial solves (plain
PyTorch) in float32 on the card against float64 on the CPU, and the device
RANSAC PnP on the card against the CPU.

The kernel tests need an NVIDIA GPU: they carry the ``cuda`` marker and skip
without one. Where JAX (which ``tests/conftest.py`` imports) is not
installed, run them with ``python -m pytest --noconftest
tests/test_torch_cuda.py -q``; ``chip_smoke.py`` runs the same comparisons
at the main path's shapes. The
last tests run anywhere: a tensor that is neither on the CPU nor on a CUDA
device is refused, never sent down the plain path."""

import numpy as np
import pytest
import torch

import chip_smoke
from airslam_tpu_torch.backend import gn, pose_gn
from airslam_tpu_torch.ops import attention, bilerp, remap
from airslam_tpu_torch.ops.gridsample import remap as remap_plain

torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_remap_kernel_equals_plain_on_euroc_grids(dev):
    """Compiled with -fmad=false: bit-equal to the plain version."""
    rng = np.random.RandomState(0)
    grids = torch.as_tensor(chip_smoke.euroc_grids(), device=dev)
    imgs = torch.as_tensor(rng.rand(2, 480, 752).astype(np.float32), device=dev)
    before = remap.remap.launches
    got = remap.remap(imgs, grids)
    assert remap.remap.launches == before + 1
    for i in range(2):
        torch.testing.assert_close(got[i], remap_plain(imgs[i], grids[i]), rtol=0, atol=0)
    one = remap.remap(imgs[0], grids[0])  # the single-image form
    torch.testing.assert_close(one, got[0], rtol=0, atol=0)
    with pytest.raises(ValueError):
        remap.remap(imgs.transpose(1, 2), grids)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,shape", [(128, (300,)), (4, (512, 30)), (7, (13,))])
def test_bilerp_kernels_equal_plain(dev, dtype, c, shape):
    """B and T vs the plain version: 1e-5 abs for f32, 1e-5 of the map's max
    for bf16 (same rounded weights; compiled without FMA contraction, so
    equal in practice)."""
    rng = np.random.RandomState(c)
    fmap = torch.as_tensor(rng.randn(128, 128, c).astype(np.float32), device=dev).to(dtype)
    x = torch.as_tensor(rng.uniform(-1.5, 129.5, shape).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.uniform(-1.5, 129.5, shape).astype(np.float32), device=dev)
    x.view(-1)[:4] = torch.tensor([127.0, 127.5, -0.5, 0.0])
    want = bilerp.bilerp_plain(fmap, x, y)
    tol = 1e-5 * (1.0 if dtype == torch.float32 else float(fmap.float().abs().max()))
    torch.testing.assert_close(bilerp.bilerp_points(fmap, x, y), want, rtol=0, atol=tol)
    torch.testing.assert_close(bilerp.bilerp_points_t(fmap, x, y),
                               torch.movedim(want, -1, 0), rtol=0, atol=tol)
    with pytest.raises(ValueError):
        bilerp.bilerp_points(fmap.transpose(0, 1), x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [128, 4])
def test_bilerp_kernels_on_an_unaligned_map(dev, dtype, c):
    """A map that does not start on 16 bytes takes B's and T's scalar forms
    and holds the same gates as the vector ones."""
    rng = np.random.RandomState(c + 1)
    base = torch.as_tensor(rng.randn(128 * 128 * c + 1).astype(np.float32), device=dev).to(dtype)
    fmap = base[1:].view(128, 128, c)
    assert fmap.data_ptr() % 16 and fmap.is_contiguous()
    x = torch.as_tensor(chip_smoke._border_points(rng, (300,), -1.5, 129.5, 128), device=dev)
    y = x.flip(0).contiguous()
    want = bilerp.bilerp_plain(fmap, x, y)
    tol = 1e-5 * (1.0 if dtype == torch.float32 else float(fmap.float().abs().max()))
    torch.testing.assert_close(bilerp.bilerp_points(fmap, x, y), want, rtol=0, atol=tol)
    torch.testing.assert_close(bilerp.bilerp_points_t(fmap, x, y), want.T, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["out_f32", "out_bf16"])
@pytest.mark.parametrize("map_dtype", [torch.float32, torch.bfloat16], ids=["maps_f32", "maps_bf16"])
@pytest.mark.parametrize("n_junc", [1, 300])
@pytest.mark.parametrize("n_lines", [1, 31, 512])
@pytest.mark.parametrize("n_views", [1, 2])
def test_loi_features_kernel_equals_plain(dev, n_views, n_lines, n_junc, map_dtype, out_dtype):
    """One launch against the plain version (out-of-range pair indices,
    points on and beyond the borders, proposals up to about 10 px out where
    the unclamped weights extrapolate): an f32 output ≤ 1e-5 abs from f32
    maps and ≤ 1e-5 of the map's max from bf16 maps; a bf16 output within
    one bf16 ulp; two runs bit-equal. Compiled without FMA contraction, the
    kernel rounds as the plain version does, so the gaps are 0 in practice."""
    rng = np.random.RandomState(n_views * 1000 + n_lines + n_junc)
    ops = chip_smoke.loi_inputs(rng, n_views, n_lines, n_junc, map_dtype, dev)
    before = bilerp.loi_features.launches
    got = bilerp.loi_features(*ops, out_dtype=out_dtype)
    assert bilerp.loi_features.launches == before + 1
    again = bilerp.loi_features(*ops, out_dtype=out_dtype)
    want = bilerp.loi_features_plain(*ops, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n_views, n_lines, 496) and got.dtype == out_dtype
    assert torch.equal(got, again)
    err, tol, ok = chip_smoke.loi_gate(got, want, ops[0])
    assert ok, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loi_features_kernel_under_graph_capture(dev, dtype):
    """Captured in a CUDA graph and replayed, the kernel gives its eager bits."""
    ops = chip_smoke.loi_inputs(np.random.RandomState(5), 2, 512, 300, dtype, dev)
    eager = bilerp.loi_features(*ops).clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bilerp.loi_features(*ops)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_loi_features_refuses_what_the_kernel_does_not_take(dev):
    """A non-contiguous, wrongly typed, misshapen or misaligned operand
    raises before any launch; no lines is an empty row block and no launch."""
    ops = chip_smoke.loi_inputs(np.random.RandomState(6), 2, 31, 300, torch.bfloat16, dev)
    loi = ops[0]
    shifted = torch.empty(loi.numel() + 1, dtype=loi.dtype, device=dev)[1:].view(loi.shape)
    shifted.copy_(loi)
    spoiled = {
        "non-contiguous lines": {5: ops[5].transpose(0, 1).contiguous().transpose(0, 1)},
        "int32 pair_idx": {4: ops[4].int()},
        "f32 aux beside bf16 maps": {2: ops[2].float()},
        "f64 junctions": {3: ops[3].double()},
        "3 views of junctions": {3: torch.cat([ops[3], ops[3][:1]])},
        "64-channel LOI map": {0: loi[..., :64].contiguous()},
        "a map off 16 bytes": {0: shifted},
        "33 interior points": {7: torch.zeros(33, device=dev), 8: torch.zeros(33, device=dev)},
    }
    before = bilerp.loi_features.launches
    for what, change in spoiled.items():
        bad = tuple(change.get(i, t) for i, t in enumerate(ops))
        with pytest.raises(ValueError):
            bilerp.loi_features(*bad)
        assert bilerp.loi_features.launches == before, what
    with pytest.raises(ValueError):
        bilerp.loi_features(*ops, out_dtype=torch.float16)
    empty = tuple(t[:, :0] if i in (4, 5, 6) else t for i, t in enumerate(ops))
    assert bilerp.loi_features(*empty).shape == (2, 0, 496)
    assert bilerp.loi_features.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loi_head_batched_on_the_card(dev, dtype):
    """The stage-1 head with the shipped weights: two views in one call (one
    ``loi_features`` launch) against the same head view by view and against
    the batched head's plain sampling on the card. f32 ≤ 1e-5 on the
    scores; bf16 ≤ 2e-2 (a bf16 input row may differ by one ulp, and the MLP
    over 2·L rows may sum in another order)."""
    from airslam_tpu_torch.models import weights as wio
    from airslam_tpu_torch.models.plnet import LoiHeadS1

    ops = chip_smoke.loi_inputs(np.random.RandomState(8), 2, 512, 300, dtype, dev)
    loi, thin, aux, junc, pairs, lines, props = ops[:7]
    head = LoiHeadS1(dtype=dtype)
    head.load_state_dict(wio.loi_s1_from_flax(wio.load_npz(wio.checkpoint_path("plnet_s0.npz"))["loi"]))
    head.to(dev)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    before = bilerp.loi_features.launches
    with torch.no_grad():
        got, _ = head(lines, props, loi, thin, aux, junc_xy=junc, pair_idx=pairs)
        assert bilerp.loi_features.launches == before + 1
        for v in range(2):
            one, _ = head(lines[v], props[v], loi[v], thin[v], aux[v], junc_xy=junc[v],
                          pair_idx=pairs[v])
            assert float((one - got[v]).abs().max()) <= tol
        cpu = head.to("cpu")
        want, _ = cpu(*(t.cpu() for t in (lines, props, loi, thin, aux)), junc_xy=junc.cpu(),
                      pair_idx=pairs.cpu())
    assert float((got.cpu() - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full", "path", "odd", "lines_only"])
def test_pose_kernel_vs_plain(dev, case):
    """Kernel P against its plain version, both float32 on the card, at
    chip_smoke.py's gates (t 2e-3, R 1e-3, inlier agreement 0.98, counts
    within 2 %): f32 sums in another order can flip an accept at a near tie,
    so the two are held to the solver's accuracy, not to bits."""
    rounds, iters = 3, 10
    if case == "full":
        problem, intr, twb_true = chip_smoke.tracking_problem(5, 512, 128, device=dev)
    elif case == "path":
        problem, intr, twb_true = chip_smoke.tracking_problem(
            6, 200, 1, n_masked_points=56, mask_lines=True, device=dev)
    elif case == "odd":  # sizes that fill neither a warp nor the block evenly
        problem, intr, twb_true = chip_smoke.tracking_problem(8, 301, 37, device=dev)
    else:
        problem, intr, twb_true = chip_smoke.tracking_problem(11, 1, 24, outliers=False,
                                                              device=dev)
        problem = problem._replace(point_obs_mask=torch.zeros_like(problem.point_obs_mask))
        rounds, iters = 2, 8
    before = pose_gn.pose_only_fast.launches
    got = pose_gn.pose_only_fast(problem, intr, gn.BAConfig(), rounds=rounds, iters=iters)
    assert pose_gn.pose_only_fast.launches == before + 1
    want = pose_gn.pose_only_fast_plain(problem, intr, gn.BAConfig(), rounds=rounds, iters=iters)
    a = chip_smoke.pose_agreement(got, want)
    g = chip_smoke.POSE_GATES
    assert a["t"] <= g["t"] and a["R"] <= g["R"], a
    assert a["inlier_agree"] >= g["inlier_agree"] and a["count_rel"] <= g["count_rel"], a
    assert int(got[3]) == int(got[1].sum()) + int(got[2].sum()) > 0
    if case != "lines_only":
        assert np.linalg.norm(got[0].frames.twb[0].double().cpu().numpy() - twb_true) < g["t_true"]
    again = pose_gn.pose_only_fast(problem, intr, gn.BAConfig(), rounds=rounds, iters=iters)
    assert torch.equal(again[0].frames.twb, got[0].frames.twb)  # fixed reduction order
    assert torch.equal(again[0].frames.Rwb, got[0].frames.Rwb)


@pytest.mark.cuda
@pytest.mark.parametrize("padded,matched", [(64, 60), (512, 400)])
def test_pose_kernel_at_the_refinement_shapes(dev, padded, matched):
    """Kernel P at the shapes of ``MapRefiner._pose_only``: the loop's matched
    mappoints padded to a power of two (at least 64), one masked line; held
    to its plain version under chip_smoke.py's gates."""
    problem, intr, twb_true = chip_smoke.refine_pose_problem(13, padded, matched, device=dev)
    before = pose_gn.pose_only_fast.launches
    got = pose_gn.pose_only_fast(problem, intr, gn.BAConfig())
    assert pose_gn.pose_only_fast.launches == before + 1
    want = pose_gn.pose_only_fast_plain(problem, intr, gn.BAConfig())
    a = chip_smoke.pose_agreement(got, want)
    g = chip_smoke.POSE_GATES
    assert a["t"] <= g["t"] and a["R"] <= g["R"], a
    assert a["inlier_agree"] >= g["inlier_agree"] and a["count_rel"] <= g["count_rel"], a
    assert not bool(got[1][matched:].any()) and not bool(got[2].any())
    assert np.linalg.norm(got[0].frames.twb[0].double().cpu().numpy() - twb_true) < g["t_true"]


@pytest.mark.cuda
def test_pose_kernel_fixed_pose_and_f64_problem(dev):
    """A fixed pose comes back bit-unchanged; a float64 problem is solved in
    float32 and handed back in its own type."""
    problem, intr, _ = chip_smoke.tracking_problem(7, 96, 12, outliers=False, device=dev)
    fixed = problem._replace(pose_fixed=torch.ones_like(problem.pose_fixed))
    out = pose_gn.pose_only_fast(fixed, intr, gn.BAConfig(), rounds=1, iters=3)[0]
    assert torch.equal(out.frames.Rwb, fixed.frames.Rwb)
    assert torch.equal(out.frames.twb, fixed.frames.twb)
    p64, intr, _ = chip_smoke.tracking_problem(7, 96, 12, device=dev, dtype=torch.float64)
    out64 = pose_gn.pose_only_fast(p64, intr, gn.BAConfig())
    want = pose_gn.pose_only_fast_plain(p64, intr, gn.BAConfig())
    assert out64[0].frames.twb.dtype == torch.float64
    a = chip_smoke.pose_agreement(out64, want)
    assert a["t"] <= 2e-3 and a["R"] <= 1e-3 and a["inlier_agree"] >= 0.98, a


def test_pose_wrapper_refuses_non_cuda_devices():
    """A problem that is neither on the CPU nor on one CUDA device raises."""
    problem, intr, _ = chip_smoke.tracking_problem(7, 16, 2)
    meta = problem._replace(
        frames=gn.FrameStates(*(t.to("meta") for t in problem.frames)),
        **{k: getattr(problem, k).to("meta") for k in gn.BAProblem._fields
           if torch.is_tensor(getattr(problem, k))})
    with pytest.raises(ValueError, match="CUDA"):
        pose_gn.pose_only_fast(meta, intr)
    with pytest.raises(ValueError, match="rounds"):
        pose_gn.pose_only_fast(problem, intr, rounds=0)


def test_wrappers_refuse_non_cuda_devices():
    """Only a CPU tensor takes the plain version; anything else must be a
    CUDA tensor or the wrapper raises."""
    fmap = torch.empty((8, 8, 4), device="meta")
    pts = torch.empty((5,), device="meta")
    for fn in (bilerp.bilerp_points, bilerp.bilerp_points_t):
        with pytest.raises(ValueError, match="CUDA"):
            fn(fmap, pts, pts)
    with pytest.raises(ValueError, match="CUDA"):
        remap.remap(torch.empty((8, 8), device="meta"), torch.empty((8, 8, 2), device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("lead,h,nq,nk,d,n_valid,dead", [
    ((2,), 4, 400, 400, 64, 388, None),   # the path's shape
    ((), 4, 1024, 1024, 64, 1000, None),  # the engine's limit, unbatched
    ((3,), 2, 77, 300, 32, 290, None),    # odd sizes, the other head dimension
    ((2,), 4, 130, 65, 64, 60, 1),        # one batch entry with every key masked
    ((3,), 4, 400, 400, 64, 388, None),   # relocalization's top-3 batch
    ((8,), 4, 400, 400, 64, 388, None),   # relocalization's matcher recovery (up to 8)
], ids=["path", "1024", "odd", "all-masked", "reloc-top3", "reloc-recovery"])
@pytest.mark.parametrize("types", ["f32", "bf16", "mixed"])
def test_flash_kernel_equals_plain(dev, lead, h, nq, nk, d, n_valid, dead, types):
    """f32 ≤ 1e-5 abs (sum orders); with bf16 anywhere ≤ 2e-2 of the output's
    max (p is rounded against the running maximum); two runs bit-equal; the
    inputs are the strided views LightGlue hands over."""
    tq, tv = {"f32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
              "mixed": (torch.float32, torch.bfloat16)}[types]
    rng = np.random.RandomState(0)
    q, k, v, mask = chip_smoke._attention_inputs(rng, lead, h, nq, nk, d, tq, tv, dev,
                                                 n_valid, dead)
    assert not q.is_contiguous()
    before = attention.flash_mha.launches
    got = attention.flash_mha(q, k, v, mask)
    assert attention.flash_mha.launches == before + 1
    again = attention.flash_mha(q, k, v, mask)
    want = attention.flash_mha_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == want.shape and torch.equal(got, again)
    err = float((got.float() - want.float()).abs().max())
    tol = 1e-5 if types == "f32" else 2e-2 * float(want.float().abs().max())
    assert err <= tol
    if dead is not None:
        mean_v = v[dead].float().mean(dim=-2, keepdim=True).expand_as(got[dead])
        assert float((got[dead].float() - mean_v).abs().max()) <= (1e-5 if types == "f32" else 2e-2)


@pytest.mark.cuda
def test_flash_kernel_without_mask_and_with_a_contiguous_copy(dev):
    rng = np.random.RandomState(1)
    q, k, v, _ = chip_smoke._attention_inputs(rng, (2,), 4, 200, 210, 64, torch.float32,
                                              torch.float32, dev)
    got = attention.flash_mha(q, k, v)
    same = attention.flash_mha(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, same)
    assert float((got - attention.mha(q, k, v)).abs().max()) <= 1e-5


def _flash_gate(got, want, types):
    """f32 ≤ 1e-5 abs; with bf16 anywhere ≤ 2e-2 of the output's max."""
    err = float((got.float() - want.float()).abs().max())
    return err <= (1e-5 if types == "f32" else 2e-2 * float(want.float().abs().max()))


_TYPES = {"f32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
          "mixed": (torch.float32, torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk,dead_tile", [(1, 1, False), (15, 63, False), (17, 64, False),
                                             (77, 65, False), (400, 300, False),
                                             (33, 300, True)],
                         ids=["1x1", "15x63", "17x64", "77x65", "400x300", "masked-tile"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("types", ["f32", "bf16", "mixed"])
def test_flash_kernel_tile_edges(dev, nq, nk, dead_tile, d, types):
    """Query counts around the 16-row fragments and key counts around the
    64-key tiles (the m16n8k16 fragment layouts, the swizzle, the zero-filled
    tail), and one 64-key tile whose keys are all masked between live ones."""
    tq, tv = _TYPES[types]
    rng = np.random.RandomState(nq * 1000 + nk)
    q, k, v, mask = chip_smoke._attention_inputs(rng, (2,), 4, nq, nk, d, tq, tv, dev, nk - nk // 7)
    if dead_tile:
        mask[:] = True
        mask[:, 64:128] = False
    got = attention.flash_mha(q, k, v, mask)
    want = attention.flash_mha_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got.float()).all())
    assert _flash_gate(got, want, types)
    assert torch.equal(got, attention.flash_mha(q, k, v, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("types", ["f32", "bf16"])
def test_flash_kernel_under_graph_capture(dev, types):
    """Captured in a CUDA graph and replayed, the kernel gives its eager bits."""
    tq, tv = _TYPES[types]
    rng = np.random.RandomState(3)
    q, k, v, mask = chip_smoke._attention_inputs(rng, (2,), 4, 400, 400, 64, tq, tv, dev, 388)
    eager = attention.flash_mha(q, k, v, mask).clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = attention.flash_mha(q, k, v, mask)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_flash_kernel_copies_an_unaligned_view(dev):
    """A view whose rows do not start on 16 bytes takes one counted copy and
    gives the bits of its aligned twin."""
    rng = np.random.RandomState(4)
    q, k, v, mask = chip_smoke._attention_inputs(rng, (2,), 4, 100, 90, 64, torch.bfloat16,
                                                 torch.bfloat16, dev, 80)
    wide = torch.zeros(2, 100, 4 * 64 + 1, dtype=q.dtype, device=dev)
    wide[..., 1:] = q.transpose(-3, -2).reshape(2, 100, 256)
    q_odd = wide[..., 1:].reshape(2, 100, 4, 64).transpose(-3, -2)  # 2-byte offset
    assert q_odd.data_ptr() % 16 != 0 and torch.equal(q_odd, q)
    before, copies = attention.flash_mha.launches, attention.flash_mha.copies
    got = attention.flash_mha(q_odd, k, v, mask)
    assert attention.flash_mha.copies == copies + 1
    assert attention.flash_mha.launches == before + 1
    aligned = attention.flash_mha(q, k, v, mask)
    assert attention.flash_mha.copies == copies + 1  # LightGlue's views take none
    torch.cuda.synchronize()
    assert torch.equal(got, aligned)


@pytest.mark.cuda
def test_pose_kernel_batched_equals_single_launches(dev):
    """n_problems = 3 in one launch (one block each) equals three launches of
    one problem, bit for bit."""
    cfg = gn.BAConfig()
    probs = [chip_smoke.tracking_problem(seed, 200, 7, n_masked_points=56, device=dev)
             for seed in (21, 22, 23)]
    intr = probs[0][1]
    ops = [pose_gn._operands(p) for p, _, _ in probs]
    stacked = [torch.stack([o[i] for o in ops]) for i in range(11)] + ops[0][11:]
    pose, pin, lin, count = pose_gn._launch(stacked, 256, 7, 3, intr, cfg, 3, 10)
    for i, (p, _, _) in enumerate(probs):
        one = pose_gn.pose_only_fast(p, intr, cfg)
        torch.cuda.synchronize()
        assert torch.equal(pose[i, :9].view(3, 3), one[0].frames.Rwb[0])
        assert torch.equal(pose[i, 9:], one[0].frames.twb[0])
        assert torch.equal(pin[i], one[1][:, 0]) and torch.equal(lin[i], one[2][:, 0])
        assert int(count[i]) == int(one[3])


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [64, 128, 256])
def test_pose_kernel_block_sizes_hold_the_gates(dev, threads):
    """Every instantiated block size holds the plain version's gates at the
    path's shape."""
    problem, intr, _ = chip_smoke.tracking_problem(6, 200, 1, n_masked_points=56,
                                                   mask_lines=True, device=dev)
    pose, pin, lin, count = pose_gn._launch(pose_gn._operands(problem), 256, 1, 1, intr,
                                            gn.BAConfig(), 3, 10, threads=threads)
    got = (problem._replace(frames=problem.frames._replace(
        Rwb=pose[:, :9].view(1, 3, 3), twb=pose[:, 9:])), pin[0, :, None], lin[0, :, None],
        count[0])
    want = pose_gn.pose_only_fast_plain(problem, intr, gn.BAConfig())
    a = chip_smoke.pose_agreement(got, want)
    g = chip_smoke.POSE_GATES
    assert a["t"] <= g["t"] and a["R"] <= g["R"] and a["inlier_agree"] >= g["inlier_agree"], a


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    """Runs anywhere: a tensor on neither the CPU nor a CUDA device raises
    before any build, and never goes down the plain path."""
    q = torch.zeros(2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        attention.flash_mha(q, q, q)


def test_loi_wrapper_refuses_non_cuda_devices():
    """Runs anywhere: operands on neither the CPU nor a CUDA device raise
    before any build, and never go down the plain path."""
    ops = chip_smoke.loi_inputs(np.random.RandomState(9), 1, 3, 4, torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        bilerp.loi_features(*(t.to("meta") for t in ops))


# ---------------------------------------------------------------------------
# the stereo-inertial solves (plain PyTorch) on the card against the CPU
# ---------------------------------------------------------------------------

VI_NOISE = (1e-3, 1e-2, 1e-5, 1e-4)  # the initialization stream's gyr/acc noise and walks


def _vi_tracking_problem(dtype, device):
    """The F=2 tracking layout at the initialization stream's shapes: 400
    keypoints padded to 512 and one masked line seen from frame 1, frame 0
    the fixed keyframe 0.2 s earlier, and one IMU factor whose deltas are
    exact for the true motion and whose information and bias Jacobians come
    from a 200 Hz preintegration at the stream's noise floors (float64 on
    the CPU). Returns (problem, intrinsics, true twb of frame 1)."""
    from airslam_tpu_torch.core.imu import ImuData, Preintegration
    from airslam_tpu_torch.slam.map import preintegration_information

    p1, intr, tj = chip_smoke.tracking_problem(12, 400, 1, n_masked_points=112,
                                               mask_lines=True, dtype=torch.float64)
    Rj = chip_smoke._rodrigues(np.array([0.02, -0.03, 0.01]))
    Ri, ti, vi, vj = np.eye(3), tj - [0.1, 0.0, 0.02], np.array([0.5, 0.0, 0.1]), \
        np.array([0.52, 0.01, 0.1])
    dT, g = 0.2, np.array([0.0, 0.0, -9.81])
    pre = Preintegration(noise=VI_NOISE, dtype=torch.float64, device="cpu")
    pre.add_batch([ImuData(0.005 * k, np.array([0.1, -0.15, 0.05]), np.array([0.3, 0.1, 9.81]))
                   for k in range(41)], 0.0, dT)
    st = pre.state
    info9, walk = preintegration_information(st.cov)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    imu = gn.IMUFactors(
        idx_i=torch.zeros(1, dtype=torch.long), idx_j=torch.ones(1, dtype=torch.long),
        dR=t(Ri.T @ Rj)[None], dV=t(Ri.T @ (vj - vi - g * dT))[None],
        dP=t(Ri.T @ (tj - ti - vi * dT - 0.5 * g * dT * dT))[None],
        JRg=st.JRg[None], JVg=st.JVg[None], JVa=st.JVa[None], JPg=st.JPg[None],
        JPa=st.JPa[None], bg_lin=torch.zeros(1, 3, dtype=torch.float64),
        ba_lin=torch.zeros(1, 3, dtype=torch.float64), dT=t([dT]), info=t(info9[None]),
        info_walk=t(walk[None]), mask=torch.ones(1, dtype=torch.bool))

    def two(a, fill=0.0):  # a column 0 that observes nothing
        return torch.cat([torch.full_like(a, fill), a], dim=1)

    obs0 = two(p1.point_obs)
    obs0[:, 0, 2] = -1.0
    problem = p1._replace(
        frames=gn.FrameStates(Rwb=t(np.stack([Ri, np.eye(3)])), twb=t(np.stack([ti, np.zeros(3)])),
                              vel=t(np.stack([vi, vi])), bg=torch.zeros(2, 3, dtype=torch.float64),
                              ba=torch.zeros(2, 3, dtype=torch.float64)),
        pose_fixed=torch.tensor([True, False]), vel_fixed=torch.tensor([True, False]),
        point_obs=obs0, point_obs_mask=two(p1.point_obs_mask, False),
        line_obs=two(p1.line_obs), line_obs_stereo=two(p1.line_obs_stereo, False),
        line_obs_mask=two(p1.line_obs_mask, False), line_obs_sigma=two(p1.line_obs_sigma, 0.8),
        imu=imu)

    def move(x):
        if not torch.is_tensor(x):
            return x
        return x.to(device, dtype) if x.is_floating_point() else x.to(device)

    return (problem._replace(frames=gn.FrameStates(*map(move, problem.frames)),
                             imu=gn.IMUFactors(*map(move, imu)),
                             **{k: move(getattr(problem, k)) for k in gn.BAProblem._fields
                                if k not in ("frames", "imu")}), intr, tj)


@pytest.mark.cuda
def test_vi_tracking_solve_on_the_card_vs_cpu_f64(dev):
    """The F=2 VI solve in float32 on the card against the same function in
    float64 on the CPU: chip_smoke.py's pose gates (t 2e-3, R 1e-3, inlier
    agreement 0.98, counts within 2 %), the velocity within 1e-2 m/s, the
    true pose within 5e-3 m; no kernel P launch."""
    from airslam_tpu_torch.backend import windows

    want_p, intr, tj = _vi_tracking_problem(torch.float64, "cpu")
    got_p, _, _ = _vi_tracking_problem(torch.float32, dev)
    before = pose_gn.pose_only_fast.launches
    got = windows.pose_only_optimization(got_p, intr, vi_tracking=True)
    want = windows.pose_only_optimization(want_p, intr, vi_tracking=True)
    assert pose_gn.pose_only_fast.launches == before
    def frame1(res):  # frame 1's pose and inlier columns, on the CPU in float64
        out, p_in, l_in, n = res
        frames = gn.FrameStates(*(x[1:].double().cpu() for x in out.frames))
        return out._replace(frames=frames), p_in[:, 1:].cpu(), l_in[:, 1:].cpu(), n.cpu()

    a = chip_smoke.pose_agreement(frame1(got), frame1(want))
    g = chip_smoke.POSE_GATES
    assert a["t"] <= g["t"] and a["R"] <= g["R"], a
    assert a["inlier_agree"] >= g["inlier_agree"] and a["count_rel"] <= g["count_rel"], a
    dv = float((got[0].frames.vel[1].double().cpu() - want[0].frames.vel[1]).abs().max())
    assert dv <= 1e-2, dv
    assert np.linalg.norm(got[0].frames.twb[1].double().cpu().numpy() - tj) < g["t_true"]


def _init_inputs():
    """Inputs of the IMU initialization over ten keyframes 0.4 s apart on a
    smooth 6-dof trajectory (float64 numpy, 200 Hz IMU with biases), seeded
    as ``Map.initialize_imu`` seeds them (closed-form gyro bias, velocities
    and gravity), all on the CPU in float64."""
    from scipy.spatial.transform import Rotation

    from airslam_tpu_torch.backend import windows
    from airslam_tpu_torch.core.imu import ImuData, Preintegration
    from airslam_tpu_torch.slam.map import preintegration_information

    bg, ba, gw = np.array([0.01, -0.015, 0.02]), np.array([0.03, -0.02, 0.05]), 9.81
    times = np.arange(0, 3.6 + 1e-9, 0.005)

    def pose(t):
        p = np.array([0.5 * np.sin(0.8 * t) + 0.25 * t, 0.3 * np.sin(0.6 * t + 1.0),
                      0.2 * np.sin(0.5 * t)])
        rv = np.array([0.1 * np.sin(0.3 * t), 0.1 * np.sin(0.4 * t), 0.2 * np.sin(0.25 * t)])
        return Rotation.from_rotvec(rv).as_matrix(), p

    R = np.stack([pose(t)[0] for t in times])
    p = np.stack([pose(t)[1] for t in times])
    h = 1e-4
    acc_w = np.stack([(pose(t + h)[1] - 2 * pose(t)[1] + pose(t - h)[1]) / h ** 2 for t in times])
    acc = np.einsum("nji,nj->ni", R, acc_w - [0, 0, -gw]) + ba
    gyr = np.stack([Rotation.from_matrix(R[i].T @ R[i + 1]).as_rotvec() / 0.005
                    for i in range(len(times) - 1)] + [np.zeros(3)]) + bg
    gyr[-1] = gyr[-2]
    kf = np.arange(0, len(times), 80)
    pres = []
    for a, b in zip(kf[:-1], kf[1:]):
        pre = Preintegration(noise=VI_NOISE, dtype=torch.float64, device="cpu")
        pre.add_batch([ImuData(times[i], gyr[i], acc[i]) for i in range(a, b + 1)],
                      times[a], times[b])
        pres.append(pre)

    def stack(key):
        return torch.stack([getattr(q.state, key) for q in pres])

    Rwb, twb = torch.as_tensor(R[kf]), torch.as_tensor(p[kf])
    dbg = windows.compute_gyr_bias(Rwb, stack("dR"), stack("JRg")).numpy()
    for q in pres:
        q.set_bias(dbg, np.zeros(3))
    vels, gravity = windows.compute_velocity(Rwb, twb, stack("dP"), stack("dV"), stack("dT"), gw)
    preint = {k: stack(k) for k in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "dT")}
    preint["info"] = torch.as_tensor(np.stack([preintegration_information(q.state.cov)[0]
                                               for q in pres]))
    z = torch.zeros(3, dtype=torch.float64)
    args = (Rwb, twb, vels, torch.as_tensor(dbg), z, windows.gravity_to_rwg(gravity), preint, gw,
            torch.as_tensor(dbg), z)
    return args, bg, ba


@pytest.mark.cuda
def test_imu_initialization_on_the_card_vs_cpu_f64(dev):
    """``imu_initialization``'s 200 LM iterations in float32 on the card
    (the information matrices from the noise floors reach about 1e8)
    against float64 on the CPU: velocities within 1e-2 m/s, the gyro bias
    within 5e-4 rad/s, the acc bias within 2e-2 m/s², Rwg within 1e-3; the
    card's gyro bias within 2e-3 of the truth."""
    from airslam_tpu_torch.backend import windows

    args, bg_true, _ = _init_inputs()
    want = windows.imu_initialization(*args)

    def card(x):
        if isinstance(x, dict):
            return {k: card(v) for k, v in x.items()}
        return x.to(dev, torch.float32) if torch.is_tensor(x) else x

    got = windows.imu_initialization(*(card(a) for a in args))
    gaps = [float((g.double().cpu() - w).abs().max()) for g, w in zip(got, want)]
    assert gaps[0] <= 1e-2 and gaps[1] <= 5e-4 and gaps[2] <= 2e-2 and gaps[3] <= 1e-3, gaps
    assert np.abs(got[1].double().cpu().numpy() - bg_true).max() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(chip_smoke.PNP_CASES))
def test_device_pnp_on_the_card(dev, name):
    """``backend/pnp.solve_pnp_ransac`` on the card: tests/test_pnp.py's case
    under its tolerances with a CUDA generator, and in float64 with the same
    minimal sets as the CPU within 1e-6 (the degenerate five-point case
    only finite)."""
    from airslam_tpu_torch.backend import pnp

    case, seed = chip_smoke.pnp_named(name)
    intr, _, _, pts, uv, m, _ = case
    t = [torch.as_tensor(a, device=dev) for a in (pts, uv, m)]
    R, tt, inl, ok = pnp.solve_pnp_ransac(*t, intr,
                                          generator=torch.Generator(device=dev).manual_seed(seed))
    assert chip_smoke._pnp_check(name, R.cpu().numpy(), tt.cpu().numpy(), inl.cpu().numpy(),
                                 bool(ok), case)
    if name != "too_few_points":
        samples = pnp.draw_samples(torch.as_tensor(m), 128, torch.Generator().manual_seed(seed))
        on_card = pnp.solve_pnp_ransac(*t, intr, samples=samples)
        on_cpu = pnp.solve_pnp_ransac(*(torch.as_tensor(a) for a in (pts, uv, m)), intr,
                                      samples=samples)
        for a, b in zip(on_card[:2], on_cpu[:2]):
            assert float((a.cpu() - b).abs().max()) <= 1e-6
        assert torch.equal(on_card[2].cpu(), on_cpu[2])


def _backward_inputs(shape, rng, dev):
    """Kernel B+T′'s operands: the training and VO shapes, one view, one
    line, and ``chip_smoke.crowded_loi_inputs``' cases (every endpoint on
    one texel row, over two passes of the row owners' list; on one texel;
    lines beyond every border)."""
    if shape in chip_smoke.LOI_BACKWARD_CASES:
        return chip_smoke.crowded_loi_inputs(rng, 2, dev, shape)
    return {"train": lambda: chip_smoke.train_loi_inputs(rng, 8, dev),
            "vo": lambda: chip_smoke.loi_inputs(rng, 2, 512, 300, torch.float32, dev),
            "one_view": lambda: chip_smoke.train_loi_inputs(rng, 1, dev),
            "one_line": lambda: chip_smoke.train_loi_inputs(rng, 3, dev, n_lines=1)}[shape]()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["train", "vo", "one_view", "one_line", "one_row", "one_texel",
                                   "beyond_borders"])
def test_loi_backward_kernel_equals_autograd_through_plain(dev, shape):
    """Kernel B+T′ against autograd through ``loi_features_plain`` (map
    gradients within 1e-5 of the largest |gradient|, the ramps' within 1e-4
    of theirs: both sum in another order), and the autograd function
    behind ``loi_features`` gives the plain forward's rows (f32 maps and
    output: within 1e-5, ``chip_smoke.loi_gate``) and the kernel's
    gradients, and counts one forward and one backward launch."""
    rng = np.random.RandomState(len(shape))
    ops = _backward_inputs(shape, rng, dev)
    v, n = ops[5].shape[:2]
    grad = torch.as_tensor(rng.randn(v, n, 496).astype(np.float32), device=dev)
    got = bilerp.loi_features_backward(grad, *ops)
    want = bilerp.loi_features_backward_plain(grad, *ops)
    for a, b, tol in zip(got, want, (1e-5,) * 3 + (1e-4,) * 2):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())
    leaves = [t.detach().clone().requires_grad_(True) for t in (ops[0], ops[1], ops[2], ops[7],
                                                                ops[8])]
    fwd, bwd = bilerp.loi_features.launches, bilerp.loi_features_backward.launches
    out = bilerp.loi_features(leaves[0], leaves[1], leaves[2], *ops[3:7], leaves[3], leaves[4])
    err, tol, ok = chip_smoke.loi_gate(
        out.detach(), bilerp.loi_features_plain(*ops, out_dtype=torch.float32), ops[0])
    assert ok, f"forward {err} > {tol}"
    out.backward(grad)
    assert (bilerp.loi_features.launches, bilerp.loi_features_backward.launches) == (fwd + 1,
                                                                                     bwd + 1)
    for leaf, g in zip(leaves, got):
        torch.testing.assert_close(leaf.grad, g, rtol=0, atol=1e-4 * float(g.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["train", "one_row"])
def test_loi_backward_kernel_is_deterministic(dev, shape):
    """Kernel B+T′ writes each texel of ``d_loi`` once, summing in the row
    owner's list order: two calls give the same bits."""
    rng = np.random.RandomState(11)
    ops = _backward_inputs(shape, rng, dev)
    grad = torch.as_tensor(rng.randn(ops[5].shape[0], ops[5].shape[1], 496).astype(np.float32),
                           device=dev)
    first = bilerp.loi_features_backward(grad, *ops)[0]
    assert torch.equal(bilerp.loi_features_backward(grad, *ops)[0], first)


@pytest.mark.cuda
def test_fast_head_detector_on_the_card_vs_cpu(dev):
    """The detector with the fast stage-1 head and the stored JAX seeded
    weights (``torch_tools_oracle.npz``) on the card, f32 with TF32 off,
    against the port's CPU run on the same pair, both views at the card's
    f32 frontend gates (``chip_smoke.DETECT_GATES``: cuDNN's convolutions
    round otherwise than the CPU's, and the seeded head's scores sit near
    the 0.5 threshold); ``loi_features`` is not launched (the fast head
    samples in plain PyTorch)."""
    from airslam_tpu_torch.frontend.detector import DetectorConfig, FeatureDetector

    z = np.load(chip_smoke.TOOLS_ORACLE)
    frames, _ = chip_smoke.oracle_pairs()
    cfg = DetectorConfig(loi_head="fast", use_superpoint=False, **chip_smoke.TOOLS_FAST)
    params = {"loi": chip_smoke.tools_loi_params(z)}
    with chip_smoke._no_tf32("f32"):
        before = bilerp.loi_features.launches
        got = FeatureDetector(cfg, device=dev, params=params).detect(frames[0],
                                                                     detect_junctions=True)
        assert bilerp.loi_features.launches == before
    want = FeatureDetector(cfg, device="cpu", params=params).detect(frames[0],
                                                                    detect_junctions=True)
    for v in range(2):
        m = chip_smoke.detection_metrics(
            {k: getattr(want, k)[v].numpy() for k in chip_smoke.TOOLS_FIELDS},
            {k: getattr(got, k)[v].cpu().numpy() for k in chip_smoke.TOOLS_FIELDS})
        assert all(m[k] >= g for k, g in chip_smoke.DETECT_GATES.items()), m
    assert int(want.line_mask.sum()) > 50


@pytest.mark.cuda
def test_loi_backward_kernel_refusals(dev):
    """bf16 maps and a wrongly shaped gradient raise."""
    ops = chip_smoke.train_loi_inputs(np.random.RandomState(4), 2, dev)
    grad = torch.randn(2, 165, 496, device=dev)
    with pytest.raises(ValueError):
        bilerp.loi_features_backward(grad, *(t.to(torch.bfloat16) for t in ops[:3]), *ops[3:])
    with pytest.raises(ValueError):
        bilerp.loi_features_backward(grad[:, :100].contiguous(), *ops)


def test_loi_backward_refuses_non_cuda_devices():
    """Runs anywhere: operands on neither the CPU nor a CUDA device raise
    before any build, and never go down the plain path."""
    ops = chip_smoke.train_loi_inputs(np.random.RandomState(9), 1, "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        bilerp.loi_features_backward(torch.zeros(1, 165, 496, device="meta"),
                                     *(t.to("meta") for t in ops))
