"""Map-scale bundle adjustment — the sparse observation-list formulation.

Port of ``airslam_tpu/backend/global_ba.py`` (the ``GlobalBA`` equivalent,
g2o_optimization.cc:1488-1959). ``backend/gn.py`` models the sliding window
as dense (landmark × frame) grids; at map scale (1,000 keyframes, 100k
points) those grids cannot be represented, so here:

- observations are a flat padded list (N,) of (point index, frame index,
  uv); residuals and Jacobians are one ``vmap(jacfwd)`` over N;
- per-point 3×3 and per-frame 6×6 blocks accumulate with scatter-adds;
- the Schur complement pairs the observations of one landmark through a
  per-landmark observation table (P, K) and accumulates the (F, F, 6, 6)
  reduced camera matrix in blocks of chunk·K² pairs (bounded memory); the
  table's padding is dropped once per solve (:func:`schur_pairs`), so no
  exact zeros are scattered;
- the reduced 6F system (15F with IMU factors, gravity pinned) is solved
  dense by Cholesky after Jacobi scaling;
- landmark updates back-substitute in one batched op.

Every scatter-add is ``index_add_`` over a flattened index under
``gn.deterministic()``, so on the card the sums run in a fixed (sorted-key)
order and two runs give the same bits, where the atomic form does not. The
LM loop reads nothing back to the host: accept and reject are
``torch.where`` on device scalars. Residuals and Jacobians are evaluated in
the problem's type, the normal equations in float64 (``ACC``); float32
products run in full precision (TF32 off).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from airslam_tpu_torch.backend import gn
from airslam_tpu_torch.backend import residuals as res
from airslam_tpu_torch.backend.gn import BAConfig, IMUFactors
from airslam_tpu_torch.core import lie
from airslam_tpu_torch.parallel.mesh import even_bounds, reduce_sum

POSE_DIM = 6
FRAME_DIM = 15  # pose 6 + vel 3 + bias 6 (VI maps)
# the normal equations' type: a float32 map's chain of keyframes and its
# barely constrained points leave the float32 Schur complement centimetres
# off the float64 solve (the JAX package's float32 solver too); float64
# accumulation on the card holds it to micrometres
ACC = torch.float64


class SparseBAProblem(NamedTuple):
    # frames
    Rwb: torch.Tensor  # (F, 3, 3)
    twb: torch.Tensor  # (F, 3)
    pose_fixed: torch.Tensor  # (F,) bool
    # points + their observations
    points: torch.Tensor  # (P, 3)
    pobs_pidx: torch.Tensor  # (N,) int64 — point index per observation
    pobs_fidx: torch.Tensor  # (N,) int64
    pobs: torch.Tensor  # (N, 3) (u, v, u_r); u_r < 0 ⇒ mono
    pobs_mask: torch.Tensor  # (N,) bool
    point_obs_table: torch.Tensor  # (P, K) int64 indices into pobs_*; == N ⇒ pad
    # lines + their observations
    lines: torch.Tensor  # (L, 6) Plücker
    lobs_lidx: torch.Tensor  # (M,)
    lobs_fidx: torch.Tensor  # (M,)
    lobs: torch.Tensor  # (M, 8)
    lobs_stereo: torch.Tensor  # (M,) bool
    lobs_mask: torch.Tensor  # (M,)
    lobs_sigma: torch.Tensor  # (M,)
    line_obs_table: torch.Tensor  # (L, K2)
    # camera
    Rcb: torch.Tensor
    tcb: torch.Tensor
    # visual-inertial state (None ⇒ vision-only): the reduced system grows to
    # 15 dof a frame and the preintegration chain couples consecutive
    # keyframes in it; gravity is pinned (GlobalBA runs after the VI
    # initialization aligned the world frame)
    vel: Optional[torch.Tensor] = None  # (F, 3)
    bg: Optional[torch.Tensor] = None  # (F, 3)
    ba: Optional[torch.Tensor] = None  # (F, 3)
    vel_fixed: Optional[torch.Tensor] = None  # (F,) bool
    Rwg: Optional[torch.Tensor] = None  # (3, 3)
    imu: Optional[IMUFactors] = None
    g_value: float = 9.81


_INDEX_LEAVES = ("pobs_pidx", "pobs_fidx", "point_obs_table", "lobs_lidx", "lobs_fidx",
                 "line_obs_table", "idx_i", "idx_j")
_BOOL_LEAVES = ("pose_fixed", "pobs_mask", "lobs_stereo", "lobs_mask", "vel_fixed", "mask")


def problem_from_numpy(prob, dtype=torch.float64, device="cpu") -> SparseBAProblem:
    """A ``SparseBAProblem`` of tensors from one whose leaves ``np.asarray``
    reads (the JAX package's problem pulled to the host, or numpy arrays):
    float leaves in ``dtype``, masks bool, indices int64, on ``device``; the
    IMU factors' leaves too."""

    def leaf(name, value):
        if value is None:
            return None
        a = np.asarray(value)
        if name in _BOOL_LEAVES:
            return torch.as_tensor(a.astype(bool), device=device)
        if name in _INDEX_LEAVES:
            return torch.as_tensor(a.astype(np.int64), device=device)
        return torch.as_tensor(a.astype(np.float64), device=device).to(dtype)

    imu = getattr(prob, "imu", None)
    if imu is not None:
        imu = gn.IMUFactors(*(leaf(n, getattr(imu, n)) for n in gn.IMUFactors._fields))
    fields = {n: leaf(n, getattr(prob, n, None)) for n in SparseBAProblem._fields
              if n not in ("imu", "g_value")}
    return SparseBAProblem(imu=imu, g_value=float(np.asarray(prob.g_value)), **fields)


def _segment_add(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Σ of ``vals`` rows into ``n`` rows by ``idx``, in a fixed order."""
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    with gn.deterministic():
        return out.index_add_(0, idx, vals)


def _point_rj(prob: SparseBAProblem, intr, with_jac: bool):
    """Per-observation residual (N, 3), row mask, depth flag and, with
    ``with_jac``, J wrt (pose 6 | point 3) as (Jc (N, 3, 6), Jp (N, 3, 3))."""
    dtype, dev = prob.points.dtype, prob.points.device

    def one(Rwb, twb, point, obs):
        def f(delta):
            R2, t2 = res.retract_pose(Rwb, twb, delta[0:6])
            Rcw, tcw = res.pose_to_camera(R2, t2, prob.Rcb, prob.tcb)
            return res.point_residual(Rcw, tcw, point + delta[6:9], obs, intr)

        if with_jac:
            J, (r, z) = gn._jac_with_value(f, 9, dtype, dev)
            return r, z, J.to(dtype)
        return f(torch.zeros(9, dtype=dtype, device=dev))

    fi, pi = prob.pobs_fidx, prob.pobs_pidx
    out = torch.func.vmap(one)(prob.Rwb[fi], prob.twb[fi], prob.points[pi], prob.pobs)
    r, z = out[0], out[1]
    m = prob.pobs_mask
    row_mask = torch.stack([m, m, m & (prob.pobs[:, 2] >= 0)], dim=-1).to(r.dtype)
    if with_jac:
        return r, row_mask, z > 0, out[2][..., 0:6], out[2][..., 6:9]
    return r, row_mask, z > 0, None, None


def _line_rj(prob: SparseBAProblem, intr, with_jac: bool):
    dtype, dev = prob.lines.dtype, prob.lines.device

    def one(Rwb, twb, line, obs):
        def f(delta):
            R2, t2 = res.retract_pose(Rwb, twb, delta[0:6])
            Rcw, tcw = res.pose_to_camera(R2, t2, prob.Rcb, prob.tcb)
            line2 = lie.line_orthonormal_oplus(line, delta[6:10])
            r = res.line_residual(Rcw, tcw, line2, obs, intr)
            return r, r

        if with_jac:
            J, (r, _) = gn._jac_with_value(f, 10, dtype, dev)
            return r, J.to(dtype)
        return (f(torch.zeros(10, dtype=dtype, device=dev))[0],)

    fi, li = prob.lobs_fidx, prob.lobs_lidx
    out = torch.func.vmap(one)(prob.Rwb[fi], prob.twb[fi], prob.lines[li], prob.lobs)
    r = out[0]
    m, st = prob.lobs_mask, prob.lobs_mask & prob.lobs_stereo
    row_mask = torch.stack([m, m, st, st], dim=-1).to(r.dtype)
    if with_jac:
        return r, row_mask, out[1][..., 0:6], out[1][..., 6:10]
    return r, row_mask, None, None


def point_chi2(prob: SparseBAProblem, intr):
    r, row_mask, depth_ok, _, _ = _point_rj(prob, intr, with_jac=False)
    return (r * r * row_mask).sum(-1), depth_ok


def line_chi2(prob: SparseBAProblem, intr):
    r, row_mask, _, _ = _line_rj(prob, intr, with_jac=False)
    return (r * r * row_mask).sum(-1) * prob.lobs_sigma


def _frame_states(prob: SparseBAProblem) -> gn.FrameStates:
    return gn.FrameStates(Rwb=prob.Rwb, twb=prob.twb, vel=prob.vel, bg=prob.bg, ba=prob.ba)


def _thresholds(prob: SparseBAProblem, cfg: BAConfig, dtype):
    pthr = gn._thresholds(prob.pobs[:, 2] >= 0, cfg.stereo_point, cfg.mono_point, dtype)
    lthr = gn._thresholds(prob.lobs_stereo, cfg.stereo_line, cfg.mono_line, dtype)
    return pthr, lthr


def _point_cost(prob: SparseBAProblem, intr, cfg: BAConfig, robust: bool):
    pchi2, _ = point_chi2(prob, intr)
    pthr = gn._thresholds(prob.pobs[:, 2] >= 0, cfg.stereo_point, cfg.mono_point, pchi2.dtype)
    if robust:
        return gn._huber_cost(pchi2, pthr, prob.pobs_mask)
    return torch.where(prob.pobs_mask, pchi2, torch.zeros_like(pchi2)).sum()


def _line_cost(prob: SparseBAProblem, intr, cfg: BAConfig, robust: bool):
    lchi2 = line_chi2(prob, intr)
    lthr = gn._thresholds(prob.lobs_stereo, cfg.stereo_line, cfg.mono_line, lchi2.dtype)
    if robust:
        return gn._huber_cost(lchi2, lthr, prob.lobs_mask)
    return torch.where(prob.lobs_mask, lchi2, torch.zeros_like(lchi2)).sum()


def _total_cost(prob: SparseBAProblem, intr, cfg: BAConfig, robust: bool, shards=None):
    """The LM cost; with ``shards`` (:func:`observation_shards`) each
    shard's landmark terms on its device, summed on the problem's, and the
    IMU terms once."""
    pshards, lshards = (shards.bind(prob) if shards is not None
                        else ([(prob, None)], [(prob, None)]))
    dev = prob.points.device
    cost = (reduce_sum([_point_cost(sh, intr, cfg, robust) for sh, _ in pshards], dev)
            + reduce_sum([_line_cost(sh, intr, cfg, robust) for sh, _ in lshards], dev))
    if prob.imu is not None:
        r, _ = gn.imu_residuals(_frame_states(prob), prob.imu, prob.Rwg, False, prob.g_value)
        r9, rw = r[:, :9], r[:, 9:15]
        m = prob.imu.mask
        c_imu = torch.einsum("ki,kij,kj->k", r9, prob.imu.info * cfg.imu_info_scale, r9)
        c_walk = torch.einsum("ki,kij,kj->k", rw, prob.imu.info_walk, rw)
        if robust:
            cost = cost + gn._huber_cost(c_imu, torch.full_like(c_imu, 16.92), m)
        else:
            cost = cost + torch.where(m, c_imu, torch.zeros_like(c_imu)).sum()
        cost = cost + torch.where(m, c_walk, torch.zeros_like(c_walk)).sum()
    return cost


def schur_pairs(table: torch.Tensor, n_obs: int):
    """What the Schur complement sums over, from a landmark observation table
    (L, K) (entries == ``n_obs`` are padding): every ordered pair of one
    landmark's real observations as (landmark, observation a, observation b),
    and every real entry as (landmark, observation). The topology does not
    change while a problem is solved, so :func:`optimize` finds these once
    (one read-back) and the LM loop scatters no padding: the JAX package's
    padded (chunk, K, K) blocks add exact zeros, all into frame 0's block."""
    valid = table < n_obs
    p, k, l = torch.nonzero(valid[:, :, None] & valid[:, None, :], as_tuple=True)
    vp, vk = torch.nonzero(valid, as_tuple=True)
    return p, table[p, k], table[p, l], vp, table[vp, vk]


def _schur_accumulate(W, Hinv, bland, pairs, fidx, f: int, block: int):
    """S (F, F, 6, 6) and bs (F, 6): Σ over the pairs (p, a, b) of
    W_a Hinv_p W_bᵀ into frames (f_a, f_b), and Σ over the entries (p, a) of
    W_a Hinv_p b_p into frame f_a. W: (N, 6, tan) per-observation cross
    blocks; Hinv: (L, tan, tan); bland: (L, tan); fidx: (N,) frame per
    observation. ``block`` pairs at a time (bounded memory); each block goes
    into the flattened S by one ``index_add_`` in a fixed order."""
    pp, a, b, vp, va = pairs
    dtype, dev = W.dtype, W.device
    S = torch.zeros(f * f * POSE_DIM * POSE_DIM, dtype=dtype, device=dev)
    bs = torch.zeros(f * POSE_DIM, dtype=dtype, device=dev)
    cols = torch.arange(POSE_DIM * POSE_DIM, device=dev)
    rows6 = torch.arange(POSE_DIM, device=dev)
    with gn.deterministic():
        for s in range(0, pp.shape[0], block):
            p_, a_, b_ = pp[s:s + block], a[s:s + block], b[s:s + block]
            WH = torch.einsum("nat,nts->nas", W[a_], Hinv[p_])
            Spair = torch.einsum("nas,nbs->nab", WH, W[b_])  # (n, 6, 6)
            key = (fidx[a_] * f + fidx[b_]) * (POSE_DIM * POSE_DIM)
            S.index_add_(0, (key[:, None] + cols).reshape(-1), Spair.reshape(-1))
        for s in range(0, vp.shape[0], block):
            p_, a_ = vp[s:s + block], va[s:s + block]
            bpair = torch.einsum("nat,nts,ns->na", W[a_], Hinv[p_], bland[p_])
            bs.index_add_(0, (fidx[a_][:, None] * POSE_DIM + rows6).reshape(-1),
                          bpair.reshape(-1))
    return S.reshape(f, f, POSE_DIM, POSE_DIM), bs.reshape(f, POSE_DIM)


def _blockdiag(blocks):
    f, k, _ = blocks.shape
    eye = torch.eye(f, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("fg,fij->figj", eye, blocks).reshape(f * k, f * k)


def _imu_system(prob: SparseBAProblem, cfg: BAConfig, robust: bool, Hvis, bvis, pose_free):
    """The VI reduced system (15F)²: the visual pose system embedded in the
    pose sub-blocks and every preintegration / bias-walk factor's 30×30
    block scattered over its two frames (gravity pinned)."""
    f = prob.Rwb.shape[0]
    dtype, dev = Hvis.dtype, Hvis.device
    D = f * FRAME_DIM
    pose_cols = (torch.arange(f, device=dev)[:, None] * FRAME_DIM
                 + torch.arange(POSE_DIM, device=dev)[None, :]).reshape(-1)
    Hred = torch.zeros(D * D, dtype=dtype, device=dev)
    bred = torch.zeros(D, dtype=dtype, device=dev)
    key = (pose_cols[:, None] * D + pose_cols[None, :]).reshape(-1)
    with gn.deterministic():
        Hred.index_add_(0, key, Hvis.reshape(-1))
        bred.index_add_(0, pose_cols, bvis.reshape(-1))

    imu = prob.imu
    ir, iJ = (x.to(dtype) for x in gn.imu_residuals(_frame_states(prob), imu, prob.Rwg, True,
                                                     prob.g_value))
    n_k = ir.shape[0]
    info9 = imu.info.to(dtype) * cfg.imu_info_scale
    if robust:
        c_imu = torch.einsum("ki,kij,kj->k", ir[:, :9], info9, ir[:, :9])
        wi = res.huber_weight(c_imu, torch.full_like(c_imu, 16.92))
    else:
        wi = torch.ones(n_k, dtype=dtype, device=dev)
    wi = wi * imu.mask
    big_info = torch.zeros((n_k, 15, 15), dtype=dtype, device=dev)
    big_info[:, :9, :9] = info9 * wi[:, None, None]
    big_info[:, 9:15, 9:15] = imu.info_walk.to(dtype) * imu.mask[:, None, None].to(dtype)

    vel_free = (~prob.vel_fixed).to(dtype)
    ii, jj = imu.idx_i.long(), imu.idx_j.long()
    frame_cols = torch.cat([pose_free[:, None].expand(f, POSE_DIM),
                            vel_free[:, None].expand(f, FRAME_DIM - POSE_DIM)], dim=1)
    cm = torch.cat([frame_cols[ii], frame_cols[jj],
                    torch.zeros((n_k, 2), dtype=dtype, device=dev)], dim=1)
    iJ = iJ * cm[:, None, :]
    JtW = torch.einsum("krc,krs->ksc", iJ, big_info)  # (K, 15, 32)
    Hk = torch.einsum("ksc,ksd->kcd", JtW, iJ)[:, :30, :30]
    bk = -torch.einsum("ksc,ks->kc", JtW, ir)[:, :30]
    ar = torch.arange(FRAME_DIM, device=dev)
    cols = torch.cat([ii[:, None] * FRAME_DIM + ar, jj[:, None] * FRAME_DIM + ar], dim=1)
    with gn.deterministic():
        Hred.index_add_(0, (cols[:, :, None] * D + cols[:, None, :]).reshape(-1), Hk.reshape(-1))
        bred.index_add_(0, cols.reshape(-1), bk.reshape(-1))
    return Hred.reshape(D, D), bred


def _point_system(prob: SparseBAProblem, intr, cfg: BAConfig, lam, robust: bool, chunk: int,
                  pairs):
    """The point observations' share of one LM solve, in ``ACC``: (Hcc
    (F, 6, 6), bc (F, 6), the Schur terms S (F, F, 6, 6) and bs (F, 6), and
    what the back-substitution needs)."""
    f, p = prob.Rwb.shape[0], prob.points.shape[0]
    dtype = ACC
    pose_free = (~prob.pose_fixed).to(dtype)
    pthr = gn._thresholds(prob.pobs[:, 2] >= 0, cfg.stereo_point, cfg.mono_point, dtype)
    r, row_mask, _, Jc, Jp = _point_rj(prob, intr, True)
    r, row_mask, Jc, Jp = (x.to(dtype) for x in (r, row_mask, Jc, Jp))
    chi2 = (r * r * row_mask).sum(-1)
    w = res.huber_weight(chi2, pthr) if robust else torch.ones_like(chi2)
    w = w * prob.pobs_mask
    Jc = Jc * row_mask[..., None] * pose_free[prob.pobs_fidx][:, None, None]
    Jp = Jp * row_mask[..., None]
    rw = r * row_mask
    Hcc = _segment_add(f, prob.pobs_fidx, torch.einsum("n,nri,nrj->nij", w, Jc, Jc))
    bc = _segment_add(f, prob.pobs_fidx, -torch.einsum("n,nri,nr->ni", w, Jc, rw))
    Hpp = _segment_add(p, prob.pobs_pidx, torch.einsum("n,nri,nrj->nij", w, Jp, Jp))
    bp = _segment_add(p, prob.pobs_pidx, -torch.einsum("n,nri,nr->ni", w, Jp, rw))
    Wcp = torch.einsum("n,nri,nrj->nij", w, Jc, Jp)  # (N, 6, 3)
    Hpp_inv = gn.inv3_spd(gn._damped_landmarks(Hpp, 3, lam.to(Hpp.device, dtype)))
    S, bs = _schur_accumulate(Wcp, Hpp_inv, bp, pairs, prob.pobs_fidx, f,
                              chunk * prob.point_obs_table.shape[1] ** 2)
    return Hcc, bc, S, bs, (Wcp, Hpp_inv, bp, prob.pobs_pidx, prob.pobs_fidx)


def _line_system(prob: SparseBAProblem, intr, cfg: BAConfig, lam, robust: bool, chunk: int,
                 pairs):
    """The line observations' share, as :func:`_point_system`'s."""
    f, l = prob.Rwb.shape[0], prob.lines.shape[0]
    dtype = ACC
    pose_free = (~prob.pose_fixed).to(dtype)
    lthr = gn._thresholds(prob.lobs_stereo, cfg.stereo_line, cfg.mono_line, dtype)
    lr, lrow, LJc, LJl = (x.to(dtype) for x in _line_rj(prob, intr, True))
    lsig = prob.lobs_sigma.to(dtype)
    lchi2 = (lr * lr * lrow).sum(-1) * lsig
    lw = res.huber_weight(lchi2, lthr) if robust else torch.ones_like(lchi2)
    lw = lw * prob.lobs_mask * lsig
    LJc = LJc * lrow[..., None] * pose_free[prob.lobs_fidx][:, None, None]
    LJl = LJl * lrow[..., None]
    lrw = lr * lrow
    Hcc = _segment_add(f, prob.lobs_fidx, torch.einsum("n,nri,nrj->nij", lw, LJc, LJc))
    bc = _segment_add(f, prob.lobs_fidx, -torch.einsum("n,nri,nr->ni", lw, LJc, lrw))
    Hll = _segment_add(l, prob.lobs_lidx, torch.einsum("n,nri,nrj->nij", lw, LJl, LJl))
    bl = _segment_add(l, prob.lobs_lidx, -torch.einsum("n,nri,nr->ni", lw, LJl, lrw))
    Wcl = torch.einsum("n,nri,nrj->nij", lw, LJc, LJl)  # (M, 6, 4)
    Hll_inv = gn.inv4_spd(gn._damped_landmarks(Hll, 4, lam.to(Hll.device, dtype)))
    S, bs = _schur_accumulate(Wcl, Hll_inv, bl, pairs, prob.lobs_fidx, f,
                              chunk * prob.line_obs_table.shape[1] ** 2)
    return Hcc, bc, S, bs, (Wcl, Hll_inv, bl, prob.lobs_lidx, prob.lobs_fidx)


def _back_substitute(back, dxc):
    """A landmark family's step: Hinv (b − Σ_obs Wᵀ dxc[frame])."""
    W, Hinv, b, lidx, fidx = back
    contrib = torch.einsum("nij,ni->nj", W, dxc.to(W.device)[fidx])
    return torch.einsum("pij,pj->pi", Hinv, b - _segment_add(b.shape[0], lidx, contrib))


def _assemble_and_solve(prob: SparseBAProblem, intr, cfg: BAConfig, lam, robust: bool,
                        chunk: int, shards):
    """One damped LM solve: residuals and Jacobians in the problem's float
    type, the normal equations, the Schur complement, the reduced solve and
    the back-substitution in float64 (``ACC``). Returns the steps in
    float64: (poses (F, 6), points (P, 3), lines (L, 4), VI or None).
    ``shards`` (:func:`observation_shards`): each shard's landmark blocks,
    Schur sums (``chunk`` landmarks' worth of pairs, chunk·K², at a time)
    and back-substitution on its device, the sums meeting on the problem's
    device in shard order; the reduced solve and the IMU system run once
    there."""
    f = prob.Rwb.shape[0]
    dtype, dev = ACC, prob.points.device
    pose_free = (~prob.pose_fixed).to(dtype)
    lam = lam.to(dtype)
    pshards, lshards = shards.bind(prob)
    pts = [_point_system(sh, intr, cfg, lam, robust, chunk, pr) for sh, pr in pshards]
    lns = [_line_system(sh, intr, cfg, lam, robust, chunk, pr) for sh, pr in lshards]

    def total(fam, i):
        return reduce_sum([t[i] for t in fam], dev)

    Hcc = total(pts, 0) + total(lns, 0)
    bc = total(pts, 1) + total(lns, 1)
    S = total(pts, 2) + total(lns, 2)
    bs = total(pts, 3) + total(lns, 3)

    # -- reduced camera system ------------------------------------------------
    n6 = f * POSE_DIM
    Hvis = _blockdiag(Hcc) - S.permute(0, 2, 1, 3).reshape(n6, n6)
    bvis = (bc - bs).reshape(n6)
    if prob.imu is None:
        Hred, bred = Hvis, bvis
    else:
        Hred, bred = _imu_system(prob, cfg, robust, Hvis, bvis, pose_free)

    diag = torch.diagonal(Hred)
    Hred = Hred + torch.diag((diag < 1e-10).to(dtype) + lam * diag.clamp(min=1.0))
    # Jacobi (symmetric diagonal) scaling: the columns mix pixel² and unitless
    # scales (the JAX package's form, kept for the same steps)
    d = torch.sqrt(torch.diagonal(Hred).clamp(min=1e-12))
    dx = gn.solve_spd(Hred / (d[:, None] * d[None, :]), bred / d) / d
    if prob.imu is None:
        dxc, dvi = dx.reshape(f, POSE_DIM), None
    else:
        dx = dx.reshape(f, FRAME_DIM)
        dxc, dvi = dx[:, 0:6], (dx[:, 6:9], dx[:, 9:12], dx[:, 12:15])

    # -- back-substitute landmarks --------------------------------------------
    dp = torch.cat([_back_substitute(t[4], dxc).to(dev) for t in pts])
    dl = torch.cat([_back_substitute(t[4], dxc).to(dev) for t in lns])
    return dxc, dp, dl, dvi


# ---------------------------------------------------------------------------
# observation shards over a device mesh (parallel/mesh.py)
# ---------------------------------------------------------------------------

_FRAME_LEAVES = ("Rwb", "twb", "pose_fixed", "Rcb", "tcb")
_POINT_OBS = ("pobs_fidx", "pobs", "pobs_mask")
_LINE_OBS = ("lobs_fidx", "lobs", "lobs_stereo", "lobs_mask", "lobs_sigma")


class _Family(NamedTuple):
    """One landmark family's shards: per shard its device, landmark range
    (lo, hi), the indices of its observations in the problem's list (None:
    every observation, unmoved), its re-indexed landmark index and table and
    its Schur pairs."""

    land: str  # "points" | "lines"
    lidx: str  # "pobs_pidx" | "lobs_lidx"
    table: str  # "point_obs_table" | "line_obs_table"
    obs: tuple
    parts: list  # [(device, lo, hi, sel, lidx, table, pairs)]


class ObservationShards(NamedTuple):
    points: _Family
    lines: _Family

    def bind(self, prob: SparseBAProblem):
        """Per family, [(shard problem, Schur pairs)] for the current
        state of ``prob``: each shard's frames and landmarks copied to its
        device, its observation leaves gathered (the masks too: they change
        between the two passes of :func:`global_ba`)."""
        return tuple(_bind(fam, prob) for fam in self)


def _bind(fam: _Family, prob: SparseBAProblem):
    out = []
    for dev, lo, hi, sel, lidx, table, pairs in fam.parts:
        if sel is None:
            out.append((prob, pairs))
            continue
        fields = {k: getattr(prob, k).to(dev) for k in _FRAME_LEAVES}
        fields.update({k: getattr(prob, k)[sel].to(dev) for k in fam.obs})
        fields.update({fam.land: getattr(prob, fam.land)[lo:hi].to(dev), fam.lidx: lidx,
                       fam.table: table})
        out.append((prob._replace(**fields), pairs))
    return out


def _family_shards(prob: SparseBAProblem, land, lidx_name, table_name, obs, devs):
    n = getattr(prob, land).shape[0]
    lidx = getattr(prob, lidx_name)
    table = getattr(prob, table_name)
    n_obs = lidx.shape[0]
    bounds = even_bounds(n, len(devs))
    if len(bounds) == 1:
        return _Family(land, lidx_name, table_name, obs,
                       [(prob.points.device, 0, n, None, None, None, schur_pairs(table, n_obs))])
    parts = []
    lidx_h, table_h = lidx.cpu(), table.cpu()
    for (lo, hi), dev in zip(bounds, devs):
        sel = torch.nonzero((lidx_h >= lo) & (lidx_h < hi))[:, 0]
        inv = torch.full((n_obs + 1,), sel.shape[0], dtype=torch.int64)
        inv[sel] = torch.arange(sel.shape[0])
        loc_table = inv[table_h[lo:hi]].to(dev)
        parts.append((dev, lo, hi, sel.to(prob.points.device), (lidx_h[sel] - lo).to(dev),
                      loc_table, schur_pairs(loc_table, sel.shape[0])))
    return _Family(land, lidx_name, table_name, obs, parts)


def observation_shards(prob: SparseBAProblem, mesh=None) -> ObservationShards:
    """The sparse problem laid out for ``mesh`` (the JAX package's
    ``shard_sparse_problem``): each landmark family's landmarks split over
    the dp devices in contiguous ranges, and with them the observations of
    those landmarks, re-indexed, with their own observation table and Schur
    pairs; a shard's Schur pairs are its own landmarks' (a landmark's
    observations stay on one device). Frames and camera are replicated. A
    family whose landmark count dp does not divide stays whole on the
    problem's device; so does everything without a mesh. The topology is
    read once (one read-back per family)."""
    devs = mesh.dp_devices() if mesh is not None else [prob.points.device]
    return ObservationShards(
        _family_shards(prob, "points", "pobs_pidx", "point_obs_table", _POINT_OBS, devs),
        _family_shards(prob, "lines", "lobs_lidx", "line_obs_table", _LINE_OBS, devs))


def _apply(prob: SparseBAProblem, dxc, dp, dl, dvi) -> SparseBAProblem:
    dt = prob.twb.dtype
    Rwb, twb = torch.func.vmap(res.retract_pose)(prob.Rwb, prob.twb, dxc.to(dt))
    lines = torch.func.vmap(lie.line_orthonormal_oplus)(prob.lines, dl.to(dt))
    out = prob._replace(Rwb=Rwb, twb=twb, points=prob.points + dp.to(dt), lines=lines)
    if dvi is not None:
        dvel, dbg, dba = (d.to(dt) for d in dvi)
        out = out._replace(vel=prob.vel + dvel, bg=prob.bg + dbg, ba=prob.ba + dba)
    return out


_STATE = ("Rwb", "twb", "points", "lines", "vel", "bg", "ba")


def optimize(prob: SparseBAProblem, intr, cfg: BAConfig, iterations: int,
             robust: bool = True, chunk: int = 2048, tau: float = 1e-5,
             mesh=None) -> SparseBAProblem:
    """``iterations`` LM steps (g2o's Levenberg schedule: λ/3 on accept, λ·ν
    and ν·2 on reject), accept/reject on the device. ``mesh``: observations
    and landmarks sharded over its dp devices (:func:`observation_shards`)."""
    shards = observation_shards(prob, mesh)
    with gn.full_f32():
        cost = _total_cost(prob, intr, cfg, robust, shards)
        lam = torch.full((), tau * 100.0, dtype=cost.dtype, device=cost.device)
        nu = torch.full((), 2.0, dtype=cost.dtype, device=cost.device)
        two = torch.full_like(nu, 2.0)
        for _ in range(iterations):
            cand = _apply(prob, *_assemble_and_solve(prob, intr, cfg, lam, robust, chunk, shards))
            new_cost = _total_cost(cand, intr, cfg, robust, shards)
            accept = new_cost < cost  # False for a NaN candidate

            def pick(a, b):
                return torch.where(accept, a, b)

            prob = prob._replace(**{n: pick(getattr(cand, n), getattr(prob, n))
                                    for n in _STATE if getattr(prob, n) is not None})
            lam = pick(lam / 3.0, lam * nu)
            nu = pick(two, nu * 2.0)
            cost = pick(new_cost, cost)
    return prob


def global_ba(prob: SparseBAProblem, intr, cfg: BAConfig = BAConfig(),
              iters1: int = 50, iters2: int = 40, chunk: int = 2048, mesh=None):
    """GlobalBA's two-pass robust schedule: optimize → chi² gate → optimize
    on the inliers → final inlier flags on the original set. Returns
    (problem, point inliers (N,), line inliers (M,)). ``mesh``: both passes
    sharded (:func:`optimize`); the gates are per observation and run on the
    problem's device."""
    prob1 = optimize(prob, intr, cfg, iters1, robust=True, chunk=chunk, mesh=mesh)
    pthr, lthr = _thresholds(prob1, cfg, prob1.points.dtype)

    def inliers(p):
        pchi2, depth_ok = point_chi2(p, intr)
        return ((pchi2 <= pthr) & depth_ok & prob.pobs_mask,
                (line_chi2(p, intr) <= lthr) & prob.lobs_mask)

    p_in, l_in = inliers(prob1)
    gated = optimize(prob1._replace(pobs_mask=p_in, lobs_mask=l_in), intr, cfg, iters2,
                     robust=False, chunk=chunk, mesh=mesh)
    final = gated._replace(pobs_mask=prob.pobs_mask, lobs_mask=prob.lobs_mask)
    p_in, l_in = inliers(final)
    return final, p_in, l_in


def build_obs_table(n_landmarks: int, lidx: np.ndarray, mask: np.ndarray,
                    n_total: int, max_obs: int) -> np.ndarray:
    """Host helper: (P, K) observation-index table (pad = n_total); a
    landmark keeps its first ``max_obs`` observations."""
    table = np.full((n_landmarks, max_obs), n_total, np.int64)
    counts = np.zeros(n_landmarks, np.int64)
    for oi in np.nonzero(mask)[0]:
        li = lidx[oi]
        if counts[li] < max_obs:
            table[li, counts[li]] = oi
            counts[li] += 1
    return table


def dense_to_sparse(prob: gn.BAProblem, max_obs: int = 16, dtype=None) -> SparseBAProblem:
    """The observation-list form of a dense-grid ``gn.BAProblem`` (point
    observations only), on the problem's device; ``dtype`` defaults to the
    problem's. Host-side: hands a window problem to the map-scale solver."""
    dtype = dtype or prob.points.dtype
    dev = prob.points.device
    obs = prob.point_obs.double().cpu().numpy()
    mask = prob.point_obs_mask.cpu().numpy()
    P = mask.shape[0]
    pi, fi = np.nonzero(mask)
    n = len(pi)
    table = build_obs_table(P, pi, np.ones(n, bool), n, max_obs)
    L = prob.lines.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    def fl(x):
        return x.to(dtype)

    return SparseBAProblem(
        Rwb=fl(prob.frames.Rwb), twb=fl(prob.frames.twb), pose_fixed=prob.pose_fixed,
        points=fl(prob.points),
        pobs_pidx=t(pi.astype(np.int64)), pobs_fidx=t(fi.astype(np.int64)),
        pobs=fl(t(obs[pi, fi])), pobs_mask=t(np.ones(n, bool)),
        point_obs_table=t(table),
        lines=fl(prob.lines),
        lobs_lidx=t(np.zeros(1, np.int64)), lobs_fidx=t(np.zeros(1, np.int64)),
        lobs=fl(t(np.zeros((1, 8)))), lobs_stereo=t(np.zeros(1, bool)),
        lobs_mask=t(np.zeros(1, bool)), lobs_sigma=fl(t(np.full(1, 0.001))),
        line_obs_table=t(np.full((L, 1), 1, np.int64)),
        Rcb=fl(prob.Rcb), tcb=fl(prob.tcb), g_value=prob.g_value,
    )
