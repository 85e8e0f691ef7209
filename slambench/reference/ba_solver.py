"""A plain GlobalBA solver: the reference put in the program's place for the
control of the GlobalBA cells.

Levenberg–Marquardt over keyframe poses (R ← R·Exp(φ), t ← t + δt) and
points, with analytic Jacobians of the stereo projection, the points
eliminated by a Schur complement over each point's observation table, and
the reduced 6F system solved dense by Cholesky; the first keyframe fixed.
The schedule is the configuration's: a Huber-robust pass, the χ² gate at the
configuration's thresholds, a second pass on the inliers. Residuals and
Jacobians are computed in ``dtype`` (the configuration's float32, TF32
off), the normal equations in ``acc`` (float64: the reference solves them
above the configuration's precision); the control computes the float32
products in TF32, the precision below the configuration's. Plain tensor
operations; nothing of the program.
"""

from __future__ import annotations

import torch


def _hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _exp(phi):
    th = phi.norm(dim=-1, keepdim=True)[..., None]
    K = _hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand_as(K)
    small = th < 1e-8
    a = torch.where(small, torch.ones_like(th), torch.sin(th) / torch.where(small, 1, th))
    b = torch.where(small, 0.5 * torch.ones_like(th),
                    (1 - torch.cos(th)) / torch.where(small, 1, th) ** 2)
    return eye + a * K + b * (K @ K)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest), as a tensor
    core reads a float32 operand when TF32 is on."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)


class Problem:
    def __init__(self, scene: dict, camera: dict, table, dtype, device, tf32_products=False):
        t = lambda a, d=dtype: torch.as_tensor(a, device=device).to(d)  # noqa: E731
        self.R, self.t, self.p = t(scene["Rwb"]), t(scene["twb0"]), t(scene["pts0"])
        self.obs = t(scene["pobs"])
        self.pidx, self.fidx = t(scene["pidx"], torch.int64), t(scene["fidx"], torch.int64)
        self.ok = t(scene["ok"], torch.bool)
        self.stereo = self.obs[:, 2] >= 0
        self.table = t(table, torch.int64)
        self.cam = {k: float(camera[k]) for k in ("fx", "fy", "cx", "cy", "bf")}
        # the products' operands in TF32: small batched products never reach
        # the tensor cores, so the control rounds them itself
        self.round = tf32 if tf32_products else (lambda x: x)

    def residual(self, R, t, p, with_jac=False):
        c = self.cam
        Rf = R[self.fidx]
        q = p[self.pidx] - t[self.fidx]
        pc = torch.einsum("nji,nj->ni", self.round(Rf), self.round(q))
        x, y, z = pc.unbind(-1)
        iz = 1.0 / z
        u = c["fx"] * x * iz + c["cx"]
        v = c["fy"] * y * iz + c["cy"]
        r = self.obs - torch.stack([u, v, u - c["bf"] * iz], -1)
        r = torch.stack([r[:, 0], r[:, 1], torch.where(self.stereo, r[:, 2], 0.0)], -1)
        if not with_jac:
            return r, z
        zero = torch.zeros_like(x)
        du = torch.stack([c["fx"] * iz, zero, -c["fx"] * x * iz * iz], -1)
        dv = torch.stack([zero, c["fy"] * iz, -c["fy"] * y * iz * iz], -1)
        dur = du + torch.stack([zero, zero, c["bf"] * iz * iz], -1)
        dur = torch.where(self.stereo[:, None], dur, torch.zeros_like(dur))
        Jpc = -torch.stack([du, dv, dur], -2)  # d r / d pc, (N, 3, 3)
        Rt = Rf.transpose(-1, -2)
        Jc = torch.cat([Jpc @ _hat(pc), -Jpc @ Rt], -1)  # (N, 3, 6): φ, δt
        Jp = Jpc @ Rt
        return r, z, Jc, Jp


def _cost(r, w):
    return (w * (r * r).sum(-1)).sum()


def _weights(prob, r, mask, robust, thr):
    chi2 = (r * r).sum(-1)
    w = mask.to(r.dtype)
    if robust:
        w = w * torch.where(chi2 <= thr, torch.ones_like(chi2), torch.sqrt(thr / chi2.clamp_min(1e-30)))
    return w


def _step(prob, R, t, p, w, lam, acc, chunk):
    """One damped Gauss–Newton step: (dφ, dt, dp)."""
    r, _, Jc, Jp = prob.residual(R, t, p, with_jac=True)
    F, P = R.shape[0], p.shape[0]
    wa = w.to(acc)[:, None, None]
    Jc, Jp, r = Jc.to(acc), Jp.to(acc), r.to(acc)
    Hcc_o = wa * Jc.transpose(-1, -2) @ Jc
    W_o = wa * Jc.transpose(-1, -2) @ Jp  # (N, 6, 3)
    Hpp_o = wa * Jp.transpose(-1, -2) @ Jp
    bc_o = -(wa * Jc.transpose(-1, -2) @ r[..., None])[..., 0]
    bp_o = -(wa * Jp.transpose(-1, -2) @ r[..., None])[..., 0]
    Hcc = torch.zeros(F, 6, 6, dtype=acc, device=r.device).index_add_(0, prob.fidx, Hcc_o)
    bc = torch.zeros(F, 6, dtype=acc, device=r.device).index_add_(0, prob.fidx, bc_o)
    Hpp = torch.zeros(P, 3, 3, dtype=acc, device=r.device).index_add_(0, prob.pidx, Hpp_o)
    bp = torch.zeros(P, 3, dtype=acc, device=r.device).index_add_(0, prob.pidx, bp_o)
    eye3 = torch.eye(3, dtype=acc, device=r.device)
    Hpp = Hpp + lam * Hpp * eye3 + 1e-12 * eye3
    Hpp_inv = torch.linalg.inv(Hpp)
    S = torch.zeros(F * 6, F * 6, dtype=acc, device=r.device)
    eye6 = torch.eye(6, dtype=acc, device=r.device)
    # an unobserved keyframe has an empty block: a small diagonal keeps it still
    Hcc = Hcc + lam * Hcc * eye6 + 1e-9 * eye6
    fi = torch.arange(F, device=r.device)
    blk = (fi[:, None, None] * 6 + torch.arange(6, device=r.device)[None, :, None]) * (F * 6) \
        + fi[:, None, None] * 6 + torch.arange(6, device=r.device)[None, None, :]
    S.view(-1).index_add_(0, blk.reshape(-1), Hcc.reshape(-1))
    rhs = bc.clone()
    Wpad = torch.cat([W_o, torch.zeros(1, 6, 3, dtype=acc, device=r.device)])
    fpad = torch.cat([prob.fidx, torch.zeros(1, dtype=torch.int64, device=r.device)])
    k = prob.table.shape[1]
    a6 = torch.arange(6, device=r.device)
    for p0 in range(0, P, chunk):
        tab = prob.table[p0:p0 + chunk]  # (c, K), pad = N
        W = Wpad[tab]  # (c, K, 6, 3)
        f = fpad[tab]
        V = W @ Hpp_inv[p0:p0 + chunk, None]  # (c, K, 6, 3)
        blocks = V[:, :, None] @ W[:, None].transpose(-1, -2)  # (c, K, K, 6, 6)
        rows = (f[:, :, None, None, None] * 6 + a6[None, None, None, :, None]) * (F * 6)
        cols = f[:, None, :, None, None] * 6 + a6[None, None, None, None, :]
        idx = (rows + cols).expand(-1, k, k, 6, 6)
        S.view(-1).index_add_(0, idx.reshape(-1), -blocks.reshape(-1))
        vb = (V @ bp[p0:p0 + chunk, None, :, None])[..., 0]  # (c, K, 6)
        rhs.index_add_(0, f.reshape(-1), -vb.reshape(-1, 6))
    rhs = rhs.reshape(-1)
    # the fixed first keyframe: its rows and columns out of the system
    keep = torch.ones(F * 6, dtype=torch.bool, device=r.device)
    keep[:6] = False
    Sk = S[keep][:, keep]
    dx = torch.zeros(F * 6, dtype=acc, device=r.device)
    L = torch.linalg.cholesky(Sk)
    dx[keep] = torch.cholesky_solve(rhs[keep][:, None], L)[:, 0]
    dxf = dx.reshape(F, 6)
    back = (W_o.transpose(-1, -2) @ dxf[prob.fidx][..., None])[..., 0]  # (N, 3)
    wsum = torch.zeros(P, 3, dtype=acc, device=r.device).index_add_(0, prob.pidx, back)
    dp = (Hpp_inv @ (bp - wsum)[..., None])[..., 0]
    return dxf[:, :3], dxf[:, 3:], dp


def _optimize(prob, R, t, p, mask, thr, iters, robust, acc, dtype, chunk):
    lam = 1e-4
    r, _ = prob.residual(R, t, p)
    cost = _cost(r, _weights(prob, r, mask, robust, thr))
    for _ in range(iters):
        w = _weights(prob, r, mask, robust, thr)
        try:
            dphi, dt, dp = _step(prob, R, t, p, w, lam, acc, chunk)
        except torch.linalg.LinAlgError:
            lam *= 4.0
            continue
        R2 = R @ _exp(dphi.to(dtype))
        t2, p2 = t + dt.to(dtype), p + dp.to(dtype)
        r2, _ = prob.residual(R2, t2, p2)
        cost2 = _cost(r2, _weights(prob, r2, mask, robust, thr))
        if bool(cost2 < cost):
            R, t, p, r, cost, lam = R2, t2, p2, r2, cost2, lam / 3.0
        else:
            lam *= 2.0
    return R, t, p


def solve(scene: dict, config: dict, table, device, acc=torch.float64, dtype=torch.float32,
          chunk: int = 8192, tf32: bool = False):
    """The configuration's GlobalBA schedule on a map scene. Returns (Rwb,
    twb, points, point inlier flags). ``tf32``: the operands of the
    projection's products rounded to TF32."""
    opt, sched = config["optimization"], config["global_ba"]
    prob = Problem(scene, config["camera"], table, dtype, device, tf32_products=tf32)
    thr = torch.where(prob.stereo, float(opt["stereo_point"]), float(opt["mono_point"])).to(dtype)
    R, t, p = _optimize(prob, prob.R, prob.t, prob.p, prob.ok, thr, int(sched["iters1"]), True,
                        acc, dtype, chunk)

    def gate(R, t, p):
        r, z = prob.residual(R, t, p)
        return ((r * r).sum(-1) <= thr) & (z > 0) & prob.ok

    inl = gate(R, t, p)
    R, t, p = _optimize(prob, R, t, p, inl, thr, int(sched["iters2"]), False, acc, dtype, chunk)
    return R, t, p, gate(R, t, p)
