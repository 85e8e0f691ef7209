"""A plain window BA: the reference of the VO cells' local BA.

The problem is one keyframe's window as the program's map built it (poses,
points, Plücker lines, their observations and masks; the driver copies the
arguments of the window's ``local_ba`` calls). The reference solves it again
from there in float64 with its own residuals and solver, as AirSLAM's local
BA defines them:

- point residuals: observation − (u, v, u − bf/z) of the point in the camera,
  the third row dropped for a mono observation (right u < 0):
  ``EdgeSE3ProjectPoint`` / ``EdgeSE3ProjectStereoPoint``;
- line residuals: the distances of the observed endpoints from the projected
  line, over the line's normal length, in the left view and, for a stereo
  observation, the right: ``EdgeSE3ProjectLine`` /
  ``EdgeStereoSE3ProjectLine``; χ² weighted by the observation's information
  scale;
- the schedule: Levenberg–Marquardt (H + λI, λ from 1e-3, divided by 3 on an
  accepted step, multiplied by ν with ν doubled on a rejected one) with Huber
  weights for ``iters1`` steps, the χ² gate at the configuration's thresholds,
  ``iters2`` plain steps on the inliers, then the inlier flags on the
  original observations;
- the updates: body pose R ← R·Exp(δφ), t ← t + R·δt; points additive; lines
  by the 4-dof orthonormal (Bartoli–Sturm) update, |d| = 1.

Jacobians are forward-mode derivatives of each observation's residual at a
zero update; the system over the free poses and the observed landmarks is
solved dense by Cholesky. Plain tensor operations; nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EPS_EXP = 1e-4  # the small-angle switch of the exponential


class Window(NamedTuple):
    """A window problem: poses (F), points (P), lines (L), observations on
    the (landmark, frame) grid, and the camera-in-body transform."""

    Rwb: torch.Tensor  # (F, 3, 3)
    twb: torch.Tensor  # (F, 3)
    pose_fixed: torch.Tensor  # (F,) bool
    points: torch.Tensor  # (P, 3)
    point_fixed: torch.Tensor  # (P,) bool
    point_obs: torch.Tensor  # (P, F, 3) u, v, right u (< 0: mono)
    point_mask: torch.Tensor  # (P, F) bool
    lines: torch.Tensor  # (L, 6) Plücker (w, d)
    line_fixed: torch.Tensor  # (L,) bool
    line_obs: torch.Tensor  # (L, F, 8) left endpoints, right endpoints
    line_stereo: torch.Tensor  # (L, F) bool
    line_mask: torch.Tensor  # (L, F) bool
    line_sigma: torch.Tensor  # (L, F) information scale
    Rcb: torch.Tensor  # (3, 3)
    tcb: torch.Tensor  # (3,)


class Solution(NamedTuple):
    Rwb: torch.Tensor
    twb: torch.Tensor
    points: torch.Tensor
    lines: torch.Tensor
    point_inlier: torch.Tensor  # (P, F)
    line_inlier: torch.Tensor  # (L, F)


def _hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _exp(v):
    """Rodrigues' exponential of (…, 3) with a series switch at small angles
    (its forward derivative at zero is the hat map)."""
    th = torch.sqrt((v * v).sum(-1))
    small = th < EPS_EXP
    safe = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, torch.ones_like(th), torch.sin(safe) / safe)
    b = torch.where(small, 0.5 * torch.ones_like(th), (1.0 - torch.cos(safe)) / (safe * safe))
    K = _hat(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def _mv(m, v):
    return (m * v[..., None, :]).sum(-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _line_oplus(line, u):
    """The orthonormal update of Plücker lines (…, 6) by (…, 4)."""
    w, d = line[..., 0:3], line[..., 3:6]
    nw, nd = torch.linalg.vector_norm(w, dim=-1), torch.linalg.vector_norm(d, dim=-1)
    n = torch.sqrt(nw * nw + nd * nd)
    u1 = w / torch.clamp(nw, min=1e-12)[..., None]
    u2 = d / torch.clamp(nd, min=1e-12)[..., None]
    U = torch.stack([u1, u2, _cross(u1, u2)], dim=-1) @ _exp(u[..., 0:3])
    c0, s0 = nw / torch.clamp(n, min=1e-12), nd / torch.clamp(n, min=1e-12)
    c, s = torch.cos(u[..., 3]), torch.sin(u[..., 3])
    out = torch.cat([(c0 * c - s0 * s)[..., None] * U[..., :, 0],
                     (s0 * c + c0 * s)[..., None] * U[..., :, 1]], -1)
    return out / torch.clamp(torch.linalg.vector_norm(out[..., 3:6], dim=-1, keepdim=True),
                             min=1e-12)


def _camera(R, t, Rcb, tcb):
    Rcw = Rcb @ R.transpose(-1, -2)
    return Rcw, tcb - _mv(Rcw, t)


def _guard(x, eps):
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def point_residual(R, t, p, obs, cam, Rcb, tcb):
    """(N, 3) residuals and depths of N point observations."""
    Rcw, tcw = _camera(R, t, Rcb, tcb)
    pc = _mv(Rcw, p) + tcw
    zi = 1.0 / _guard(pc[..., 2], 1e-9)
    u = pc[..., 0] * zi * cam["fx"] + cam["cx"]
    v = pc[..., 1] * zi * cam["fy"] + cam["cy"]
    return obs - torch.stack([u, v, u - cam["bf"] * zi], -1), pc[..., 2]


def _line_coeffs(w, cam):
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    return torch.stack([fy * w[..., 0], fx * w[..., 1],
                        -fy * cx * w[..., 0] - fx * cy * w[..., 1] + fx * fy * w[..., 2]], -1)


def _endpoint_error(l, x, y):
    n = torch.sqrt(l[..., 0] * l[..., 0] + l[..., 1] * l[..., 1])
    return (x * l[..., 0] + y * l[..., 1] + l[..., 2]) / torch.where(
        n < 1e-12, torch.full_like(n, 1e-12), n)


def line_residual(R, t, line, obs, cam, Rcb, tcb):
    """(N, 4) endpoint distances of N line observations (left, then right)."""
    Rcw, tcw = _camera(R, t, Rcb, tcb)
    d = _mv(Rcw, line[..., 3:6])
    w = _mv(Rcw, line[..., 0:3]) + _cross(tcw, d)
    b = cam["bf"] / cam["fx"]
    w_r = torch.stack([w[..., 0], w[..., 1] + b * d[..., 2], w[..., 2] - b * d[..., 1]], -1)
    ll, lr = _line_coeffs(w, cam), _line_coeffs(w_r, cam)
    return torch.stack([_endpoint_error(ll, obs[..., 0], obs[..., 1]),
                        _endpoint_error(ll, obs[..., 2], obs[..., 3]),
                        _endpoint_error(lr, obs[..., 4], obs[..., 5]),
                        _endpoint_error(lr, obs[..., 6], obs[..., 7])], -1)


def _huber_w(chi2, thr):
    return torch.where(chi2 <= thr, torch.ones_like(chi2),
                       torch.sqrt(thr / torch.clamp(chi2, min=1e-12)))


def _huber_cost(chi2, thr):
    return torch.where(chi2 <= thr, chi2,
                       2.0 * torch.sqrt(thr * torch.clamp(chi2, min=1e-12)) - thr)


class _Obs:
    """The observations of the original masks as flat lists."""

    def __init__(self, w: Window, cfg: dict):
        self.pp, self.pf = torch.nonzero(w.point_mask, as_tuple=True)
        self.pobs = w.point_obs[self.pp, self.pf]
        self.pstereo = self.pobs[:, 2] >= 0
        self.prow = torch.stack([torch.ones_like(self.pstereo)] * 2 + [self.pstereo], -1)
        dt = w.points.dtype
        self.pthr = torch.where(self.pstereo, float(cfg["stereo_point"]),
                                float(cfg["mono_point"])).to(dt)
        self.ll, self.lf = torch.nonzero(w.line_mask, as_tuple=True)
        self.lobs = w.line_obs[self.ll, self.lf]
        st = w.line_stereo[self.ll, self.lf]
        self.lrow = torch.stack([torch.ones_like(st)] * 2 + [st] * 2, -1)
        self.lsig = w.line_sigma[self.ll, self.lf].to(dt)
        self.lthr = torch.where(st, float(cfg["stereo_line"]), float(cfg["mono_line"])).to(dt)


class _Solver:
    def __init__(self, w: Window, cam: dict, cfg: dict):
        self.w, self.cam = w, cam
        self.o = _Obs(w, cfg)
        dev = w.points.device
        F, P, L = w.Rwb.shape[0], w.points.shape[0], w.lines.shape[0]
        o = self.o
        seen_p = torch.zeros(P, dtype=torch.bool, device=dev)
        seen_p[o.pp] = True
        seen_l = torch.zeros(L, dtype=torch.bool, device=dev)
        seen_l[o.ll] = True
        free_f, free_p, free_l = ~w.pose_fixed, seen_p & ~w.point_fixed, seen_l & ~w.line_fixed

        def offsets(free, k, base):
            off = torch.full(free.shape, -1, dtype=torch.int64, device=dev)
            n = int(free.sum())
            off[free] = base + k * torch.arange(n, device=dev)
            return off, base + k * n

        self.f_off, n = offsets(free_f, 6, 0)
        self.p_off, n = offsets(free_p, 3, n)
        self.l_off, n = offsets(free_l, 4, n)
        self.n = n

    # -- residuals, χ² and the cost ------------------------------------------
    def point_r(self, s):
        o = self.o
        return self._point_r(s[0][o.pf], s[1][o.pf], s[2][o.pp], o.pobs, o.prow)

    def _point_r(self, R, t, p, obs, row, dpose=None, dp=None):
        w = self.w
        if dpose is not None:
            R, t = R @ _exp(dpose[..., 0:3]), t + _mv(R, dpose[..., 3:6])
            p = p + dp
        r, z = point_residual(R, t, p, obs, self.cam, w.Rcb, w.tcb)
        return r * row, z

    def line_r(self, s):
        o = self.o
        return self._line_r(s[0][o.lf], s[1][o.lf], s[3][o.ll], o.lobs, o.lrow)

    def _line_r(self, R, t, ln, obs, row, dpose=None, dl=None):
        w = self.w
        if dpose is not None:
            R, t = R @ _exp(dpose[..., 0:3]), t + _mv(R, dpose[..., 3:6])
            ln = _line_oplus(ln, dl)
        return line_residual(R, t, ln, obs, self.cam, w.Rcb, w.tcb) * row

    def chi2(self, s):
        r, z = self.point_r(s)
        lr = self.line_r(s)
        return (r * r).sum(-1), z, (lr * lr).sum(-1) * self.o.lsig

    def cost(self, s, pa, la, robust):
        pc, _, lc = self.chi2(s)
        if robust:
            pc, lc = _huber_cost(pc, self.o.pthr), _huber_cost(lc, self.o.lthr)
        return (pc * pa).sum() + (lc * la).sum()

    def gate(self, s):
        pc, z, lc = self.chi2(s)
        return (pc <= self.o.pthr) & (z > 0), lc <= self.o.lthr

    # -- one damped step ------------------------------------------------------
    def _jac(self, fn, args, n_lm):
        """Residuals' Jacobians (N, rows, 6 + n_lm): the forward derivative of
        one observation's residual ``fn(dpose, dlandmark, *row)`` at a zero
        update, mapped over the observations ``args``."""
        dt, dev = self.w.points.dtype, self.w.points.device
        zero = torch.zeros(6 + n_lm, dtype=dt, device=dev)

        def one(*row):
            return torch.func.jacfwd(lambda d: fn(d[None, :6], d[None, 6:], *row))(zero)

        return torch.func.vmap(one)(*args)

    def step(self, s, pa, la, robust, lam):
        o, n = self.o, self.n
        dev, dt = self.w.points.device, self.w.points.dtype
        r, _ = self.point_r(s)
        pc = (r * r).sum(-1)
        wp = (_huber_w(pc, o.pthr) if robust else torch.ones_like(pc)) * pa
        Jp = self._jac(lambda dpo, dl, R, t, p, ob, row: self._point_r(
            R[None], t[None], p[None], ob[None], row[None], dpo, dl)[0][0],
            (s[0][o.pf], s[1][o.pf], s[2][o.pp], o.pobs, o.prow), 3)
        lr = self.line_r(s)
        lc = (lr * lr).sum(-1) * o.lsig
        wl = (_huber_w(lc, o.lthr) if robust else torch.ones_like(lc)) * la * o.lsig
        Jl = self._jac(lambda dpo, dl, R, t, ln, ob, row: self._line_r(
            R[None], t[None], ln[None], ob[None], row[None], dpo, dl)[0],
            (s[0][o.lf], s[1][o.lf], s[3][o.ll], o.lobs, o.lrow), 4)

        H = torch.zeros((n + 1) * (n + 1), dtype=dt, device=dev)
        b = torch.zeros(n + 1, dtype=dt, device=dev)
        a6 = torch.arange(6, device=dev)
        for J, res, wt, fi, off, k in ((Jp, r, wp, o.pf, self.p_off[o.pp], 3),
                                       (Jl, lr, wl, o.lf, self.l_off[o.ll], 4)):
            if J.shape[0] == 0:
                continue
            ak = torch.arange(k, device=dev)
            fo = self.f_off[fi]
            idx = torch.cat([torch.where(fo[:, None] >= 0, fo[:, None] + a6, n),
                             torch.where(off[:, None] >= 0, off[:, None] + ak, n)], 1)
            JtW = J.transpose(-1, -2) * wt[:, None, None]
            blocks = JtW @ J
            H.index_add_(0, (idx[:, :, None] * (n + 1) + idx[:, None, :]).reshape(-1),
                         blocks.reshape(-1))
            b.index_add_(0, idx.reshape(-1), -(JtW @ res[..., None])[..., 0].reshape(-1))
        H = H.view(n + 1, n + 1)[:n, :n] + lam * torch.eye(n, dtype=dt, device=dev)
        H = H + torch.diag((torch.diagonal(H) < 1e-10).to(dt))
        L, info = torch.linalg.cholesky_ex(H)
        if bool(info != 0):
            return None
        dx = torch.cholesky_solve(b[:n, None], L)[:, 0]
        dx = torch.cat([dx, torch.zeros(1, dtype=dt, device=dev)])

        def take(off, k):
            idx = torch.where(off[:, None] >= 0, off[:, None] + torch.arange(k, device=dev), n)
            return dx[idx]

        return take(self.f_off, 6), take(self.p_off, 3), take(self.l_off, 4)

    def apply(self, s, d):
        dpose, dp, dl = d
        R, t, p, ln = s
        return (R @ _exp(dpose[:, 0:3]), t + _mv(R, dpose[:, 3:6]), p + dp, _line_oplus(ln, dl))

    def optimize(self, s, pa, la, robust, iters):
        cost = self.cost(s, pa, la, robust)
        lam, nu = 1e-3, 2.0
        for _ in range(iters):
            d = self.step(s, pa, la, robust, lam)
            cand = None if d is None else self.apply(s, d)
            new = None if cand is None else self.cost(cand, pa, la, robust)
            if new is not None and bool(new < cost):
                s, cost, lam, nu = cand, new, lam / 3.0, 2.0
            else:
                lam, nu = lam * nu, nu * 2.0
        return s


def solve(w: Window, cam: dict, cfg: dict, iters1: int, iters2: int,
          dtype=torch.float64) -> Solution:
    """The window's local BA in ``dtype``. ``cam``: rectified fx, fy, cx, cy,
    bf; ``cfg``: the χ² thresholds (``mono_point``, ``stereo_point``,
    ``mono_line``, ``stereo_line``)."""
    w = Window(*(x.to(dtype) if x.is_floating_point() else x for x in w))
    sv = _Solver(w, cam, cfg)
    o = sv.o
    s = (w.Rwb, w.twb, w.points, w.lines)
    ones_p = torch.ones(len(o.pp), dtype=dtype, device=w.points.device)
    ones_l = torch.ones(len(o.ll), dtype=dtype, device=w.points.device)
    s = sv.optimize(s, ones_p, ones_l, True, iters1)
    gp, gl = sv.gate(s)
    s = sv.optimize(s, gp.to(dtype), gl.to(dtype), False, iters2)
    fp, fl = sv.gate(s)
    p_in = torch.zeros_like(w.point_mask)
    p_in[o.pp, o.pf] = fp
    l_in = torch.zeros_like(w.line_mask)
    l_in[o.ll, o.lf] = fl
    return Solution(*s, p_in, l_in)


def robust_cost(w: Window, cam: dict, cfg: dict, state) -> float:
    """The Huber cost over every observation of the original masks at
    ``state`` (Rwb, twb, points, lines), in float64."""
    w = Window(*(x.double() if x.is_floating_point() else x for x in w))
    sv = _Solver(w, cam, cfg)
    s = tuple(x.double() for x in state)
    return float(sv.cost(s, torch.ones(len(sv.o.pp), dtype=torch.float64, device=w.points.device),
                         torch.ones(len(sv.o.ll), dtype=torch.float64, device=w.points.device),
                         True))
