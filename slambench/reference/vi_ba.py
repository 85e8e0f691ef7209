"""A plain stereo-inertial reference: the reference of the VI cells.

Float64 ``torch`` and numpy, written from AirSLAM's definitions (nothing of
the program is imported; TF32 plays no part: no product here is a float32
matrix product):

- on-manifold preintegration (Forster et al., RSS 2015, as ``src/imu.cc``'s
  ``Preinteration::Propagate`` orders it: dP and dV from the previous dR,
  the bias Jacobians before dR, the 9×9 covariance by A·Σ·Aᵀ + B·N·Bᵀ and
  the bias walk added once a sample), over the midpoint rows
  ``AddBatchData`` forms from the raw samples between two frames;
- the 9-d IMU residual of ``EdgeIMU`` (rotation, velocity, position, each
  delta corrected to first order in the bias change) and the 6-d bias
  random walk, gravity ``Rwg · (0, 0, −g)``;
- the F = 2 VI pose-only solve of tracking (``FrameOptimization`` with the
  IMU edge to the last keyframe): the keyframe fixed, the frame's pose,
  velocity and biases free (15 dof), landmarks fixed, ``rounds`` rounds of
  ``iters`` Huber-robust LM steps, the pose re-seeded each round (velocity
  and biases keep running), the observations relabelled by χ² after each;
- the VI window BA of the local map (``LocalmapOptimization`` with IMU
  edges): the point and line terms of :mod:`slambench.reference.window_ba`,
  each free frame's 15 dof, the IMU and walk terms between consecutive
  keyframes, gravity held; a robust pass, the χ² gate, a plain pass, the
  inlier flags;
- the IMU initialization's optimization (``IMUInitialization``): the
  velocities, one shared bias pair with priors, and the 2-dof gravity
  direction, the poses fixed.

Departures from AirSLAM, each the program's reading of it too: the
information of an IMU edge is the PSD projection of the inverse of the
preintegration covariance regularized by 1e-12·I (:func:`information`),
scaled by ``imu_info_scale`` and Huber-weighted at δ² = 16.92 in the robust
passes;
the LM schedule is the program's (λ from 1e-3, or 1e-4 for the
initialization, divided by 3 on an accepted step and multiplied by ν on a
rejected one, ν doubled) in place of g2o's gain-ratio rule; a midpoint
row of no length (on a synced grid, the sample just past the frame gives
one) leaves the preintegration as it is, where ``Propagate`` would still
add one sample's bias walk to the covariance (``walk_on_empty_rows`` gives
``Propagate``'s reading, for the size of that departure). Each LM step is
solved from the weighted rows of the linearized problem by Householder QR
(the rows ordered by decreasing size), not from its normal equations: a
line near a camera centre gives rows up to 1e12, which normal equations
square past float64's reach.

Jacobians are forward-mode derivatives of each residual at a zero update.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slambench.reference import window_ba as wba

F64 = torch.float64
IMU_HUBER = 16.92  # δ² of the IMU edge's Huber kernel (g2o_optimization.cc:321)
IMU_INFO_SCALE = 1e-2  # the IMU edge's information scale (g2o_optimization.cc:321)


# -- SO(3) in numpy, for the preintegration -----------------------------------


def _np_hat(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


def _np_exp(v):
    th = float(np.linalg.norm(v))
    K = _np_hat(v)
    if th < 1e-4:
        return np.eye(3) + K + 0.5 * K @ K
    return np.eye(3) + np.sin(th) / th * K + (1.0 - np.cos(th)) / th ** 2 * K @ K


def _np_right_jacobian(v):
    th = float(np.linalg.norm(v))
    K = _np_hat(v)
    if th < 1e-4:
        return np.eye(3) - 0.5 * K + K @ K / 6.0
    return (np.eye(3) - (1.0 - np.cos(th)) / th ** 2 * K
            + (th - np.sin(th)) / th ** 3 * K @ K)


def _np_normalize(R):
    U, _, Vt = np.linalg.svd(R)
    return U @ Vt


# -- preintegration -----------------------------------------------------------


def midpoint_rows(samples: np.ndarray, t0: float, t1: float):
    """(dt, acc, gyr) rows of raw samples (M, 7: t, gyro, acc) spanning
    [t0, t1], as ``AddBatchData`` forms them: each pair of consecutive
    samples that overlaps the interval gives one row, its value the linear
    interpolation at the middle of the overlap, its dt the overlap."""
    dts, accs, gyrs = [], [], []
    for a, b in zip(samples[:-1], samples[1:]):
        ta, tb = float(a[0]), float(b[0])
        if tb < t0:
            continue
        if ta > t1:
            break
        lo, hi = max(ta, t0), min(tb, t1)
        mid = 0.5 * (lo + hi)
        wa = (tb - mid) / (tb - ta)
        wb = (mid - ta) / (tb - ta)
        gyrs.append(wa * a[1:4] + wb * b[1:4])
        accs.append(wa * a[4:7] + wb * b[4:7])
        dts.append(hi - lo)
    return np.asarray(dts, np.float64), np.asarray(accs).reshape(-1, 3), \
        np.asarray(gyrs).reshape(-1, 3)


def preintegrate(dts, accs, gyrs, bg, ba, noise, walk_on_empty_rows: bool = False) -> dict:
    """The preintegrated deltas, their bias Jacobians and the 15×15
    covariance of midpoint rows at the biases (bg, ba). ``noise``: the
    per-sample (gyro, acc, gyro walk, acc walk) standard deviations (the
    densities already scaled by √rate and 1/√rate). A row of no length
    leaves everything as it is; with ``walk_on_empty_rows`` it adds one
    sample's bias walk to the covariance, as ``Propagate`` does."""
    gn, an, gw, aw = (float(x) for x in noise)
    Nn = np.diag([gn * gn] * 3 + [an * an] * 3)
    Nw = np.diag([gw * gw] * 3 + [aw * aw] * 3)
    dR, dV, dP = np.eye(3), np.zeros(3), np.zeros(3)
    JRg, JVg, JVa, JPg, JPa = (np.zeros((3, 3)) for _ in range(5))
    cov = np.zeros((15, 15))
    z, I = np.zeros((3, 3)), np.eye(3)
    dT = 0.0
    for dt, am, wm in zip(dts, accs, gyrs):
        if dt <= 0.0:
            # a row of no length (the sample past the frame on a synced grid)
            if walk_on_empty_rows:
                cov[9:, 9:] = cov[9:, 9:] + Nw
            continue
        a, w = am - ba, wm - bg
        ah = _np_hat(a)
        dP = dP + dV * dt + 0.5 * dR @ a * dt * dt
        dV = dV + dR @ a * dt
        JPa = JPa + JVa * dt - 0.5 * dR * dt * dt
        JPg = JPg + JVg * dt - 0.5 * dR * dt * dt @ ah @ JRg
        JVa = JVa - dR * dt
        JVg = JVg - dR * dt @ ah @ JRg
        dRk = _np_exp(w * dt)
        Jr = _np_right_jacobian(w * dt)
        A = np.block([[dRk.T, z, z], [-dR @ ah * dt, I, z], [-0.5 * dR @ ah * dt * dt, I * dt, I]])
        B = np.block([[Jr * dt, z], [z, dR * dt], [z, 0.5 * dR * dt * dt]])
        cov[:9, :9] = A @ cov[:9, :9] @ A.T + B @ Nn @ B.T
        cov[9:, 9:] = cov[9:, 9:] + Nw
        JRg = dRk.T @ JRg - Jr * dt
        dR = _np_normalize(dR @ dRk)
        dT += dt
    return dict(dR=dR, dV=dV, dP=dP, dT=dT, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                cov=cov)


def information(cov):
    """(info9 (9, 9), info_walk (6, 6)) of a 15×15 preintegration covariance:
    the inverse of the 9×9 block regularized by 1e-12·I, symmetrized and
    projected onto the PSD cone, and the inverses of the gyro and acc walk
    blocks, each regularized alike (the program's and the JAX package's
    reading; ``EdgeInertial`` inverts the 9×9 block with no regularizer)."""
    cov = np.asarray(cov, np.float64)
    info9 = np.linalg.inv(cov[:9, :9] + 1e-12 * np.eye(9))
    info9 = 0.5 * (info9 + info9.T)
    ev, V = np.linalg.eigh(info9)
    info9 = (V * np.clip(ev, 0.0, None)) @ V.T
    walk = np.zeros((6, 6))
    walk[:3, :3] = np.linalg.inv(cov[9:12, 9:12] + 1e-12 * np.eye(3))
    walk[3:, 3:] = np.linalg.inv(cov[12:15, 12:15] + 1e-12 * np.eye(3))
    return info9, walk


# -- SO(3) in torch, differentiable at the identity ----------------------------


def log(R):
    """The rotation vector of R (…, 3, 3) as ``SO3Log`` (src/imu.cc:57-67)
    defines it: θ / (2 sin θ) · vee(R − Rᵀ) with θ = acos((tr R − 1) / 2),
    and ½ · vee(R − Rᵀ) where (tr R − 1) / 2 exceeds 0.99999."""
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    d = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    near = d.abs() > 0.99999
    dc = torch.where(near, torch.zeros_like(d), d)
    th = torch.acos(dc)
    f = torch.where(near, torch.full_like(d, 0.5), th / (2.0 * torch.sqrt(1.0 - dc * dc)))
    return v * f[..., None]


def _mv(m, v):
    return (m * v[..., None, :]).sum(-1)


# -- the IMU factor -------------------------------------------------------------


class Factors(NamedTuple):
    """K IMU factors from frame ``i`` to frame ``j`` with their deltas at
    the linearization biases, and their information."""

    i: torch.Tensor
    j: torch.Tensor
    dR: torch.Tensor
    dV: torch.Tensor
    dP: torch.Tensor
    JRg: torch.Tensor
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bg_lin: torch.Tensor
    ba_lin: torch.Tensor
    dT: torch.Tensor
    info: torch.Tensor  # (K, 9, 9)
    info_walk: torch.Tensor  # (K, 6, 6)
    mask: torch.Tensor  # (K,) bool


def imu_residual(Ri, ti, vi, Rj, tj, vj, bg, ba, dR, dV, dP, JRg, JVg, JVa, JPg, JPa,
                 bg_lin, ba_lin, dT, Rwg, g_value):
    """The 9-d residual (rotation, velocity, position) of ``EdgeIMU`` for
    the biases (bg, ba); batched over leading dimensions."""
    dbg, dba = bg - bg_lin, ba - ba_lin
    dRc = dR @ wba._exp(_mv(JRg, dbg))
    dVc = dV + _mv(JVg, dbg) + _mv(JVa, dba)
    dPc = dP + _mv(JPg, dbg) + _mv(JPa, dba)
    g = Rwg[..., :, 2] * (-g_value)
    dT = dT[..., None]
    RiT = Ri.transpose(-1, -2)
    er = log(dRc.transpose(-1, -2) @ RiT @ Rj)
    ev = _mv(RiT, vj - vi - g * dT) - dVc
    ep = _mv(RiT, tj - ti - vi * dT - 0.5 * g * dT * dT) - dPc
    return torch.cat([er, ev, ep], -1)


# -- the VI problem ---------------------------------------------------------------


class VIWindow(NamedTuple):
    """A VI problem: the vision window of :class:`window_ba.Window`, each
    frame's velocity and biases with their fix flags, the IMU factors, and
    gravity."""

    base: wba.Window
    vel: torch.Tensor  # (F, 3)
    bg: torch.Tensor  # (F, 3)
    ba: torch.Tensor  # (F, 3)
    vel_fixed: torch.Tensor  # (F,) bool: velocity and biases
    factors: Factors
    Rwg: torch.Tensor  # (3, 3)
    g_value: float


class State(NamedTuple):
    Rwb: torch.Tensor
    twb: torch.Tensor
    vel: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    points: torch.Tensor
    lines: torch.Tensor


class Solution(NamedTuple):
    state: State
    point_inlier: torch.Tensor  # (P, F)
    line_inlier: torch.Tensor  # (L, F)


def _f64(x):
    return x.to(F64) if torch.is_tensor(x) and x.is_floating_point() else x


def as_f64(w: VIWindow) -> VIWindow:
    return VIWindow(wba.Window(*(_f64(x) for x in w.base)), *(_f64(x) for x in w[1:5]),
                    Factors(*(_f64(x) for x in w.factors)), _f64(w.Rwg), float(w.g_value))


class _Solver:
    """Dense LM over the free unknowns of a VI problem: 15 a frame (pose 6
    as ``VIPose::Update``: R ← R·Exp(δφ), t ← t + R·δt; velocity, gyro
    and acc bias additive), 3 a free observed point, 4 a free observed line
    (the orthonormal update); the columns of fixed poses and of fixed
    velocities and biases held."""

    def __init__(self, w: VIWindow, cam: dict, cfg: dict, imu_info_scale: float,
                 landmarks_free: bool = True):
        self.w, self.cam, self.scale = w, cam, float(imu_info_scale)
        base = w.base
        self.o = wba._Obs(base, cfg)
        dev = base.points.device
        F, P, L = base.Rwb.shape[0], base.points.shape[0], base.lines.shape[0]
        o = self.o
        seen_p = torch.zeros(P, dtype=torch.bool, device=dev)
        seen_p[o.pp] = True
        seen_l = torch.zeros(L, dtype=torch.bool, device=dev)
        seen_l[o.ll] = True
        pose_free, vel_free = ~base.pose_fixed, ~w.vel_fixed
        free_f = pose_free | vel_free
        free_p = seen_p & ~base.point_fixed & landmarks_free
        free_l = seen_l & ~base.line_fixed & landmarks_free

        def offsets(free, k, at):
            off = torch.full(free.shape, -1, dtype=torch.int64, device=dev)
            m = int(free.sum())
            off[free] = at + k * torch.arange(m, device=dev)
            return off, at + k * m

        f_off, n = offsets(free_f, 15, 0)
        self.p_off, n = offsets(free_p, 3, n)
        self.l_off, n = offsets(free_l, 4, n)
        self.n = n
        # the index of each frame's 15 columns (n: held)
        cols = f_off[:, None] + torch.arange(15, device=dev)
        held = torch.cat([(~pose_free)[:, None].expand(F, 6), (~vel_free)[:, None].expand(F, 9)],
                         1) | (f_off < 0)[:, None]
        self.f_cols = torch.where(held, torch.full_like(cols, n), cols)
        fa = w.factors
        self.fi, self.fj = fa.i.long(), fa.j.long()

    # -- residuals ----------------------------------------------------------------
    def _point_r(self, R, t, p, obs, row, dpose=None, dp=None):
        b = self.w.base
        if dpose is not None:
            R, t = R @ wba._exp(dpose[..., 0:3]), t + _mv(R, dpose[..., 3:6])
            p = p + dp
        r, z = wba.point_residual(R, t, p, obs, self.cam, b.Rcb, b.tcb)
        return r * row, z

    def _line_r(self, R, t, ln, obs, row, dpose=None, dl=None):
        b = self.w.base
        if dpose is not None:
            R, t = R @ wba._exp(dpose[..., 0:3]), t + _mv(R, dpose[..., 3:6])
            ln = wba._line_oplus(ln, dl)
        return wba.line_residual(R, t, ln, obs, self.cam, b.Rcb, b.tcb) * row

    def _imu_r(self, Si, Sj, fa, d=None):
        """(…, 15): the 9-d residual and the walk (bg_j − bg_i, ba_j − ba_i)
        of factors ``fa`` between the states ``Si`` and ``Sj`` (Rwb, twb,
        vel, bg, ba); ``d`` (…, 30) the update of frame i, then frame j."""
        (Ri, ti, vi, bgi, bai), (Rj, tj, vj, bgj, baj) = Si, Sj
        if d is not None:
            Ri, ti = Ri @ wba._exp(d[..., 0:3]), ti + _mv(Ri, d[..., 3:6])
            vi, bgi, bai = vi + d[..., 6:9], bgi + d[..., 9:12], bai + d[..., 12:15]
            Rj, tj = Rj @ wba._exp(d[..., 15:18]), tj + _mv(Rj, d[..., 18:21])
            vj, bgj, baj = vj + d[..., 21:24], bgj + d[..., 24:27], baj + d[..., 27:30]
        r9 = imu_residual(Ri, ti, vi, Rj, tj, vj, bgj, baj, *fa, self.w.Rwg, self.w.g_value)
        return torch.cat([r9, bgj - bgi, baj - bai], -1)

    def _gathered(self, s: State):
        fa = self.w.factors
        return (tuple(x[self.fi] for x in s[:5]), tuple(x[self.fj] for x in s[:5]),
                (fa.dR, fa.dV, fa.dP, fa.JRg, fa.JVg, fa.JVa, fa.JPg, fa.JPa, fa.bg_lin,
                 fa.ba_lin, fa.dT))

    def chi2(self, s: State):
        o = self.o
        r, z = self._point_r(s.Rwb[o.pf], s.twb[o.pf], s.points[o.pp], o.pobs, o.prow)
        lr = self._line_r(s.Rwb[o.lf], s.twb[o.lf], s.lines[o.ll], o.lobs, o.lrow)
        return (r * r).sum(-1), z, (lr * lr).sum(-1) * o.lsig

    def _imu_terms(self, s: State):
        fa = self.w.factors
        r = self._imu_r(*self._gathered(s))
        r9, rw = r[:, :9], r[:, 9:]
        c9 = torch.einsum("ki,kij,kj->k", r9, fa.info * self.scale, r9)
        cw = torch.einsum("ki,kij,kj->k", rw, fa.info_walk, rw)
        return r, c9, cw

    def cost(self, s: State, pa, la, robust: bool) -> torch.Tensor:
        o = self.o
        pc, _, lc = self.chi2(s)
        if robust:
            pc, lc = wba._huber_cost(pc, o.pthr), wba._huber_cost(lc, o.lthr)
        _, c9, cw = self._imu_terms(s)
        if robust:
            c9 = wba._huber_cost(c9, torch.full_like(c9, IMU_HUBER))
        m = self.w.factors.mask.to(F64)
        return (pc * pa).sum() + (lc * la).sum() + (m * (c9 + cw)).sum()

    def gate(self, s: State):
        o = self.o
        pc, z, lc = self.chi2(s)
        return (pc <= o.pthr) & (z > 0), lc <= o.lthr

    # -- one damped step --------------------------------------------------------------
    @staticmethod
    def _jac(fn, args, width, dev):
        zero = torch.zeros(width, dtype=F64, device=dev)

        def one(*row):
            return torch.func.jacfwd(lambda d: fn(d, *row))(zero)

        return torch.func.vmap(one)(*args)

    def step(self, s: State, pa, la, robust: bool, lam):
        """One damped step: the least-squares problem
        min ‖W^½ (J·dx + r)‖² + λ‖dx‖² over the free unknowns, solved from
        its rows (not its normal equations) by Householder QR with the rows
        ordered by decreasing size. A line whose estimate passes near a
        camera centre has rows up to 1e12; squared into normal equations
        they leave rounding noise of ~1e8 where the pose blocks hold ~1e5,
        and a Cholesky factorization of those fails."""
        o, n, w = self.o, self.n, self.w
        dev = w.base.points.device
        blocks = []  # (rows (N, r, c), weighted residuals (N, r), columns (N, c))

        def add(J, res, S, idx):
            """Rows of J (N, r, c) under the square-root weights S (N, r, r)."""
            blocks.append((S @ J, (S @ res[..., None])[..., 0], idx))

        def diag(wt, k):
            return torch.sqrt(wt)[:, None, None] * torch.eye(k, dtype=F64, device=dev)

        if len(o.pp):
            r, _ = self._point_r(s.Rwb[o.pf], s.twb[o.pf], s.points[o.pp], o.pobs, o.prow)
            pc = (r * r).sum(-1)
            wp = (wba._huber_w(pc, o.pthr) if robust else torch.ones_like(pc)) * pa
            J = self._jac(lambda d, R, t, p, ob, row: self._point_r(
                R, t, p, ob, row, d[:6], d[6:])[0],
                (s.Rwb[o.pf], s.twb[o.pf], s.points[o.pp], o.pobs, o.prow), 9, dev)
            idx = torch.cat([self.f_cols[o.pf, :6], self._lm_cols(self.p_off[o.pp], 3)], 1)
            add(J, r, diag(wp, 3), idx)
        if len(o.ll):
            lr = self._line_r(s.Rwb[o.lf], s.twb[o.lf], s.lines[o.ll], o.lobs, o.lrow)
            lc = (lr * lr).sum(-1) * o.lsig
            wl = (wba._huber_w(lc, o.lthr) if robust else torch.ones_like(lc)) * la * o.lsig
            J = self._jac(lambda d, R, t, ln, ob, row: self._line_r(
                R, t, ln, ob, row, d[:6], d[6:]),
                (s.Rwb[o.lf], s.twb[o.lf], s.lines[o.ll], o.lobs, o.lrow), 10, dev)
            idx = torch.cat([self.f_cols[o.lf, :6], self._lm_cols(self.l_off[o.ll], 4)], 1)
            add(J, lr, diag(wl, 4), idx)
        fa = w.factors
        if len(self.fi):
            r, c9, _ = self._imu_terms(s)
            wi = (wba._huber_w(c9, torch.full_like(c9, IMU_HUBER)) if robust
                  else torch.ones_like(c9))
            m = fa.mask.to(F64)
            Wt = torch.zeros((len(self.fi), 15, 15), dtype=F64, device=dev)
            Wt[:, :9, :9] = fa.info * self.scale * (wi * m)[:, None, None]
            Wt[:, 9:, 9:] = fa.info_walk * m[:, None, None]
            # the symmetric square root of each factor's information
            ev, V = torch.linalg.eigh((Wt + Wt.mT) * 0.5)
            S = V @ (torch.sqrt(ev.clamp(min=0.0))[..., None] * V.mT)
            J = torch.func.vmap(lambda Si, Sj, f: torch.func.jacfwd(
                lambda d: self._imu_r(Si, Sj, f, d))(
                    torch.zeros(30, dtype=F64, device=dev)))(*self._gathered(s))
            add(J, r, S, torch.cat([self.f_cols[self.fi], self.f_cols[self.fj]], 1))
        m_rows = sum(J.shape[0] * J.shape[1] for J, _, _ in blocks)
        A = torch.zeros((m_rows, n + 1), dtype=F64, device=dev)
        rhs = torch.zeros(m_rows, dtype=F64, device=dev)
        at = 0
        for J, res, idx in blocks:
            k, r_ = J.shape[0], J.shape[1]
            rows = at + torch.arange(k * r_, device=dev).reshape(k, r_)
            A.index_put_((rows[:, :, None].expand(k, r_, idx.shape[1]),
                          idx[:, None, :].expand(k, r_, idx.shape[1])), J, accumulate=True)
            rhs[rows.reshape(-1)] = res.reshape(-1)
            at += k * r_
        A = A[:, :n]  # column n gathers the held columns
        # λI, and a dof that nothing observes pinned by 1, as rows
        pin = ((A * A).sum(0) + lam < 1e-10).to(F64)
        A = torch.cat([A, torch.diag(torch.sqrt(lam + pin))])
        rhs = torch.cat([rhs, torch.zeros(n, dtype=F64, device=dev)])
        order = torch.argsort(A.abs().amax(1), descending=True)
        dx = torch.linalg.lstsq(A[order], -rhs[order][:, None], driver="gels").solution[:, 0]
        if not bool(torch.isfinite(dx).all()):
            return None
        dx = torch.cat([dx, torch.zeros(1, dtype=F64, device=dev)])
        return (dx[self.f_cols], dx[self._lm_cols(self.p_off, 3)],
                dx[self._lm_cols(self.l_off, 4)])

    def _lm_cols(self, off, k):
        return torch.where(off[:, None] >= 0, off[:, None] + torch.arange(k, device=off.device),
                           self.n)

    @staticmethod
    def apply(s: State, d) -> State:
        df, dp, dl = d
        return State(s.Rwb @ wba._exp(df[:, 0:3]), s.twb + _mv(s.Rwb, df[:, 3:6]),
                     s.vel + df[:, 6:9], s.bg + df[:, 9:12], s.ba + df[:, 12:15],
                     s.points + dp, wba._line_oplus(s.lines, dl))

    def optimize(self, s: State, pa, la, robust: bool, iters: int, lam0: float = 1e-3):
        cost = self.cost(s, pa, la, robust)
        lam, nu = lam0, 2.0
        for _ in range(iters):
            d = self.step(s, pa, la, robust, lam)
            cand = None if d is None else self.apply(s, d)
            new = None if cand is None else self.cost(cand, pa, la, robust)
            if new is not None and bool(new < cost):
                s, cost, lam, nu = cand, new, lam / 3.0, 2.0
            else:
                lam, nu = lam * nu, nu * 2.0
        return s


def _state(w: VIWindow) -> State:
    b = w.base
    return State(b.Rwb, b.twb, w.vel, w.bg, w.ba, b.points, b.lines)


def _flags(w: VIWindow, o, fp, fl):
    p_in = torch.zeros_like(w.base.point_mask)
    p_in[o.pp, o.pf] = fp
    l_in = torch.zeros_like(w.base.line_mask)
    l_in[o.ll, o.lf] = fl
    return p_in, l_in


def window_ba(w: VIWindow, cam: dict, cfg: dict, imu_info_scale: float, iters1: int,
              iters2: int) -> Solution:
    """The VI local BA: ``iters1`` robust LM steps, the χ² gate,
    ``iters2`` plain steps on the inliers, the inlier flags on the original
    observations; gravity held."""
    w = as_f64(w)
    sv = _Solver(w, cam, cfg, imu_info_scale)
    o = sv.o
    ones_p = torch.ones(len(o.pp), dtype=F64, device=w.base.points.device)
    ones_l = torch.ones(len(o.ll), dtype=F64, device=w.base.points.device)
    s = sv.optimize(_state(w), ones_p, ones_l, True, iters1)
    gp, gl = sv.gate(s)
    s = sv.optimize(s, gp.to(F64), gl.to(F64), False, iters2)
    return Solution(s, *_flags(w, o, *sv.gate(s)))


def pose_only(w: VIWindow, cam: dict, cfg: dict, imu_info_scale: float, rounds: int = 3,
              iters: int = 10, lam0: float = 1e-3) -> Solution:
    """The VI pose-only solve of tracking: landmarks fixed; each round
    re-seeds the free poses from the problem (velocities and biases keep
    their running values), runs ``iters`` robust LM steps on the active
    observations, then relabels every observation by χ² and depth."""
    w = as_f64(w)
    sv = _Solver(w, cam, cfg, imu_info_scale, landmarks_free=False)
    o = sv.o
    s0 = _state(w)
    pa = torch.ones(len(o.pp), dtype=F64, device=w.base.points.device)
    la = torch.ones(len(o.ll), dtype=F64, device=w.base.points.device)
    s = s0
    for _ in range(rounds):
        s = sv.optimize(s._replace(Rwb=s0.Rwb, twb=s0.twb), pa, la, True, iters, lam0)
        gp, gl = sv.gate(s)
        pa, la = gp.to(F64), gl.to(F64)
    return Solution(s, *_flags(w, o, pa > 0, la > 0))


def cost(w: VIWindow, cam: dict, cfg: dict, imu_info_scale: float, state: State) -> float:
    """The robust cost over every observation and factor at ``state``."""
    w = as_f64(w)
    sv = _Solver(w, cam, cfg, imu_info_scale)
    dev = w.base.points.device
    return float(sv.cost(State(*(x.to(F64) for x in state)),
                         torch.ones(len(sv.o.pp), dtype=F64, device=dev),
                         torch.ones(len(sv.o.ll), dtype=F64, device=dev), True))


# -- the IMU initialization ----------------------------------------------------------


def imu_initialization(Rwb, twb, vel0, bg0, ba0, Rwg0, pre: dict, g_value: float, prior_bg,
                       prior_ba, iterations: int = 200, info_prior_gyr: float = 1e2,
                       info_prior_acc: float = 1e5, lam0: float = 1e-4):
    """The initialization's LM over every keyframe's velocity, one shared
    (bg, ba) with priors of information ``info_prior_gyr`` and
    ``info_prior_acc`` at (prior_bg, prior_ba), and the gravity direction
    Rwg = Rwg0 · Exp((δx, δy, 0)); poses fixed, each factor's deltas
    linearized at (bg0, ba0) and weighed by ``pre["info"]``. Returns
    (velocities (F, 3), bg, ba, Rwg)."""
    args = [x.to(F64) for x in (Rwb, twb, vel0, bg0, ba0, Rwg0, prior_bg, prior_ba)]
    Rwb, twb, vel0, bg0, ba0, Rwg0, prior_bg, prior_ba = args
    p = {k: v.to(F64) for k, v in pre.items()}
    f = Rwb.shape[0]
    n = 3 * f + 8
    dev = twb.device

    def unpack(x):
        v = x[:3 * f].reshape(f, 3)
        g = torch.cat([x[3 * f + 6:], x.new_zeros(1)])
        return v, x[3 * f:3 * f + 3], x[3 * f + 3:3 * f + 6], Rwg0 @ wba._exp(g)

    def residuals(x):
        v, bg, ba, Rwg = unpack(x)
        r = imu_residual(Rwb[:-1], twb[:-1], v[:-1], Rwb[1:], twb[1:], v[1:], bg, ba, p["dR"],
                         p["dV"], p["dP"], p["JRg"], p["JVg"], p["JVa"], p["JPg"], p["JPa"],
                         bg0, ba0, p["dT"], Rwg, g_value)
        return torch.cat([r.reshape(-1), bg - prior_bg, ba - prior_ba])

    k = f - 1
    W = torch.zeros((9 * k + 6, 9 * k + 6), dtype=F64, device=dev)
    W[:9 * k, :9 * k] = torch.block_diag(*p["info"])
    W[9 * k:9 * k + 3, 9 * k:9 * k + 3] = info_prior_gyr * torch.eye(3, dtype=F64, device=dev)
    W[9 * k + 3:, 9 * k + 3:] = info_prior_acc * torch.eye(3, dtype=F64, device=dev)

    def cost(x):
        r = residuals(x)
        return r @ W @ r

    x = torch.cat([vel0.reshape(-1), bg0, ba0, torch.zeros(2, dtype=F64, device=dev)])
    c = cost(x)
    lam, nu = lam0, 2.0
    eye = torch.eye(n, dtype=F64, device=dev)
    for _ in range(iterations):
        J = torch.func.jacfwd(residuals)(x)
        r = residuals(x)
        JtW = J.T @ W
        dx = torch.linalg.solve(JtW @ J + lam * eye, -(JtW @ r))
        cand = x + dx
        c2 = cost(cand)
        if bool(torch.isfinite(c2)) and bool(c2 < c):
            x, c, lam, nu = cand, c2, lam / 3.0, 2.0
        else:
            lam, nu = lam * nu, nu * 2.0
    return unpack(x)
