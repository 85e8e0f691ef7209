"""Device-resident RANSAC PnP.

Port of ``airslam_tpu/backend/pnp.py``. The reference calls
``cv::solvePnPRansac`` on the host (``SolvePnPWithCV``,
g2o_optimization.cc:1085-1134: 100 iterations, 20 px, 0.99); the pipelines
keep that call, and this module is the alternative that stays on the device
(``MapBuilder(use_jax_pnp=True)``):

- all hypotheses are solved at once: one batched SVD of the (H, 12, 12) DLT
  systems (H = 128), each from 6 points drawn with replacement among the
  valid entries;
- the minimal solver is the 6-point DLT with the rotation block projected
  onto SO(3) (orthogonal Procrustes);
- inliers are counted against the reference's 20 px reprojection gate;
- the best hypothesis is refined by 5 Gauss-Newton steps on its inliers, with
  the analytic Jacobian of the left-multiplied rotation update.

The draws come from an explicit ``torch.Generator`` (the builder seeds it
with the frame id), or from ``samples`` given by the caller, so that a test
can hand the JAX function and this one the same minimal sets.
"""

from __future__ import annotations

from typing import Optional

import torch

from airslam_tpu_torch.core import lie


def _dlt_pose(points, uv_norm, sel):
    """Minimal DLT: points (N, 3), uv_norm (N, 2) normalized image
    coordinates, sel (…, S) indices of minimal sets. Returns (Rcw (…, 3, 3),
    tcw (…, 3))."""
    p = points[sel]  # (…, S, 3)
    u = uv_norm[sel]
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)  # (…, S, 4)
    zeros = torch.zeros_like(ph)
    rows_u = torch.cat([ph, zeros, -u[..., 0:1] * ph], dim=-1)  # (…, S, 12)
    rows_v = torch.cat([zeros, ph, -u[..., 1:2] * ph], dim=-1)
    a = torch.cat([rows_u, rows_v], dim=-2)  # (…, 2S, 12)
    # the null vector: the right singular vector of the least singular value
    vh = torch.linalg.svd(a, full_matrices=True)[2]
    h = vh[..., -1, :].reshape(*vh.shape[:-2], 3, 4)
    # scale and chirality: |det R| = 1, the first point in front
    scale = torch.linalg.det(h[..., :3]).abs().pow(1.0 / 3.0)
    scale = torch.where(scale < 1e-12, torch.ones_like(scale), scale)
    h = h / scale[..., None, None]
    depth0 = (h[..., 2, :3] * p[..., 0, :]).sum(-1) + h[..., 2, 3]
    h = h * torch.where(depth0 < 0, -1.0, 1.0).to(h.dtype)[..., None, None]
    return lie.normalize_rotation(h[..., :3]), h[..., 3]


def _project(r, t, points, intr):
    """Camera coordinates and pixels of ``points`` (N, 3) under (…, 3, 3) /
    (…, 3); the depth guarded as the JAX function guards it."""
    pc = points @ r.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = pc[..., 0] / z * intr.fx + intr.cx
    v = pc[..., 1] / z * intr.fy + intr.cy
    return pc, z, u, v


def _reproj_errors(r, t, points, uv, intr):
    """Pixel reprojection errors (…, N); 1e9 for points behind the camera."""
    pc, _, u, v = _project(r, t, points, intr)
    err = torch.sqrt((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2)
    return torch.where(pc[..., 2] > 0, err, torch.full_like(err, 1e9))


def _gn_step(r, t, points, uv, mask, intr, reproj_thr):
    """One Gauss-Newton step on the inliers of (r, t): residuals weighted by
    the inlier flags, the update R ← exp(δθ) R, t ← t + δt."""
    w = ((_reproj_errors(r, t, points, uv, intr) < reproj_thr) & mask).to(points.dtype)
    pc, z, u, v = _project(r, t, points, intr)
    res = torch.stack([u - uv[:, 0], v - uv[:, 1]], dim=-1) * w[:, None]  # (N, 2)
    zs = torch.where(pc[:, 2].abs() < 1e-9, torch.zeros_like(z), torch.ones_like(z))
    # d(u, v)/d pc, with the guarded depth's derivative where it is guarded
    zero = torch.zeros_like(z)
    du = torch.stack([intr.fx / z, zero, -intr.fx * pc[:, 0] / (z * z) * zs], dim=-1)
    dv = torch.stack([zero, intr.fy / z, -intr.fy * pc[:, 1] / (z * z) * zs], dim=-1)
    dproj = torch.stack([du, dv], dim=-2) * w[:, None, None]  # (N, 2, 3)
    rp = points @ r.transpose(-1, -2)  # (N, 3): d pc / d δθ = −[R p]×, d pc / d δt = I
    dpc = torch.cat([-lie.hat(rp), torch.eye(3, dtype=r.dtype, device=r.device)
                     .expand(rp.shape[0], 3, 3)], dim=-1)  # (N, 3, 6)
    jac = (dproj @ dpc).reshape(-1, 6)
    res = res.reshape(-1)
    h = jac.T @ jac + 1e-6 * torch.eye(6, dtype=r.dtype, device=r.device)
    dx = torch.linalg.solve(h, -(jac.T @ res))
    return lie.so3_exp(dx[:3]) @ r, t + dx[3:]


def draw_samples(mask: torch.Tensor, iterations: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(iterations, 6) indices drawn with replacement, uniformly among the
    valid entries of ``mask`` (among all when none is valid), as
    ``jax.random.categorical`` draws them from 0 / −1e9 logits."""
    weights = torch.where(mask, 1.0, 1e-30).to(torch.float64)
    return torch.multinomial(weights, iterations * 6, replacement=True,
                             generator=generator).reshape(iterations, 6)


def solve_pnp_ransac(points, uv, mask, intr, generator: Optional[torch.Generator] = None,
                     iterations: int = 128, reproj_thr: float = 20.0, refine_steps: int = 5,
                     samples: Optional[torch.Tensor] = None):
    """points (N, 3) world points (padded), uv (N, 2) pixels, mask (N,)
    validity, ``intr`` the camera's intrinsics. ``samples``: (iterations, 6)
    minimal sets to use instead of drawing them from ``generator``. Returns
    (Rcw, tcw, inliers (N,) bool, ok) as tensors on the points' device; no
    value is read back to the host."""
    uv_norm = torch.stack([(uv[:, 0] - intr.cx) / intr.fx, (uv[:, 1] - intr.cy) / intr.fy],
                          dim=1)
    if samples is None:
        samples = draw_samples(mask, iterations, generator)
    sel = samples.to(points.device, torch.long)
    rs, ts = _dlt_pose(points, uv_norm, sel)
    inl = (_reproj_errors(rs, ts, points, uv, intr) < reproj_thr) & mask
    scores = inl.sum(-1)
    best = torch.argmax(scores)  # the first of equal counts, as jnp.argmax
    r, t = rs[best], ts[best]
    ok = scores[best] >= 6
    for _ in range(refine_steps):
        r, t = _gn_step(r, t, points, uv, mask, intr, reproj_thr)
    inliers = (_reproj_errors(r, t, points, uv, intr) < reproj_thr) & mask
    return r, t, inliers, ok & (inliers.sum() >= 6)
