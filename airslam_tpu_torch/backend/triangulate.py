"""Triangulation.

Port of ``airslam_tpu/backend/triangulate.py`` (whole file):

- :func:`triangulate_point` — multi-view linear least squares from bearing
  vectors with a rank check (``Map::TriangulateMappoint``, map.cc:367-414).
- :func:`fit_line_huber` — robust 3D line fit over points with reject-refit
  rounds (``Map::TriangulateMaplineByMappoints``'s cv::fitLine DIST_HUBER +
  4 rounds at 0.1 m, map.cc:416-504), as a fixed-iteration IRLS on masked
  arrays.

Every function takes any number of leading batch dimensions (the JAX package
batches with ``vmap``); the ``*_batch`` names are kept for its callers.
"""

from __future__ import annotations

import torch


def triangulate_point(Rcw, tcw, uv, mask, intr, min_obs: int = 2):
    """Rcw: (…, N, 3, 3); tcw: (…, N, 3); uv: (…, N, 2) pixel observations;
    mask: (…, N).

    Midpoint-style linear system: for each view, the bearing b_i (unit) and
    camera centre c_i give the constraint (I − b bᵀ)(x − c) = 0.
    Returns (point (…, 3), ok (…,))."""
    bearings_c = intr.back_project_mono(uv)
    Rwc = Rcw.mT
    centers = -torch.einsum("...nij,...nj->...ni", Rwc, tcw)
    b = torch.einsum("...nij,...nj->...ni", Rwc, bearings_c)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True).clamp(min=1e-12)

    eye = torch.eye(3, dtype=b.dtype, device=b.device)
    P = eye - torch.einsum("...ni,...nj->...nij", b, b)  # (…, N, 3, 3)
    P = P * mask[..., None, None]
    A = P.sum(dim=-3)
    rhs = torch.einsum("...nij,...nj->...ni", P, centers).sum(dim=-2)
    # rank / conditioning check via the smallest eigenvalue
    evals = torch.linalg.eigvalsh(A)
    ok = (mask.sum(dim=-1) >= min_obs) & (evals[..., 0] > 1e-6)
    x = torch.linalg.solve(A + (~ok).to(A.dtype)[..., None, None] * eye, rhs)
    return x, ok


def triangulate_points_batch(Rcw, tcw, uv, mask, intr, min_obs: int = 2):
    """:func:`triangulate_point` over (B, N, …) grids in one call."""
    return triangulate_point(Rcw, tcw, uv, mask, intr, min_obs)


def fit_line_huber(points, mask, rounds: int = 4, inlier_dist: float = 0.1,
                   huber_delta: float = 0.05):
    """Robust line fit: IRLS around (centroid, principal direction) with
    reject-refit rounds dropping points farther than ``inlier_dist``.
    points (…, N, 3), mask (…, N).

    Returns (cartesian line (…, 6) = (p0, d), inlier_mask (…, N), ok (…,))."""
    base = mask.to(points.dtype)

    def fit(m_):
        wsum = m_.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        mean = (points * m_[..., None]).sum(dim=-2) / wsum
        centered = (points - mean[..., None, :]) * m_[..., None]
        cov = centered.mT @ centered / wsum[..., None]
        _, evecs = torch.linalg.eigh(cov)
        return mean, evecs[..., :, -1]

    def dist_to(mean, d):
        rel = points - mean[..., None, :]
        proj = rel - torch.einsum("...ni,...i->...n", rel, d)[..., None] * d[..., None, :]
        return torch.linalg.norm(proj, dim=-1)

    m = base
    for _ in range(rounds):
        dist = dist_to(*fit(m))
        w = torch.where(dist < huber_delta, torch.ones_like(dist),
                        huber_delta / dist.clamp(min=1e-9))
        m = base * w * (dist < inlier_dist)
    mean, d = fit(m)
    inliers = mask & (dist_to(mean, d) < inlier_dist)
    return torch.cat([mean, d], dim=-1), inliers, inliers.sum(dim=-1) >= 2


def extreme_projections(line_cart, points, mask):
    """Endpoints from the extreme projections of the inlier points onto the
    line (map.cc endpoint selection). Returns (…, 6) endpoints."""
    p0, d = line_cart[..., 0:3], line_cart[..., 3:6]
    t = torch.einsum("...ni,...i->...n", points - p0[..., None, :], d)
    inf = torch.full_like(t, float("inf"))
    t_min = torch.where(mask, t, inf).amin(dim=-1, keepdim=True)
    t_max = torch.where(mask, t, -inf).amax(dim=-1, keepdim=True)
    return torch.cat([p0 + t_min * d, p0 + t_max * d], dim=-1)


def fit_lines_batch(points, mask):
    """Robust line fits over a (B, P, 3) point grid in one call:
    :func:`fit_line_huber` + :func:`extreme_projections`.
    Returns (endpoints (B, 6), ok (B,))."""
    cart, inliers, ok = fit_line_huber(points, mask)
    return extreme_projections(cart, points, inliers), ok
