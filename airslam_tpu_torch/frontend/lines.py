"""Line feature processing: point↔line association, line matching through
shared point matches, and stereo line triangulation.

Port of ``airslam_tpu/frontend/lines.py`` (which replaces
``src/line_processor.cc``):

- ``AssignPointsToLines`` (line_processor.cc:68-120) as one dense (L, K)
  computation of point-line distance + bounding-box + endpoint-segment tests;
- ``MatchLines`` (line_processor.cc:122-180): the vote matrix over
  (line0, line1) as one matrix product with the point-match incidence;
- ``TriangulateByStereo`` (line_processor.cc:196-245) over all line pairs;
- the two-view plane-intersection triangulation (line_processor.cc:275-310),
  ``Point2DTo3D`` and the endpoint trim of the map's endpoint maintenance
  (tensor and numpy forms).
"""

from __future__ import annotations

import numpy as np
import torch

from airslam_tpu_torch.core import lie

POINT_LINE_DIST = 3.0  # px


def point_line_relation(lines, line_mask, kpts, kp_mask, max_dist: float = POINT_LINE_DIST):
    """Dense point-on-line relation.

    lines: (L, 4) endpoints; kpts: (K, 2). Returns (rel (L, K) bool,
    dist (L, K)). A point belongs to a line iff it is within ``max_dist`` px
    of the infinite line, inside the segment bbox inflated by ``max_dist``,
    and near the segment (endpoint balls of radius 3 or the obtuse-angle
    test) — line_processor.cc:92-116."""
    x1, y1, x2, y2 = (lines[:, i, None] for i in range(4))
    px, py = kpts[None, :, 0], kpts[None, :, 1]

    a = y2 - y1
    b = x1 - x2
    c = x2 * y1 - x1 * y2
    d = torch.sqrt(a * a + b * b)
    dist = torch.abs(a * px + b * py + c) / torch.clamp(d, min=1e-12)

    in_box = ((px >= torch.minimum(x1, x2) - max_dist) & (px <= torch.maximum(x1, x2) + max_dist)
              & (py >= torch.minimum(y1, y2) - max_dist)
              & (py <= torch.maximum(y1, y2) + max_dist))

    side1 = (x1 - px) ** 2 + (y1 - py) ** 2
    side2 = (x2 - px) ** 2 + (y2 - py) ** 2
    line_len2 = d * d
    near_segment = ((side1 <= 9.0) | (side2 <= 9.0)
                    | ((side1 < line_len2 + side2) & (side2 < line_len2 + side1)))

    rel = ((dist <= max_dist) & in_box & near_segment
           & line_mask[:, None] & kp_mask[None, :])
    return rel, dist


def match_lines_by_points(rel0, rel1, match_idx1, match_mask, min_votes: int = 2,
                          min_score: float = 0.8):
    """Line matching from shared point matches (line_processor.cc:122-180).

    rel0: (L0, K0) bool point-on-line; rel1: (L1, K1); match_idx1: (K0,) the
    image-1 index each image-0 point matched (−1 invalid); match_mask: (K0,).
    Returns (L0,) int64 line match indices into image 1 (−1 = none).

    Votes V[i, j] = Σ_k rel0[i, k] · matched[k] · rel1[j, idx1[k]] (small
    integers, exact in float32). Acceptance: mutual row/col argmax (first
    index on ties), ≥ min_votes, and votes² / min(|pts0|, |pts1|) ≥ min_score."""
    safe_idx = torch.where(match_mask, match_idx1, torch.zeros_like(match_idx1)).long()
    hit = rel1[:, safe_idx].float() * match_mask.float()[None, :]  # (L1, K0)
    votes = rel0.float() @ hit.T  # (L0, L1)

    best_v = votes.max(dim=1).values
    row_best = votes.argmax(dim=1)
    col_best = votes.argmax(dim=0)
    mutual = col_best[row_best] == torch.arange(votes.shape[0], device=votes.device)

    n0 = rel0.sum(dim=1).float()
    n1 = rel1.sum(dim=1).float()
    denom = torch.minimum(n0, n1[row_best])
    score = best_v * best_v / torch.clamp(denom, min=1.0)

    ok = mutual & (best_v >= min_votes) & (score >= min_score)
    return torch.where(ok, row_best, torch.full_like(row_best, -1))


def frame_relations(lines_l, lmask_l, kpts_l, kmask_l,
                    lines_r, lmask_r, kpts_r, kmask_r, idx1, msk):
    """A frame's line bookkeeping: the left point-on-line relation, the right
    one, and the stereo line match through the shared point matches. Returns
    (rel_l (L, K) bool, line_match (L,))."""
    rel_l, _ = point_line_relation(lines_l, lmask_l, kpts_l, kmask_l)
    rel_r, _ = point_line_relation(lines_r, lmask_r, kpts_r, kmask_r)
    return rel_l, match_lines_by_points(rel_l, rel_r, idx1, msk)


def _guard(x, eps=1e-9):
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def triangulate_stereo_lines(lines_left, lines_right, valid, Rwc, twc, intr,
                             min_x_diff, max_x_diff):
    """Stereo line triangulation over all pairs (line_processor.cc:196-245).

    lines_left/right: (L, 4) matched rectified segments. Returns
    (endpoints_w (L, 6) world endpoints, ok (L,))."""
    x11, y11, x12, y12 = (lines_left[:, i] for i in range(4))
    x21, y21, x22, y22 = (lines_right[:, i] for i in range(4))

    dxl, dyl = x12 - x11, y12 - y11
    angle_l = torch.atan(dyl / _guard(dxl))
    dxr, dyr = x22 - x21, y22 - y21
    angle_r = torch.atan(dyr / _guard(dxr))
    not_horizontal = ((dyl.abs() > 3) & (angle_l.abs() >= 0.175)
                      & (dyr.abs() > 3) & (angle_r.abs() >= 0.175))

    k_inv = dxr / _guard(dyr)
    x11r = x21 + k_inv * (y11 - y21)
    x12r = x21 + k_inv * (y12 - y21)

    d1 = x11 - x11r
    d2 = x12 - x12r
    disp_ok = ((d1 >= min_x_diff) & (d1 <= max_x_diff)
               & (d2 >= min_x_diff) & (d2 <= max_x_diff))

    p1 = intr.back_project_stereo(torch.stack([x11, y11, x11r], dim=-1))
    p2 = intr.back_project_stereo(torch.stack([x12, y12, x12r], dim=-1))
    p1w = p1 @ Rwc.T + twc
    p2w = p2 @ Rwc.T + twc
    return torch.cat([p1w, p2w], dim=-1), valid & not_horizontal & disp_ok


def _dot(a, b):
    return (a * b).sum(dim=-1)


def triangulate_two_views(line2d_1, Twc1_R, Twc1_t, line2d_2, Twc2_R, Twc2_t, intr,
                          min_angle_cos: float = 1.0):
    """Two-view plane-intersection triangulation (line_processor.cc:275-310).

    Each observation back-projects to a plane through the camera centre; the
    3D line is the plane intersection, expressed in world Plücker (w, d).
    Returns (line_w (…, 6), degenerate mask where the planes are near-parallel).
    """
    def plane_from_obs(line2d):
        p1 = intr.back_project_mono(line2d[..., 0:2])
        p2 = intr.back_project_mono(line2d[..., 2:4])
        n = torch.linalg.cross(p1, p2)
        # plane through the origin of that camera frame: n·x = 0
        return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-12)

    # plane 1 in the camera-1 frame: (n1, 0)
    n1 = plane_from_obs(line2d_1)
    # camera 2 expressed in the camera-1 frame
    R12 = Twc1_R.mT @ Twc2_R
    t12 = torch.einsum("...ij,...j->...i", Twc1_R.mT, Twc2_t - Twc1_t)
    n2 = torch.einsum("...ij,...j->...i", R12, plane_from_obs(line2d_2))
    d2 = -_dot(n2, t12)  # plane 2: n2·x + d2 = 0

    cos_theta = _dot(n1, n2).abs()
    # Plücker from two planes pi1 = (n1, d1=0), pi2 = (n2, d2): direction
    # d = n1×n2 and moment w = d1·n2 − d2·n1 (here d1 = 0).
    d = torch.linalg.cross(n1, n2)
    w = -d2[..., None] * n1
    line_c1 = lie.line_normalize(torch.cat([w, d], dim=-1))
    line_w = lie.line_transform(Twc1_R, Twc1_t, line_c1)
    return lie.line_normalize(line_w), cos_theta > min_angle_cos - 1e-12


def point_2d_to_3d(anchor_3d1, anchor_3d2, anchor_2d1, anchor_2d2, p2d):
    """Linear interpolation of a 2D point between two anchor correspondences
    onto the 3D segment (``Point2DTo3D``, line_processor.cc:328-338): the
    dominant image axis of the anchor segment gives the interpolation ratio."""
    d2d = anchor_2d2 - anchor_2d1
    md = torch.where(d2d[..., 0].abs() > d2d[..., 1].abs(), 0, 1)[..., None]
    num = torch.gather(p2d - anchor_2d1, -1, md)[..., 0]
    den = torch.gather(d2d, -1, md)[..., 0]
    rate = num / torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    return anchor_3d1 + rate[..., None] * (anchor_3d2 - anchor_3d1)


def endpoint_trim(line3d_w, obs_lines_2d, Rcw, tcw, intr):
    """Project 2D endpoint observations onto a 3D line to get world endpoints
    (endpoint maintenance, map.cc:192-340): back-project each observed
    endpoint ray and take the closest point on the 3D line."""
    cart = lie.line_to_cartesian(line3d_w)
    p0, dvec = cart[..., 0:3], cart[..., 3:6]
    Rwc = Rcw.mT
    origin = -torch.einsum("...ij,...j->...i", Rwc, tcw)

    def closest_on_line(uv):
        ray_w = torch.einsum("...ij,...j->...i", Rwc, intr.back_project_mono(uv))
        ray_w = ray_w / torch.linalg.norm(ray_w, dim=-1, keepdim=True).clamp(min=1e-12)
        # closest point on (p0, d) to the ray (origin, ray_w)
        w0 = origin - p0
        a, bq, cq = _dot(dvec, dvec), _dot(dvec, ray_w), _dot(ray_w, ray_w)
        dq, eq = _dot(dvec, w0), _dot(ray_w, w0)
        denom = a * cq - bq * bq
        s = torch.where(denom.abs() < 1e-12, torch.zeros_like(denom),
                        (dq * cq - bq * eq) / denom)
        return p0 + s[..., None] * dvec

    return torch.cat([closest_on_line(obs_lines_2d[..., 0:2]),
                      closest_on_line(obs_lines_2d[..., 2:4])], dim=-1)


def endpoint_trim_np(line3d_w, obs_lines_2d, Rcw, tcw, fx, fy, cx, cy):
    """Numpy twin of :func:`endpoint_trim` over N observations of ONE line —
    the host path of keyframe endpoint maintenance.

    line3d_w (6,) Plücker (w, d); obs_lines_2d (N, 4); Rcw (N, 3, 3);
    tcw (N, 3). Returns (N, 6) world endpoints."""
    line = np.asarray(line3d_w, np.float64)
    w, d = line[0:3], line[3:6]
    nd = max(float(np.linalg.norm(d)), 1e-12)
    w, d = w / nd, d / nd
    p0 = np.cross(d, w)
    n = np.asarray(obs_lines_2d).shape[0]
    return endpoint_trim_rows_np(np.broadcast_to(p0, (n, 3)), np.broadcast_to(d, (n, 3)),
                                 obs_lines_2d, Rcw, tcw, fx, fy, cx, cy)


def endpoint_trim_rows_np(p0, dvec, obs_lines_2d, Rcw, tcw, fx, fy, cx, cy):
    """Row-batched numpy endpoint trim: each row carries ITS OWN line
    (p0 (N, 3), dvec (N, 3) unit) and observation/camera, so that
    Map.update_maplines_endpoints_batch trims every (line, observer) pair of
    a BA window in one pass. Same math as :func:`endpoint_trim`."""
    p0 = np.asarray(p0, np.float64)
    dvec = np.asarray(dvec, np.float64)
    obs = np.asarray(obs_lines_2d, np.float64)
    Rwc = np.swapaxes(np.asarray(Rcw, np.float64), -1, -2)
    origin = -np.einsum("nij,nj->ni", Rwc, np.asarray(tcw, np.float64))

    def closest(uv):
        ray_c = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                          np.ones(len(uv))], axis=-1)
        ray_w = np.einsum("nij,nj->ni", Rwc, ray_c)
        ray_w /= np.clip(np.linalg.norm(ray_w, axis=-1, keepdims=True), 1e-12, None)
        w0 = origin - p0
        a = np.einsum("ni,ni->n", dvec, dvec)
        bq = np.einsum("ni,ni->n", ray_w, dvec)
        cq = np.einsum("ni,ni->n", ray_w, ray_w)
        dq = np.einsum("ni,ni->n", w0, dvec)
        eq = np.einsum("ni,ni->n", ray_w, w0)
        denom = a * cq - bq * bq
        small = np.abs(denom) < 1e-12
        s = np.where(small, 0.0, (dq * cq - bq * eq) / np.where(small, 1.0, denom))
        return p0 + s[:, None] * dvec

    return np.concatenate([closest(obs[:, 0:2]), closest(obs[:, 2:4])], axis=-1)
