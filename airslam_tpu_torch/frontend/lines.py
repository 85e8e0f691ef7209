"""Line feature processing: point↔line association, line matching through
shared point matches, and stereo line triangulation.

Port of the tracking part of ``airslam_tpu/frontend/lines.py`` (which
replaces ``src/line_processor.cc``):

- ``AssignPointsToLines`` (line_processor.cc:68-120) as one dense (L, K)
  computation of point-line distance + bounding-box + endpoint-segment tests;
- ``MatchLines`` (line_processor.cc:122-180): the vote matrix over
  (line0, line1) as one matrix product with the point-match incidence;
- ``TriangulateByStereo`` (line_processor.cc:196-245) over all line pairs.

The two-view triangulation and the ``endpoint_trim*`` functions belong to the
window backend and the map and are not ported yet.
"""

from __future__ import annotations

import torch

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
