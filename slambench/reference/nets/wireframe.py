"""Fixed-shape wireframe decode: junction selection, proposal↔junction
matching, pair dedup, and final line/junction gating.

Port of ``airslam_tpu/ops/wireframe.py`` (the host-side
``PLNet::wireframe_matcher``, plnet.cpp:272-307, and the final decode,
plnet.cpp:519-585, with static shapes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference.nets.detect import simple_nms, top_k, topk_grid
from slambench.reference.nets.gather import take_rows, take_values


class Junctions(NamedTuple):
    xy: torch.Tensor  # (J, 2) in stride-4 grid coordinates
    score: torch.Tensor  # (J,)
    mask: torch.Tensor  # (J,)


class LineCandidates(NamedTuple):
    pairs: torch.Tensor  # (L, 2) int64 junction indices (max_idx, min_idx)
    lines: torch.Tensor  # (L, 4) endpoint coords in stride-4 grid
    mask: torch.Tensor  # (L,)
    prop_lines: torch.Tensor  # (L, 4) representative proposal endpoints


class DecodedLines(NamedTuple):
    lines: torch.Tensor  # (L, 4) in 512-space pixels
    score: torch.Tensor  # (L,)
    mask: torch.Tensor  # (L,) — passed line_threshold + min length
    junction_xy: torch.Tensor  # (L, 4) int endpoints marked in the junction map
    junction_valid: torch.Tensor  # (L, 2) per-endpoint in-border validity


def decode_junctions(junc_heat: torch.Tensor, junc_offset: torch.Tensor,
                     k: int) -> Junctions:
    """Top-k junctions from the stride-4 heatmap with sub-cell offsets."""
    h, w = junc_heat.shape
    nmsed = simple_nms(junc_heat, 1)
    if h % 4 == 0 and w % 4 == 0 and (h // 4) * (w // 4) >= 2 * k:
        score, idx = topk_grid(nmsed, k, 4)
    else:
        score, idx = top_k(nmsed.reshape(-1), k)
    ys = (idx // w).float()
    xs = (idx % w).float()
    off = take_rows(junc_offset.reshape(h * w, 2), idx)
    xy = torch.stack([xs, ys], dim=-1) + off
    return Junctions(xy=xy, score=score, mask=score > 0)


def match_proposals(line_pred: torch.Tensor, line_logit: torch.Tensor,
                    juncs: Junctions, match_threshold: float = 5.0,
                    logit_threshold: float = None):
    """Attach each proposal endpoint to its nearest junction. Returns
    (keep (P,), jmin (P,), jmax (P,)) — ``iskeep`` / ``idx_junc_to_end_min``
    / ``idx_junc_to_end_max`` of plnet.cpp:453-458. ``argmin`` takes the
    first index on ties, as in JAX."""
    jxy = torch.where(juncs.mask[:, None], juncs.xy, torch.full_like(juncs.xy, 1e6))
    pts = torch.cat([line_pred[:, 0:2], line_pred[:, 2:4]], dim=0)
    diff = pts[:, None, :] - jxy[None, :, :]
    dall = torch.sum(diff * diff, dim=-1)  # (2P, J)
    dmin = dall.min(dim=1).values
    jall = dall.argmin(dim=1)
    p = line_pred.shape[0]
    j1, j2 = jall[:p], jall[p:]
    d1, d2 = dmin[:p], dmin[p:]
    thr2 = match_threshold * match_threshold
    keep = (d1 < thr2) & (d2 < thr2) & (j1 != j2)
    if logit_threshold is not None:
        keep = keep & (line_logit > logit_threshold)
    return keep, torch.minimum(j1, j2), torch.maximum(j1, j2)


def dedup_pairs(keep: torch.Tensor, jmin: torch.Tensor, jmax: torch.Tensor,
                juncs: Junctions, num_junctions: int, max_lines: int,
                line_pred: torch.Tensor = None) -> LineCandidates:
    """Unique (jmin, jmax) pairs in first-occurrence order, capped at
    ``max_lines`` (the ``unique_map`` walk, plnet.cpp:283-305). Candidate
    endpoints are the junction coordinates, ordered (jmax, jmin).

    Sort-based: (key, order) packed into one int64, sorted, each key's first
    entry marked, survivors ranked by original order. int64 cannot overflow
    here, so the JAX int32 scatter-min fallback has no counterpart.

    ``line_pred`` (P, 4): when given, also returns each unique pair's
    representative proposal (the first kept proposal deduplicating to it).
    """
    p = keep.shape[0]
    n_keys = num_junctions * num_junctions
    key = jmin * num_junctions + jmax
    order = torch.arange(p, device=keep.device)
    packed = torch.where(keep, key * p + order, torch.full_like(key, n_keys * p))
    packed = torch.sort(packed).values
    skey = packed // p
    sorder = packed % p
    first = torch.ones(1, dtype=torch.bool, device=keep.device)
    is_first = torch.cat([first, skey[1:] != skey[:-1]]) & (skey < n_keys)
    rank = torch.where(is_first, sorder, torch.full_like(sorder, p))
    if p < max_lines:  # tiny inputs: pad so k ≤ n
        rank = torch.cat([rank, rank.new_full((max_lines - p,), p)])
        skey = torch.cat([skey, skey.new_full((max_lines - p,), n_keys)])
    neg_order, sel = top_k(-rank, max_lines)
    uniq_key = take_values(skey, sel)
    first_occ = -neg_order
    valid = first_occ < p
    pair_min = uniq_key // num_junctions
    pair_max = uniq_key % num_junctions
    p1 = take_rows(juncs.xy, pair_max)
    p2 = take_rows(juncs.xy, pair_min)
    lines = torch.cat([p1, p2], dim=-1)
    if line_pred is not None:
        prop_lines = take_rows(line_pred, first_occ.clamp(0, p - 1))
    else:
        prop_lines = lines
    return LineCandidates(pairs=torch.stack([pair_max, pair_min], dim=-1),
                          lines=lines, mask=valid, prop_lines=prop_lines)


def gate_lines(lines_adjusted: torch.Tensor, scores_line: torch.Tensor,
               cand_mask: torch.Tensor, image_hw: tuple, border: int,
               line_threshold: float, length_threshold: float) -> DecodedLines:
    """Final gating (plnet.cpp:519-558): ×4 upscale, junction-map marking at
    score ≥ 0.5; kept lines need score ≥ line_threshold and length ≥
    length_threshold px."""
    h, w = image_hw
    xy = lines_adjusted * 4.0
    xi = (xy + 0.1).to(torch.int32)  # truncation toward zero, as astype
    p1_ok = ((xi[:, 0] > border) & (xi[:, 0] < w - border)
             & (xi[:, 1] > border) & (xi[:, 1] < h - border))
    p2_ok = ((xi[:, 2] > border) & (xi[:, 2] < w - border)
             & (xi[:, 3] > border) & (xi[:, 3] < h - border))
    junction_line = cand_mask & (scores_line >= 0.5)
    dx = xy[:, 2] - xy[:, 0]
    dy = xy[:, 3] - xy[:, 1]
    length2 = dx * dx + dy * dy
    keep = (junction_line & (scores_line >= line_threshold)
            & (length2 >= length_threshold * length_threshold))
    return DecodedLines(
        lines=xy,
        score=torch.where(cand_mask, scores_line, torch.zeros_like(scores_line)),
        mask=keep,
        junction_xy=torch.where(junction_line[:, None], xi, -torch.ones_like(xi)),
        junction_valid=torch.stack([p1_ok & junction_line, p2_ok & junction_line], dim=-1),
    )


def collect_junction_keypoints(decoded: DecodedLines, heat: torch.Tensor,
                               max_junctions: int) -> Junctions:
    """Deduplicate accepted line endpoints into junction keypoints with the
    heatmap score attached (``junction_detector``, plnet.cpp:425-448): a
    stable sort over the endpoints' flat pixel indices, first of each kept."""
    h, w = heat.shape
    exy = decoded.junction_xy.reshape(-1, 2).long()
    evalid = decoded.junction_valid.reshape(-1)
    n = exy.shape[0]
    ys_i = exy[:, 1].clamp(0, h - 1)
    xs_i = exy[:, 0].clamp(0, w - 1)
    score_at = heat[ys_i, xs_i]
    flat_idx = ys_i * w + xs_i
    key = torch.where(evalid, flat_idx, torch.full_like(flat_idx, h * w))
    skey, perm = torch.sort(key, stable=True)
    sscore = score_at[perm]
    first = torch.ones(1, dtype=torch.bool, device=heat.device)
    is_first = torch.cat([first, skey[1:] != skey[:-1]]) & (skey < h * w)
    safe = torch.clamp(skey, max=h * w - 1)
    cand_score = torch.where(is_first, sscore, torch.full_like(sscore, -1.0))
    k = min(max_junctions, n)
    score, sel = top_k(cand_score, k)
    pos = take_values(safe, sel)
    xs = (pos % w).float()
    ys = (pos // w).float()
    mask = score > -1.0
    score = torch.where(mask, score, torch.zeros_like(score))
    if k < max_junctions:  # tiny-config padding
        pad = max_junctions - k
        xs = torch.cat([xs, xs.new_zeros(pad)])
        ys = torch.cat([ys, ys.new_zeros(pad)])
        score = torch.cat([score, score.new_zeros(pad)])
        mask = torch.cat([mask, mask.new_zeros(pad)])
    return Junctions(xy=torch.stack([xs, ys], dim=-1), score=score, mask=mask)
