"""Point matcher: LightGlue or SuperGlue with the fixed-shape mutual-argmax
decode.

Port of ``airslam_tpu/frontend/matcher.py``: keypoint normalization
(point_matcher.cc:39-49, scale 0.5 LightGlue / 0.7 SuperGlue), the network,
mutual argmax with the exp-score gate (0.1 / 0.2), and optional
fundamental-matrix RANSAC outlier rejection (OpenCV, imported only when asked
for).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from airslam_tpu_torch import resolve_device
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.models.lightglue import LightGlue, normalize_keypoints
from airslam_tpu_torch.models.superglue import SuperGlue
from airslam_tpu_torch.ops.match import Matches, mutual_match


MATCHER_FILES = {0: "lightglue.npz", 1: "superglue.npz"}  # checkpoint per ``matcher:``


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    matcher: int = 0  # 0 lightglue, 1 superglue (vo_euroc.yaml:10)
    image_width: int = 752
    image_height: int = 480
    max_keypoints: int = 512  # static token budget (engine profile ≤1024)
    sinkhorn_iterations: int = 0  # SuperGlue OT (reference ships it disabled)
    # LightGlue's attention through the fused kernel (ops/attention.flash_mha,
    # kernel F on the card) instead of plain tensor ops: 36 launches per pass
    use_flash: bool = False
    dtype: Any = torch.float32


def _reject_outliers(p0, p1, i0, i1, sc):
    """Fundamental-matrix RANSAC (20 px, 0.99), point_matcher.cc:105-119.
    OpenCV 4.13 raises on exact correspondences of a pure translation where
    OpenCV 5.0 returns a model that keeps every match; the matches are then
    kept, as 5.0 keeps them."""
    import cv2

    try:
        _, inl = cv2.findFundamentalMat(p0.astype(np.float32), p1.astype(np.float32),
                                        cv2.FM_RANSAC, 20.0, 0.99)
    except cv2.error:
        inl = None
    if inl is None:
        return i0, i1, sc
    good = inl.ravel().astype(bool)
    return i0[good], i1[good], sc[good]


class PointMatcher:
    """LightGlue (``matcher: 0``, the shipped ``lightglue.npz``) or SuperGlue
    (``matcher: 1``, ``superglue.npz``, Sinkhorn iterations from the config).
    ``device``: ``cuda`` unless the caller passes another. ``params``: the
    matcher's tree in the JAX layout (a ``--model_dir``'s ``lightglue.npz`` /
    ``superglue.npz``) in place of the shipped one."""

    def __init__(self, config: MatcherConfig = MatcherConfig(), device=None, params=None):
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            params = wio.load_npz(wio.checkpoint_path(MATCHER_FILES[config.matcher]))
        if config.matcher == 0:
            self.threshold = 0.1  # exp-score gate (light_glue.cpp:214-266)
            self.norm_scale = 0.5  # NormalizeKeypoints scale
            self.model = LightGlue(dtype=config.dtype, use_flash=config.use_flash)
            self.model.load_state_dict(wio.lightglue_from_flax(params))
        else:
            self.threshold = 0.2  # super_glue.cpp:339-367
            self.norm_scale = 0.7
            self.model = SuperGlue(dtype=config.dtype,
                                   sinkhorn_iterations=config.sinkhorn_iterations)
            self.model.load_state_dict(wio.superglue_from_flax(params))
        self.model.to(self.device).eval()

    @torch.no_grad()
    def match(self, kpts0, scores0, desc0, mask0, kpts1, scores1, desc1, mask1,
              threshold: Optional[float] = None) -> Matches:
        """Keypoints (…, N, 2) in pixels, descriptors (…, N, 256), masks
        (…, N), padded to a fixed token count; any leading batch dimensions
        go through the network as ONE forward pass. ``scores0``/``scores1``
        (…, N) are the keypoint scores SuperGlue reads; LightGlue ignores them.
        Returns fixed-shape Matches."""
        cfg = self.config
        thr = self.threshold if threshold is None else threshold

        def t(a, dtype=torch.float32):
            return torch.as_tensor(a, device=self.device).to(dtype)

        nk0 = normalize_keypoints(t(kpts0), cfg.image_width, cfg.image_height,
                                  self.norm_scale)
        nk1 = normalize_keypoints(t(kpts1), cfg.image_width, cfg.image_height,
                                  self.norm_scale)
        m0, m1 = t(mask0, torch.bool), t(mask1, torch.bool)
        if cfg.matcher == 0:
            with torch.profiler.record_function("lightglue"):
                scores, _, _ = self.model(nk0, t(desc0), m0, nk1, t(desc1), m1)
        else:
            with torch.profiler.record_function("superglue"):
                scores = self.model(nk0, t(scores0), t(desc0), m0,
                                    nk1, t(scores1), t(desc1), m1)
        with torch.profiler.record_function("match"):
            return mutual_match(scores, m0, m1, thr)

    @staticmethod
    def _pairs(mask, idx1, score, f0, f1, outlier_rejection):
        """Host decode of one pair's Matches (numpy rows)."""
        i0 = np.nonzero(mask)[0]
        i1 = idx1[i0]
        sc = score[i0]
        if outlier_rejection and len(i0) > 8:
            p0 = np.asarray(torch.as_tensor(f0.keypoints).cpu())[i0]
            p1 = np.asarray(torch.as_tensor(f1.keypoints).cpu())[i1]
            i0, i1, sc = _reject_outliers(p0, p1, i0, i1, sc)
        return np.stack([i0, i1], axis=-1).astype(np.int32), sc

    def matching_points(self, feats0, feats1, outlier_rejection: bool = False,
                        threshold: Optional[float] = None):
        """(M, 2) int32 match index pairs + (M,) scores (``MatchingPoints``)."""
        return self.matching_points_batched([(feats0, feats1)], outlier_rejection,
                                            threshold)[0]

    def matching_points_batched(self, pairs, outlier_rejection: bool = False,
                                threshold: Optional[float] = None):
        """Match B (feats0, feats1) pairs in ONE batched forward pass over
        (B, N, …) — a frame's stereo and temporal match together. Returns a
        list of what :meth:`matching_points` returns for each pair."""
        if not pairs:
            return []

        def stack(side, field):
            return torch.stack([torch.as_tensor(getattr(p[side], field), device=self.device)
                                for p in pairs])

        # LightGlue reads no keypoint scores, so they are stacked for SuperGlue only
        sg = self.config.matcher != 0
        m = self.match(stack(0, "keypoints"), stack(0, "kp_scores") if sg else None,
                       stack(0, "kp_desc"), stack(0, "kp_mask"),
                       stack(1, "keypoints"), stack(1, "kp_scores") if sg else None,
                       stack(1, "kp_desc"), stack(1, "kp_mask"), threshold=threshold)
        # one host pull for the whole batch
        mask, idx1, score = (a.cpu().numpy() for a in (m.mask, m.idx1, m.score))
        return [self._pairs(mask[b], idx1[b], score[b], f0, f1, outlier_rejection)
                for b, (f0, f1) in enumerate(pairs)]
