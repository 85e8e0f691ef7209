"""Entry points of the port.

:class:`FrontendStep` — the stereo frontend step: rectify → PLNet + stage-1
LOI head → LightGlue → mutual match, on one 752×480 pair. Port of
``__graft_entry__.py:entry``'s ``frontend_step`` (the JAX package's flagship
program, ``use_superpoint=False``, ``loi_head="s1"``, ``matcher=0``) plus the
rectify step of ``MapBuilder.rectify`` (``pipelines/map_builder.py:100-121``),
which on the card is kernel R.

:func:`vo_map_builder` — the visual-odometry ``MapBuilder`` as
``configs/visual_odometry/vo_euroc.yaml`` sets it up (SuperPoint keypoints,
PLNet lines and junctions, LightGlue). ``add_input`` initialises it on the
first frame with enough stereo points and from then on tracks every frame,
inserts keyframes and runs the local BA; ``track_frame`` runs the per-frame
tracking path alone against the last keyframe.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from airslam_tpu_torch import resolve_device
from airslam_tpu_torch.frontend.detector import DetectorConfig, FeatureDetector
from airslam_tpu_torch.frontend.matcher import MatcherConfig, PointMatcher
from airslam_tpu_torch.ops.remap import remap
from airslam_tpu_torch.pipelines.map_builder import MapBuilder


class FrontendStep(nn.Module):
    """Detect both stereo views and match them, with the shipped checkpoints
    (``plnet_s0.npz``, ``lightglue.npz``).

    ``dtype`` is the compute dtype (``torch.bfloat16`` is the production
    program, ``torch.float32`` the same program in f32). ``device``: ``cuda``
    unless the caller passes another; raises without a card."""

    def __init__(self, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.detector = FeatureDetector(
            DetectorConfig(max_keypoints=400, use_superpoint=False, dtype=dtype),
            device=self.device)
        self.matcher = PointMatcher(MatcherConfig(dtype=dtype), device=self.device)
        # registered so .parameters() / .to() see the whole program
        self.plnet = self.detector.plnet
        self.loi = self.detector.loi
        self.lightglue = self.matcher.model

    @torch.no_grad()
    def forward(self, stereo_pair):
        """stereo_pair: (2, 480, 752) grayscale in [0, 1]. Returns entry()'s
        11-tuple: (kp0, kp1, idx1, match_score, lines0, line_mask0, kp_desc0,
        kp_mask0, junctions (2, J, 2), junc_desc (2, J, 256), junc_mask (2, J))."""
        pair = torch.as_tensor(stereo_pair, dtype=torch.float32, device=self.device)
        feats = self.detector.detect(pair)
        f0 = type(feats)(*(t[0] for t in feats))
        f1 = type(feats)(*(t[1] for t in feats))
        m = self.matcher.match(f0.keypoints, f0.kp_scores, f0.kp_desc, f0.kp_mask,
                               f1.keypoints, f1.kp_scores, f1.kp_desc, f1.kp_mask)
        return (f0.keypoints, f1.keypoints, m.idx1, m.score, f0.lines,
                f0.line_mask, f0.kp_desc, f0.kp_mask, feats.junctions,
                feats.junc_desc, feats.junc_mask)

    def rectify(self, left, right, grids):
        """Rectify a raw stereo pair: ``grids`` is the (left, right) pair of
        (H, W, 2) source grids, or both stacked as (2, H, W, 2). Both views go
        through kernel R in one launch on the card. Returns (left, right)."""
        if not torch.is_tensor(grids):
            grids = torch.stack([torch.as_tensor(g) for g in grids])
        grids = grids.to(self.device, torch.float32).contiguous()
        images = torch.stack([torch.as_tensor(left), torch.as_tensor(right)])
        with torch.profiler.record_function("rectify"):
            out = remap(images.to(self.device, torch.float32).contiguous(), grids)
        return out[0], out[1]


def vo_map_builder(camera, dtype=torch.bfloat16, device=None, use_flash: bool = False,
                   **builder_args) -> MapBuilder:
    """The tracking pipeline with the shipped checkpoints (``plnet_s0.npz``,
    ``superpoint.npz``, ``lightglue.npz``): 400 SuperPoint keypoints, 512
    lines, networks in ``dtype``, geometry in float32. ``camera``: a
    :class:`core.camera.Camera`. ``use_flash``: LightGlue's attention through
    the fused kernel (``MatcherConfig.use_flash``). ``device``: ``cuda`` unless the caller passes
    another; raises without a card."""
    device = resolve_device(device)
    detector = FeatureDetector(DetectorConfig(max_keypoints=400, use_superpoint=True,
                                              dtype=dtype), device=device)
    matcher = PointMatcher(MatcherConfig(dtype=dtype, use_flash=use_flash), device=device)
    return MapBuilder(camera, detector, matcher, device=device, **builder_args)
