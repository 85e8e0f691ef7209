"""Feature detector: resize → PLNet → wireframe decode → stage-1 LOI head →
keypoint decode → descriptor sampling.

Port of ``airslam_tpu/frontend/detector.py``, both stage-1 heads
(``loi_head="s1"``, the shipped one, and ``"fast"``). Junction keypoints
are detected only when the caller asks (``detect_junctions=True``, as every
pipeline caller of the JAX ``detect`` does); otherwise their fields are
zeros, as JAX's. With ``use_superpoint`` (the shipped VO configuration)
keypoints and descriptors come from SuperPoint and PLNet supplies lines and
junctions (feature_detector.cc:7-34); without it, as in
``__graft_entry__.entry()``, PLNet supplies all three. The JAX ``vmap`` over
the batch is a loop over the views of the decode, except for the stage-1
head, which runs once over every view's candidate lines.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from airslam_tpu_torch import resolve_device
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.models.plnet import NUM_JUNCTIONS, PLNet, LoiHead, LoiHeadS1
from airslam_tpu_torch.models.superpoint import SuperPoint
from airslam_tpu_torch.ops import wireframe
from airslam_tpu_torch.ops.detect import top_k, topk_keypoints
from airslam_tpu_torch.ops.gather import take_rows, take_values
from airslam_tpu_torch.ops.gridsample import sample_descriptors
from airslam_tpu_torch.utils.timing import span

DETECT_SIZE = 512  # network input resolution (plnet.cpp:17-22)
# the upstream AirSLAM export of the stage-1 head, read when no plnet_s1.npz
# is found; a bare name is looked up as a checkpoint (AIRSLAM_CHECKPOINT_DIR,
# then the shipped folder), an absolute path as it is
PLNET_S1_ONNX = "plnet_s1.onnx"
# window-max prestage of the proposal prefilter: best proposal per 6
# consecutive proposals (2 cells), then top-max_proposals over the maxima
PROPOSAL_WINDOW = 6


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    max_keypoints: int = 400
    keypoint_threshold: float = 0.004
    remove_borders: int = 4
    line_threshold: float = 0.75
    line_length_threshold: float = 50.0
    use_superpoint: bool = True
    max_lines: int = 512
    max_junctions: int = 256
    junction_match_threshold: float = 5.0  # stride-4 cells
    # keep the top-k proposals by confidence before junction matching
    max_proposals: int = 4096
    # "s1": the stage-1 head of the shipped checkpoint; "fast": the narrower
    # 16-sample head (no weights ship for it)
    loi_head: str = "s1"
    dtype: Any = torch.float32


class FrameFeatures(NamedTuple):
    """Fixed-shape per-image detection output (coords in input resolution)."""

    keypoints: torch.Tensor  # (K, 2)
    kp_scores: torch.Tensor  # (K,)
    kp_desc: torch.Tensor  # (K, 256)
    kp_mask: torch.Tensor  # (K,)
    lines: torch.Tensor  # (L, 4)
    line_scores: torch.Tensor  # (L,)
    line_mask: torch.Tensor  # (L,)
    junctions: torch.Tensor  # (J, 2)
    junc_scores: torch.Tensor  # (J,)
    junc_desc: torch.Tensor  # (J, 256)
    junc_mask: torch.Tensor  # (J,)


def _prefilter(p, logit, k: int):
    """Top-``k`` proposals by confidence (detector.py:104-134): each
    window's best proposal, then an exact top-k over the window maxima."""
    win = PROPOSAL_WINDOW
    lg = logit.reshape(-1, win)
    logit, selw = top_k(lg.max(dim=1).values, k)
    aw = take_values(lg.argmax(dim=1), selw)
    pw = take_rows(p.reshape(-1, win * 4), selw).reshape(-1, win, 4)
    return pw[torch.arange(pw.shape[0], device=pw.device), aw], logit


def _line_candidates(plnet_out: dict, cfg: DetectorConfig):
    """One view's wireframe decode up to the candidate lines
    (detector.py:94-139): junctions, the proposal prefilter, junction
    matching and pair dedup. Returns (junctions, candidates)."""
    juncs = wireframe.decode_junctions(plnet_out["junc_heat"],
                                       plnet_out["junc_offset"], NUM_JUNCTIONS)
    p, logit = _prefilter(plnet_out["line_pred"].reshape(-1, 4),
                          plnet_out["line_logit"].reshape(-1), cfg.max_proposals)
    keep, jmin, jmax = wireframe.match_proposals(p, logit, juncs,
                                                 cfg.junction_match_threshold)
    cands = wireframe.dedup_pairs(keep, jmin, jmax, juncs, NUM_JUNCTIONS,
                                  cfg.max_lines, line_pred=p)
    return juncs, cands


def _finish_view(plnet_out: dict, sp_out: Optional[dict], cfg: DetectorConfig,
                 w_scale: float, h_scale: float, lines_adj, line_scores,
                 cand_mask, detect_junctions: bool) -> FrameFeatures:
    """One view's decode after the stage-1 head (detector.py:140-196): line
    gating, keypoints, descriptors, and with ``detect_junctions`` junction
    keypoints (else zeros and an all-false mask). ``sp_out``: SuperPoint's
    outputs, the source of the keypoint heatmap and descriptors when given;
    else PLNet's."""
    point_src = plnet_out if sp_out is None else sp_out
    heat = point_src["scores"]
    desc_map = point_src["descriptors"]  # (64, 64, 256) NHWC
    dev = heat.device

    # -- lines -------------------------------------------------------------
    decoded = wireframe.gate_lines(lines_adj, line_scores, cand_mask,
                                   (DETECT_SIZE, DETECT_SIZE), cfg.remove_borders,
                                   cfg.line_threshold, cfg.line_length_threshold)
    scale4 = torch.tensor([w_scale, h_scale, w_scale, h_scale], dtype=torch.float32,
                          device=dev)
    lines_out = decoded.lines * scale4

    # -- keypoints ---------------------------------------------------------
    kps = topk_keypoints(heat, cfg.keypoint_threshold, cfg.remove_borders,
                         cfg.max_keypoints)
    desc_chw = desc_map.permute(2, 0, 1)  # (256, 64, 64)
    kp_desc = sample_descriptors(desc_chw, kps.xy, stride=8)
    scale2 = scale4[:2]

    # -- junction keypoints (for the BoW structure graph) ------------------
    j = cfg.max_junctions
    if detect_junctions:
        jkp = wireframe.collect_junction_keypoints(decoded, heat, j)
        junc = dict(junctions=jkp.xy * scale2, junc_scores=jkp.score,
                    junc_desc=sample_descriptors(desc_chw, jkp.xy, stride=8), junc_mask=jkp.mask)
    else:
        junc = dict(junctions=torch.zeros(j, 2, device=dev), junc_scores=torch.zeros(j, device=dev),
                    junc_desc=torch.zeros(j, 256, device=dev),
                    junc_mask=torch.zeros(j, dtype=torch.bool, device=dev))
    return FrameFeatures(
        keypoints=kps.xy * scale2, kp_scores=kps.score, kp_desc=kp_desc,
        kp_mask=kps.mask, lines=lines_out, line_scores=decoded.score,
        line_mask=decoded.mask, **junc)


def detect_batch(plnet_out: dict, sp_out: Optional[dict], cfg: DetectorConfig,
                 w_scale: float, h_scale: float, loi, detect_junctions: bool) -> FrameFeatures:
    """Decode every image of the batch (detector.py:82-210): each view's
    candidate lines, then ONE stage-1 head call (``loi``: a
    :class:`LoiHeadS1` or :class:`LoiHead`) over the stacked views, then
    each view's gating, keypoints and, with ``detect_junctions``, junction
    keypoints. Returns batched FrameFeatures."""
    b = plnet_out["scores"].shape[0]

    def view(out, i):
        return None if out is None else {k: v[i] for k, v in out.items()}

    juncs, cands = zip(*(_line_candidates(view(plnet_out, i), cfg) for i in range(b)))
    with span("loi"):
        scores, lines_adj = loi(torch.stack([c.lines for c in cands]),
                                torch.stack([c.prop_lines for c in cands]),
                                plnet_out["loi"], plnet_out["loi_thin"], plnet_out["loi_aux"],
                                junc_xy=torch.stack([j.xy for j in juncs]),
                                pair_idx=torch.stack([c.pairs for c in cands]))
    views = [_finish_view(view(plnet_out, i), view(sp_out, i), cfg, w_scale, h_scale,
                          lines_adj[i], scores[i], cands[i].mask, detect_junctions)
             for i in range(b)]
    return FrameFeatures(*(torch.stack(f) for f in zip(*views)))


def resize_to_detect(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W) → (B, 1, 512, 512): bilinear with antialiasing, which is
    what ``jax.image.resize(..., "bilinear")`` does on a downscale."""
    x = images[:, None]
    if tuple(images.shape[-2:]) != (DETECT_SIZE, DETECT_SIZE):
        x = F.interpolate(x, (DETECT_SIZE, DETECT_SIZE), mode="bilinear",
                          align_corners=False, antialias=True)
    return x


def stage1_head_params():
    """The stage-1 head's parameter tree in the JAX detector's order
    (``airslam_tpu/frontend/detector.py:243-259``): ``plnet_s1.npz``, else
    :data:`PLNET_S1_ONNX` through ``weights.import_plnet_s1``, else None."""
    ckpt = wio.checkpoint_path("plnet_s1.npz")
    if os.path.exists(ckpt):
        return wio.load_npz(ckpt)
    onnx = wio.checkpoint_path(PLNET_S1_ONNX)
    if os.path.exists(onnx):
        return wio.import_plnet_s1(onnx)
    return None


class FeatureDetector:
    """Owns PLNet and the stage-1 LOI head, loaded from the shipped
    ``plnet_s0.npz``, and with ``config.use_superpoint`` SuperPoint from
    ``superpoint.npz``. ``device``: ``cuda`` unless the caller passes another
    (``"cpu"`` runs the plain versions of the kernels). ``params``: a tree in
    the JAX ``FeatureDetector``'s layout (``{"plnet", "loi"[, "superpoint"]}``,
    as a ``--model_dir``'s ``plnet.npz`` holds it) whose entries replace the
    shipped ones. A ``"plnet"`` tree without a ``"loi"`` one gets the
    stage-1 head of :func:`stage1_head_params` (``plnet_s1.npz``, else the
    upstream ONNX), else the shipped ``plnet_s0.npz``'s.

    With ``config.loi_head="fast"``, ``params["loi"]`` holds the JAX fast
    head's parameters. No weights ship for that head: without them it is
    initialised as flax initialises a ``Dense`` (``lecun_normal`` kernels,
    zero biases) from a ``torch.Generator`` seeded with ``seed``. That is
    another draw than the JAX detector's for the same seed (``jax.random``
    and PyTorch's generator differ), as for ``synthgen.World3D``; the same
    weights need the JAX head's parameters passed in.
    """

    def __init__(self, config: DetectorConfig = DetectorConfig(), device=None, params=None,
                 seed: int = 0):
        self.config = config
        self.device = resolve_device(device)
        fast = config.loi_head == "fast"
        if config.loi_head not in ("s1", "fast"):
            raise ValueError(f"unknown loi_head {config.loi_head!r} (s1 or fast)")
        params = dict(params or {})
        if "plnet" in params and "loi" not in params and not fast:
            # a PLNet without its head: the head's own checkpoint, in the JAX
            # detector's order (airslam_tpu/frontend/detector.py:243-259)
            head = stage1_head_params()
            if head is not None:
                params["loi"] = head
        if "plnet" not in params or ("loi" not in params and not fast):
            shipped = wio.load_npz(wio.checkpoint_path("plnet_s0.npz"))
            # the shipped "loi" entry is the stage-1 head's; the fast head has none
            params = {"plnet": shipped["plnet"], **({} if fast else {"loi": shipped["loi"]}),
                      **params}
        self.plnet = PLNet(dtype=config.dtype)
        self.plnet.load_state_dict(wio.plnet_from_flax(params["plnet"]))
        if fast:
            self.loi = LoiHead(dtype=config.dtype)
            if "loi" in params:
                self.loi.load_state_dict(wio.loi_fast_from_flax(params["loi"]))
            else:
                from airslam_tpu_torch.parallel.train_plnet import flax_init_

                # drawn in float32, then cast as a loaded checkpoint is
                init = flax_init_(LoiHead(), torch.Generator().manual_seed(seed))
                self.loi.load_state_dict(init.state_dict())
        else:
            self.loi = LoiHeadS1(dtype=config.dtype)
            self.loi.load_state_dict(wio.loi_s1_from_flax(params["loi"]))
        self.plnet.to(self.device).eval()
        self.loi.to(self.device).eval()
        self.superpoint = None
        if config.use_superpoint:
            self.superpoint = SuperPoint(dtype=config.dtype)
            self.superpoint.load_state_dict(wio.superpoint_from_flax(
                params.get("superpoint")
                or wio.load_npz(wio.checkpoint_path("superpoint.npz"))))
            self.superpoint.to(self.device).eval()

    @torch.no_grad()
    def detect(self, images, detect_junctions: bool = False) -> FrameFeatures:
        """images: (B, H, W) float in [0, 1]. Returns batched FrameFeatures
        (coordinates in input resolution); the junction fields are zeros
        unless ``detect_junctions``, as in the JAX ``detect``."""
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        h, w = images.shape[-2:]
        with span("resize+plnet"):
            x = resize_to_detect(images)
            out = self.plnet(x)
        sp_out = None
        if self.superpoint is not None:
            with span("superpoint"):
                sp_out = self.superpoint(x)
        with span("decode+loi"):
            return detect_batch(out, sp_out, self.config, w / DETECT_SIZE, h / DETECT_SIZE,
                                self.loi, detect_junctions)
