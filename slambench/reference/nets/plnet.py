"""PLNet and the stage-1 LOI head: a copy of ``airslam_tpu_torch/models/plnet.py``
(the fast head left out) whose sampler is the plain one.


Port of ``airslam_tpu/models/plnet.py``: ``PLNetBackbone``, ``LineHeadTrunk``,
``PLNet``, ``LoiHeadS1``, whose samplers ``_onnx_bilerp`` /
``_interior_feats`` are one call of ``ops.bilerp.loi_features`` here, and the
fast ``LoiHead`` with its sampler ``_bilinear_lookup`` (plain PyTorch: a
border-clamped gather, which the JAX package runs outside any Pallas kernel).
Inside, convolutions run NCHW; the outputs keep the JAX layouts (NHWC maps)
so the two packages compare like with like.

Compute dtype follows the JAX program: convs and Dense layers run in
``dtype`` (inputs and weights cast), the keypoint softmax, descriptor
normalization and the sigmoid heads run in f32, and the LOI maps stay in
``dtype`` into the sampler (kernel ``loi_features`` on the card).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from slambench.reference.nets.weights import BACKBONE_CONVS, TRUNK_HEADS
from slambench.reference.nets.bilerp import loi_features

NUM_JUNCTIONS = 300  # top-k junctions, = JN in plnet.cpp:284
NUM_PROPOSALS_PER_CELL = 3
LOI_POINTS = 16  # samples along each candidate line (the fast head)
LOI_DIM = 128


class PLNetBackbone(nn.Module):
    """Space-to-depth stem + VGG trunk (plnet.py:77-138). Returns (feat at
    stride 8, {"c3": stride 4, "c5": stride 16, "c6": stride 32}), NCHW."""

    def __init__(self):
        super().__init__()
        widths = {"conv1a": (4, 64), "conv1b": (64, 64), "conv2a": (64, 128)}
        for name in BACKBONE_CONVS:
            cin, cout = widths.get(name, (128, 128))
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))

    def forward(self, x):
        def conv(name, t):
            return F.relu(getattr(self, name)(t))

        # the identity 2×2 stride-2 stem: channel 2a+b of cell (i, j) is
        # pixel (2i+a, 2j+b) — pixel_unshuffle's order for one channel
        x = F.pixel_unshuffle(x, 2)
        x = conv("conv1b", conv("conv1a", x))
        x = F.max_pool2d(x, 2)
        c3 = x = conv("conv2b", conv("conv2a", x))
        x = F.max_pool2d(x, 2)
        feat = conv("conv3b", conv("conv3a", x))
        y = conv("conv4b", conv("conv4a", F.max_pool2d(feat, 2)))
        z = conv("conv5b", conv("conv5a", F.max_pool2d(y, 2)))
        return feat, {"c3": c3, "c5": y, "c6": z}


class LineHeadTrunk(nn.Module):
    """Stride-4 line trunk (plnet.py:141-172): ``fuse0`` (one 1×1 kernel over
    the 512-wide pyramid concat) is split per level and applied at source
    resolution, upsampled and summed; then a 3×3 ``fuse2``."""

    def __init__(self):
        super().__init__()
        self.fuse0 = nn.Conv2d(512, 128, 1)
        self.fuse2 = nn.Conv2d(128, 128, 3, padding=1)

    def forward(self, parts):
        h4, w4 = parts[0].shape[-2:]
        acc = None
        for i, t in enumerate(parts):
            y = F.conv2d(t, self.fuse0.weight[:, 128 * i:128 * (i + 1)])
            if y.shape[-2:] != (h4, w4):
                y = F.interpolate(y, (h4, w4), mode="bilinear", align_corners=False)
            acc = y if acc is None else acc + y
        x = F.relu(acc + self.fuse0.bias[None, :, None, None])
        return F.relu(self.fuse2(x))


class PLNet(nn.Module):
    """Stage 0: backbone + keypoint heads + line heads (plnet.py:175-259).

    ``forward(image)``: (B, 1, 512, 512) in [0, 1]. Returns the JAX output
    dict with NHWC layouts: ``scores`` (B, 512, 512), ``kp_logits``
    (B, 64, 64, 65) float32, ``descriptors``
    (B, 64, 64, 256), ``junc_heat`` (B, 128, 128), ``junc_offset``
    (B, 128, 128, 2), ``line_pred`` (B, 128, 128, 3, 4), ``line_logit``
    (B, 128, 128, 3), ``loi`` (B, 128, 128, 128), ``loi_thin``/``loi_aux``
    (B, 128, 128, 4) — the LOI maps contiguous, in the compute dtype."""

    offset_scale = 8.0

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = PLNetBackbone()
        self.convPDa = nn.Conv2d(128, 512, 3, padding=1)  # convPa | convDa
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDb = nn.Conv2d(256, 256, 1)
        self.line_trunk = LineHeadTrunk()
        self.heads = nn.Conv2d(128, sum(f for _, f in TRUNK_HEADS), 3, padding=1)
        self.to(dtype)

    def forward(self, image):
        feat, skips = self.backbone(image.to(self.dtype))
        pd = F.relu(self.convPDa(feat))
        logits = self.convPb(pd[:, :256]).float()
        prob = torch.softmax(logits, dim=1)[:, :64]
        scores = F.pixel_shuffle(prob, 8)[:, 0]  # channel 8r+s → pixel (8i+r, 8j+s)

        desc = self.convDb(pd[:, 256:]).float()
        desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True),
                                  min=1e-12)

        trunk = self.line_trunk([skips["c3"], feat, skips["c5"], skips["c6"]])
        heads = self.heads(trunk).permute(0, 2, 3, 1)  # NHWC view
        o, i0 = {}, 0
        for n, f in TRUNK_HEADS:
            o[n] = heads[..., i0:i0 + f]
            i0 += f
        b, h4, w4, _ = heads.shape

        cy = torch.arange(h4, dtype=torch.float32, device=heads.device) + 0.5
        cx = torch.arange(w4, dtype=torch.float32, device=heads.device) + 0.5
        cyy, cxx = torch.meshgrid(cy, cx, indexing="ij")
        center = torch.stack([cxx, cyy, cxx, cyy], dim=-1)  # (h4, w4, 4)
        line_raw = o["line_pred"].float() * self.offset_scale
        p = NUM_PROPOSALS_PER_CELL
        line_pred = line_raw.reshape(b, h4, w4, p, 4) + center[None, :, :, None, :]

        return {
            "scores": scores,
            "kp_logits": logits.permute(0, 2, 3, 1),  # (B, 64, 64, 65) for training CE
            "descriptors": desc.permute(0, 2, 3, 1),
            "junc_heat": torch.sigmoid(o["junc_heat"].float())[..., 0],
            "junc_offset": torch.sigmoid(o["junc_off"].float()),
            "line_pred": line_pred,
            "line_logit": o["line_logit"].float(),
            "loi": o["loi"].contiguous(),
            "loi_thin": o["loi_thin"].contiguous(),
            "loi_aux": o["loi_aux"].contiguous(),
        }


class LoiHeadS1(nn.Module):
    """Stage-1 LOI verification head, the architecture of the reference's
    ``plnet_s1.onnx`` (plnet.py:314-410): endpoint LOI features (2 × 128),
    30 thin samples along the junction line and 30 aux samples along the
    representative proposal (4 channels each, channel-major), a 3-layer MLP
    plus a residual branch, and a 2-way softmax score.

    The interior ramps ``t_fwd``/``t_rev`` are parameters, as in the JAX
    head: training moves them. They stay float32 whatever ``dtype``."""

    n_interior = 30

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc2_0 = nn.Linear(2 * LOI_DIM + 240, 128)
        self.fc2_2 = nn.Linear(128, 128)
        self.fc2_4 = nn.Linear(128, 128)
        self.fc2_res = nn.Linear(240, 128)
        self.fc2_head = nn.Linear(128, 2)
        self.to(dtype)
        # the ONNX graph's f32 sampling ramps (bits set by the checkpoint)
        n = self.n_interior
        self.t_fwd = nn.Parameter(torch.arange(1, n + 1, dtype=torch.float32) / (n + 1))
        self.t_rev = nn.Parameter(torch.arange(n, 0, -1, dtype=torch.float32) / (n + 1))

    def forward(self, lines, prop_lines, loi, loi_thin, loi_aux, junc_xy=None, pair_idx=None):
        """lines/prop_lines: (V, L, 4) (x1, y1, x2, y2) in 128-grid coords;
        loi (V, 128, 128, 128), loi_thin/aux (V, 128, 128, 4) HWC; ``junc_xy``
        (V, J, 2) the junctions and ``pair_idx`` (V, L, 2) each line's
        endpoint junctions — or the same without the leading V for one view.
        With junctions the LOI map is sampled at them and gathered per line
        (the JAX head's fast endpoint path, the one its detector runs);
        without, at each line's two endpoints (the path training takes,
        plnet.py:382-386), passed to the sampler as 2·L junctions and the
        pairs (i, L + i): JAX samples both paths at ``point − 0.5``. Every
        view is sampled in one ``loi_features`` call and the MLP runs once
        over the V·L rows. Returns (scores (V, L) or (L,), lines)."""
        single = lines.ndim == 2
        if single:
            lines, prop_lines, loi, loi_thin, loi_aux = (
                t[None] for t in (lines, prop_lines, loi, loi_thin, loi_aux))
            if junc_xy is not None:
                junc_xy, pair_idx = junc_xy[None], pair_idx[None]
        v, n = lines.shape[:2]
        if junc_xy is None:
            junc_xy = torch.cat([lines[..., 0:2], lines[..., 2:4]], dim=1).contiguous()
            ar = torch.arange(n, device=lines.device)
            pair_idx = torch.stack([ar, ar + n], dim=-1).expand(v, n, 2).contiguous()
        feats = loi_features(loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines,
                             self.t_fwd, self.t_rev, out_dtype=self.dtype).reshape(v * n, -1)
        res_in = feats[:, 2 * LOI_DIM:]  # [thin | aux]
        x = F.relu(self.fc2_0(feats))
        x = F.relu(self.fc2_2(x))
        x = self.fc2_4(x)
        r = F.relu(self.fc2_res(res_in))
        logits = self.fc2_head(x + r).float()
        scores = torch.softmax(logits, dim=-1)[:, 1].reshape(v, n)
        return (scores[0], lines[0]) if single else (scores, lines)

