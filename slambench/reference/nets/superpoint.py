"""SuperPoint keypoint detector/descriptor.

Port of ``airslam_tpu/models/superpoint.py``: the VGG-style encoder
(2×64 /2, 2×64 /2, 2×128 /2, 2×128), the 65-way cell softmax with
depth-to-space decode, and the L2-normalised stride-8 descriptor map.
Convolutions run NCHW in ``dtype``; the softmax, the descriptor
normalisation and the outputs are float32, and the outputs keep the JAX
layouts (``scores`` (B, H, W), ``descriptors`` (B, H/8, W/8, 256) NHWC).
Decoding (top-k, descriptor sampling) lives in ``ops``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

VGG_CONVS = (("conv1a", 1, 64), ("conv1b", 64, 64), ("conv2a", 64, 64), ("conv2b", 64, 64),
             ("conv3a", 64, 128), ("conv3b", 128, 128), ("conv4a", 128, 128),
             ("conv4b", 128, 128))


class VGGBackbone(nn.Module):
    """SuperPoint's encoder; returns the stride-8 feature map (NCHW)."""

    def __init__(self):
        super().__init__()
        for name, cin, cout in VGG_CONVS:
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))

    def forward(self, x):
        for i in range(1, 5):
            x = F.relu(getattr(self, f"conv{i}a")(x))
            x = F.relu(getattr(self, f"conv{i}b")(x))
            if i < 4:
                x = F.max_pool2d(x, 2)
        return x


class SuperPoint(nn.Module):
    """Detector + descriptor heads on the VGG backbone.

    ``forward(image)``: (B, 1, H, W) in [0, 1]. Returns ``scores`` (B, H, W),
    ``kp_logits`` (B, H/8, W/8, 65) and ``descriptors`` (B, H/8, W/8, 256),
    all float32."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = VGGBackbone()
        self.convPa = nn.Conv2d(128, 256, 3, padding=1)
        self.convPb = nn.Conv2d(256, 65, 1)  # 8×8 cell pixels + dustbin
        self.convDa = nn.Conv2d(128, 256, 3, padding=1)
        self.convDb = nn.Conv2d(256, 256, 1)
        self.to(dtype)

    def forward(self, image):
        feat = self.backbone(image.to(self.dtype))
        logits = self.convPb(F.relu(self.convPa(feat))).float()
        prob = torch.softmax(logits, dim=1)[:, :64]
        scores = F.pixel_shuffle(prob, 8)[:, 0]  # channel 8r+s → pixel (8i+r, 8j+s)

        desc = self.convDb(F.relu(self.convDa(feat))).float()
        desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True),
                                  min=1e-12)
        return {"scores": scores, "kp_logits": logits.permute(0, 2, 3, 1),
                "descriptors": desc.permute(0, 2, 3, 1)}
