"""Shape arithmetic of the per-layer readers: the card's peaks, a kernel's
bound, the work of kernels P and ``loi_features`` per call, and the model
FLOPs of a VO frame.

``bound_ms`` is a copy of ``chip_smoke._bound_ms``, ``pose_work`` of
``chip_smoke._pose_work`` (with its ``POSE_FLOPS``), ``loi_work`` of
``chip_smoke._loi_work`` (with ``_distinct_taps``): the benchmark keeps its
own, so a change to the program's scripts cannot move a roofline.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per row of kernel P's solve (chip_smoke.POSE_FLOPS)
POSE_FLOPS = {"point_iter": 400, "point_cost": 45, "line_iter": 1100, "line_cost": 110}


def bound_ms(n_bytes, n_flops):
    """The least time the card could take: bytes over HBM bandwidth or f32
    operations over the f32 peak, whichever is larger; and which."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pose_work(n_p: int, n_l: int, rounds: int, iters: int):
    """(bytes, f32 operations) of one kernel-P solve of ``n_p`` points and
    ``n_l`` lines: every operand read once and every result written once;
    per round ``iters`` Jacobian passes and ``iters + 2`` robust costs."""
    n_bytes = (n_p * (12 + 12 + 1) + n_l * (24 + 32 + 1 + 1 + 4) + 4 * (9 + 3 + 9 + 3) + 1
               + 48 + n_p + n_l + 4)
    w = POSE_FLOPS
    per_cost = n_p * w["point_cost"] + n_l * w["line_cost"]
    per_jac = n_p * w["point_iter"] + n_l * w["line_iter"]
    return n_bytes, rounds * (iters * per_jac + (iters + 2) * per_cost)


def _distinct_taps(x, y, h, w):
    """Distinct texels the 4-tap samples of these points touch."""
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    taps = torch.cat([(yy * w + xx).reshape(-1) for yy in (y0, y1) for xx in (x0, x1)])
    return int(torch.unique(taps.long()).numel())


def loi_work(call: dict):
    """(bytes, f32 operations) of one ``loi_features`` call recorded by
    ``harness.probes``: the small operands read once, the texels of the
    three maps the samples touch (per view), the output written once; 9
    operations per sample and channel and about 20 per point for its taps."""
    junc, pairs, lines, props, t_fwd, t_rev = call["small"]
    size = call["map_size"]
    h, w = call["map_shape"][1:3]
    n_views, n_lines = lines.shape[:2]
    nt = t_fwd.shape[0]
    n_bytes = sum(t.numel() * t.element_size() for t in call["small"]) + call["out_bytes"]
    for v in range(n_views):
        idx = pairs[v].clamp(0, junc.shape[1] - 1).unique()
        n_bytes += _distinct_taps(junc[v, idx, 0] - 0.5, junc[v, idx, 1] - 0.5, h, w) * 128 * size
        for seg in (lines[v], props[v]):
            x = seg[:, 0:1] * t_fwd[None] + seg[:, 2:3] * t_rev[None] - 0.5
            y = seg[:, 1:2] * t_fwd[None] + seg[:, 3:4] * t_rev[None] - 0.5
            n_bytes += _distinct_taps(x, y, h, w) * 4 * size
    n_samples_c = n_views * n_lines * (2 * 128 + 2 * 4 * nt)
    n_points = n_views * n_lines * (2 + 2 * nt)
    return n_bytes, n_samples_c * 9 + n_points * 20


def conv_flops(model: torch.nn.Module, shape) -> int:
    """2 × multiply-adds of every convolution and dense layer of ``model``
    on an input of ``shape``, from the layers' output shapes in a forward
    pass on the meta device (no memory, no arithmetic)."""
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
            total[0] += 2 * k * out.numel()
        elif isinstance(mod, torch.nn.Linear):
            total[0] += 2 * mod.in_features * out.numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model.to("meta")(torch.zeros(shape, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return total[0]


def lightglue_flops(n0: int, n1: int, dim: int = 256, layers: int = 9) -> int:
    """Model FLOPs of one LightGlue pass over a pair of ``n0`` and ``n1``
    keypoints: projections, attention products and token updates."""
    def side(n):
        proj = 2 * n * dim * dim
        update = 2 * n * (2 * dim) * (2 * dim) + 2 * n * (2 * dim) * dim
        self_blk = 2 * n * dim * 3 * dim + 4 * n * n * dim + proj + update
        cross_side = 2 * (2 * n * dim * dim) + proj + update
        return layers * (self_blk + cross_side) + 2 * proj  # input and final projections

    cross = layers * 3 * (2 * n0 * n1 * dim)  # the shared similarity and two products
    return side(n0) + side(n1) + cross + 2 * n0 * n1 * dim


def detector_flops(use_superpoint: bool = True, views: int = 2) -> int:
    """Model FLOPs of PLNet's and SuperPoint's layers on ``views`` 512×512
    inputs (the stage-1 head's MLP is counted apart: its rows vary)."""
    from slambench.reference.nets.plnet import PLNet
    from slambench.reference.nets.superpoint import SuperPoint

    shape = (views, 1, 512, 512)
    flops = conv_flops(PLNet(), shape)
    if use_superpoint:
        flops += conv_flops(SuperPoint(), shape)
    return flops
