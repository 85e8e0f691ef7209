"""Synthetic-shapes scenes for detector training, rendered batched on the device.

Port of ``airslam_tpu/frontend/synthgen.py:1-420``: random line segments,
filled convex polygons and a region-contrast checker grid, rendered with
anti-aliasing, whose corners and segments are exact ground truth for the
detector's heads; affine-warped co-visible pairs for the descriptors; the
photometric augmentation of each view.

Each stage is split in two. A draw function takes a ``torch.Generator`` and
returns the stage's random tensors by name, batched (leading ``B``), on the
generator's device; a deterministic function takes those tensors. The draws
hold the values the JAX stage draws with ``jax.random`` (in the same units:
a draw whose bounds depend on another draw is kept in [0, 1) and scaled in
the arithmetic, as ``jax.random.uniform`` does), so a test can rebuild them
from a JAX key and hand them to both packages.

The 3D world of ``synthgen.py:421-569`` (``World3D``, ``make_world3d``,
``render_view3d``) renders the stereo sequences of
``apps/make_synth_dataset_torch.py`` and ``apps/benchmark_system_torch.py``,
batched over views on the given device, with the same split: the world's,
the texture's and the pixel noise's draws, then deterministic functions.

The generator is PyTorch's (Philox on the card), not JAX's threefry, so the
same seed gives another scene or world than the JAX package: one from the
same distributions. A test that needs the JAX scene rebuilds its draws from
the JAX key and hands them to the port.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

SIZE = 512  # render resolution (the detector's input size)
N_SEG = 8  # standalone segments
N_TRI = 3  # filled triangles
N_QUAD = 3  # filled quads
N_POLY_V = 3 * N_TRI + 4 * N_QUAD
MAX_CROSS = 64
N_CHECK = 13  # checker grid lines per axis
CHECK_CROSS = N_CHECK * N_CHECK
MAX_CORNERS = 2 * N_SEG + N_POLY_V + MAX_CROSS + CHECK_CROSS
MAX_SEGMENTS = N_SEG + N_POLY_V + 2 * N_CHECK

Draws = Dict[str, torch.Tensor]


class Shapes(NamedTuple):
    """Scene geometry in pixel coordinates, batched (leading B)."""

    segments: torch.Tensor  # (B, MAX_SEGMENTS, 4): standalone, polygon edges, checker grid
    segment_mask: torch.Tensor  # (B, MAX_SEGMENTS) bool
    tri_verts: torch.Tensor  # (B, N_TRI, 3, 2)
    quad_verts: torch.Tensor  # (B, N_QUAD, 4, 2)
    fill_shade: torch.Tensor  # (B, N_TRI + N_QUAD)
    stroke: torch.Tensor  # (B, MAX_SEGMENTS)
    checker_origin: torch.Tensor  # (B, 2)
    checker_basis: torch.Tensor  # (B, 2, 2)
    checker_shade: torch.Tensor  # (B,), 0 disables the checker


class Scene(NamedTuple):
    image: torch.Tensor  # (B, H, W) float in [0, 1]
    corners: torch.Tensor  # (B, MAX_CORNERS, 2) xy pixel coordinates
    corner_mask: torch.Tensor  # (B, MAX_CORNERS) bool
    segments: torch.Tensor  # (B, MAX_SEGMENTS, 4) x1 y1 x2 y2
    segment_mask: torch.Tensor  # (B, MAX_SEGMENTS) bool


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return _scale(u, lo, hi)


def _scale(u, lo, hi):
    """``jax.random.uniform``'s map of u in [0, 1) onto [lo, hi)."""
    return torch.maximum(torch.as_tensor(lo, dtype=u.dtype, device=u.device),
                         u * (hi - lo) + lo)


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def _col(v: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1), to broadcast a per-image scalar over an image."""
    return v[:, None, None]


def _pixels(batch_like: torch.Tensor, size_h: int, size_w: int):
    dev = batch_like.device
    px = (torch.arange(size_w, dtype=torch.float32, device=dev) + 0.5)[None, None, :]
    py = (torch.arange(size_h, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    return px, py


# ---------------------------------------------------------------------------
# geometry helpers (synthgen.py:62-115)
# ---------------------------------------------------------------------------


def _seg_dist(px, py, seg):
    """Distance from every pixel to a segment. px/py broadcast to (B, H, W);
    seg (B, 4)."""
    ax, ay, bx, by = (_col(seg[:, i]) for i in range(4))
    dx, dy = bx - ax, by - ay
    L2 = torch.clamp_min(dx * dx + dy * dy, 1e-6)
    t = torch.clamp(((px - ax) * dx + (py - ay) * dy) / L2, 0.0, 1.0)
    qx = ax + t * dx
    qy = ay + t * dy
    return torch.sqrt((px - qx) ** 2 + (py - qy) ** 2)


def _halfplane(px, py, a, b, c):
    """Signed distance of points to the line through a->b, positive on the
    side of c. a, b, c: (B, 2); px/py broadcast against (B, 1, ...)."""
    def s(v):
        return v.reshape(v.shape + (1,) * (px.dim() - 1))

    nx, ny = s(b[:, 1] - a[:, 1]), s(a[:, 0] - b[:, 0])
    nrm = torch.sqrt(nx * nx + ny * ny) + 1e-6
    nx, ny = nx / nrm, ny / nrm
    d = (px - s(a[:, 0])) * nx + (py - s(a[:, 1])) * ny
    sign = torch.sign((s(c[:, 0]) - s(a[:, 0])) * nx + (s(c[:, 1]) - s(a[:, 1])) * ny)
    return d * sign


def _poly_fill(px, py, verts):
    """Soft inside-mask of a convex polygon, verts (B, V, 2)."""
    n = verts.shape[1]
    centroid = torch.mean(verts, dim=1)
    inside = None
    for i in range(n):
        d = _halfplane(px, py, verts[:, i], verts[:, (i + 1) % n], centroid)
        inside = d if inside is None else torch.minimum(inside, d)
    return torch.sigmoid(inside * 2.0)


def _seg_intersections(segs, mask):
    """Pairwise segment intersections, (B, S², 2) with validity (B, S²)."""
    b, s = segs.shape[:2]
    a = segs[:, :, None, :]
    c = segs[:, None, :, :]
    x1, y1, x2, y2 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    x3, y3, x4, y4 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    den = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    safe = torch.abs(den) > 1e-6
    den = torch.where(safe, den, torch.ones_like(den))
    t = ((x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)) / den
    u = ((x1 - x3) * (y1 - y2) - (y1 - y3) * (x1 - x2)) / den
    hit = safe & (t > 0.02) & (t < 0.98) & (u > 0.02) & (u < 0.98)
    hit = hit & mask[:, :, None] & mask[:, None, :]
    ar = torch.arange(s, device=segs.device)
    hit = hit & (ar[:, None] < ar[None, :])  # upper triangle
    ix = x1 + t * (x2 - x1)
    iy = y1 + t * (y2 - y1)
    return torch.stack([ix, iy], dim=-1).reshape(b, s * s, 2), hit.reshape(b, s * s)


def _fma(a, b, c):
    """a·b + c rounded once (the float32 product is exact in float64; the
    float64 sum's second rounding to float32 can differ from one rounding
    only at a float32 tie)."""
    return (a.double() * b.double() + c.double()).float()


def _affine_points(p, A, t=None):
    """x' = A x (+ t) for points p (B, ..., 2), A (B, 2, 2), t (B, 2), with
    XLA's arithmetic for the JAX package's ``p @ A.T + t``: per output
    ``fma(y, A[i, 1], x · A[i, 0])``, then ``+ t``."""
    def s(v):
        return v.reshape(v.shape + (1,) * (p.dim() - 2))

    x, y = p[..., 0], p[..., 1]
    ox = _fma(y, s(A[:, 0, 1]), x * s(A[:, 0, 0]))
    oy = _fma(y, s(A[:, 1, 1]), x * s(A[:, 1, 0]))
    if t is not None:
        ox, oy = ox + s(t[:, 0]), oy + s(t[:, 1])
    return torch.stack([ox, oy], dim=-1)


def _matmul2(A, B):
    """Batched 2×2 product A @ B, with XLA's arithmetic (as above)."""
    return torch.stack([torch.stack([_fma(A[:, i, 1], B[:, 1, j], A[:, i, 0] * B[:, 0, j])
                                     for j in range(2)], -1) for i in range(2)], -2)


# ---------------------------------------------------------------------------
# shapes (synthgen.py:117-185)
# ---------------------------------------------------------------------------


def shape_draws(gen: torch.Generator, batch: int, size: int = SIZE) -> Draws:
    """The random tensors of :func:`sample_shapes`: segment endpoints,
    polygon centres, base angles, angle jitters and radii, shades, strokes
    and the checker grid's switch, pitch, origin and contrast."""
    m = 24.0
    d = {"p1": _uniform(gen, (batch, N_SEG, 2), m, size - m),
         "p2": _uniform(gen, (batch, N_SEG, 2), m, size - m)}
    for name, n, nv, lo, hi in (("tri", N_TRI, 3, 40.0, 110.0), ("quad", N_QUAD, 4, 50.0, 130.0)):
        d[name + "_center"] = _uniform(gen, (batch, n, 2), size * 0.2, size * 0.8)
        d[name + "_base"] = _uniform(gen, (batch, n), 0.0, 6.28)
        d[name + "_jitter"] = _uniform(gen, (batch, n, nv), -0.35, 0.35)
        d[name + "_radius"] = _uniform(gen, (batch, n, nv), lo, hi)
    d["fill_shade"] = _uniform(gen, (batch, N_TRI + N_QUAD), -0.45, 0.45)
    d["stroke"] = _uniform(gen, (batch, MAX_SEGMENTS), -0.5, 0.5)
    d["checker_on"] = _uniform(gen, (batch,), 0.0, 1.0)
    d["pitch"] = _uniform(gen, (batch,), 44.0, 80.0)
    d["origin"] = _uniform(gen, (batch, 2), -80.0, 0.0)
    d["delta"] = _uniform(gen, (batch,), 0.10, 0.30)
    d["delta_sign"] = _uniform(gen, (batch,), 0.0, 1.0)
    return d


def sample_shapes(d: Draws, size: int = SIZE) -> Shapes:
    """Scene geometry with static budgets (synthgen.py:117)."""
    m = 24.0
    p1, p2 = d["p1"], d["p2"]
    b, dev = p1.shape[0], p1.device
    diff = p2 - p1
    seg_ok = torch.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2) > 64.0
    segs = [torch.cat([p1, p2], dim=-1)]
    seg_masks = [seg_ok]

    def polygon(name, nv):
        ar = torch.arange(nv, dtype=torch.float32, device=dev) * (6.28318 / nv)
        ang = d[name + "_base"][..., None] + ar + d[name + "_jitter"]
        r = d[name + "_radius"]
        v = d[name + "_center"][..., None, :] + torch.stack(
            [torch.cos(ang), torch.sin(ang)], dim=-1) * r[..., None]
        return torch.clamp(v, m, size - m)

    tri, quad = polygon("tri", 3), polygon("quad", 4)
    for v in (tri, quad):
        edges = torch.cat([v, torch.roll(v, -1, dims=2)], dim=-1)  # (B, n, nv, 4)
        segs.append(edges.reshape(b, -1, 4))
        seg_masks.append(torch.ones(edges.shape[:1] + (edges.shape[1] * edges.shape[2],),
                                    dtype=torch.bool, device=dev))

    stroke = d["stroke"]
    stroke = torch.where(torch.abs(stroke) < 0.25, torch.sign(stroke) * 0.25, stroke)
    stroke = torch.cat([stroke[:, :N_SEG + N_POLY_V],
                        torch.zeros_like(stroke[:, N_SEG + N_POLY_V:])], dim=1)

    on = (d["checker_on"] < 0.5).float()
    pitch, origin = d["pitch"], d["origin"]
    delta = d["delta"] * torch.where(d["delta_sign"] > 0.5, 1.0, -1.0)
    basis = pitch[:, None, None] * torch.eye(2, device=dev)
    idx = torch.arange(N_CHECK, dtype=torch.float32, device=dev)
    xs_g = origin[:, 0:1] + idx * pitch[:, None]
    ys_g = origin[:, 1:2] + idx * pitch[:, None]
    lo, hi = 3.0, SIZE - 3.0
    vsegs = torch.stack([xs_g, torch.full_like(xs_g, lo), xs_g, torch.full_like(xs_g, hi)], -1)
    hsegs = torch.stack([torch.full_like(ys_g, lo), ys_g, torch.full_like(ys_g, hi), ys_g], -1)
    vmask = (xs_g > lo) & (xs_g < hi) & (on[:, None] > 0)
    hmask = (ys_g > lo) & (ys_g < hi) & (on[:, None] > 0)
    segs.append(torch.cat([vsegs, hsegs], dim=1))
    seg_masks.append(torch.cat([vmask, hmask], dim=1))

    return Shapes(segments=torch.cat(segs, dim=1), segment_mask=torch.cat(seg_masks, dim=1),
                  tri_verts=tri, quad_verts=quad, fill_shade=d["fill_shade"], stroke=stroke,
                  checker_origin=origin, checker_basis=basis, checker_shade=delta * on)


def warp_shapes(shapes: Shapes, A: torch.Tensor, t: torch.Tensor) -> Shapes:
    """Affine-transform all scene geometry: x' = A x + t (synthgen.py:188)."""
    segs = shapes.segments
    return shapes._replace(
        segments=torch.cat([_affine_points(segs[..., 0:2], A, t),
                            _affine_points(segs[..., 2:4], A, t)], dim=-1),
        tri_verts=_affine_points(shapes.tri_verts, A, t),
        quad_verts=_affine_points(shapes.quad_verts, A, t),
        checker_origin=_affine_points(shapes.checker_origin, A, t),
        checker_basis=_matmul2(A, shapes.checker_basis))


def affine_draws(gen: torch.Generator, batch: int, view: float = 1.0) -> Draws:
    """The random tensors of :func:`random_affine`: rotation, scale, shift.
    With ``view`` > 1 each pair first draws its strength ``v`` in [1, view]
    (synthgen.py:385-389), and its rotation in ±0.35·v, scale in 1 ± 0.15·v
    and shift in ±40·v px; else v = 1: ±0.35, 0.85-1.15, ±40 px."""
    if view > 1.0:
        v = 1.0 + (view - 1.0) * torch.rand((batch,), generator=gen, device=gen.device)
        rot, lo, hi, shift = 0.35 * v, 1.0 - 0.15 * v, 1.0 + 0.15 * v, 40.0 * v
    else:  # the JAX defaults' own float32 roundings (0.85 is not 1 - 0.15)
        v = torch.ones((batch,), device=gen.device)
        rot, lo, hi, shift = (torch.full_like(v, c) for c in (0.35, 0.85, 1.15, 40.0))

    def u(shape, a, b):
        r = torch.rand(shape, generator=gen, device=gen.device)
        return _scale(r, a.reshape(a.shape + (1,) * (r.dim() - 1)),
                      b.reshape(b.shape + (1,) * (r.dim() - 1)))

    return {"v": v, "theta": u((batch,), -rot, rot), "scale": u((batch,), lo, hi),
            "shift": u((batch, 2), -shift, shift)}


def random_affine(d: Draws, size: int = SIZE):
    """Affine about the image centre (synthgen.py:204). Returns A (B, 2, 2)
    and t (B, 2)."""
    th, s = d["theta"], d["scale"]
    c, sn = torch.cos(th) * s, torch.sin(th) * s
    A = torch.stack([torch.stack([c, -sn], -1), torch.stack([sn, c], -1)], -2)
    center = torch.full((th.shape[0], 2), size / 2.0, device=th.device)
    t = center - _affine_points(center, A) + d["shift"]
    return A, t


# ---------------------------------------------------------------------------
# rendering (synthgen.py:218-289)
# ---------------------------------------------------------------------------


def render_draws(gen: torch.Generator, batch: int, size: int = SIZE) -> Draws:
    """The random tensors of :func:`render_from_shapes`: the 4×4 background
    grid, the 32×32 background noise and the per-pixel sensor noise."""
    return {"bg": _uniform(gen, (batch, 4, 4), 0.35, 0.85),
            "bg_noise": _uniform(gen, (batch, 32, 32), -0.04, 0.04),
            "noise": _normal(gen, (batch, size, size))}


def _upsample(grid: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(grid, (size, size), "bilinear")`` for an upscale."""
    return F.interpolate(grid[:, None], (size, size), mode="bilinear",
                         align_corners=False)[:, 0]


def render_from_shapes(shapes: Shapes, d: Draws, size: int = SIZE) -> Scene:
    """Render geometry with the drawn photometrics; extract ground truth."""
    px, py = _pixels(shapes.segments, size, size)
    bg = _upsample(d["bg"], size) + _upsample(d["bg_noise"], size)
    img = bg

    Uinv = torch.linalg.inv(shapes.checker_basis)
    dx = px - _col(shapes.checker_origin[:, 0])
    dy = py - _col(shapes.checker_origin[:, 1])
    cxc = _col(Uinv[:, 0, 0]) * dx + _col(Uinv[:, 0, 1]) * dy
    cyc = _col(Uinv[:, 1, 0]) * dx + _col(Uinv[:, 1, 1]) * dy
    pattern = torch.tanh(torch.sin(math.pi * cxc) * torch.sin(math.pi * cyc) * 6.0)
    img = img + _col(shapes.checker_shade) * pattern
    polys = ([shapes.tri_verts[:, i] for i in range(N_TRI)]
             + [shapes.quad_verts[:, i] for i in range(N_QUAD)])
    for i, v in enumerate(polys):
        f = _poly_fill(px, py, v)
        img = img * (1 - f) + torch.clamp(bg + _col(shapes.fill_shade[:, i]), 0.05, 0.95) * f

    for i0 in range(0, MAX_SEGMENTS, 8):
        idx = range(i0, min(i0 + 8, MAX_SEGMENTS))
        dist = torch.stack([_seg_dist(px, py, shapes.segments[:, i]) for i in idx], dim=1)
        alpha = torch.clamp(1.6 - dist, 0.0, 1.0)
        cmask = shapes.segment_mask[:, i0:i0 + 8].float()
        cshade = shapes.stroke[:, i0:i0 + 8]
        img = img + torch.sum(alpha * (cmask * cshade)[:, :, None, None], dim=1)
    img = torch.clamp(img, 0.0, 1.0)
    img = torch.clamp(img + d["noise"] * 0.02, 0.0, 1.0)

    # ground-truth corners: segment endpoints, polygon vertices, crossings
    segs, smask = shapes.segments, shapes.segment_mask
    b = segs.shape[0]
    base_c = torch.cat([segs[:, :N_SEG, 0:2], segs[:, :N_SEG, 2:4],
                        shapes.tri_verts.reshape(b, -1, 2), shapes.quad_verts.reshape(b, -1, 2)],
                       dim=1)
    base_m = torch.cat([smask[:, :N_SEG], smask[:, :N_SEG],
                        torch.ones((b, N_POLY_V), dtype=torch.bool, device=segs.device)], dim=1)
    xpts, xmask = _seg_intersections(segs[:, :N_SEG], smask[:, :N_SEG])
    # jax.lax.top_k: the hits first, ties in index order
    sel = torch.sort(xmask.float(), dim=1, descending=True, stable=True).indices[:, :MAX_CROSS]
    xpts = torch.gather(xpts, 1, sel[..., None].expand(-1, -1, 2))
    xmask = torch.gather(xmask, 1, sel)
    ar = torch.arange(N_CHECK, dtype=torch.float32, device=segs.device)
    ij = torch.stack(torch.meshgrid(ar, ar, indexing="ij"), -1).reshape(1, -1, 2)
    B_ = shapes.checker_basis
    cpts = shapes.checker_origin[:, None, :] + _affine_points(ij.expand(b, -1, -1), B_)
    cmask_chk = (shapes.checker_shade != 0.0)[:, None].expand(-1, CHECK_CROSS)
    for v in polys:  # crossings hidden under filled polygons are not corners
        cmask_chk = cmask_chk & (_poly_fill(cpts[..., 0], cpts[..., 1], v) < 0.5)
    corners = torch.cat([base_c, xpts, cpts], dim=1)
    corner_mask = torch.cat([base_m, xmask, cmask_chk], dim=1)
    corner_mask = corner_mask & torch.all((corners > 4.0) & (corners < size - 4.0), dim=-1)
    ends = segs.reshape(b, -1, 2, 2)
    in_img = torch.all(((ends > 2.0) & (ends < size - 2.0)).reshape(b, -1, 4), dim=-1)
    return Scene(image=img, corners=corners, corner_mask=corner_mask, segments=segs,
                 segment_mask=smask & in_img)


# ---------------------------------------------------------------------------
# photometric augmentation (synthgen.py:302-362)
# ---------------------------------------------------------------------------


def augment_draws(gen: torch.Generator, batch: int, size: int = SIZE) -> Draws:
    """The random tensors of :func:`photometric_augment`. ``strength``,
    ``center`` and ``gradient_dir`` hold their values; ``brightness``,
    ``gamma``, ``contrast``, ``vignette`` and ``gradient`` are in [0, 1)
    (their bounds scale with the strength); ``noise`` is standard normal."""
    u = (batch,)
    return {"strength": _uniform(gen, u, 0.15, 1.0),
            "brightness": _uniform(gen, u, 0.0, 1.0), "gamma": _uniform(gen, u, 0.0, 1.0),
            "contrast": _uniform(gen, u, 0.0, 1.0),
            "center": _uniform(gen, (batch, 2), 0.3, 0.7),
            "vignette": _uniform(gen, u, 0.0, 1.0), "gradient_dir": _normal(gen, (batch, 2)),
            "gradient": _uniform(gen, u, 0.0, 1.0), "noise": _normal(gen, (batch, size, size))}


def photometric_augment(img: torch.Tensor, d: Draws, strength: float = 1.0) -> torch.Tensor:
    """Random photometric transform of [0, 1] images (B, H, W), each image by
    its own draws (synthgen.py:302): brightness, gamma, contrast about the
    mean, vignette, a linear illumination gradient, and noise that grows as
    the image darkens."""
    h, w = img.shape[-2:]
    s = strength * d["strength"]
    b = torch.exp(_scale(d["brightness"], -1.5 * s, 0.4 * s))
    gamma = torch.exp(_scale(d["gamma"], -0.8 * s, 0.8 * s))
    c = 1.0 + _scale(d["contrast"], -0.5 * s, 0.5 * s)

    out = torch.clamp(img, 0.0, 1.0) ** _col(gamma)
    mean = torch.mean(out, dim=(1, 2), keepdim=True)
    out = (out - mean) * _col(c) + mean
    out = out * _col(b)

    py = (torch.arange(h, dtype=torch.float32, device=img.device) / h)[None, :, None]
    px = (torch.arange(w, dtype=torch.float32, device=img.device) / w)[None, None, :]
    cen = d["center"]
    r2 = (px - _col(cen[:, 0])) ** 2 + (py - _col(cen[:, 1])) ** 2
    v_str = _scale(d["vignette"], torch.zeros_like(s), 0.8 * s)
    out = out * (1.0 - _col(v_str) * torch.clamp(r2 * 2.0, 0.0, 1.0))

    gdir = d["gradient_dir"]
    gdir = gdir / (torch.sqrt(gdir[:, 0] ** 2 + gdir[:, 1] ** 2) + 1e-9)[:, None]
    g_str = _scale(d["gradient"], torch.zeros_like(s), 0.25 * s)
    out = out + _col(g_str) * ((px - 0.5) * _col(gdir[:, 0]) + (py - 0.5) * _col(gdir[:, 1]))

    sigma = 0.01 + 0.05 * s * torch.clamp(1.0 - b, 0.0, 1.0)
    out = out + d["noise"] * _col(sigma)
    return torch.clamp(out, 0.0, 1.0)


def dark_draws(gen: torch.Generator, batch: int, size: int = SIZE, width: int = None) -> Draws:
    """The random tensor of :func:`dark_transform`: standard normal noise
    over (batch, size, width or size) pixels."""
    return {"noise": _normal(gen, (batch, size, width or size))}


def dark_transform(img: torch.Tensor, d: Draws, level: float = 0.25, gamma: float = 1.8,
                   noise: float = 0.03) -> torch.Tensor:
    """Low-light degradation of fixed strength (synthgen.py:355): gamma crush
    to ``level`` of the brightness plus sensor noise."""
    out = torch.clamp(img, 0.0, 1.0) ** gamma * level
    out = out + d["noise"] * noise
    return torch.clamp(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# scenes and pairs (synthgen.py:365-417)
# ---------------------------------------------------------------------------


def scene_draws(gen: torch.Generator, batch: int, size: int = SIZE,
                augment: float = 0.0) -> Dict[str, Draws]:
    """The draws of :func:`render_scene`, by stage."""
    d = {"shapes": shape_draws(gen, batch, size), "render": render_draws(gen, batch, size)}
    if augment > 0:
        d["augment"] = augment_draws(gen, batch, size)
    return d


def render_scene(d: Dict[str, Draws], size: int = SIZE, augment: float = 0.0) -> Scene:
    s = render_from_shapes(sample_shapes(d["shapes"], size), d["render"], size)
    if augment > 0:
        s = s._replace(image=photometric_augment(s.image, d["augment"], augment))
    return s


def pair_draws(gen: torch.Generator, batch: int, size: int = SIZE,
               augment: float = 0.0, view: float = 1.0) -> Dict[str, Draws]:
    """The draws of :func:`render_pair_with_affine`, by stage: one scene,
    one affine (``view`` widens it, :func:`affine_draws`), the two views'
    photometrics and augmentations."""
    d = {"shapes": shape_draws(gen, batch, size), "affine": affine_draws(gen, batch, view),
         "render0": render_draws(gen, batch, size), "render1": render_draws(gen, batch, size)}
    if augment > 0:
        d["augment0"] = augment_draws(gen, batch, size)
        d["augment1"] = augment_draws(gen, batch, size)
    return d


def render_pair_with_affine(d: Dict[str, Draws], size: int = SIZE, augment: float = 0.0):
    """Two renders of one scene related by a known affine (view 0 → view 1
    pixels), each with its own photometrics: corner i of view 0 is corner i
    of view 1. Returns (s0, s1, A, t)."""
    shapes = sample_shapes(d["shapes"], size)
    A, t = random_affine(d["affine"], size)
    s0 = render_from_shapes(shapes, d["render0"], size)
    s1 = render_from_shapes(warp_shapes(shapes, A, t), d["render1"], size)
    if augment > 0:
        s0 = s0._replace(image=photometric_augment(s0.image, d["augment0"], augment))
        s1 = s1._replace(image=photometric_augment(s1.image, d["augment1"], augment))
    return s0, s1, A, t


def render_pair(d: Dict[str, Draws], size: int = SIZE, augment: float = 0.0):
    s0, s1, _, _ = render_pair_with_affine(d, size, augment)
    return s0, s1


def render_batch(gen: torch.Generator, batch: int, size: int = SIZE) -> Scene:
    return render_scene(scene_draws(gen, batch, size), size)


def render_pair_batch(gen: torch.Generator, batch: int, size: int = SIZE):
    return render_pair(pair_draws(gen, batch, size), size)


# ---------------------------------------------------------------------------
# the 3D world → camera images (synthgen.py:421-569): the EuRoC stand-in of
# the rendered sequences, with multi-view geometry the SLAM chain can track
# ---------------------------------------------------------------------------

WORLD_EXTENT = ((-4.0, 4.0), (-2.5, 2.5), (2.0, 20.0))  # x, y, z ranges of the corridor
TEXTURE_OCTAVES = 5
TEXTURE_PLANES = 2  # the floor, then the back wall


class World3D(NamedTuple):
    segments: torch.Tensor  # (S, 2, 3) segment endpoints in the world
    seg_shade: torch.Tensor  # (S,)
    blobs: torch.Tensor  # (B, 3) dot features
    blob_shade: torch.Tensor  # (B,)


def world3d_draws(gen: torch.Generator, n_seg: int = 48, n_blob: int = 320) -> Draws:
    """The random tensors of :func:`make_world3d`: uniforms in [0, 1) for the
    positions (scaled to the extent in the arithmetic) and the shade signs,
    the lengths and shade magnitudes in their ranges, normals for the
    directions, and the axis each segment is squashed along."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device=gen.device)

    return {"seg_a": u(n_seg, 3), "seg_dir": _normal(gen, (n_seg, 3)),
            "seg_axis": torch.randint(0, 3, (n_seg,), generator=gen, device=gen.device),
            "seg_length": _uniform(gen, (n_seg, 1), 0.8, 3.0),
            "seg_shade": _uniform(gen, (n_seg,), 0.25, 0.55), "seg_sign": u(n_seg),
            "blobs": u(n_blob, 3), "blob_shade": _uniform(gen, (n_blob,), 0.3, 0.6),
            "blob_sign": u(n_blob)}


def make_world3d(d: Draws, extent=WORLD_EXTENT) -> World3D:
    """Random wireframe-and-dots corridor (synthgen.py:433-466). Segments
    hug axis-aligned planes, so many are straight edges the detector finds;
    blobs give the point detector texture everywhere."""
    (x0, x1), (y0, y1), (z0, z1) = extent

    def upts(u):
        return torch.stack([x0 + u[:, 0] * (x1 - x0), y0 + u[:, 1] * (y1 - y0),
                            z0 + u[:, 2] * (z1 - z0)], -1)

    def signed(shade, sign):
        return shade * torch.where(sign > 0.5, 1.0, -1.0)

    a = upts(d["seg_a"])
    # squash one axis so that segments lie roughly in planes
    squash = F.one_hot(d["seg_axis"].long(), 3).to(a.dtype)
    v = d["seg_dir"] * (1.0 - squash * 0.95)
    # |v| with XLA's arithmetic: one fused multiply-add per further term
    norm = torch.sqrt(_fma(v[:, 2], v[:, 2], _fma(v[:, 1], v[:, 1], v[:, 0] * v[:, 0])))
    v = v / (norm[:, None] + 1e-9)
    b = a + v * d["seg_length"]
    return World3D(torch.stack([a, b], dim=1), signed(d["seg_shade"], d["seg_sign"]),
                   upts(d["blobs"]), signed(d["blob_shade"], d["blob_sign"]))


def texture_draws(gen: torch.Generator) -> Draws:
    """The angles of :func:`_octave_noise` on each textured plane: (planes,
    octaves, 3) in [0, 6.28318)."""
    return {"theta": _uniform(gen, (TEXTURE_PLANES, TEXTURE_OCTAVES, 3), 0.0, 6.28318)}


def view_noise_draws(gen: torch.Generator, n: int, height: int, width: int) -> Draws:
    """The per-pixel sensor noise of :func:`render_view3d` for ``n`` views."""
    return {"noise": _normal(gen, (n, height, width))}


def _octave_noise(u, v, theta, amp: float = 1.0):
    """Smooth 1/f texture over surface coordinates (u, v) (synthgen.py:469-485):
    summed directional sinusoids, one orientation and phase per octave
    (``theta`` (octaves, 3)). A function of the surface point, so the texture
    is consistent across views."""
    out = torch.zeros_like(u)
    for k in range(theta.shape[0]):
        th = theta[k]
        f = (1.4 ** k) * 2.2
        d = u * torch.cos(th[0]) + v * torch.sin(th[0])
        e = u * torch.cos(th[1] + 1.7) + v * torch.sin(th[1] + 1.7)
        out = out + (amp / (1.35 ** k)) * torch.sin(f * d + th[2]) * torch.cos(0.73 * f * e + th[1])
    return out


def _project(p3, Rcw, tcw, fx, fy, cx, cy):
    """World points (S, 3) into N views: pixels (N, S, 2) and depth (N, S)."""
    pc = torch.einsum("sk,njk->nsj", p3, Rcw) + tcw[:, None, :]
    z = torch.clamp_min(pc[..., 2], 0.2)
    return torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], -1), pc[..., 2]


def render_view3d(world: World3D, Rcw, tcw, fx, fy, cx, cy, height: int, width: int,
                  noise=None, texture: float = 0.0, texture_theta=None,
                  floor_y: float = 2.8, wall_z: float = 20.5) -> torch.Tensor:
    """Rasterize the world into N grayscale views (N, H, W) in [0, 1]
    (synthgen.py:488-569), on the world's device. ``Rcw`` (N, 3, 3), ``tcw``
    (N, 3): each view's world-to-camera pose.

    Segments are drawn as anti-aliased strokes when both ends lie in front
    of the camera (8 at a time), blobs as small gaussians (32 at a time).
    ``texture > 0`` adds 1/f texture (``texture_theta``, from
    :func:`texture_draws`) on two planes of the world, the floor at
    y = ``floor_y`` and the back wall at z = ``wall_z``: each pixel's ray is
    intersected with them and the texture sampled at the hit point, so it
    moves with parallax across views. ``texture = 0`` keeps the flat shading
    of the earlier renders. ``noise`` (N, H, W), standard normal: per-pixel
    sensor noise of 0.01."""
    n = Rcw.shape[0]
    dt = world.segments.dtype
    px = torch.arange(width, dtype=dt, device=Rcw.device)[None, None, :] + 0.5
    py = torch.arange(height, dtype=dt, device=Rcw.device)[None, :, None] + 0.5

    img = torch.full((n, height, width), 0.55, dtype=dt, device=Rcw.device)
    if texture > 0.0:
        if texture_theta is None:
            raise ValueError("texture > 0 needs the texture's draws (texture_draws)")
        # the world-frame ray through each pixel and the camera centre
        dx = ((px - cx) / fx).expand(1, height, width)
        dy = ((py - cy) / fy).expand(1, height, width)
        d_cam = torch.stack([dx, dy, torch.ones_like(dx)], -1)  # (1, H, W, 3)
        d_w = torch.einsum("nhwk,nkj->nhwj", d_cam.expand(n, -1, -1, -1), Rcw)  # Rcw^T per pixel
        C = -torch.einsum("nkj,nk->nj", Rcw, tcw)  # camera centres in the world
        eps = 1e-6

        def safe(den):
            return torch.where(torch.abs(den) < eps, eps, den)

        t_f = (floor_y - C[:, 1, None, None]) / safe(d_w[..., 1])  # floor y = floor_y
        t_wz = (wall_z - C[:, 2, None, None]) / safe(d_w[..., 2])  # back wall z = wall_z
        hits = []
        for t_pl, (ua, va), plane in ((t_f, (0, 2), 0), (t_wz, (0, 1), 1)):
            ok = t_pl > 0.2
            t_safe = torch.where(ok, t_pl, 1e6)
            hit = C[:, None, None, :] + t_safe[..., None] * d_w
            tex = _octave_noise(hit[..., ua], hit[..., va], texture_theta[plane])
            hits.append((t_safe, torch.where(ok, tex, 0.0)))
        (t0, tex0), (t1, tex1) = hits
        tex = torch.where(t0 < t1, tex0, tex1)  # the nearer plane
        att = 1.0 / (1.0 + 0.05 * torch.minimum(t0, t1))  # far texture stays faint
        img = img + texture * tex * att
    else:
        u = (px / width * 8).to(torch.int32) + (py / height * 6).to(torch.int32)
        img = img + 0.04 * torch.cos(u.to(dt) * 2.1)

    p2a, za = _project(world.segments[:, 0], Rcw, tcw, fx, fy, cx, cy)
    p2b, zb = _project(world.segments[:, 1], Rcw, tcw, fx, fy, cx, cy)
    w_seg = ((za > 0.25) & (zb > 0.25)).to(dt) * world.seg_shade  # (N, S)
    segs2d = torch.cat([p2a, p2b], dim=-1)  # (N, S, 4)
    for i0 in range(0, segs2d.shape[1], 8):
        ch = segs2d[:, i0: i0 + 8]
        ax, ay, bx, by = (ch[..., i, None, None] for i in range(4))  # (N, 8, 1, 1)
        sx, sy = bx - ax, by - ay
        L2 = torch.clamp_min(sx * sx + sy * sy, 1e-6)
        t = torch.clamp(((px - ax) * sx + (py - ay) * sy) / L2, 0.0, 1.0)
        d = torch.sqrt((px - (ax + t * sx)) ** 2 + (py - (ay + t * sy)) ** 2)
        alpha = torch.clamp(1.8 - d, 0.0, 1.0)
        img = img + torch.sum(alpha * w_seg[:, i0: i0 + 8, None, None], dim=1)

    pb, zbl = _project(world.blobs, Rcw, tcw, fx, fy, cx, cy)
    w_blob = (zbl > 0.25).to(dt) * world.blob_shade
    for i0 in range(0, pb.shape[1], 32):
        bdx = px - pb[:, i0: i0 + 32, 0, None, None]
        bdy = py - pb[:, i0: i0 + 32, 1, None, None]
        g = torch.exp(-(bdx * bdx + bdy * bdy) / 8.0)
        img = img + torch.sum(g * w_blob[:, i0: i0 + 32, None, None], dim=1)

    img = torch.clamp(img, 0.02, 0.98)
    if noise is not None:
        img = torch.clamp(img + noise * 0.01, 0.0, 1.0)
    return img
