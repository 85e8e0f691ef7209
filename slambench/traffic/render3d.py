"""Frozen copy of the port's rendered 3D world, the stand-in for EuRoC's
camera streams.

Copied from ``airslam_tpu_torch/frontend/synthgen.py``: ``World3D``,
``world3d_draws``, ``make_world3d``, ``texture_draws``,
``view_noise_draws``, ``_octave_noise``, ``_project`` and
``render_view3d`` (with the helpers ``_uniform``, ``_scale``, ``_normal``
and ``_fma``). The benchmark renders its traffic with this copy and never
with the program's, so a change to the program cannot move the images it
is measured on.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

Draws = Dict[str, torch.Tensor]

WORLD_EXTENT = ((-4.0, 4.0), (-2.5, 2.5), (2.0, 20.0))  # x, y, z ranges of the corridor
TEXTURE_OCTAVES = 5
TEXTURE_PLANES = 2  # the floor, then the back wall


class World3D(NamedTuple):
    segments: torch.Tensor  # (S, 2, 3) segment endpoints in the world
    seg_shade: torch.Tensor  # (S,)
    blobs: torch.Tensor  # (B, 3) dot features
    blob_shade: torch.Tensor  # (B,)


def _scale(u, lo, hi):
    """``jax.random.uniform``'s map of u in [0, 1) onto [lo, hi)."""
    return torch.maximum(torch.as_tensor(lo, dtype=u.dtype, device=u.device),
                         u * (hi - lo) + lo)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return _scale(torch.rand(shape, generator=gen, device=gen.device), lo, hi)


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def _fma(a, b, c):
    """a·b + c rounded once (the float32 product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def world3d_draws(gen: torch.Generator, n_seg: int = 48, n_blob: int = 320) -> Draws:
    """The random tensors of :func:`make_world3d`."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device=gen.device)

    return {"seg_a": u(n_seg, 3), "seg_dir": _normal(gen, (n_seg, 3)),
            "seg_axis": torch.randint(0, 3, (n_seg,), generator=gen, device=gen.device),
            "seg_length": _uniform(gen, (n_seg, 1), 0.8, 3.0),
            "seg_shade": _uniform(gen, (n_seg,), 0.25, 0.55), "seg_sign": u(n_seg),
            "blobs": u(n_blob, 3), "blob_shade": _uniform(gen, (n_blob,), 0.3, 0.6),
            "blob_sign": u(n_blob)}


def make_world3d(d: Draws, extent=WORLD_EXTENT) -> World3D:
    """Random wireframe-and-dots corridor: segments hug axis-aligned planes,
    blobs give the point detector texture everywhere."""
    (x0, x1), (y0, y1), (z0, z1) = extent

    def upts(u):
        return torch.stack([x0 + u[:, 0] * (x1 - x0), y0 + u[:, 1] * (y1 - y0),
                            z0 + u[:, 2] * (z1 - z0)], -1)

    def signed(shade, sign):
        return shade * torch.where(sign > 0.5, 1.0, -1.0)

    a = upts(d["seg_a"])
    squash = F.one_hot(d["seg_axis"].long(), 3).to(a.dtype)
    v = d["seg_dir"] * (1.0 - squash * 0.95)
    norm = torch.sqrt(_fma(v[:, 2], v[:, 2], _fma(v[:, 1], v[:, 1], v[:, 0] * v[:, 0])))
    v = v / (norm[:, None] + 1e-9)
    b = a + v * d["seg_length"]
    return World3D(torch.stack([a, b], dim=1), signed(d["seg_shade"], d["seg_sign"]),
                   upts(d["blobs"]), signed(d["blob_shade"], d["blob_sign"]))


def texture_draws(gen: torch.Generator) -> Draws:
    """The angles of :func:`_octave_noise` on each textured plane."""
    return {"theta": _uniform(gen, (TEXTURE_PLANES, TEXTURE_OCTAVES, 3), 0.0, 6.28318)}


def view_noise_draws(gen: torch.Generator, n: int, height: int, width: int) -> Draws:
    """The per-pixel sensor noise of :func:`render_view3d` for ``n`` views."""
    return {"noise": _normal(gen, (n, height, width))}


def _octave_noise(u, v, theta, amp: float = 1.0):
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
    """Rasterize the world into N grayscale views (N, H, W) in [0, 1] on the
    world's device; ``Rcw`` (N, 3, 3), ``tcw`` (N, 3) world-to-camera poses;
    ``noise`` (N, H, W) standard normal, added at 0.01."""
    n = Rcw.shape[0]
    dt = world.segments.dtype
    px = torch.arange(width, dtype=dt, device=Rcw.device)[None, None, :] + 0.5
    py = torch.arange(height, dtype=dt, device=Rcw.device)[None, :, None] + 0.5

    img = torch.full((n, height, width), 0.55, dtype=dt, device=Rcw.device)
    if texture > 0.0:
        if texture_theta is None:
            raise ValueError("texture > 0 needs the texture's draws (texture_draws)")
        dx = ((px - cx) / fx).expand(1, height, width)
        dy = ((py - cy) / fy).expand(1, height, width)
        d_cam = torch.stack([dx, dy, torch.ones_like(dx)], -1)
        d_w = torch.einsum("nhwk,nkj->nhwj", d_cam.expand(n, -1, -1, -1), Rcw)
        C = -torch.einsum("nkj,nk->nj", Rcw, tcw)
        eps = 1e-6

        def safe(den):
            return torch.where(torch.abs(den) < eps, eps, den)

        t_f = (floor_y - C[:, 1, None, None]) / safe(d_w[..., 1])
        t_wz = (wall_z - C[:, 2, None, None]) / safe(d_w[..., 2])
        hits = []
        for t_pl, (ua, va), plane in ((t_f, (0, 2), 0), (t_wz, (0, 1), 1)):
            ok = t_pl > 0.2
            t_safe = torch.where(ok, t_pl, 1e6)
            hit = C[:, None, None, :] + t_safe[..., None] * d_w
            tex = _octave_noise(hit[..., ua], hit[..., va], texture_theta[plane])
            hits.append((t_safe, torch.where(ok, tex, 0.0)))
        (t0, tex0), (t1, tex1) = hits
        tex = torch.where(t0 < t1, tex0, tex1)
        att = 1.0 / (1.0 + 0.05 * torch.minimum(t0, t1))
        img = img + texture * tex * att
    else:
        u = (px / width * 8).to(torch.int32) + (py / height * 6).to(torch.int32)
        img = img + 0.04 * torch.cos(u.to(dt) * 2.1)

    p2a, za = _project(world.segments[:, 0], Rcw, tcw, fx, fy, cx, cy)
    p2b, zb = _project(world.segments[:, 1], Rcw, tcw, fx, fy, cx, cy)
    w_seg = ((za > 0.25) & (zb > 0.25)).to(dt) * world.seg_shade
    segs2d = torch.cat([p2a, p2b], dim=-1)
    for i0 in range(0, segs2d.shape[1], 8):
        ch = segs2d[:, i0: i0 + 8]
        ax, ay, bx, by = (ch[..., i, None, None] for i in range(4))
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
