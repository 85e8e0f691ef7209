"""SO(3)/SE(3)/Plücker-line Lie operations on tensors.

Port of ``airslam_tpu/core/lie.py`` (whole file). Conventions follow the
reference system (sair-lab/AirSLAM):

- ``so3_exp`` / ``so3_log`` / right Jacobian: Rodrigues with the same
  small-angle branches as ``SO3Exp``/``SO3Log``/``ComputerDeltaR`` in
  ``src/imu.cc:26-67``.
- ``normalize_rotation``: SVD projection onto SO(3) (``src/imu.cc:16-19``).
- Plücker 3D lines are 6-vectors ``(w, d)``, ``w`` the moment (``p × d`` for
  any point ``p`` on the line) and ``d`` the direction, matching
  ``g2o::Line3D`` (``src/line_processor.cc:257-326``,
  ``src/g2o_optimization/edge_project_line.cc:37-46``).
- The 4-dof orthonormal line update (Bartoli–Sturm) matches
  ``VertexLine3D::oplusImpl`` (``include/g2o_optimization/vertex_line3d.h:22-26``).

All functions broadcast over leading batch dimensions and keep the input
dtype. The guarded branches are ``torch.where`` selections, so forward-mode
derivatives (``torch.func.jacfwd``) pick the selected branch's derivative, as
``jax.jacfwd`` does through ``jnp.where``.
"""

from __future__ import annotations

import torch

_EPS = 1e-4  # IMU_EPS in include/imu.h:20


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(…, i, j) · (…, j) -> (…, i)."""
    return (m * v[..., None, :]).sum(-1)


def hat(v: torch.Tensor) -> torch.Tensor:
    """(…, 3) -> (…, 3, 3) skew-symmetric matrix. Reference: src/imu.cc:12-14."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def vee(m: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3) skew -> (…, 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _theta_terms(v):
    theta = torch.sqrt((v * v).sum(-1))
    small = theta < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    return small, safe, safe * safe


def _rodrigues(v, a, b):
    omega = hat(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(omega.shape)
    return eye + a[..., None, None] * omega + b[..., None, None] * (omega @ omega)


def so3_exp(v: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map, (…, 3) -> (…, 3, 3): the series switch of
    ``SO3Exp`` (src/imu.cc:40-55) at theta < 1e-4, without its SVD
    renormalization."""
    small, st, st2 = _theta_terms(v)
    one = torch.ones_like(st)
    a = torch.where(small, one, torch.sin(st) / st)
    b = torch.where(small, 0.5 * one, (1.0 - torch.cos(st)) / st2)
    return _rodrigues(v, a, b)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3) -> (…, 3). Branches of ``SO3Log`` (src/imu.cc:57-67)."""
    d = 0.5 * (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1.0)
    delta_r = torch.stack([r[..., 2, 1] - r[..., 1, 2],
                           r[..., 0, 2] - r[..., 2, 0],
                           r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    near_identity = d.abs() > 0.99999
    d_clip = torch.clamp(d, -1.0 + 1e-12, 1.0 - 1e-12)
    theta = torch.acos(d_clip)
    scale = theta / (2.0 * torch.sqrt(1.0 - d_clip * d_clip))
    scale = torch.where(near_identity, 0.5 * torch.ones_like(scale), scale)
    return scale[..., None] * delta_r


def so3_right_jacobian(v: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of the SO(3) exp, as in ``ComputerDeltaR`` (src/imu.cc:21-33)."""
    small, st, st2 = _theta_terms(v)
    zero = torch.zeros_like(st)
    a = torch.where(small, zero, (1.0 - torch.cos(st)) / st2)
    b = torch.where(small, zero, (st - torch.sin(st)) / (st2 * st))
    return _rodrigues(v, -a, b)


def so3_right_jacobian_inv(v: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian (used by the IMU rotation residual Jacobians)."""
    small, st, st2 = _theta_terms(v)
    coef = torch.where(
        small, torch.zeros_like(st),
        1.0 / st2 - (1.0 + torch.cos(st)) / (2.0 * st * torch.sin(st)))
    return _rodrigues(v, torch.full_like(st, 0.5), coef)


def normalize_rotation(r: torch.Tensor) -> torch.Tensor:
    """Project (…, 3, 3) onto SO(3) via SVD — ``NormalizeRotation`` src/imu.cc:16-19."""
    u, _, vt = torch.linalg.svd(r)
    det = torch.linalg.det(u @ vt)
    # guard against reflections (det = -1); the reference assumes det > 0
    u_fixed = torch.cat([u[..., :, :-1], u[..., :, -1:] * torch.sign(det)[..., None, None]],
                        dim=-1)
    return u_fixed @ vt


# ---------------------------------------------------------------------------
# SE(3) as (R, t) pairs and 4x4 homogeneous matrices
# ---------------------------------------------------------------------------


def se3_matrix(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(…,3,3),(…,3) -> (…,4,4)."""
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = r.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([r, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype,
                          device=r.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(r: torch.Tensor, t: torch.Tensor):
    rt = r.transpose(-1, -2)
    return rt, -_mv(rt, t)


def se3_compose(r1, t1, r2, t2):
    """(R1,t1)·(R2,t2): apply T2 first."""
    return r1 @ r2, _mv(r1, t2) + t1


def se3_apply(r, t, p):
    return _mv(r, p) + t


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(…, 4) quaternion (w, x, y, z) -> (…, 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def rot_to_quat(r: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3) -> (…, 4) quaternion (w, x, y, z), branchless Shepperd-style."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]

    def half_root(s):
        return 0.5 * torch.sqrt(torch.clamp(s, min=1e-12))

    def sign_of(d):
        return torch.sign(torch.where(d == 0, torch.ones_like(d), d))

    qw = half_root(1.0 + m00 + m11 + m22)
    qx = half_root(1.0 + m00 - m11 - m22) * sign_of(m21 - m12)
    qy = half_root(1.0 - m00 + m11 - m22) * sign_of(m02 - m20)
    qz = half_root(1.0 - m00 - m11 + m22) * sign_of(m10 - m01)
    q = torch.stack([qw, qx, qy, qz], dim=-1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Plücker lines: 6-vectors (w, d); w = moment, d = direction (g2o::Line3D layout)
# ---------------------------------------------------------------------------


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def line_from_endpoints(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Two 3D points -> normalized Plücker (w, d) with |d| = 1
    (``ComputeLine3DFromEndpoints``, src/line_processor.cc:312-326)."""
    d = p2 - p1
    dn = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return torch.cat([_cross(p1, dn), dn], dim=-1)


def line_normalize(line: torch.Tensor) -> torch.Tensor:
    """Scale so |d| = 1 (g2o ``Line3D::normalize``)."""
    n = torch.linalg.vector_norm(line[..., 3:6], dim=-1, keepdim=True)
    return line / torch.clamp(n, min=1e-12)


def line_transform(r: torch.Tensor, t: torch.Tensor, line: torch.Tensor) -> torch.Tensor:
    """Apply SE(3) (R, t) to a Plücker line: w' = R w + t × (R d); d' = R d
    (the g2o ``Isometry3 * Line3D`` action, src/line_processor.cc:305,
    edge_project_line.cc:28)."""
    w = _mv(r, line[..., 0:3])
    d = _mv(r, line[..., 3:6])
    return torch.cat([w + _cross(t, d), d], dim=-1)


def line_to_cartesian(line: torch.Tensor) -> torch.Tensor:
    """(w, d) -> (p0, d) with p0 the point on the line closest to the origin."""
    line = line_normalize(line)
    w, d = line[..., 0:3], line[..., 3:6]
    return torch.cat([_cross(d, w), d], dim=-1)


def line_orthonormal_oplus(line: torch.Tensor, update: torch.Tensor) -> torch.Tensor:
    """4-dof orthonormal (Bartoli–Sturm) update of a Plücker line.

    ``update`` = (…, 4): the first 3 rotate the U ∈ SO(3) frame (right
    multiply), the last rotates the W ∈ SO(2) factor carrying the w/d
    magnitude ratio (``VertexLine3D::oplusImpl``). Returns a line with |d|=1.
    """
    w, d = line[..., 0:3], line[..., 3:6]
    nw = torch.linalg.vector_norm(w, dim=-1)
    nd = torch.linalg.vector_norm(d, dim=-1)
    n = torch.sqrt(nw * nw + nd * nd)
    u1 = w / torch.clamp(nw, min=1e-12)[..., None]
    u2 = d / torch.clamp(nd, min=1e-12)[..., None]
    u = torch.stack([u1, u2, _cross(u1, u2)], dim=-1)  # columns
    cos_phi = nw / torch.clamp(n, min=1e-12)
    sin_phi = nd / torch.clamp(n, min=1e-12)

    u_new = u @ so3_exp(update[..., 0:3])
    dphi = update[..., 3]
    cos_new = cos_phi * torch.cos(dphi) - sin_phi * torch.sin(dphi)
    sin_new = sin_phi * torch.cos(dphi) + cos_phi * torch.sin(dphi)
    w_new = cos_new[..., None] * u_new[..., :, 0]
    d_new = sin_new[..., None] * u_new[..., :, 1]
    return line_normalize(torch.cat([w_new, d_new], dim=-1))


def line_point_distance(line: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Euclidean distance of a 3D point to a normalized Plücker line."""
    line = line_normalize(line)
    w, d = line[..., 0:3], line[..., 3:6]
    return torch.linalg.vector_norm(_cross(p, d) - w, dim=-1)
