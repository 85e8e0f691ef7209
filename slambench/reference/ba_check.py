"""The correctness comparison of the GlobalBA cells.

The map's observations are exact, so its truth is the solve's optimum; the
reference holds each solve the window ran against it, in float64 on the
solve's device with plain tensor operations:

- ``pose_err_m``: the largest distance of an observed keyframe's position
  from the truth (the first keyframe is fixed, so no alignment; a keyframe
  that no valid observation reaches has nothing to move it). Computed, not
  compared: sound solves read up to 3.5e-3 m on an open chain of 1,000
  keyframes (float32 residuals), the control under twice that (PERF.md);
- ``rot_err``: the largest Frobenius norm of an observed keyframe's rotation
  minus the true one;
- ``point_err_m``: the largest distance of a point with a valid stereo
  observation from its true position (a point seen by mono observations
  alone is pinned only as far as their baselines reach);
- ``rms_px``: the root mean square of the reprojection residuals (u, v and,
  for stereo observations, the right u) of the valid observations;
- ``inlier_flips``: observations whose inlier flag differs from the gate
  evaluated here at the solve's result (χ² of the unit-information residual
  at most the configuration's threshold, stereo or mono, a positive depth,
  a valid observation). An exact comparison: limit 0.

Each number is the worst over the window's solves. The limits hold the solve
to the configuration's float32 with TF32 off: a solve whose normal equations
are float32 rather than the program's float64 reads like a sound one on every
number here (PERF.md), so the configuration states float32 and the control is
the precision below it, the reference's products with TF32-rounded operands.
"""

from __future__ import annotations

import torch

from slambench.harness.common import Check


def residuals(Rwb, twb, points, scene, cam, device):
    """(N, 3) reprojection residuals (observation − projection, the mono
    rows' third entry zero) and depths, in float64; the body frame is the
    camera's."""
    f64 = torch.float64
    pidx = torch.as_tensor(scene["pidx"], device=device)
    fidx = torch.as_tensor(scene["fidx"], device=device)
    obs = torch.as_tensor(scene["pobs"], device=device, dtype=f64)
    R, t, p = Rwb.to(device, f64), twb.to(device, f64), points.to(device, f64)
    pc = torch.einsum("nji,nj->ni", R[fidx], p[pidx] - t[fidx])  # Rᵀ (p − t)
    z = pc[:, 2]
    u = cam["fx"] * pc[:, 0] / z + cam["cx"]
    v = cam["fy"] * pc[:, 1] / z + cam["cy"]
    ur = u - cam["bf"] / z
    r = obs - torch.stack([u, v, ur], -1)
    r[:, 2] = torch.where(obs[:, 2] >= 0, r[:, 2], torch.zeros_like(r[:, 2]))
    return r, z


def numbers(out, scene: dict, config: dict, device) -> dict:
    Rwb, twb, points, p_in = out
    f64 = torch.float64
    cam, opt = config["camera"], config["optimization"]
    ok = torch.as_tensor(scene["ok"], device=device)
    r, z = residuals(Rwb, twb, points, scene, cam, device)
    stereo = torch.as_tensor(scene["pobs"][:, 2] >= 0, device=device)
    chi2 = (r * r).sum(-1)
    thr = torch.where(stereo, torch.tensor(float(opt["stereo_point"]), dtype=f64, device=device),
                      torch.tensor(float(opt["mono_point"]), dtype=f64, device=device))
    gate = (chi2 <= thr) & (z > 0) & ok
    rows = torch.stack([ok, ok, ok & stereo], -1)
    rms = torch.sqrt((r * r)[rows].mean())
    seen = torch.zeros(points.shape[0], dtype=torch.bool, device=device)
    seen[torch.as_tensor(scene["pidx"], device=device)[ok & stereo]] = True
    used = torch.zeros(twb.shape[0], dtype=torch.bool, device=device)
    used[torch.as_tensor(scene["fidx"], device=device)[ok]] = True
    t_true = torch.as_tensor(scene["twb"], device=device, dtype=f64)
    R_true = torch.as_tensor(scene["Rwb"], device=device, dtype=f64)
    p_true = torch.as_tensor(scene["pts"], device=device, dtype=f64)
    return {"pose_err_m": float((twb.to(device, f64) - t_true).norm(dim=-1)[used].max()),
            "rot_err": float((Rwb.to(device, f64) - R_true).flatten(1).norm(dim=-1)[used].max()),
            "point_err_m": float((points.to(device, f64) - p_true).norm(dim=-1)[seen].max()),
            "rms_px": float(rms),
            "inlier_flips": int((p_in.to(device) != gate).sum())}


def judge(outs, scene: dict, config: dict, limits: dict, device):
    """The checks of a run: the worst of every number over the solves
    ``outs`` [(Rwb, twb, points, point inlier flags)]."""
    worst = {}
    for out in outs:
        for k, v in numbers(out, scene, config, device).items():
            if v != v:  # NaN
                v = float("inf")
            worst[k] = max(worst.get(k, v), v)
    return [Check(name, worst.get(name, float("inf")), limits[name])
            for name in ("rot_err", "point_err_m", "rms_px", "inlier_flips")]
