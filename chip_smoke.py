"""Smoke run of the PyTorch port (``airslam_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the script exits non-zero
without a result line):

1. ``device``: the card's name and power limit (``nvidia-smi``), then the
   CUDA kernels are built from ``airslam_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel).
2. ``kernel R``: rectification remap on the EuRoC cam0/cam1 grids vs its
   plain PyTorch version (f32, ≤1e-5), kernel / plain / ``F.grid_sample``
   times.
3. ``kernel B`` / ``kernel T``: LOI point sampling at the frontend's shapes,
   f32 and bf16 maps, points on and beyond the borders, vs the plain version
   (f32 ≤1e-5 abs; bf16 ≤1e-5 relative to the map's max).
4. ``slice``: ``FrontendStep`` in bf16, then f32 with TF32 off, over the 3
   stereo pairs of ``tests/data/torch_frontend_oracle.npz`` (the JAX
   package's f32 CPU outputs), gated with ``scripts/verify_tpu.py``'s
   metrics and thresholds.
5. ``path``: every launch count set to 0, then rectify (kernel R) →
   ``FrontendStep`` (kernels B, T) on one pair; each kernel must have run.
   The same again for the f32 program. Then the per-frame time over 20
   frames, bf16 and f32.

Before the last line it prints the kernels' JSON record and the card's
``nvidia-smi`` line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX or the JAX package (the oracle is a stored file).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(REPO, "tests", "data", "torch_frontend_oracle.npz")
EUROC = {  # configs/camera/euroc.yaml:14-15,23-24: fx, fy, cx, cy / radtan
    "cam0": ([458.654, 457.296, 367.215, 248.375],
             [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]),
    "cam1": ([457.587, 456.134, 379.999, 255.238],
             [-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]),
}
HEIGHT, WIDTH = 480, 752
# H100 SXM data sheet (dense): HBM rate, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_GATES = {"kp_agree_1px": 0.90, "kp_top100_overlap": 0.85,
              "line_agree_3px": 0.80, "junc_agree_2px": 0.80, "match_agree": 0.90}
F32_GATES = {"kp_agree_1px": 0.98, "kp_top100_overlap": 0.95,
             "line_agree_3px": 0.90, "junc_agree_2px": 0.90, "match_agree": 0.95}


# ---------------------------------------------------------------------------
# frontend agreement metrics (copied from scripts/verify_tpu.py:55-130)
# ---------------------------------------------------------------------------


def _pts_agree(a, b, tol):
    """Fraction of rows of ``a`` with a row of ``b`` within ``tol`` (L2)."""
    if len(a) == 0:
        return 1.0
    if len(b) == 0:
        return 0.0
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    return float((d.min(axis=1) <= tol).mean())


def _lines_agree(a, b, tol):
    """Fraction of segments in ``a`` matched by one in ``b`` with both
    endpoints within ``tol`` (either endpoint order)."""
    if len(a) == 0:
        return 1.0
    if len(b) == 0:
        return 0.0
    e1 = np.maximum(np.linalg.norm(a[:, None, 0:2] - b[None, :, 0:2], axis=-1),
                    np.linalg.norm(a[:, None, 2:4] - b[None, :, 2:4], axis=-1))
    e2 = np.maximum(np.linalg.norm(a[:, None, 0:2] - b[None, :, 2:4], axis=-1),
                    np.linalg.norm(a[:, None, 2:4] - b[None, :, 0:2], axis=-1))
    d = np.minimum(e1, e2)
    return float((d.min(axis=1) <= tol).mean())


def _match_pairs(out):
    """(kp0_xy, kp1_xy) coordinate pairs of accepted matches."""
    kp0, kp1, idx1 = out["o0"], out["o1"], out["o2"].astype(np.int64)
    ok = idx1 >= 0
    return np.concatenate([kp0[ok], kp1[np.clip(idx1[ok], 0, len(kp1) - 1)]],
                          axis=-1)  # (M, 4)


def frontend_metrics(ref, got):
    """Agreement of two entry()-layout output dicts (``o0``..``o10``)."""
    m = {}
    kp_c = ref["o0"][ref["o7"] > 0]
    kp_t = got["o0"][got["o7"] > 0]
    m["kp_agree_1px"] = _pts_agree(kp_c, kp_t, 1.0)
    k = min(100, len(kp_c), len(kp_t))
    m["kp_top100_overlap"] = _pts_agree(ref["o0"][:k], got["o0"][:k], 1.0)
    m["line_agree_3px"] = _lines_agree(ref["o4"][ref["o5"] > 0],
                                       got["o4"][got["o5"] > 0], 3.0)
    m["junc_agree_2px"] = _pts_agree(ref["o8"][ref["o10"] > 0],
                                     got["o8"][got["o10"] > 0], 2.0)
    mc = _match_pairs(ref)
    mt = _match_pairs(got)
    if len(mc) and len(mt):
        d0 = np.linalg.norm(mc[:, None, 0:2] - mt[None, :, 0:2], axis=-1)
        d1 = np.linalg.norm(mc[:, None, 2:4] - mt[None, :, 2:4], axis=-1)
        m["match_agree"] = float((np.maximum(d0, d1).min(axis=1) <= 1.5).mean())
    else:
        m["match_agree"] = 1.0 if len(mc) == len(mt) else 0.0
    return m


def oracle_pairs():
    """The fixture's stereo pairs (float32 in [0, 1]) and the JAX outputs."""
    z = np.load(ORACLE)
    frames = z["frames_u8"].astype(np.float32) / np.float32(255.0)
    refs = [{k[len(f"p{i}_"):]: z[k] for k in z.files if k.startswith(f"p{i}_")}
            for i in range(frames.shape[0])]
    return frames, refs


def euroc_grids():
    """EuRoC cam0/cam1 undistortion grids (R = I, P = K), (2, H, W, 2)."""
    from airslam_tpu_torch.core.camera import undistort_rectify_map

    out = []
    for cam in ("cam0", "cam1"):
        (fx, fy, cx, cy), dist = EUROC[cam]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        out.append(undistort_rectify_map(K, dist, np.eye(3), K, (WIDTH, HEIGHT)))
    return np.stack(out)


# ---------------------------------------------------------------------------
# chip phases
# ---------------------------------------------------------------------------


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


@contextlib.contextmanager
def _no_tf32(label):
    """TF32 off while the f32 program runs; restored after."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if label == "f32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _time_ms(fn, iters=100, reps=5):
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed ``reps`` times between CUDA events, so the host's
    launch overhead stays out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up off the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _eager_ms(fn, iters=200, warmup=20):
    """Time per call of ``fn`` issued eagerly back to back (CUDA events):
    the wrapper's host cost shows here when it exceeds the kernel's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_r(dev, grids_np):
    import torch
    import torch.nn.functional as F

    from airslam_tpu_torch.ops.gridsample import remap as remap_plain
    from airslam_tpu_torch.ops.remap import remap

    rng = np.random.RandomState(0)
    images = torch.as_tensor(rng.rand(2, HEIGHT, WIDTH).astype(np.float32), device=dev)
    grids = torch.as_tensor(grids_np, device=dev)
    got = remap(images, grids)

    def plain():
        return torch.stack([remap_plain(images[i], grids[i]) for i in range(2)])

    want = plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    _require(err <= 1e-5, f"kernel R disagrees with its plain version: {err}")
    # nearest library call: grid_sample over normalized coordinates; it clamps
    # the COORDINATE at the border (padding_mode="border") where remap clamps
    # the integer taps with unclipped weights, so the two differ off-image
    scale = torch.tensor([2.0 / (WIDTH - 1), 2.0 / (HEIGHT - 1)], device=dev)
    norm_grid = grids * scale - 1.0
    img4 = images[:, None]

    def library():
        return F.grid_sample(img4, norm_grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    ms = _time_ms(lambda: remap(images, grids))
    eager = _eager_ms(lambda: remap(images, grids))
    plain_ms = _time_ms(plain)
    lib_ms = _time_ms(library)
    n = 2 * HEIGHT * WIDTH
    taps = sum(_distinct_taps(grids[i, ..., 0], grids[i, ..., 1], HEIGHT, WIDTH)
               for i in range(2))  # texels the grids read, not the whole images
    bound, by = _bound_ms(taps * 4 + n * 8 + n * 4, n * 13)
    print(f"kernel R: max_abs_err={err:.3e} (<=1e-5) ms={ms:.5f} eager_ms={eager:.5f} "
          f"plain_ms={plain_ms:.5f} texels_read={taps}/{n} "
          f"grid_sample_ms={lib_ms:.5f} bound_ms={bound:.6f} ({by})")
    return {"name": "remap", "route": "cuda", "source": "airslam_tpu_torch/csrc/remap.cu",
            "replaces": "airslam_tpu/ops/remap_tiled.py:140", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def _border_points(rng, shape, lo, hi, size):
    """Uniform points plus exact border and beyond-border values."""
    n = int(np.prod(shape))
    v = rng.uniform(lo, hi, n).astype(np.float32)
    edge = np.asarray([-1.5, -0.5, 0.0, size - 1.0, size - 0.5, size + 1.0], np.float32)
    v[:len(edge)] = edge
    v[len(edge):2 * len(edge)] = edge[::-1]
    return v.reshape(shape)


def _distinct_taps(x, y, h, w):
    """Distinct texels the 4-tap samples of these points touch."""
    import torch

    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    taps = torch.cat([(yy * w + xx).reshape(-1) for yy in (y0, y1) for xx in (x0, x1)])
    return int(torch.unique(taps.long()).numel())


def phase_kernel_bt(dev, which):
    """Kernel B (LOI map, 300 junction points) or T (thin/aux map, 512×30
    interior points) at the frontend's shapes."""
    import torch
    import torch.nn.functional as F

    from airslam_tpu_torch.ops import bilerp

    rng = np.random.RandomState(1 if which == "B" else 2)
    c, pts = (128, (300,)) if which == "B" else (4, (512, 30))
    fn = bilerp.bilerp_points if which == "B" else bilerp.bilerp_points_t
    x = torch.as_tensor(_border_points(rng, pts, -1.5, 129.5, 128), device=dev)
    y = torch.as_tensor(_border_points(rng, pts, -1.5, 129.5, 128)[::-1].copy(), device=dev)

    def plain(fmap):
        out = bilerp.bilerp_plain(fmap, x, y)
        return out if which == "B" else torch.movedim(out, -1, 0)

    errs = {}
    maps = {}
    for dtype in (torch.float32, torch.bfloat16):
        fmap = torch.as_tensor(rng.randn(128, 128, c).astype(np.float32), device=dev).to(dtype)
        got, want = fn(fmap, x, y), plain(fmap)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 * (1.0 if dtype == torch.float32 else float(fmap.float().abs().max()))
        _require(err <= tol, f"kernel {which} ({dtype}) disagrees with plain: {err} > {tol}")
        errs[dtype], maps[dtype] = err, fmap
    fmap = maps[torch.bfloat16]  # the production program's dtype
    # nearest library call: grid_sample, align_corners=True, zero padding
    # (its border weights differ from the stage-1 arithmetic)
    img4 = fmap.permute(2, 0, 1)[None].contiguous()
    g = (torch.stack([x, y], dim=-1).reshape(1, 1, -1, 2) * (2.0 / 127) - 1.0).to(fmap.dtype)

    def library():
        return F.grid_sample(img4, g, mode="bilinear", align_corners=True)

    ms = _time_ms(lambda: fn(fmap, x, y))
    eager = _eager_ms(lambda: fn(fmap, x, y))
    plain_ms = _time_ms(lambda: plain(fmap))
    lib_ms = _time_ms(library)
    n = x.numel()
    n_bytes = _distinct_taps(x, y, 128, 128) * c * 2 + n * 8 + n * c * 4
    bound, by = _bound_ms(n_bytes, n * c * 8 + n * 20)
    print(f"kernel {which}: points={tuple(pts)} C={c} max_abs_err f32={errs[torch.float32]:.3e} "
          f"bf16={errs[torch.bfloat16]:.3e} ms={ms:.5f} eager_ms={eager:.5f} plain_ms={plain_ms:.5f} "
          f"grid_sample_ms={lib_ms:.5f} bound_ms={bound:.6f} ({by})")
    name = "bilerp_points" if which == "B" else "bilerp_points_t"
    line = 45 if which == "B" else 124
    return {"name": name, "route": "cuda", "source": "airslam_tpu_torch/csrc/bilerp.cu",
            "replaces": f"airslam_tpu/ops/bilerp_pallas.py:{line}",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def _outputs_np(out):
    """entry()-layout dict of numpy arrays (bf16 values widened to f32)."""
    import torch

    return {f"o{j}": (o.float() if o.dtype == torch.bfloat16 else o).cpu().numpy()
            for j, o in enumerate(out)}


def phase_slice(dev, frames, refs):
    import torch

    from airslam_tpu_torch.entry import FrontendStep

    steps = {}
    for label, dtype, gates in (("bf16", torch.bfloat16, BF16_GATES),
                                ("f32", torch.float32, F32_GATES)):
        with _no_tf32(label):
            step = FrontendStep(dtype=dtype, device=dev)
            per_pair = [frontend_metrics(ref, _outputs_np(step(torch.as_tensor(pair, device=dev))))
                        for pair, ref in zip(frames, refs)]
        mean = {k: float(np.mean([m[k] for m in per_pair])) for k in gates}
        print(f"slice {label}: " + " ".join(f"{k}={v:.4f}(>={gates[k]})" for k, v in mean.items()))
        bad = [k for k, v in mean.items() if v < gates[k]]
        _require(not bad, f"slice {label} gates failed: {bad}")
        steps[label] = step
    return steps


def phase_path(dev, steps, frames, grids_np):
    import torch

    from airslam_tpu_torch.ops import bilerp, remap as remap_mod

    grids = torch.as_tensor(grids_np, device=dev)
    raw = torch.as_tensor(frames[0], device=dev)
    counted = (remap_mod.remap, bilerp.bilerp_points, bilerp.bilerp_points_t)

    def frame(step):
        left, right = step.rectify(raw[0], raw[1], grids)
        return step(torch.stack([left, right]))

    launches = {}
    for label in ("bf16", "f32"):  # bf16 is the production program
        for fn in counted:
            fn.launches = 0
        with _no_tf32(label):
            out = frame(steps[label])
            torch.cuda.synchronize()
        launches[label] = {fn.__name__: fn.launches for fn in counted}
        tag = "kernels:" if label == "bf16" else "kernels f32:"
        print(tag + "".join(f" {k}={v}" for k, v in launches[label].items()))
        _require(all(v > 0 for v in launches[label].values()),
                 f"a kernel of the {label} path did not run: {launches[label]}")
        shapes = [(400, 2), (400, 2), (400,), (400,), (512, 4), (512,), (400, 256), (400,),
                  (2, 256, 2), (2, 256, 256), (2, 256)]
        _require([tuple(o.shape) for o in out] == shapes,
                 f"{label} path outputs have the wrong shapes")
        _require(all(bool(torch.isfinite(o.float()).all()) for o in out),
                 f"{label} path outputs are not finite")
        _require(int(out[7].sum()) > 0 and int(out[5].sum()) > 0 and int((out[2] >= 0).sum()) > 0,
                 f"{label} path found no keypoints, lines or matches")

    times = {}
    for label in ("bf16", "f32"):
        with _no_tf32(label):
            for _ in range(3):
                frame(steps[label])
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(20):
                frame(steps[label])
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 20
        times[label] = (start.elapsed_time(end) / 20, wall)
    print("path per-frame (rectify + frontend, 20 frames): " + " ".join(
        f"{k}: events_ms={v[0]:.3f} wall_ms={v[1]:.3f}" for k, v in times.items()))
    return launches["bf16"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "airslam_tpu_torch")):
        print("chip_smoke: the airslam_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    from airslam_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    logs = cuda_build.build()
    print(f"build: {sorted(logs) or 'cached'} in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {name}: {ln.strip()}")

    grids_np = euroc_grids()
    kernels = [phase_kernel_r(dev, grids_np), phase_kernel_bt(dev, "B"),
               phase_kernel_bt(dev, "T")]
    frames, refs = oracle_pairs()
    steps = phase_slice(dev, frames, refs)
    launches = phase_path(dev, steps, frames, grids_np)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
