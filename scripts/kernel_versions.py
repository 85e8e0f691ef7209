"""Kernels P, F and B+T′ of two checkouts side by side on one NVIDIA GPU.

    python3 scripts/kernel_versions.py --base DIR

``DIR`` holds another checkout's ``airslam_tpu_torch`` package, for instance
an earlier commit's, unpacked into a directory that ``.gitignore`` lists:

    mkdir -p _archive/base && git archive <commit> airslam_tpu_torch | tar -x -C _archive/base

Each checkout runs in a process of its own, in the order base, this, this,
base, on the same inputs (made from seeds by this checkout's
``chip_smoke.py``), and builds its own kernels:

- kernel P on the tracking path's problem (200 matched points padded to 256,
  one masked line) and on the full one (512 points, 128 lines): pose, inlier
  flags and count after 3 rounds × 10 iterations; the accepted iterates of
  the first round (a rejected trial leaves the pose as it was, so the pose
  after iteration k differs from the pose after k − 1 exactly when iteration
  k was accepted); device ms by CUDA-graph replay;
- kernel F through ``flash_mha`` on LightGlue's bf16 views at (2, 4, 400, 64):
  its output, device ms, eager ms, and the wrapper's host µs per call: 200
  calls issued after a synchronisation and timed on the host's clock (the
  device's queue takes them without blocking, so this is the host's cost
  whatever the kernel's), and the same for the layout step ``_bhnd`` of q, k
  and v alone;
- kernel B+T′ through ``loi_features_backward`` at the training shape (8
  views, 165 lines) and the VO shape (2 views, 512 lines, 300 junctions):
  its five gradients and device ms by CUDA-graph replay (the call: its zero
  fills and the kernel).

It prints the gaps between the two checkouts (P: max abs of t and R against
each other and against the plain version, inlier agreement, counts, the
first round's accepted iterates, bit-equality; F: bit-equality and max abs;
B+T′: each gradient's max abs between the checkouts and each checkout's
against autograd through this checkout's plain version, as a share of the
largest |gradient|; the runs' outputs pass through a temporary directory)
and each run's times, then the card's name and power limit, and writes them
to ``chiprun_out/kernel_versions_<last part of DIR>.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "chiprun_out")
ROUNDS, ITERS = 3, 10


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` (its problem generators and timers),
    loaded from its file so that ``airslam_tpu_torch`` comes from sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_us(fn, calls=200, reps=5):
    """Host µs per call of ``fn``, ``calls`` calls after a synchronisation;
    the best of ``reps``."""
    import torch

    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def child(tree: str, out: str) -> None:
    """Run one checkout's kernels and save what they gave to ``out``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = _chip_smoke()
    from airslam_tpu_torch.backend import gn, pose_gn
    from airslam_tpu_torch.ops import attention

    dev = torch.device("cuda")
    cfg = gn.BAConfig()
    res = {"tree": np.array(os.path.abspath(tree))}
    problems = {"path": cs.tracking_problem(6, 200, 1, n_masked_points=56, mask_lines=True,
                                            device=dev),
                "full": cs.tracking_problem(5, 512, 128, device=dev)}
    for name, (problem, intr, _) in problems.items():
        out3 = pose_gn.pose_only_fast(problem, intr, cfg, rounds=ROUNDS, iters=ITERS)
        plain = pose_gn.pose_only_fast_plain(problem, intr, cfg, rounds=ROUNDS, iters=ITERS)
        first = [pose_gn.pose_only_fast(problem, intr, cfg, rounds=1, iters=k)[0]
                 for k in range(ITERS + 1)]
        torch.cuda.synchronize()
        res[f"{name}_pose"] = torch.cat([out3[0].frames.Rwb.reshape(-1),
                                         out3[0].frames.twb.reshape(-1)]).cpu().numpy()
        res[f"{name}_plain_pose"] = torch.cat([plain[0].frames.Rwb.reshape(-1),
                                               plain[0].frames.twb.reshape(-1)]).cpu().numpy()
        res[f"{name}_flags"] = torch.cat([out3[1].reshape(-1), out3[2].reshape(-1)]).cpu().numpy()
        res[f"{name}_count"] = np.array(int(out3[3]))
        res[f"{name}_round1"] = np.stack([torch.cat([p.frames.Rwb.reshape(-1),
                                                     p.frames.twb.reshape(-1)]).cpu().numpy()
                                          for p in first])
        res[f"{name}_ms"] = np.array(cs._time_ms(
            lambda: pose_gn.pose_only_fast(problem, intr, cfg), iters=20))

    rng = np.random.RandomState(0)
    q, k, v, mask = cs._attention_inputs(rng, (2,), 4, 400, 400, 64, torch.bfloat16,
                                         torch.bfloat16, dev, 388)
    out_f = attention.flash_mha(q, k, v, mask)
    torch.cuda.synchronize()
    res["f_out"] = out_f.float().cpu().numpy()
    res["f_ms"] = np.array(cs._time_ms(lambda: attention.flash_mha(q, k, v, mask)))
    res["f_eager_ms"] = np.array(cs._eager_ms(lambda: attention.flash_mha(q, k, v, mask)))
    res["f_host_us"] = np.array(_host_us(lambda: attention.flash_mha(q, k, v, mask)))
    res["f_layout_host_us"] = np.array(_host_us(
        lambda: (attention._bhnd(q), attention._bhnd(k), attention._bhnd(v)), calls=2000))

    from airslam_tpu_torch.ops import bilerp

    for name, (ops, grad) in _backward_shapes(cs, dev).items():
        for k, d in zip(GRADS, bilerp.loi_features_backward(grad, *ops)):
            res[f"{name}_{k}"] = d.cpu().numpy()
        res[f"{name}_ms"] = np.array(cs._time_ms(lambda: bilerp.loi_features_backward(grad,
                                                                                      *ops)))
    np.savez(out, **res)


GRADS = ("d_loi", "d_thin", "d_aux", "d_t_fwd", "d_t_rev")


def _backward_shapes(cs, dev):
    """Kernel B+T′'s operands and row gradient at the training and VO
    shapes, from seeds."""
    import torch

    shapes = {"btp_train": cs.train_loi_inputs(np.random.RandomState(5), 8, dev),
              "btp_vo": cs.loi_inputs(np.random.RandomState(6), 2, 512, 300, torch.float32, dev)}
    return {name: (ops, torch.as_tensor(np.random.RandomState(7).randn(
        ops[5].shape[0], ops[5].shape[1], 496).astype(np.float32), device=dev))
        for name, ops in shapes.items()}


def _backward_plain() -> dict:
    """Autograd through this checkout's plain version at the runs' inputs,
    on the card."""
    import torch

    cs = _chip_smoke()
    from airslam_tpu_torch.ops import bilerp

    out = {}
    for name, (ops, grad) in _backward_shapes(cs, torch.device("cuda")).items():
        for k, d in zip(GRADS, bilerp.loi_features_backward_plain(grad, *ops)):
            out[f"{name}_{k}"] = d.cpu().numpy()
    return out


def _accepted(round1: np.ndarray) -> list:
    """Indices k of the first round's accepted iterations."""
    return [k for k in range(1, len(round1)) if not np.array_equal(round1[k], round1[k - 1])]


def compare(base: dict, this: dict, plain_grads: dict) -> dict:
    rep = {}
    for name in ("path", "full"):
        pb, pt = base[f"{name}_pose"].astype(np.float64), this[f"{name}_pose"].astype(np.float64)
        plain = this[f"{name}_plain_pose"].astype(np.float64)
        rep[f"P {name}"] = {
            "bit_equal": bool(np.array_equal(base[f"{name}_pose"], this[f"{name}_pose"])
                              and np.array_equal(base[f"{name}_flags"], this[f"{name}_flags"])),
            "dt": float(np.abs(pt[9:] - pb[9:]).max()), "dR": float(np.abs(pt[:9] - pb[:9]).max()),
            "dt_to_plain": {"base": float(np.abs(pb[9:] - plain[9:]).max()),
                            "this": float(np.abs(pt[9:] - plain[9:]).max())},
            "inlier_agree": float((base[f"{name}_flags"] == this[f"{name}_flags"]).mean()),
            "count": {"base": int(base[f"{name}_count"]), "this": int(this[f"{name}_count"])},
            "round1_accepted": {"base": _accepted(base[f"{name}_round1"]),
                                "this": _accepted(this[f"{name}_round1"])},
            "round1_iterates_bit_equal": [bool(np.array_equal(a, b)) for a, b in
                                          zip(base[f"{name}_round1"], this[f"{name}_round1"])],
        }
    rep["F bf16 (2, 4, 400, 64)"] = {
        "bit_equal": bool(np.array_equal(base["f_out"], this["f_out"])),
        "max_abs": float(np.abs(base["f_out"] - this["f_out"]).max())}
    for name in ("btp_train", "btp_vo"):
        gaps = {}
        for k in GRADS:
            a, b, want = base[f"{name}_{k}"], this[f"{name}_{k}"], plain_grads[f"{name}_{k}"]
            scale = max(float(np.abs(want).max()), 1e-30)
            gaps[k] = {"base_vs_this": float(np.abs(a - b).max()) / scale,
                       "base_vs_plain": float(np.abs(a - want).max()) / scale,
                       "this_vs_plain": float(np.abs(b - want).max()) / scale}
        rep[f"B+T' {name[4:]} (share of the largest |gradient|)"] = gaps
    return rep


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", help="directory holding the other checkout's airslam_tpu_torch")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.out)
        return 0
    if not args.base or not os.path.isdir(os.path.join(args.base, "airslam_tpu_torch")):
        print("kernel_versions: --base DIR must hold an airslam_tpu_torch package", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, tree) in enumerate((("base", args.base), ("this", REPO), ("this", REPO),
                                           ("base", args.base))):
            path = os.path.join(tmp, f"run_{i}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                            "--out", path], check=True)
            with np.load(path) as z:
                runs.append((label, {k: z[k] for k in z.files}))
    sys.path.insert(0, REPO)
    plain = _backward_plain()
    times = [{"run": label, "P path ms": float(r["path_ms"]), "P full ms": float(r["full_ms"]),
              "F ms": float(r["f_ms"]), "F eager ms": float(r["f_eager_ms"]),
              "F host us": float(r["f_host_us"]), "F layout host us": float(r["f_layout_host_us"]),
              "B+T' train ms": float(r["btp_train_ms"]), "B+T' VO ms": float(r["btp_vo_ms"])}
             for label, r in runs]

    def same_d_loi(a, b):
        return all(np.array_equal(runs[a][1][f"{n}_d_loi"], runs[b][1][f"{n}_d_loi"])
                   for n in ("btp_train", "btp_vo"))

    rep = {"gaps (base run 1 vs this run 1)": compare(runs[0][1], runs[1][1], plain),
           "repeat bit-equal": {
               "base": bool(np.array_equal(runs[0][1]["path_pose"], runs[3][1]["path_pose"])),
               "this": bool(np.array_equal(runs[1][1]["path_pose"], runs[2][1]["path_pose"])),
               "B+T' d_loi base": same_d_loi(0, 3), "B+T' d_loi this": same_d_loi(1, 2)},
           "times": times}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    rep["card"] = card
    for key, val in rep.items():
        print(f"{key}: {json.dumps(val)}")
    name = os.path.basename(os.path.normpath(args.base))
    with open(os.path.join(OUT, f"kernel_versions_{name}.json"), "w") as f:
        json.dump(rep, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
