#!/usr/bin/env python
"""Batch sequence runner of the PyTorch/CUDA port: run one stage over every
sequence under a dataset root and collect per-sequence outputs (plus the ATE
when ground truth is present as <seq>/mav0/state_groundtruth_estimate0/data.csv).

Counterpart of ``apps/run_batch.py`` (the reference's
``scripts/run_batch_*.py``) on the port's CLIs:
``visual_odometry_torch.py``, ``map_refinement_torch.py``,
``relocalization_torch.py`` and ``evaluate_torch.py``, each a subprocess.
``--device`` is passed on to each of them: ``auto`` (the default) means the
card, ``cpu`` the plain PyTorch path.

Usage:
  python apps/run_batch_torch.py --stage vo --config_path configs/visual_odometry/vo_euroc.yaml \\
      --camera_config_path configs/camera/euroc.yaml --dataset_root DATA --out_root OUT
"""

import argparse
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def parse_args(argv=None):
    from airslam_tpu_torch.utils import device as device_util

    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=["vo", "refine", "reloc"], default="vo")
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--camera_config_path", default=None)
    ap.add_argument("--dataset_root", required=True,
                    help="directory of sequences (each with mav0/ inside, EuRoC style)")
    ap.add_argument("--out_root", required=True)
    ap.add_argument("--max_frames", type=int, default=0)
    device_util.add_arg(ap)
    return ap.parse_args(argv)


def stage_command(args, dataroot: str, out_dir: str, device: str) -> list:
    """The command line of ``args.stage`` on one sequence."""
    if args.stage == "vo":
        cmd = [sys.executable, os.path.join(_REPO, "apps", "visual_odometry_torch.py"),
               "--config_path", args.config_path,
               "--camera_config_path", args.camera_config_path,
               "--dataroot", dataroot, "--saving_dir", out_dir,
               "--device", device]
        if args.max_frames:
            cmd += ["--max_frames", str(args.max_frames)]
    elif args.stage == "refine":
        cmd = [sys.executable, os.path.join(_REPO, "apps", "map_refinement_torch.py"),
               "--config_path", args.config_path, "--map_root", out_dir,
               "--device", device]
    else:
        cmd = [sys.executable, os.path.join(_REPO, "apps", "relocalization_torch.py"),
               "--config_path", args.config_path, "--map_root", out_dir,
               "--query_folder", os.path.join(dataroot, "cam0", "data"),
               "--traj_path", os.path.join(out_dir, "reloc_trajectory.txt"),
               "--device", device]
    return cmd


def main(argv=None):
    """Runs the stage over every sequence. Returns {sequence: "ok" or
    "exit N"}."""
    args = parse_args(argv)
    from airslam_tpu_torch.utils import device as device_util

    device = device_util.select(args.device).type  # raises without a card unless cpu
    if args.stage == "vo" and not args.camera_config_path:
        raise SystemExit("--stage vo needs --camera_config_path")

    seqs = sorted(
        d for d in os.listdir(args.dataset_root)
        if os.path.isdir(os.path.join(args.dataset_root, d))
    )
    print(f"{len(seqs)} sequences under {args.dataset_root}")
    results = {}
    for seq in seqs:
        seq_dir = os.path.join(args.dataset_root, seq)
        mav0 = os.path.join(seq_dir, "mav0")
        dataroot = mav0 if os.path.isdir(mav0) else seq_dir
        out_dir = os.path.join(args.out_root, seq)
        os.makedirs(out_dir, exist_ok=True)

        cmd = stage_command(args, dataroot, out_dir, device)
        print(f"[{seq}] {' '.join(cmd)}", flush=True)
        rc = subprocess.call(cmd)
        results[seq] = "ok" if rc == 0 else f"exit {rc}"

        # optional ATE against EuRoC ground truth
        gt_csv = os.path.join(dataroot, "state_groundtruth_estimate0", "data.csv")
        traj = os.path.join(out_dir, "trajectory_v0.txt" if args.stage == "vo"
                            else "trajectory_v1.txt")
        if args.stage in ("vo", "refine") and os.path.exists(gt_csv) and os.path.exists(traj):
            gt_tum = os.path.join(out_dir, "gt_tum.txt")
            _euroc_gt_to_tum(gt_csv, gt_tum)
            subprocess.call([sys.executable, os.path.join(_REPO, "apps", "evaluate_torch.py"),
                             "--est", traj, "--gt", gt_tum])

    print("\nsummary:")
    for seq, status in results.items():
        print(f"  {seq}: {status}")
    return results


def _euroc_gt_to_tum(csv_path: str, out_path: str):
    """EuRoC ground-truth CSV (ns, p, q_wxyz, …) → TUM (s, p, q_xyzw)."""
    with open(csv_path) as f, open(out_path, "w") as out:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split(",")
            ts = float(v[0]) * 1e-9
            px, py, pz = v[1:4]
            qw, qx, qy, qz = v[4:8]
            out.write(f"{ts:.9f} {px} {py} {pz} {qx} {qy} {qz} {qw}\n")


if __name__ == "__main__":
    main()
