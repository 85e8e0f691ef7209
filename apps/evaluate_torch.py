#!/usr/bin/env python
"""Trajectory evaluation with the PyTorch/CUDA port: ATE RMSE with Sim(3)
alignment (evo_ape tum -as) and the LOST criterion (the estimated trajectory
ends more than 10 s before the ground truth).

Counterpart of ``apps/evaluate.py``, on ``airslam_tpu_torch.io.trajectory``
(host numpy; no device is used).

Usage: python apps/evaluate_torch.py --est trajectory_v0.txt --gt gt_tum.txt
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def evaluate(est, gt, align: bool = True, lost_gap: float = 10.0):
    """(ATE RMSE in m, number of associated poses) of ``est`` against ``gt``
    ([(timestamp, Twc)] each), poses associated by the nearest stamp within
    20 ms; (None, reason) when the run counts as lost."""
    import numpy as np

    from airslam_tpu_torch.io.trajectory import ate_rmse

    if not est or not gt:
        return None, "LOST (empty trajectory)"
    if gt[-1][0] - est[-1][0] > lost_gap:
        return None, f"LOST (trajectory ends {gt[-1][0] - est[-1][0]:.1f} s early)"
    gt_times = np.asarray([t for t, _ in gt])
    pairs_e, pairs_g = [], []
    for t, T in est:
        j = int(np.argmin(np.abs(gt_times - t)))
        if abs(gt_times[j] - t) < 0.02:
            pairs_e.append((t, T))
            pairs_g.append(gt[j])
    if len(pairs_e) < 3:
        return None, "LOST (no timestamp association)"
    return ate_rmse(pairs_e, pairs_g, align=align), len(pairs_e)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--est", required=True, help="estimated TUM trajectory")
    ap.add_argument("--gt", required=True, help="ground-truth TUM trajectory")
    ap.add_argument("--no_align", action="store_true")
    ap.add_argument("--lost_gap", type=float, default=10.0)
    args = ap.parse_args(argv)

    from airslam_tpu_torch.io.trajectory import load_tum

    rmse, n = evaluate(load_tum(args.est), load_tum(args.gt), align=not args.no_align,
                       lost_gap=args.lost_gap)
    if rmse is None:
        print(n)
        return 1
    print(f"ATE RMSE: {rmse:.6f} m over {n} poses")
    return 0


if __name__ == "__main__":
    sys.exit(main())
