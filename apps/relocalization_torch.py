#!/usr/bin/env python
"""Relocalization CLI of the PyTorch/CUDA port.

Counterpart of ``apps/relocalization.py`` on ``airslam_tpu_torch``, with the
same flags plus ``--device`` and ``--use_flash``: loads
``AirSLAM_mapv1.bin`` (written by either package's refinement CLI) with its
databases and the vocabularies beside it (``point_voc.npz``,
``junction_voc.npz``), relocalizes every image of a query folder, writes a
TUM trajectory of the accepted queries and prints ``recall: s / t = r``
(demo/relocalization.cpp:63). The networks run in float32, as the JAX CLI
builds them (TF32 off), and so does the map's geometry. Runs on the GPU unless
``--device cpu`` is given; without a card it fails rather than fall back.

Usage:
  python apps/relocalization_torch.py --config_path configs/relocalization/reloc_euroc.yaml \\
      --map_root ./out --query_folder ./queries [--traj_path t.txt] [--use_flash]
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--map_root", required=True,
                    help="dir with AirSLAM_mapv1.bin, point_voc.npz and junction_voc.npz")
    ap.add_argument("--query_folder", required=True)
    ap.add_argument("--traj_path", default="reloc_trajectory.txt")
    ap.add_argument("--query_stride", type=int, default=1,
                    help="relocalize every Nth query image")
    ap.add_argument("--no_recovery", action="store_true",
                    help="no projection-guided match recovery after PnP")
    ap.add_argument("--diagnose", action="store_true",
                    help="print per-query stage diagnostics (candidate count, raw pair "
                         "counts, PnP/recovery/final inliers)")
    ap.add_argument("--oracle_retrieval", action="store_true",
                    help="perfect-recall retrieval (every keyframe is a candidate): the "
                         "recall measured is the matching ceiling")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--use_flash", action="store_true",
                    help="LightGlue's attention through the fused CUDA kernel")
    return ap.parse_args(argv)


def build(args):
    """The relocalizer the arguments name. Returns (MapUser, device)."""
    import torch

    from airslam_tpu_torch import resolve_device
    from airslam_tpu_torch.frontend.detector import FeatureDetector
    from airslam_tpu_torch.frontend.matcher import PointMatcher
    from airslam_tpu_torch.io.config import RelocalizationConfigs
    from airslam_tpu_torch.io.serialization import load_map
    from airslam_tpu_torch.loopclosure.database import Database
    from airslam_tpu_torch.loopclosure.vocabulary import Vocabulary
    from airslam_tpu_torch.pipelines.map_user import MapUser

    device = resolve_device(args.device)
    cfg = RelocalizationConfigs.load(args.config_path)
    m, dbs = load_map(os.path.join(args.map_root, "AirSLAM_mapv1.bin"), device=device,
                      dtype=torch.float32)
    print(f"loaded map: {len(m.keyframes)} keyframes on {device}")

    voc_path = os.path.join(args.map_root, "point_voc.npz")
    jvoc_path = os.path.join(args.map_root, "junction_voc.npz")
    if not os.path.exists(voc_path):
        raise SystemExit("point vocabulary missing (point_voc.npz in map_root)")
    point_db = Database(Vocabulary.load(voc_path, device=device))
    if "point" in dbs:
        point_db.load_state_dict(dbs["point"])
    junction_db = None
    if os.path.exists(jvoc_path):
        junction_db = Database(Vocabulary.load(jvoc_path, device=device))
        if "junction" in dbs:
            junction_db.load_state_dict(dbs["junction"])

    detector = FeatureDetector(dataclasses.replace(cfg.detector, dtype=torch.float32),
                               device=device)
    matcher = PointMatcher(dataclasses.replace(cfg.matcher, dtype=torch.float32,
                                               use_flash=args.use_flash), device=device)
    user = MapUser(m, detector, matcher, point_db, junction_db,
                   min_inlier_num=cfg.min_inlier_num, pose_refinement=cfg.pose_refinement,
                   projection_recovery=not args.no_recovery)
    user.oracle_retrieval = args.oracle_retrieval
    return user, device


def stamp(name):
    try:
        return float(os.path.splitext(name)[0])
    except ValueError:
        return float("inf")


def main(argv=None):
    """Returns (MapUser, per-query records [(name, ok, Twc, last_stats, ms)])."""
    args = parse_args(argv)
    import cv2
    import numpy as np
    import torch

    from airslam_tpu_torch.io.trajectory import save_tum

    # the networks in float32 throughout, as the JAX CLI computes them: no
    # TF32 in cuDNN's convolutions or cuBLAS's products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    user, device = build(args)
    names = sorted(os.listdir(args.query_folder), key=stamp)[::args.query_stride]
    success, trajectory, records = 0, [], []
    for name in names:
        img = cv2.imread(os.path.join(args.query_folder, name), cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        t0 = time.perf_counter()
        ok, Twc = user.relocalize_image(img.astype(np.float32) / 255.0)
        records.append((name, ok, Twc, user.last_stats, (time.perf_counter() - t0) * 1e3))
        if args.diagnose:
            print(f"diag {name} ok={ok} {user.last_stats}", flush=True)
        if ok:
            success += 1
            try:
                ts = float(os.path.splitext(name)[0]) * 1e-9
            except ValueError:
                ts = float(len(trajectory))
            trajectory.append((ts, Twc))
    save_tum(args.traj_path, trajectory)
    total = len(names)
    print(f"recall: {success} / {total} = {success / max(total, 1):.3f}")
    return user, records


if __name__ == "__main__":
    main()
