#!/usr/bin/env python
"""Offline map refinement CLI of the PyTorch/CUDA port.

Counterpart of ``apps/map_refinement.py`` on ``airslam_tpu_torch``, with the
same flags plus ``--device`` and ``--use_flash``: loads
``AirSLAM_mapv0.bin`` (written by either package), runs loop detection, the
pose graph (maps of at least the config's ``pose_graph_min_mappoints``),
landmark merging, the global BA and the junction vocabulary, and writes
``trajectory_v1.txt``, ``AirSLAM_mapv1.bin``, ``point_voc.npz`` and
``junction_voc.npz``. The networks run in float32 with TF32 off, as the JAX
CLI builds them, and so does the map's geometry. Runs on the GPU unless ``--device
cpu`` is given; without a card it fails rather than fall back.

Usage:
  python apps/map_refinement_torch.py --config_path configs/map_refinement/mr_euroc.yaml \\
      --map_root ./out [--voc_path voc.npz] [--use_flash]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--camera_config_path", default=None)
    ap.add_argument("--map_root", required=True, help="dir with AirSLAM_mapv0.bin")
    ap.add_argument("--voc_path", default=None,
                    help="point vocabulary .npz; trained from the map if absent")
    ap.add_argument("--model_dir", default=None,
                    help="a directory holding lightglue.npz (default: the shipped weights)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--use_flash", action="store_true",
                    help="LightGlue's attention through the fused CUDA kernel")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from airslam_tpu_torch import resolve_device
    from airslam_tpu_torch.frontend.matcher import PointMatcher
    from airslam_tpu_torch.io.config import MapRefinementConfigs
    from airslam_tpu_torch.io.serialization import load_map
    from airslam_tpu_torch.io.trajectory import save_tum
    from airslam_tpu_torch.loopclosure.vocabulary import Vocabulary, train_vocabulary
    from airslam_tpu_torch.models import weights as wio
    from airslam_tpu_torch.pipelines.map_refiner import MapRefiner

    # float32 networks compute in float32, as the JAX CLI's: no TF32 in
    # cuDNN's convolutions (on by default) or cuBLAS's products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    cfg = MapRefinementConfigs.load(args.config_path)
    m, _ = load_map(os.path.join(args.map_root, "AirSLAM_mapv0.bin"), device=device,
                    dtype=torch.float32)
    print(f"loaded map: {len(m.keyframes)} keyframes, {len(m.mappoints)} mappoints "
          f"on {device}")

    if args.voc_path and os.path.exists(args.voc_path):
        voc = Vocabulary.load(args.voc_path, device=device)
    else:
        descs = np.concatenate([
            m.keyframes[f].kp_desc[m.keyframes[f].kp_mask] for f in m.keyframe_ids])
        print(f"training point vocabulary on {len(descs)} descriptors (k=10, auto depth)")
        voc = train_vocabulary(descs, k=10, device=device)
        if args.voc_path:
            voc.save(args.voc_path)

    matcher = PointMatcher(dataclasses.replace(cfg.matcher, dtype=torch.float32,
                                               use_flash=args.use_flash), device=device)
    if args.model_dir:
        path = os.path.join(args.model_dir, "lightglue.npz")
        if os.path.exists(path):
            matcher.model.load_state_dict(wio.lightglue_from_flax(wio.load_npz(path)))

    refiner = MapRefiner(m, matcher, voc)
    n_loops = refiner.run(pose_graph_min_mappoints=cfg.pose_graph_min_mappoints)
    print(f"loop pairs: {n_loops}")
    print(f"pose graph refinement: {'ran' if refiner.pose_graph_ran else 'skipped'}")
    print(f"merged mappoints: {refiner.n_merged_mappoints}  "
          f"maplines: {refiner.n_merged_maplines}")
    print("stage ms: " + " ".join(f"{k}={v:.1f}" for k, v in refiner.stage_ms.items()))

    save_tum(os.path.join(args.map_root, "trajectory_v1.txt"), m.keyframe_trajectory())
    refiner.save(os.path.join(args.map_root, "AirSLAM_mapv1.bin"))
    # the vocabularies ride next to the map, where relocalization reads them
    voc.save(args.voc_path or os.path.join(args.map_root, "point_voc.npz"))
    if refiner.junction_database is not None:
        refiner.junction_database.voc.save(os.path.join(args.map_root, "junction_voc.npz"))
    print("saved trajectory_v1.txt, AirSLAM_mapv1.bin and vocabularies")
    return refiner


if __name__ == "__main__":
    main()
