#!/usr/bin/env python
"""Feature detection demo of the PyTorch/CUDA port: run the detector over an
image folder and write annotated line/keypoint images.

Counterpart of ``apps/test_feature.py`` (``demo/test_feature.cpp``) on
``airslam_tpu_torch``, with the same flags and output: with
``--camera_config_path`` each image is rectified with the camera's left map
(kernel R on the card); the detector runs PLNet's keypoints (no SuperPoint),
the stage-1 head (kernel ``loi_features`` on the card) and the junctions;
each image gets its lines, keypoints and point-on-line relation drawn
(``utils/debugviz.save_line_detection_result``) and one printed line. The
networks run in float32 with TF32 off, as the JAX CLI's; ``--dtype bf16``
opts into bfloat16. Runs on the GPU unless ``--device cpu`` is given;
without a card it fails rather than fall back.

Usage:
  python apps/test_feature_torch.py --image_dir IMAGES --save_dir OUT \\
      [--camera_config_path configs/camera/euroc.yaml] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    from airslam_tpu_torch.utils import device as device_util

    ap = argparse.ArgumentParser()
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--save_dir", required=True)
    ap.add_argument("--camera_config_path", default=None)
    ap.add_argument("--model_dir", default=None, help="directory with plnet.npz")
    ap.add_argument("--max_keypoints", type=int, default=400)
    ap.add_argument("--keypoint_threshold", type=float, default=0.004)
    ap.add_argument("--line_threshold", type=float, default=0.5)
    ap.add_argument("--line_length_threshold", type=float, default=50.0)
    ap.add_argument("--dtype", default="f32", choices=("f32", "bf16"),
                    help="the networks' type (f32, as the JAX CLI; bf16 opt-in)")
    device_util.add_arg(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Runs the CLI. Returns [(file name, FrameFeatures of its one view as
    numpy arrays)] in the order the images were processed."""
    args = parse_args(argv)

    import cv2
    import numpy as np
    import torch

    from airslam_tpu_torch.core.camera import Camera
    from airslam_tpu_torch.frontend.detector import DetectorConfig, FeatureDetector
    from airslam_tpu_torch.frontend.lines import point_line_relation
    from airslam_tpu_torch.models.weights import load_model_dir
    from airslam_tpu_torch.ops.remap import remap
    from airslam_tpu_torch.utils import device as device_util
    from airslam_tpu_torch.utils.debugviz import save_line_detection_result

    device = device_util.select(args.device)
    # float32 networks compute in float32, as the JAX CLI's
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DetectorConfig(
        max_keypoints=args.max_keypoints,
        keypoint_threshold=args.keypoint_threshold,
        line_threshold=args.line_threshold,
        line_length_threshold=args.line_length_threshold,
        use_superpoint=False,
        dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
    )
    det_params, _ = load_model_dir(args.model_dir)
    detector = FeatureDetector(cfg, device=device, params=det_params)

    camera = Camera(args.camera_config_path) if args.camera_config_path else None
    ml = camera.rectify_maps(device)[0] if camera else None

    os.makedirs(args.save_dir, exist_ok=True)
    results = []
    for name in sorted(os.listdir(args.image_dir)):
        img = cv2.imread(os.path.join(args.image_dir, name), cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        imgf = torch.as_tensor(img.astype(np.float32) / np.float32(255.0), device=device)
        if ml is not None:
            imgf = remap(imgf, ml)
        feats = detector.detect(imgf[None], detect_junctions=True)
        f = type(feats)(*(t[0].float().cpu().numpy() if t.dtype == torch.bfloat16
                          else t[0].cpu().numpy() for t in feats))
        rel, _ = point_line_relation(*(torch.as_tensor(a) for a in (
            f.lines, f.line_mask, f.keypoints, f.kp_mask)))
        save_line_detection_result(
            os.path.join(args.save_dir, name), imgf, f.lines, f.line_mask,
            f.keypoints, f.kp_mask, rel,
        )
        print(f"{name}: {int(f.kp_mask.sum())} keypoints, {int(f.line_mask.sum())} lines")
        results.append((name, f))
    return results


if __name__ == "__main__":
    main()
