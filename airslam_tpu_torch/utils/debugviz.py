"""Debug image writers.

Port of ``airslam_tpu/utils/debugviz.py`` (``src/debug.cc``: detections,
matches, stereo matches, tracking, line detection, point-line relations, BoW
match mosaics — debug.h:19-59). Every argument may be a tensor (on any
device) or a numpy array: images are grayscale in [0, 1]; the writers draw
with OpenCV on the host and write PNGs, the same pixels as the JAX writers
for the same inputs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _np(x):
    """A tensor (any device, bf16 widened) or array-like as numpy; None stays."""
    if x is None:
        return None
    if torch.is_tensor(x):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def _to_bgr(image: np.ndarray) -> np.ndarray:
    img8 = np.clip(image * 255.0, 0, 255).astype(np.uint8)
    return cv2.cvtColor(img8, cv2.COLOR_GRAY2BGR)


def _color(i: int):
    rng = np.random.RandomState(i * 7919 + 13)
    return tuple(int(c) for c in rng.randint(50, 255, 3))


def save_detector_result(path, image, keypoints, kp_mask=None):
    """Keypoint overlay (``SaveDetectorResult``)."""
    image, keypoints, kp_mask = _np(image), _np(keypoints), _np(kp_mask)
    img = _to_bgr(image)
    for i, (x, y) in enumerate(np.asarray(keypoints)):
        if kp_mask is not None and not kp_mask[i]:
            continue
        cv2.circle(img, (int(x), int(y)), 2, (0, 255, 0), -1)
    cv2.imwrite(path, img)


def save_line_detection_result(path, image, lines, line_mask=None,
                               keypoints=None, kp_mask=None, relation=None):
    """Line (+ optional point-on-line) overlay (``SaveLineDetectionResult``/
    ``SavePointLineRelation``)."""
    image, lines, line_mask = _np(image), _np(lines), _np(line_mask)
    keypoints, kp_mask, relation = _np(keypoints), _np(kp_mask), _np(relation)
    img = _to_bgr(image)
    lines = np.asarray(lines)
    for i, (x1, y1, x2, y2) in enumerate(lines):
        if line_mask is not None and not line_mask[i]:
            continue
        c = _color(i)
        cv2.line(img, (int(x1), int(y1)), (int(x2), int(y2)), c, 2)
        if relation is not None and keypoints is not None:
            for j in np.nonzero(relation[i])[0]:
                x, y = keypoints[j]
                cv2.circle(img, (int(x), int(y)), 3, c, -1)
    if keypoints is not None and relation is None:
        for j, (x, y) in enumerate(np.asarray(keypoints)):
            if kp_mask is not None and not kp_mask[j]:
                continue
            cv2.circle(img, (int(x), int(y)), 2, (0, 255, 0), -1)
    cv2.imwrite(path, img)


def save_matching_result(path, image0, kpts0, image1, kpts1, pairs):
    """Side-by-side match visualization (``SaveMatchingResult``/
    ``SaveStereoMatchResult``)."""
    image0, kpts0, image1, kpts1, pairs = (_np(a) for a in (image0, kpts0, image1, kpts1, pairs))
    h = max(image0.shape[0], image1.shape[0])
    w0 = image0.shape[1]
    canvas = np.zeros((h, w0 + image1.shape[1]), image0.dtype)
    canvas[: image0.shape[0], :w0] = image0
    canvas[: image1.shape[0], w0:] = image1
    img = _to_bgr(canvas)
    for k, (i0, i1) in enumerate(np.asarray(pairs)):
        x0, y0 = kpts0[i0]
        x1, y1 = kpts1[i1]
        c = _color(k)
        cv2.line(img, (int(x0), int(y0)), (int(x1) + w0, int(y1)), c, 1)
        cv2.circle(img, (int(x0), int(y0)), 2, c, -1)
        cv2.circle(img, (int(x1) + w0, int(y1)), 2, c, -1)
    cv2.imwrite(path, img)


def save_tracking_result(path, image0, frame0_kpts, image1, frame1_kpts, pairs,
                         save_root: Optional[str] = None):
    save_matching_result(path, image0, frame0_kpts, image1, frame1_kpts, pairs)


def save_stereo_match_result(path, image_left, image_right, kpts_left,
                             kpts_right, pairs):
    """Dedicated stereo-pair match overlay (``SaveStereoMatchResult``,
    debug.h:26-27): side-by-side views with match lines; stereo residual
    (y-difference) annotated by color — green for |dy| <= 2 px, red
    otherwise (rectified stereo should be horizontal)."""
    image_left, image_right, kpts_left, kpts_right, pairs = (
        _np(a) for a in (image_left, image_right, kpts_left, kpts_right, pairs))
    h = max(image_left.shape[0], image_right.shape[0])
    w0 = image_left.shape[1]
    canvas = np.zeros((h, w0 + image_right.shape[1]), image_left.dtype)
    canvas[: image_left.shape[0], :w0] = image_left
    canvas[: image_right.shape[0], w0:] = image_right
    img = _to_bgr(canvas)
    for i0, i1 in np.asarray(pairs):
        x0, y0 = kpts_left[i0]
        x1, y1 = kpts_right[i1]
        c = (0, 255, 0) if abs(float(y0) - float(y1)) <= 2.0 else (0, 0, 255)
        cv2.line(img, (int(x0), int(y0)), (int(x1) + w0, int(y1)), c, 1)
        cv2.circle(img, (int(x0), int(y0)), 2, c, -1)
        cv2.circle(img, (int(x1) + w0, int(y1)), 2, c, -1)
    cv2.imwrite(path, img)


def save_point_line_relation(path, image, lines, points, relation,
                             line_mask=None):
    """Point-on-line membership overlay (``SavePointLineRelation``,
    debug.h:36-37): each line in a distinct color, member points filled in
    the same color, non-member points as small gray dots."""
    image, lines, points, relation, line_mask = (
        _np(a) for a in (image, lines, points, relation, line_mask))
    img = _to_bgr(image)
    lines = np.asarray(lines)
    points = np.asarray(points)
    rel = np.asarray(relation, bool)
    member = rel.any(axis=0) if rel.size else np.zeros(len(points), bool)
    for j, (x, y) in enumerate(points):
        if not member[j]:
            cv2.circle(img, (int(x), int(y)), 1, (160, 160, 160), -1)
    for i, (x1, y1, x2, y2) in enumerate(lines):
        if line_mask is not None and not line_mask[i]:
            continue
        c = _color(i)
        cv2.line(img, (int(x1), int(y1)), (int(x2), int(y2)), c, 2)
        for j in np.nonzero(rel[i])[0]:
            x, y = points[j]
            cv2.circle(img, (int(x), int(y)), 3, c, -1)
    cv2.imwrite(path, img)


def save_stereo_line_match(path, image_left, image_right, lines_left,
                           lines_right, right_to_left, points_on_line_left=None,
                           kpts_left=None):
    """Stereo line-match overlay (``SaveStereoLineMatch``, debug.h:42-49):
    matched lines share a color across the two views; unmatched right lines
    are thin gray. ``right_to_left[r]`` is the left-line index or -1."""
    image_left, image_right, lines_left, lines_right, right_to_left = (
        _np(a) for a in (image_left, image_right, lines_left, lines_right, right_to_left))
    points_on_line_left, kpts_left = _np(points_on_line_left), _np(kpts_left)
    h = max(image_left.shape[0], image_right.shape[0])
    w0 = image_left.shape[1]
    canvas = np.zeros((h, w0 + image_right.shape[1]), image_left.dtype)
    canvas[: image_left.shape[0], :w0] = image_left
    canvas[: image_right.shape[0], w0:] = image_right
    img = _to_bgr(canvas)
    lines_left = np.asarray(lines_left)
    lines_right = np.asarray(lines_right)
    right_to_left = np.asarray(right_to_left)
    for li, (x1, y1, x2, y2) in enumerate(lines_left):
        c = _color(li)
        cv2.line(img, (int(x1), int(y1)), (int(x2), int(y2)), c, 2)
        if points_on_line_left is not None and kpts_left is not None:
            for j in np.nonzero(np.asarray(points_on_line_left)[li])[0]:
                x, y = kpts_left[j]
                cv2.circle(img, (int(x), int(y)), 3, c, -1)
    for ri, (x1, y1, x2, y2) in enumerate(lines_right):
        li = int(right_to_left[ri]) if ri < len(right_to_left) else -1
        c = _color(li) if li >= 0 else (140, 140, 140)
        th = 2 if li >= 0 else 1
        cv2.line(img, (int(x1) + w0, int(y1)), (int(x2) + w0, int(y2)), c, th)
    cv2.imwrite(path, img)


def save_dbow_matching_results(path, query_image, database_images, scores=None,
                               shared_words=None, tile_width: int = 320):
    """Loop-candidate mosaic (``DrawDbowMatchingResults``, debug.h:56-57):
    query on the left, ranked database frames tiled right, captioned with
    their BoW score / shared-word count."""
    query_image = _np(query_image)
    database_images = [_np(im) for im in database_images]
    scores, shared_words = _np(scores), _np(shared_words)
    def resize(im):
        hw = int(round(im.shape[0] * tile_width / im.shape[1]))
        return cv2.resize(np.clip(im * 255, 0, 255).astype(np.uint8),
                          (tile_width, hw))

    tiles = [resize(query_image)] + [resize(im) for im in database_images]
    th = max(t.shape[0] for t in tiles) + 18
    canvas = np.zeros((th, tile_width * len(tiles)), np.uint8)
    for k, t in enumerate(tiles):
        canvas[18:18 + t.shape[0], k * tile_width:(k + 1) * tile_width] = t
    img = cv2.cvtColor(canvas, cv2.COLOR_GRAY2BGR)
    cv2.putText(img, "query", (4, 13), cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                (0, 255, 255), 1)
    for k in range(len(database_images)):
        cap = f"#{k}"
        if scores is not None:
            cap += f" s={float(scores[k]):.3f}"
        if shared_words is not None:
            cap += f" w={int(shared_words[k])}"
        cv2.putText(img, cap, ((k + 1) * tile_width + 4, 13),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.4, (0, 255, 255), 1)
    cv2.imwrite(path, img)


def save_dbow_junction_matching(path, query_image, database_image,
                                junctions_q, junctions_d, match_matrix):
    """Junction structure-graph match overlay
    (``DrawDbowJunctionMatchingResults``, debug.h:59-60): side-by-side
    query/database views with a line per matched junction pair."""
    query_image, database_image, junctions_q, junctions_d, match_matrix = (
        _np(a) for a in (query_image, database_image, junctions_q, junctions_d, match_matrix))
    h = max(query_image.shape[0], database_image.shape[0])
    w0 = query_image.shape[1]
    canvas = np.zeros((h, w0 + database_image.shape[1]), query_image.dtype)
    canvas[: query_image.shape[0], :w0] = query_image
    canvas[: database_image.shape[0], w0:] = database_image
    img = _to_bgr(canvas)
    mm = np.asarray(match_matrix, bool)
    for qi, di in zip(*np.nonzero(mm)):
        x0, y0 = junctions_q[qi]
        x1, y1 = junctions_d[di]
        c = _color(int(qi))
        cv2.line(img, (int(x0), int(y0)), (int(x1) + w0, int(y1)), c, 1)
        cv2.circle(img, (int(x0), int(y0)), 3, c, 1)
        cv2.circle(img, (int(x1) + w0, int(y1)), 3, c, 1)
    cv2.imwrite(path, img)
