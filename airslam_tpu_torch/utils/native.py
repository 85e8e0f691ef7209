"""ctypes bindings of the port's native host kernels (``csrc/slam_kernels.cpp``).

Port of ``airslam_tpu/utils/native.py``. The port keeps its own copy of the
C++ source and builds it with ``g++`` at first use into
``airslam_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
carries a hash of the source and the flags; it never reads or writes the JAX
package's ``native/libslam_kernels.so``. A failed build raises: there is no
fallback. The ``*_plain`` functions are the numpy versions of the same four
loops; the tests hold the native ones against them.

These are host loops by nature (inverted-file walks, union-find, radius
scans over one frame's keypoints): they stay on the CPU whatever device the
map uses.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.normpath(os.path.join(_HERE, "..", "csrc", "slam_kernels.cpp"))
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "_build"))
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None


def _target() -> str:
    with open(SRC, "rb") as f:
        h = hashlib.sha1(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libslam_kernels-{h.hexdigest()[:12]}.so")


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed. Raises if ``g++`` fails."""
    global _lib
    if _lib is not None:
        return _lib
    so = _target()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, SRC], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for csrc/slam_kernels.cpp:\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent builder sees all or nothing
    lib = ctypes.CDLL(so)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    lib.invfile_query.argtypes = [i32p, ctypes.c_int64, i64p, i32p,
                                  ctypes.c_int64, i32p, ctypes.c_int64]
    lib.invfile_query.restype = None
    lib.union_find.argtypes = [i64p, i64p, ctypes.c_int64, i64p, ctypes.c_int64]
    lib.union_find.restype = None
    lib.radius_search.argtypes = [f32p, u8p, ctypes.c_int64, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_float, i32p]
    lib.radius_search.restype = ctypes.c_int64
    lib.descriptor_distances.argtypes = [f32p, f32p, ctypes.c_int64, f32p]
    lib.descriptor_distances.restype = None
    _lib = lib
    return lib


def invfile_query(query_words: np.ndarray, csr_offsets: np.ndarray,
                  csr_frames: np.ndarray, n_frames: int) -> np.ndarray:
    """Shared-word counts per dense frame slot (n_frames,) int32."""
    lib = get_lib()
    qw = np.ascontiguousarray(query_words, np.int32)
    offsets = np.ascontiguousarray(csr_offsets, np.int64)
    frames = np.ascontiguousarray(csr_frames, np.int32)
    if len(offsets) < 1 or (len(frames) and int(offsets[-1]) > len(frames)):
        raise ValueError("invfile_query: offsets do not index the frame list")
    counts = np.zeros(n_frames, np.int32)
    lib.invfile_query(qw, len(qw), offsets, frames, len(offsets) - 1, counts, n_frames)
    return counts


def invfile_query_plain(query_words, csr_offsets, csr_frames, n_frames: int) -> np.ndarray:
    counts = np.zeros(n_frames, np.int32)
    n_words = len(csr_offsets) - 1
    for w in np.asarray(query_words, np.int32):
        if 0 <= w < n_words:
            fr = np.asarray(csr_frames)[csr_offsets[w]: csr_offsets[w + 1]]
            np.add.at(counts, fr[(fr >= 0) & (fr < n_frames)], 1)
    return counts


def union_find(pairs: np.ndarray, n_ids: int) -> np.ndarray:
    """pairs: (N, 2) int64 → roots (n_ids,) with smallest-id representatives."""
    lib = get_lib()
    pairs = np.ascontiguousarray(pairs, np.int64).reshape(-1, 2)
    roots = np.zeros(n_ids, np.int64)
    lib.union_find(np.ascontiguousarray(pairs[:, 0]), np.ascontiguousarray(pairs[:, 1]),
                   len(pairs), roots, n_ids)
    return roots


def union_find_plain(pairs: np.ndarray, n_ids: int) -> np.ndarray:
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    parent = np.arange(n_ids, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in pairs:
        if a < 0 or b < 0 or a >= n_ids or b >= n_ids:
            continue
        ra, rb = find(a), find(b)
        if ra != rb:
            if ra < rb:
                parent[rb] = ra
            else:
                parent[ra] = rb
    return np.asarray([find(i) for i in range(n_ids)], np.int64)


def radius_search(kpts_xy: np.ndarray, mask: np.ndarray, x: float, y: float,
                  radius: float) -> np.ndarray:
    """Indices of the masked keypoints within ``radius`` of (x, y)."""
    lib = get_lib()
    kx = np.ascontiguousarray(kpts_xy, np.float32).reshape(-1, 2)
    mk = np.ascontiguousarray(mask, np.uint8)
    if len(mk) != len(kx):
        raise ValueError("radius_search: one mask entry per keypoint")
    out = np.zeros(len(kx), np.int32)
    m = lib.radius_search(kx, mk, len(kx), x, y, radius, out)
    return out[:m]


def radius_search_plain(kpts_xy, mask, x: float, y: float, radius: float) -> np.ndarray:
    kx = np.asarray(kpts_xy, np.float32)
    d = kx - np.asarray([x, y], np.float32)
    r2 = np.float32(radius) * np.float32(radius)
    sel = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] <= r2) & np.asarray(mask).astype(bool)
    return np.nonzero(sel)[0].astype(np.int32)


def descriptor_distances(query: np.ndarray, descs: np.ndarray) -> np.ndarray:
    """1 − q·dᵢ over 256-d rows (DescriptorDistance, utils.cc:15-17)."""
    lib = get_lib()
    q = np.ascontiguousarray(query, np.float32)
    d = np.ascontiguousarray(descs, np.float32)
    if q.shape != (256,) or d.ndim != 2 or d.shape[1] != 256:
        raise ValueError(f"descriptor_distances: 256-d rows, got {q.shape} and {d.shape}")
    out = np.zeros(len(d), np.float32)
    lib.descriptor_distances(q, d, len(d), out)
    return out


def descriptor_distances_plain(query, descs) -> np.ndarray:
    return (1.0 - np.asarray(descs, np.float32) @ np.asarray(query, np.float32)).astype(
        np.float32)
