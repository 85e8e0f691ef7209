"""Kernel R: stereo rectification remap (``csrc/remap.cu``).

Replaces the Pallas TPU kernel ``airslam_tpu/ops/remap_tiled.py:_kernel``
(``remap_planned``), which ``MapBuilder.rectify`` runs on both views of every
frame. Its plain twin is :func:`ops.gridsample.remap`. What bounds the kernel
on the H100 and what its design does about it is noted in the CUDA source.

:func:`remap` takes a CPU tensor through the plain version and a CUDA tensor
through the kernel; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from airslam_tpu_torch.ops import cuda_build
from airslam_tpu_torch.ops.gridsample import remap as remap_plain


@functools.cache
def _fn():
    fn = cuda_build.library("remap").airslam_remap
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def remap(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear remap of grayscale images over (x, y) source grids.

    ``image``: (H, W) with ``grid`` (Ho, Wo, 2), or (B, H, W) with one grid
    per image, (B, Ho, Wo, 2). Returns (…, Ho, Wo) float32. Both views of a
    stereo pair go in one launch.
    """
    if image.device.type == "cpu":
        if image.ndim == 2:
            return remap_plain(image, grid)
        return torch.stack([remap_plain(im, g) for im, g in zip(image, grid)])
    if image.device.type != "cuda" or grid.device != image.device:
        raise ValueError(f"remap: image on {image.device}, grid on "
                         f"{grid.device}; both must be on the same CUDA device")
    if image.dtype != torch.float32 or grid.dtype != torch.float32:
        raise ValueError("remap: image and grid must be float32")
    batched = image.ndim == 3
    imgs, grids = (image, grid) if batched else (image[None], grid[None])
    if (imgs.ndim != 3 or grids.ndim != 4 or grids.shape[-1] != 2
            or grids.shape[0] != imgs.shape[0]):
        raise ValueError(f"remap: bad shapes image {tuple(image.shape)}, "
                         f"grid {tuple(grid.shape)}")
    b, h, w = imgs.shape
    if not (imgs.is_contiguous() and grid.is_contiguous()):
        raise ValueError("remap: image and grid must be contiguous")
    if grid.data_ptr() % 8:
        raise ValueError("remap: grid must be 8-byte aligned (read as float2)")
    ho, wo = grids.shape[1], grids.shape[2]
    out = torch.empty((b, ho, wo), dtype=torch.float32, device=image.device)
    if out.numel() == 0:
        return out if batched else out[0]
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = _fn()(imgs.data_ptr(), grid.data_ptr(), out.data_ptr(), b, h, w,
                    ho, wo, stream)
    if err:
        raise RuntimeError(f"remap kernel launch failed: CUDA error {err}")
    remap.launches += 1
    return out if batched else out[0]


remap.launches = 0
