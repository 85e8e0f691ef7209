"""Kernels B and T: LOI bilinear point sampling (``csrc/bilerp.cu``).

Replace the Pallas TPU kernels ``airslam_tpu/ops/bilerp_pallas.py:_kernel``
(:func:`bilerp_points`, row-major output) and ``:_kernel_t``
(:func:`bilerp_points_t`, channel-major output) that the stage-1 LOI head
runs on its 128-channel LOI map and its 4-channel thin/aux maps. What bounds
them on the H100 and what the design does about it is noted in the CUDA
source.

Both follow the stage-1 ONNX corner arithmetic: ``x0 = clip(floor x, 0,
W-1)``, ``x1 = clip(x0+1, 0, W-1)``, UNclamped weights (zero total weight at
the far border; the two taps add when ``x0 == x1``). For bf16 maps the row
(y) weights are rounded to bf16 and everything accumulates in f32, as the
Pallas kernels do (``bilerp_pallas.py:68-70,147-150``) — which differs from
the JAX CPU einsum branch (``plnet.py:488``), which rounds its rows to bf16.
:func:`bilerp_plain` is the plain PyTorch version with the kernels'
semantics.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from airslam_tpu_torch.ops import cuda_build


def _corners(n: torch.Tensor, size: int):
    """Clipped integer taps and their weights along one axis."""
    n0 = torch.clamp(torch.floor(n), 0.0, size - 1)
    n1 = torch.clamp(n0 + 1.0, 0.0, size - 1)
    w0 = n1 - n
    w1 = n - n0
    same = n0 == n1
    return (n0.to(torch.int64), n1.to(torch.int64),
            torch.where(same, w0 + w1, w0), torch.where(same, torch.zeros_like(w1), w1))


def bilerp_plain(fmap: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sampling of ``fmap`` (H, W, C) at ``x``/``y`` (any
    shape). Returns (..., C) float32."""
    h, w, c = fmap.shape
    shape = x.shape
    x = x.reshape(-1).float()
    y = y.reshape(-1).float()
    x0, x1, wx0, wx1 = _corners(x, w)
    y0, y1, wy0, wy1 = _corners(y, h)
    if fmap.dtype == torch.bfloat16:
        wy0 = wy0.to(torch.bfloat16).float()
        wy1 = wy1.to(torch.bfloat16).float()
    f = fmap.float()
    a = wy0[:, None] * f[y0, x0] + wy1[:, None] * f[y1, x0]
    b = wy0[:, None] * f[y0, x1] + wy1[:, None] * f[y1, x1]
    out = a * wx0[:, None] + b * wx1[:, None]
    return out.reshape(shape + (c,))


@functools.cache
def _fn():
    fn = cuda_build.library("bilerp").airslam_bilerp
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(fmap, x, y, wrapper) -> torch.Tensor:
    """Check the operands, launch kernel B or T, and count the launch on
    ``wrapper``."""
    name = wrapper.__name__
    channel_major = wrapper is bilerp_points_t
    dev = fmap.device
    if dev.type != "cuda" or x.device != dev or y.device != dev:
        raise ValueError(f"{name}: map on {dev}, points on {x.device}/{y.device}; "
                         "all must be on the same CUDA device")
    if fmap.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: map dtype {fmap.dtype} (float32 or bfloat16)")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(f"{name}: points must be float32")
    if fmap.ndim != 3 or x.shape != y.shape:
        raise ValueError(f"{name}: map {tuple(fmap.shape)} must be (H, W, C), "
                         f"x {tuple(x.shape)} and y {tuple(y.shape)} alike")
    if not (fmap.is_contiguous() and x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{name}: map and points must be contiguous")
    h, w, c = fmap.shape
    n = x.numel()
    shape = (c,) + tuple(x.shape) if channel_major else tuple(x.shape) + (c,)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(fmap.data_ptr(), int(fmap.dtype == torch.bfloat16),
                    x.data_ptr(), y.data_ptr(), out.data_ptr(), n, h, w, c,
                    int(channel_major), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def bilerp_points(fmap: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kernel B: sample ``fmap`` (H, W, C) at ``x``/``y`` (any shape).
    Returns (..., C) float32."""
    if fmap.device.type == "cpu":
        return bilerp_plain(fmap, x, y)
    return _launch(fmap, x, y, bilerp_points)


def bilerp_points_t(fmap: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kernel T: same sampling, CHANNEL-MAJOR (C, ...) float32 output — the
    layout the stage-1 head's thin/aux flatten wants."""
    if fmap.device.type == "cpu":
        return torch.movedim(bilerp_plain(fmap, x, y), -1, 0)
    return _launch(fmap, x, y, bilerp_points_t)


bilerp_points.launches = 0
bilerp_points_t.launches = 0
