"""LOI bilinear point sampling (``csrc/bilerp.cu``): kernels B and T, and
``loi_features``, their redesign for the H100.

Kernels B (:func:`bilerp_points`, row-major output) and T
(:func:`bilerp_points_t`, channel-major output) replace the Pallas TPU
kernels ``airslam_tpu/ops/bilerp_pallas.py:_kernel`` and ``:_kernel_t``
that the stage-1 LOI head runs on its 128-channel LOI map and its 4-channel
thin/aux maps. :func:`loi_features` computes what the head asked of them —
the endpoint features at the clamped junctions, the 30 interior samples per
line of both 4-channel maps, and their concatenation into the MLP's input
row — for every view of a frame in one launch; the head runs it, and B and T
stay as entry points. What bounds them on the H100 and what the design does
about it is noted in the CUDA source.

All three follow the stage-1 ONNX corner arithmetic: ``x0 = clip(floor x,
0, W-1)``, ``x1 = clip(x0+1, 0, W-1)``, UNclamped weights (zero total weight
at the far border; the two taps add when ``x0 == x1``). For bf16 maps the
row (y) weights are rounded to bf16 and everything accumulates in f32, as
the Pallas kernels do (``bilerp_pallas.py:68-70,147-150``) — which differs
from the JAX CPU einsum branch (``plnet.py:488``), which rounds its rows to
bf16. :func:`bilerp_plain` and :func:`loi_features_plain` are the plain
PyTorch versions with the kernels' semantics.

Training differentiates the head's sampling: :func:`loi_features_backward`
(kernel B+T′) is ``loi_features``' gradient with respect to the three maps
and the two interior ramps, for float32 maps, and the autograd function
behind ``loi_features`` on the card. The JAX trainer has no Pallas kernel
there (it differentiates the f32 einsum sampler with XLA);
:func:`loi_features_backward_plain` is autograd through the plain version.

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


LOI_C, INTERIOR_C = 128, 4  # the channel counts loi_features is built for
MAX_INTERIOR = 32  # interior points per line: one lane each


def loi_features_plain(loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines,
                       t_fwd, t_rev, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`loi_features`: the stage-1 head's
    sampling, view by view — the LOI map at each junction − 0.5 gathered by
    the clamped ``pair_idx``, the thin map along ``lines`` and the aux map
    along ``prop_lines`` at ``s0·t_fwd + s2·t_rev − 0.5`` (likewise y),
    flattened channel-major — concatenated and cast to ``out_dtype`` (the
    maps' dtype when None). Shapes as :func:`loi_features`."""
    rows = []
    for v in range(loi.shape[0]):
        f_junc = bilerp_plain(loi[v], junc_xy[v, :, 0] - 0.5, junc_xy[v, :, 1] - 0.5)
        idx = pair_idx[v].clamp(0, junc_xy.shape[1] - 1)
        parts = [f_junc[idx[:, 0]], f_junc[idx[:, 1]]]
        for fmap, seg in ((loi_thin[v], lines[v]), (loi_aux[v], prop_lines[v])):
            x = seg[:, 0:1] * t_fwd[None, :] + seg[:, 2:3] * t_rev[None, :] - 0.5
            y = seg[:, 1:2] * t_fwd[None, :] + seg[:, 3:4] * t_rev[None, :] - 0.5
            # (L, T, C) -> channel-major (L, C·T)
            parts.append(bilerp_plain(fmap, x, y).transpose(1, 2).reshape(seg.shape[0], -1))
        rows.append(torch.cat(parts, dim=-1))
    return torch.stack(rows).to(out_dtype or loi.dtype)


@functools.cache
def _lib():
    lib = cuda_build.library("bilerp")
    lib.airslam_bilerp.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.airslam_loi_features.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                                         + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                                         + [ctypes.c_void_p])
    lib.airslam_loi_features_backward.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                                                  + [ctypes.c_void_p])
    lib.airslam_loi_features_attributes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.airslam_bilerp, lib.airslam_loi_features, lib.airslam_loi_features_backward,
               lib.airslam_loi_features_attributes):
        fn.restype = ctypes.c_int
    return lib


def kernel_attributes(map_dtype, out_dtype) -> dict:
    """What the compiler gave the ``loi_features`` instantiation for these
    types (``cudaFuncGetAttributes``)."""
    out = (ctypes.c_int * 4)()
    err = _lib().airslam_loi_features_attributes(int(map_dtype == torch.bfloat16),
                                                 int(out_dtype == torch.bfloat16), out)
    if err:
        raise RuntimeError(f"loi_features attributes: CUDA error {err}")
    return dict(zip(("registers", "static_smem", "local_bytes", "threads"), out))


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
        err = _lib().airslam_bilerp(fmap.data_ptr(), int(fmap.dtype == torch.bfloat16),
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


def _check_loi(name, loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines, t_fwd,
               t_rev):
    """Check ``loi_features``' operands (device, types, shapes, contiguity,
    the maps on 16 bytes); raise ``ValueError`` on what the kernels do not
    take. Returns (V, H, W, J, L, T)."""
    dev = loi.device
    operands = dict(loi=loi, loi_thin=loi_thin, loi_aux=loi_aux, junc_xy=junc_xy,
                    pair_idx=pair_idx, lines=lines, prop_lines=prop_lines, t_fwd=t_fwd,
                    t_rev=t_rev)
    if dev.type != "cuda" or any(t.device != dev for t in operands.values()):
        raise ValueError(f"{name}: operands on {sorted({str(t.device) for t in operands.values()})}; "
                         "all must be on the same CUDA device")
    if loi.dtype not in (torch.float32, torch.bfloat16) or not (
            loi_thin.dtype == loi_aux.dtype == loi.dtype):
        raise ValueError(f"{name}: maps {loi.dtype}/{loi_thin.dtype}/{loi_aux.dtype} "
                         "(all float32 or all bfloat16)")
    for k in ("junc_xy", "lines", "prop_lines", "t_fwd", "t_rev"):
        if operands[k].dtype != torch.float32:
            raise ValueError(f"{name}: {k} must be float32, not {operands[k].dtype}")
    if pair_idx.dtype != torch.int64:
        raise ValueError(f"{name}: pair_idx must be int64, not {pair_idx.dtype}")
    if loi.ndim != 4 or loi.shape[-1] != LOI_C:
        raise ValueError(f"{name}: loi {tuple(loi.shape)} must be (V, H, W, {LOI_C})")
    v, h, w, _ = loi.shape
    n_junc = junc_xy.shape[1] if junc_xy.ndim == 3 else -1
    n_lines = lines.shape[1] if lines.ndim == 3 else -1
    nt = t_fwd.shape[0] if t_fwd.ndim == 1 else -1
    want = dict(loi_thin=(v, h, w, INTERIOR_C), loi_aux=(v, h, w, INTERIOR_C),
                junc_xy=(v, n_junc, 2), pair_idx=(v, n_lines, 2), lines=(v, n_lines, 4),
                prop_lines=(v, n_lines, 4), t_fwd=(nt,), t_rev=(nt,))
    bad = [f"{k} {tuple(operands[k].shape)} (want {s})" for k, s in want.items()
           if tuple(operands[k].shape) != s]
    if bad:
        raise ValueError(f"{name}: " + ", ".join(bad))
    if not 1 <= nt <= MAX_INTERIOR:
        raise ValueError(f"{name}: {nt} interior points (1-{MAX_INTERIOR})")
    if n_junc == 0 and n_lines:
        raise ValueError(f"{name}: lines but no junctions")
    if not all(t.is_contiguous() for t in operands.values()):
        raise ValueError(f"{name}: every operand must be contiguous")
    if any(t.data_ptr() % 16 for t in (loi, loi_thin, loi_aux)):
        raise ValueError(f"{name}: the maps must start on 16 bytes")
    return v, h, w, n_junc, n_lines, nt


def _launch_loi(loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines, t_fwd, t_rev,
                out_dtype, warps: int = 0) -> torch.Tensor:
    """Check the operands, launch ``loi_features`` once, and count the
    launch. ``warps``: lines per block, 1-8 (0: the kernel's default)."""
    name = "loi_features"
    v, h, w, n_junc, n_lines, nt = _check_loi(name, loi, loi_thin, loi_aux, junc_xy, pair_idx,
                                              lines, prop_lines, t_fwd, t_rev)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: output dtype {out_dtype} (float32 or bfloat16)")
    if warps not in range(9):
        raise ValueError(f"{name}: warps={warps} (0-8)")
    dev = loi.device
    out = torch.empty((v, n_lines, 2 * LOI_C + 2 * INTERIOR_C * nt), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().airslam_loi_features(
            loi.data_ptr(), loi_thin.data_ptr(), loi_aux.data_ptr(),
            int(loi.dtype == torch.bfloat16), junc_xy.data_ptr(), pair_idx.data_ptr(),
            lines.data_ptr(), prop_lines.data_ptr(), t_fwd.data_ptr(), t_rev.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), v, n_lines, n_junc, h, w, nt,
            warps, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    loi_features.launches += 1
    return out


def loi_features_backward_plain(grad, loi, loi_thin, loi_aux, junc_xy, pair_idx, lines,
                                prop_lines, t_fwd, t_rev):
    """Plain PyTorch version of :func:`loi_features_backward`: autograd
    through :func:`loi_features_plain` (its forward included). Returns
    (d_loi, d_thin, d_aux, d_t_fwd, d_t_rev), float32."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_(True)
                  for t in (loi, loi_thin, loi_aux, t_fwd, t_rev)]
        out = loi_features_plain(leaves[0], leaves[1], leaves[2], junc_xy, pair_idx, lines,
                                 prop_lines, leaves[3], leaves[4], out_dtype=torch.float32)
        grads = torch.autograd.grad(out, leaves, grad_outputs=grad.float(), allow_unused=True)
    return tuple(torch.zeros_like(t) if d is None else d for t, d in zip(leaves, grads))


def loi_features_backward(grad, loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines,
                          t_fwd, t_rev):
    """Kernel B+T′: the gradient of :func:`loi_features` with respect to the
    three maps and the two interior ramps, for float32 maps (training).
    ``grad`` (V, L, 256 + 8·T) float32; the other operands as
    :func:`loi_features`. Junctions, lines and proposals take no gradient.
    Returns (d_loi, d_thin, d_aux, d_t_fwd, d_t_rev). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if loi.device.type == "cpu":
        return loi_features_backward_plain(grad, loi, loi_thin, loi_aux, junc_xy, pair_idx,
                                           lines, prop_lines, t_fwd, t_rev)
    name = "loi_features_backward"
    v, h, w, n_junc, n_lines, nt = _check_loi(name, loi, loi_thin, loi_aux, junc_xy, pair_idx,
                                              lines, prop_lines, t_fwd, t_rev)
    if loi.dtype != torch.float32:
        raise ValueError(f"{name}: maps {loi.dtype}; the backward takes float32 maps only")
    shape = (v, n_lines, 2 * LOI_C + 2 * INTERIOR_C * nt)
    if (grad.dtype != torch.float32 or tuple(grad.shape) != shape or grad.device != loi.device
            or not grad.is_contiguous() or grad.data_ptr() % 16):
        raise ValueError(f"{name}: grad {tuple(grad.shape)} {grad.dtype} on {grad.device} must "
                         f"be a contiguous float32 {shape} on {loi.device}, on 16 bytes")
    dev = loi.device
    out = tuple(torch.zeros_like(t) for t in (loi, loi_thin, loi_aux, t_fwd, t_rev))
    if grad.numel():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib().airslam_loi_features_backward(
                grad.data_ptr(), loi_thin.data_ptr(), loi_aux.data_ptr(), junc_xy.data_ptr(),
                pair_idx.data_ptr(), lines.data_ptr(), prop_lines.data_ptr(), t_fwd.data_ptr(),
                t_rev.data_ptr(), *(t.data_ptr() for t in out), v, n_lines, n_junc, h, w, nt,
                stream)
        if err:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
        loi_features_backward.launches += 1
    return out


class _LoiFeatures(torch.autograd.Function):
    """``loi_features`` on the card with kernel B+T′ as its backward."""

    @staticmethod
    def forward(ctx, loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines, t_fwd, t_rev,
                out_dtype):
        ctx.save_for_backward(loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines, t_fwd,
                              t_rev)
        return _launch_loi(loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines, t_fwd,
                           t_rev, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[:3] + ctx.needs_input_grad[7:9]
        d = loi_features_backward(grad.float().contiguous(), *ctx.saved_tensors)
        d_loi, d_thin, d_aux, d_tf, d_tr = (g if n else None for g, n in zip(d, need))
        return d_loi, d_thin, d_aux, None, None, None, None, d_tf, d_tr, None


def loi_features(loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines, t_fwd, t_rev,
                 out_dtype=None) -> torch.Tensor:
    """The stage-1 LOI head's sampling for V views in one launch.

    ``loi`` (V, H, W, 128), ``loi_thin``/``loi_aux`` (V, H, W, 4) HWC in one
    dtype; ``junc_xy`` (V, J, 2) the junctions; ``pair_idx`` (V, L, 2) each
    line's endpoint junctions (clamped to [0, J−1]); ``lines``/``prop_lines``
    (V, L, 4) (x1, y1, x2, y2) in 128-grid coords; ``t_fwd``/``t_rev`` (T,)
    the interior ramps. Returns the MLP's input rows (V, L, 256 + 8·T) in
    ``out_dtype`` (the maps' dtype when None): endpoint 1, endpoint 2, then
    the thin and the aux samples, each flattened channel-major. On the card,
    when a map or a ramp requires a gradient, the call is differentiable
    through kernel B+T′ (:func:`loi_features_backward`)."""
    out_dtype = out_dtype or loi.dtype
    if loi.device.type == "cpu":
        return loi_features_plain(loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines,
                                  t_fwd, t_rev, out_dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (loi, loi_thin, loi_aux, t_fwd, t_rev)):
        return _LoiFeatures.apply(loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines,
                                  t_fwd, t_rev, out_dtype)
    return _launch_loi(loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines, t_fwd,
                       t_rev, out_dtype)


bilerp_points.launches = 0
bilerp_points_t.launches = 0
loi_features.launches = 0
loi_features_backward.launches = 0
