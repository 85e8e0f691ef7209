"""Masked multi-head attention for the feature matchers.

Port of ``airslam_tpu/ops/attention.py``:

- :func:`mha`: plain tensor ops, what the default configuration runs
  (``MatcherConfig.use_flash=False``).
- :func:`flash_mha`: kernel F (``csrc/attention.cu``), which replaces the
  Pallas TPU kernel ``_flash_kernel`` behind the JAX ``flash_mha``; LightGlue
  calls it with ``use_flash=True``. :func:`flash_mha_plain` is its plain
  PyTorch version with the kernel's casts and its order of division. What
  bounds the kernel on the H100 and what its design does about it is noted
  in the CUDA source.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. All three take any number of leading batch dimensions. The kernel
reads its operands in place where every row starts on 16 bytes (LightGlue's
views do); an operand that does not is copied once, and
``flash_mha.copies`` counts it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from airslam_tpu_torch.ops import cuda_build

_NEG = -1e9
HEAD_DIMS = (32, 64)  # the head sizes csrc/attention.cu is instantiated for


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        kv_mask: torch.Tensor = None) -> torch.Tensor:
    """q: (…, H, Nq, D), k/v: (…, H, Nk, D), kv_mask: (…, Nk) bool.
    Returns (…, H, Nq, D)."""
    d = q.shape[-1]
    logits = torch.einsum("...hqd,...hkd->...hqk", q, k) / math.sqrt(d)
    if kv_mask is not None:
        logits = torch.where(kv_mask[..., None, None, :], logits,
                             torch.full_like(logits, _NEG))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("...hqk,...hkd->...hqd", w, v)


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor = None) -> torch.Tensor:
    """Kernel F's arithmetic in plain tensor ops (``attention.py:49-61`` of
    the JAX package): ``k`` in ``q``'s type, logits in f32 divided by √D,
    masked keys REPLACED by −1e9 (a row with every key masked gives the mean
    of ``v``), ``p = exp(logits − max)`` rounded to ``v``'s type before the
    second product, the division by the unrounded row sum last, output in
    ``q``'s type. Shapes as :func:`mha`."""
    acc = torch.promote_types(q.dtype, torch.float32)
    d = q.shape[-1]
    k = k.to(q.dtype)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) / math.sqrt(d)
    if kv_mask is not None:
        logits = torch.where(kv_mask[..., None, None, :], logits,
                             torch.full_like(logits, _NEG))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).to(acc), v.to(acc)) / denom
    return out.to(q.dtype)


@functools.cache
def _fn():
    fn = cuda_build.library("attention").airslam_flash_mha
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 10
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def kernel_attributes(q_dtype, v_dtype, d: int, q_warps: int = 0) -> dict:
    """What the compiler gave the kernel instantiation a call with these
    types, head size and query tile runs (``cudaFuncGetAttributes``)."""
    fn = cuda_build.library("attention").airslam_flash_mha_attributes
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    err = fn(int(q_dtype == torch.bfloat16), int(v_dtype == torch.bfloat16), d, q_warps, out)
    if err:
        raise RuntimeError(f"flash_mha attributes: CUDA error {err}")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "local_bytes", "threads",
                     "rows"), out))


def _bhnd(t: torch.Tensor) -> torch.Tensor:
    """(…, H, N, D) as a 4-d (B, H, N, D) tensor whose last dimension is
    contiguous and whose rows start on 16 bytes: a view wherever the strides
    allow it (the transposed views LightGlue hands over do), else one copy,
    which ``flash_mha.copies`` counts."""
    if t.ndim == 4:
        t4 = t
    elif t.ndim == 3:
        t4 = t[None]
    else:
        t4 = t.reshape(-1, *t.shape[-3:])
        if t4.data_ptr() != t.data_ptr():  # the leading dimensions did not merge in place
            flash_mha.copies += 1
            return t4
    sb, sh, sn, sd = t4.stride()
    # the base on 16 bytes and every row stride a multiple of 16 bytes (the
    # element count per 16 bytes is a power of two: one test for all three)
    if sd == 1 and t4.data_ptr() % 16 == 0 and (sb | sh | sn) % (16 // t4.element_size()) == 0:
        return t4
    flash_mha.copies += 1
    return t4.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v, kv_mask, q_warps: int = 0) -> torch.Tensor:
    """One kernel launch; ``q_warps`` picks the bf16 route's query tile
    (16-row tiles per block, 1–4; 0 = the kernel's default)."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev or (
            kv_mask is not None and kv_mask.device != dev):
        raise ValueError(f"flash_mha: q on {dev}, k on {k.device}, v on {v.device}; "
                         "all operands must be on the same CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"flash_mha: {name} is {t.dtype} (float32 or bfloat16)")
        if t.ndim < 3:
            raise ValueError(f"flash_mha: {name} {tuple(t.shape)} must be (…, H, N, D)")
    lead, (heads, nq, d) = q.shape[:-3], q.shape[-3:]
    nk = k.shape[-2]
    if k.shape != lead + (heads, nk, d) or v.shape != k.shape:
        raise ValueError(f"flash_mha: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (…, H, Nq, D) / (…, H, Nk, D)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_mha: head dimension {d}; the kernel is built for {HEAD_DIMS}")
    if nk == 0:
        raise ValueError("flash_mha: no keys")
    if kv_mask is not None and (kv_mask.dtype != torch.bool or kv_mask.shape != lead + (nk,)):
        raise ValueError(f"flash_mha: kv_mask {tuple(kv_mask.shape)} {kv_mask.dtype} must be "
                         f"bool {tuple(lead + (nk,))}")
    if q_warps not in (0, 1, 2, 3, 4):
        raise ValueError(f"flash_mha: q_warps={q_warps} (0-4)")
    out = torch.empty(lead + (nq, heads, d), dtype=q.dtype, device=dev)
    if out.numel():
        q4, k4, v4 = _bhnd(q), _bhnd(k.to(q.dtype)), _bhnd(v)
        batch = q4.shape[0]
        if batch > 65535 or heads > 65535:
            raise ValueError(f"flash_mha: batch {batch} × heads {heads} exceeds the grid")
        mask_ptr, mask_stride = None, 0
        if kv_mask is not None:
            m2 = kv_mask.reshape(batch, nk)
            m2 = m2 if m2.stride(1) == 1 else m2.contiguous()
            mask_ptr, mask_stride = m2.data_ptr(), m2.stride(0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _fn()(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), mask_ptr, out.data_ptr(),
                        batch, heads, nq, nk, d, int(q.dtype == torch.bfloat16),
                        int(v.dtype == torch.bfloat16), *q4.stride()[:3], *k4.stride()[:3],
                        *v4.stride()[:3], mask_stride, q_warps, stream)
        if err:
            raise RuntimeError(f"flash_mha kernel launch failed: CUDA error {err}")
        flash_mha.launches += 1
    # the kernel writes (…, Nq, H, D), the layout the caller's merge wants
    return out.transpose(-3, -2)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_mask: torch.Tensor = None) -> torch.Tensor:
    """Kernel F: fused masked attention, one launch for all batch entries and
    heads. Shapes as :func:`mha`; float32 or bfloat16 operands (``k`` is cast
    to ``q``'s type, ``v`` may differ), the mask per batch entry. Returns
    (…, H, Nq, D) in ``q``'s type, as a transposed view of (…, Nq, H, D)."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, kv_mask)
    return _launch(q, k, v, kv_mask)


flash_mha.launches = 0
flash_mha.copies = 0  # operands the wrapper had to copy for the kernel's layout
