"""A small executor of ONNX graphs on torch tensors.

Counterpart of ``airslam_tpu/models/onnx_exec.py``: it runs an upstream
AirSLAM graph (``plnet_s1.onnx``, the stage-1 LOI head) *as data*, the
oracle of a weight import, without the ``onnx`` or ``onnxruntime``
packages. It implements the same 27 ops with the semantics of the JAX
package's numpy executor, including what that executor does beyond the
ONNX spec's minimum: slice sentinels clamped as it clamps them, negative
indices of ``Gather``/``GatherElements``/``ScatterElements`` counted from
the end, the last of several updates to one element kept by
``ScatterElements``, and numpy's result types (``Div`` of integers is a
float64 true division; a 0-d operand promotes as a numpy 0-d array does).

Tensors live on an explicit device: the card unless the caller asks for
another (``device="cpu"``). No op here is a kernel of the JAX package's
Pallas set; each is plain PyTorch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from airslam_tpu_torch import resolve_device
from airslam_tpu_torch.models.onnx_import import DTYPES, load_onnx_graph

_TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
          np.dtype(np.float16): torch.float16, np.dtype(np.int32): torch.int32,
          np.dtype(np.int64): torch.int64, np.dtype(np.bool_): torch.bool}
_NUMPY = {v: k for k, v in _TORCH.items()}


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)  # a writable copy; 0-d stays 0-d
    return torch.as_tensor(a, dtype=_TORCH[a.dtype], device=device)


def _probe(t: torch.Tensor):
    """A numpy stand-in for ``t`` in type promotion: its 0-d value where it
    is 0-d (numpy promotes 0-d arrays by their value under NumPy 1 rules),
    else an empty array of its type."""
    dt = _NUMPY[t.dtype]
    return np.asarray(t.item(), dt) if t.dim() == 0 else np.empty((0,), dt)


def _numpy_type(ufunc, *ts):
    """The dtype numpy's ``ufunc`` gives for operands like ``ts``."""
    with np.errstate(all="ignore"):
        return _TORCH[ufunc(*(_probe(t) for t in ts)).dtype]


def _binary(ufunc, fn, a, b):
    dt = _numpy_type(ufunc, a, b)
    return fn(a.to(dt), b.to(dt))


def _ints(t) -> list:
    return [int(v) for v in torch.as_tensor(t).reshape(-1).tolist()]


def _index(idx: torch.Tensor, dim: int) -> torch.Tensor:
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + dim, idx)


def _slice(data, starts, ends, axes=None, steps=None):
    starts, ends = _ints(starts), _ints(ends)
    axes = _ints(axes) if axes is not None else list(range(len(starts)))
    steps = _ints(steps) if steps is not None else [1] * len(starts)
    out = data
    for s, e, a, st in zip(starts, ends, axes, steps):
        a = a % data.dim()
        # the JAX executor's clamping of INT_MAX/MIN-like sentinels
        dim = data.shape[a]
        s, e = min(s, dim), min(e, dim)
        if s < -dim:
            s = -dim
        if e < -(dim + 1):
            e = None if st < 0 else -dim
        picked = range(*slice(s, e, st).indices(dim))
        out = out.index_select(a, torch.as_tensor(list(picked), dtype=torch.int64,
                                                  device=data.device))
    return out


def _gather(data, indices, axis):
    axis = axis % data.dim()
    idx = _index(indices, data.shape[axis])
    out = data.index_select(axis, idx.reshape(-1))
    return out.reshape(data.shape[:axis] + idx.shape + data.shape[axis + 1:])


def _scatter_elements(data, indices, updates, axis):
    """``data`` with ``updates`` put along ``axis`` at ``indices``; of
    several updates to one element the last in row-major order stays, as
    ``np.put_along_axis`` leaves it."""
    axis = axis % data.dim()
    idx = _index(indices, data.shape[axis])
    # each update's flat target in the output
    grids = torch.meshgrid(*(torch.arange(n, device=data.device) for n in idx.shape),
                           indexing="ij")
    coords = [idx if d == axis else grids[d] for d in range(data.dim())]
    strides = np.cumprod((list(data.shape[1:]) + [1])[::-1])[::-1]  # row-major
    target = sum(c * int(s) for c, s in zip(coords, strides)).reshape(-1)
    order = torch.arange(target.numel(), device=data.device)
    last = torch.full((data.numel(),), -1, dtype=torch.int64, device=data.device)
    last.scatter_reduce_(0, target, order, reduce="amax")
    keep = last[target] == order
    out = data.contiguous().clone().reshape(-1)
    out[target[keep]] = updates.to(data.dtype).expand(idx.shape).reshape(-1)[keep]
    return out.reshape(data.shape)


def _max_pool_1d(x, kernel, stride):
    """1-D max pooling over the last axis (NCW), no padding."""
    return x.unfold(-1, kernel, stride).amax(-1)


def run_graph(path: str, feeds: Dict[str, np.ndarray], trace: bool = False,
              device=None) -> Dict[str, torch.Tensor]:
    """Execute the graph at ``path`` on ``feeds`` (numpy arrays or tensors);
    returns the graph's outputs as tensors on ``device`` (the card unless the
    caller asks for another) and, with ``trace``, every initializer and
    intermediate tensor by name."""
    dev = resolve_device(device)
    nodes, inits, _, g_out = load_onnx_graph(path)
    env: Dict[str, torch.Tensor] = {k: _tensor(v, dev) for k, v in inits.items()}
    for k, v in feeds.items():
        env[k] = _tensor(v, dev)

    for n in nodes:
        op = n["op"]
        ins = [env[i] if i else None for i in n["inputs"]]
        a = n["attrs"]
        if op == "Constant":
            out = _tensor(a["value"], dev)
        elif op == "Cast":
            out = ins[0].to(_TORCH[np.dtype(DTYPES[int(a["to"])])])
        elif op == "Shape":
            out = torch.as_tensor(list(ins[0].shape), dtype=torch.int64, device=dev)
        elif op == "Reshape":
            out = ins[0].reshape(_ints(ins[1]))
        elif op == "Gather":
            out = _gather(ins[0], ins[1], int(a.get("axis", 0)))
        elif op == "GatherElements":
            axis = int(a.get("axis", 0)) % ins[0].dim()
            out = torch.gather(ins[0], axis, _index(ins[1], ins[0].shape[axis]))
        elif op == "ScatterElements":
            out = _scatter_elements(ins[0], ins[1], ins[2], int(a.get("axis", 0)))
        elif op == "Range":
            out = torch.arange(int(ins[0]), int(ins[1]), int(ins[2]), dtype=torch.int64,
                               device=dev)
        elif op == "Slice":
            out = _slice(ins[0], ins[1], ins[2], ins[3] if len(ins) > 3 else None,
                         ins[4] if len(ins) > 4 else None)
        elif op == "ConstantOfShape":
            val = a.get("value")
            fill = _tensor(val.ravel()[:1].reshape(()) if val is not None and val.size
                           else np.float32(0), dev)
            out = fill.expand(_ints(ins[0])).clone()
        elif op == "Unsqueeze":
            out = ins[0]
            for ax in sorted(_ints(ins[1])):
                out = out.unsqueeze(ax)
        elif op == "Concat":
            dt = _TORCH[np.result_type(*(_NUMPY[t.dtype] for t in ins))]
            out = torch.cat([t.to(dt) for t in ins], dim=int(a["axis"]))
        elif op == "Sub":
            out = _binary(np.subtract, torch.sub, *ins)
        elif op == "Add":
            out = _binary(np.add, torch.add, *ins)
        elif op == "Mul":
            out = _binary(np.multiply, torch.mul, *ins)
        elif op == "Div":
            out = _binary(np.true_divide, torch.true_divide, *ins)
        elif op == "Floor":
            out = torch.floor(ins[0].to(_numpy_type(np.floor, ins[0])))
        elif op == "Clip":
            lo = ins[1] if len(ins) > 1 and ins[1] is not None else None
            hi = ins[2] if len(ins) > 2 and ins[2] is not None else None
            dt = _TORCH[np.result_type(*(_probe(t) for t in (ins[0], lo, hi)
                                         if t is not None))]
            out = ins[0].to(dt)
            # np.clip is minimum(maximum(x, lo), hi)
            if lo is not None:
                out = torch.maximum(out, lo.to(dt))
            if hi is not None:
                out = torch.minimum(out, hi.to(dt))
        elif op == "Relu":
            out = torch.maximum(ins[0], torch.zeros((), dtype=ins[0].dtype, device=dev))
        elif op == "Transpose":
            perm = a.get("perm")
            out = ins[0].permute(*(perm if perm is not None
                                   else reversed(range(ins[0].dim()))))
        elif op == "Flatten":
            ax = int(a.get("axis", 1))
            lead = int(np.prod(ins[0].shape[:ax])) if ax else 1
            out = ins[0].reshape(lead, -1)
        elif op == "Gemm":
            alpha = float(a.get("alpha", 1.0))
            beta = float(a.get("beta", 1.0))
            A = ins[0].T if int(a.get("transA", 0)) else ins[0]
            B = ins[1].T if int(a.get("transB", 0)) else ins[1]
            out = alpha * _binary(np.matmul, torch.matmul, A, B)
            if len(ins) > 2 and ins[2] is not None:
                out = _binary(np.add, torch.add, out, beta * ins[2])
        elif op == "Softmax":
            ax = int(a.get("axis", -1))
            e = torch.exp(ins[0] - ins[0].amax(dim=ax, keepdim=True))
            out = e / e.sum(dim=ax, keepdim=True)
        elif op == "MatMul":
            out = _binary(np.matmul, torch.matmul, *ins)
        elif op == "Max":
            out = ins[0]
            for x in ins[1:]:
                out = _binary(np.maximum, torch.maximum, out, x)
        elif op == "ReduceMax":
            axes = a.get("axes")
            keep = bool(a.get("keepdims", 1))
            x = ins[0]
            out = x.amax(dim=tuple(int(v) for v in axes), keepdim=keep) if axes else \
                (x.amax().reshape([1] * x.dim()) if keep else x.amax())
        elif op == "MaxPool":
            k = int(a["kernel_shape"][0])
            out = _max_pool_1d(ins[0], k, int(a.get("strides", [k])[0]))
        else:
            raise NotImplementedError(f"op {op} ({n['name']})")
        env[n["outputs"][0]] = out

    if trace:
        return env
    return {k: env[k] for k in g_out}
