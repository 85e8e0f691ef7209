"""The ONNX import of the port against the JAX package's, on the CPU.

No upstream ONNX file ships with the repo, so every file here is written by
the test with a small protobuf writer (as tests/test_onnx_import.py does):
the parser's outputs (nodes, attributes, initializers of every stored type,
op counts), ``weights.import_plnet_s1`` on a file shaped as the upstream
``plnet_s1.onnx`` and written from the shipped ``plnet_s1.npz``, the
executor's 27 ops on seeded feeds (integers bit-equal, float32 within 1e-6,
``trace=True``'s intermediates too), and the detector reading the head from
the ONNX file when no ``plnet_s1.npz`` is found.
"""

import numpy as np
import pytest
import torch

from airslam_tpu.models import onnx_exec as jexec
from airslam_tpu.models import onnx_import as jimport
from airslam_tpu.models import plnet as jplnet
from airslam_tpu.models import weights as jweights
from airslam_tpu_torch.frontend import detector as tdetector
from airslam_tpu_torch.models import onnx_exec, onnx_import
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.models.plnet import LoiHeadS1

torch.set_num_threads(2)

TOL = 1e-6  # float32 outputs against the JAX executor's
INT_MAX, INT_MIN = 2 ** 63 - 1, -(2 ** 63)
ONNX_TYPES = {np.dtype(np.float32): 1, np.dtype(np.int32): 6, np.dtype(np.int64): 7,
              np.dtype(np.bool_): 9, np.dtype(np.float16): 10, np.dtype(np.float64): 11}


# -- a protobuf writer of the onnx.proto3 subset the parsers read ------------

def varint(x):
    x &= (1 << 64) - 1  # int64 fields are two's complement in 64 bits
    out = b""
    while True:
        b7 = x & 0x7F
        x >>= 7
        if x:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def field(num, wt, payload):
    key = varint((num << 3) | wt)
    return key + varint(len(payload)) + payload if wt == 2 else key + payload


def tensor(name, arr, packed_floats=False):
    arr = np.asarray(arr)
    msg = b"".join(field(1, 0, varint(d)) for d in arr.shape)
    msg += field(2, 0, varint(ONNX_TYPES[arr.dtype])) + field(8, 2, name.encode())
    if packed_floats:
        return msg + field(4, 2, arr.astype(np.float32).tobytes())
    return msg + field(9, 2, arr.tobytes())


def attr(name, value):
    msg = field(1, 2, name.encode())
    if isinstance(value, np.ndarray):
        return msg + field(5, 2, tensor("", value))
    if isinstance(value, float):
        return msg + field(2, 5, np.float32(value).tobytes())
    if isinstance(value, int):
        return msg + field(3, 0, varint(value))
    if all(isinstance(v, float) for v in value):
        return msg + field(7, 2, np.asarray(value, np.float32).tobytes())
    return msg + b"".join(field(8, 0, varint(v)) for v in value)


def node(op, inputs, outputs, name="", **attrs):
    msg = b"".join(field(1, 2, i.encode()) for i in inputs)
    msg += b"".join(field(2, 2, o.encode()) for o in outputs)
    msg += field(3, 2, name.encode()) + field(4, 2, op.encode())
    return msg + b"".join(field(5, 2, attr(k, v)) for k, v in attrs.items())


def model(nodes, inits, inputs, outputs, packed=()):
    graph = b"".join(field(1, 2, n) for n in nodes)
    graph += b"".join(field(5, 2, tensor(k, v, k in packed)) for k, v in inits.items())
    graph += b"".join(field(11, 2, field(1, 2, n.encode())) for n in inputs)
    graph += b"".join(field(12, 2, field(1, 2, n.encode())) for n in outputs)
    return field(7, 2, graph)


def write(path, blob):
    path.write_bytes(blob)
    return str(path)


def const(name, value):
    return node("Constant", [], [name], name=name, value=np.asarray(value))


# -- the parser --------------------------------------------------------------

def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


def test_parser_equals_jax(tmp_path):
    """Both packages' ``load_onnx_graph`` / ``load_onnx`` return the same
    nodes (inputs, outputs, names, int / float / ints / floats / tensor
    attributes) and initializers (raw f32, f16, i32, i64, bool, f64, packed
    float_data, a scalar without dims) and op counts."""
    rng = np.random.RandomState(0)
    inits = {"w_f32": rng.randn(3, 4).astype(np.float32),
             "w_f16": rng.randn(5).astype(np.float16),
             "w_i32": rng.randint(-9, 9, (2, 3)).astype(np.int32),
             "w_i64": np.asarray([INT_MIN, -1, 0, INT_MAX], np.int64),
             "w_bool": rng.rand(6) > 0.5, "w_f64": rng.randn(2, 2),
             "w_packed": rng.randn(4, 2).astype(np.float32),
             "w_scalar": np.asarray(2.5, np.float32)}
    nodes = [node("Gemm", ["a", "w_f32"], ["g"], name="gemm", alpha=0.5, transB=1),
             node("Softmax", ["g"], ["s"], axis=-1),
             node("Transpose", ["s"], ["t"], perm=[1, 0], scales=[0.25, -3.0]),
             node("Constant", [], ["c"], value=rng.randn(2, 2).astype(np.float32)),
             node("Gemm", ["t", "c"], ["out"])]
    path = write(tmp_path / "parse.onnx",
                 model(nodes, inits, ["a"], ["out", "s"], packed={"w_packed"}))

    want, got = jimport.load_onnx_graph(path), onnx_import.load_onnx_graph(path)
    assert [n["op"] for n in got[0]] == ["Gemm", "Softmax", "Transpose", "Constant", "Gemm"]
    for jn, tn in zip(want[0], got[0]):
        assert jn.keys() == tn.keys() and jn["attrs"].keys() == tn["attrs"].keys()
        for k in ("op", "name", "inputs", "outputs"):
            assert jn[k] == tn[k], k
        for k in jn["attrs"]:
            assert _same(np.asarray(jn["attrs"][k]), np.asarray(tn["attrs"][k])), k
    assert got[0][1]["attrs"]["axis"] == -1 and got[0][0]["attrs"]["transB"] == 1
    assert want[1].keys() == got[1].keys() == inits.keys()
    for k, v in inits.items():
        assert _same(got[1][k], want[1][k]) and _same(got[1][k], v), k
    assert got[2:] == want[2:] == (["a"], ["out", "s"])
    wj, oj = jimport.load_onnx(path)
    wt, ot = onnx_import.load_onnx(path)
    assert ot == oj == {"Gemm": 2, "Softmax": 1, "Transpose": 1, "Constant": 1}
    assert wt.keys() == wj.keys() and all(_same(wt[k], wj[k]) for k in wj)


# -- the stage-1 head's import -----------------------------------------------

S1_LINEAR = {"fc2_0": "fc2.0", "fc2_2": "fc2.2", "fc2_4": "fc2.4", "fc2_res": "fc2_res.0",
             "fc2_head": "fc2_head"}


@pytest.fixture(scope="module")
def plnet_s1():
    return wio.load_npz(wio.checkpoint_path("plnet_s1.npz"))


@pytest.fixture(scope="module")
def s1_onnx(tmp_path_factory, plnet_s1):
    """A file shaped as the upstream ``plnet_s1.onnx``: the shipped head's
    weights (out, in) under the upstream names, the two ramps, and the
    graph's op kinds."""
    p = plnet_s1["params"]
    inits = {}
    for flax_name, onnx_name in S1_LINEAR.items():
        inits[f"{onnx_name}.weight"] = np.ascontiguousarray(p[flax_name]["kernel"].T)
        inits[f"{onnx_name}.bias"] = p[flax_name]["bias"]
    inits["onnx::Mul_1141"] = p["t_fwd"].reshape(1, -1, 1)
    inits["onnx::Mul_1142"] = p["t_rev"].reshape(1, -1, 1)
    nodes = [node("GatherElements", ["loi_features", "idx"], ["g"], axis=2)]
    nodes += [node("Gemm", ["g", f"{n}.weight", f"{n}.bias"], [f"y{i}"], transB=1)
              for i, n in enumerate(S1_LINEAR.values())]
    nodes += [node("Softmax", ["y4"], ["scores_line"], axis=-1)]
    path = tmp_path_factory.mktemp("onnx") / "plnet_s1.onnx"
    return write(path, model(nodes, inits, ["loi_features", "idx"], ["scores_line"]))


def test_import_plnet_s1_equals_jax(s1_onnx, plnet_s1):
    """``import_plnet_s1`` gives the JAX function's tree bit for bit, and that
    tree is the shipped ``plnet_s1.npz`` it was written from."""
    want, got = jweights.import_plnet_s1(s1_onnx), wio.import_plnet_s1(s1_onnx)
    flat_w, flat_g = _flat(want), _flat(got)
    assert flat_g.keys() == flat_w.keys() == _flat(plnet_s1).keys()
    assert len(flat_g) == 12
    for k in flat_w:
        assert _same(flat_g[k], flat_w[k]) and _same(flat_g[k], _flat(plnet_s1)[k]), k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_imported_head_equals_jax_head(s1_onnx):
    """The port's ``LoiHeadS1`` loaded from the imported tree gives the JAX
    head's output on seeded inputs in float32: within 1e-6 absolute plus 1e-6
    of the value (the 496-wide products sum in another order than XLA's:
    1.01e-6 at a score of 0.69 on these inputs, 1.5e-6 of it)."""
    import jax.numpy as jnp

    tree = wio.import_plnet_s1(s1_onnx)
    rng = np.random.RandomState(5)
    loi = rng.randn(128, 128, 128).astype(np.float32)
    thin = rng.randn(128, 128, 4).astype(np.float32)
    aux = rng.randn(128, 128, 4).astype(np.float32)
    lines = rng.uniform(-1, 129, (256, 4)).astype(np.float32)
    props = (lines + rng.randn(256, 4)).astype(np.float32)
    want_s, want_l = jplnet.LoiHeadS1().apply(
        jweights.import_plnet_s1(s1_onnx), *(jnp.asarray(a) for a in (lines, props, loi, thin,
                                                                     aux)))
    head = LoiHeadS1()
    head.load_state_dict(wio.loi_s1_from_flax(tree))
    with torch.no_grad():
        got_s, got_l = head(*(torch.from_numpy(a) for a in (lines, props, loi, thin, aux)))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=TOL, atol=TOL)


# -- the executor ------------------------------------------------------------

EXEC_OPS = {"Constant", "Cast", "Shape", "Reshape", "Gather", "GatherElements",
            "ScatterElements", "Range", "Slice", "ConstantOfShape", "Unsqueeze", "Concat",
            "Sub", "Add", "Mul", "Div", "Floor", "Clip", "Relu", "Transpose", "Flatten",
            "Gemm", "Softmax", "MatMul", "Max", "ReduceMax", "MaxPool"}


def _exec_graph():
    """Graphs over a float32 input x (2, 3, 8) and int64 indices that use
    every op of the executor (slice sentinels, negative indices and steps,
    duplicate scatter targets, numpy's promotions of 0-d operands and of
    integer division), with their initializers and outputs."""
    rng = np.random.RandomState(1)
    inits = {"w8": rng.uniform(-2, 2, 8).astype(np.float32),
             "gw": rng.uniform(-0.5, 0.5, (24, 5)).astype(np.float32),
             "gwt": rng.uniform(-0.5, 0.5, (5, 24)).astype(np.float32),
             "gb": rng.uniform(-1, 1, 5).astype(np.float32),
             "mm": rng.uniform(-0.5, 0.5, (8, 4)).astype(np.float32)}
    nodes = [
        node("Shape", ["x"], ["shape"]),
        const("two", np.int64(2)), const("zero", np.int64(0)), const("one", np.int64(1)),
        node("Gather", ["shape", "two"], ["n8"]),
        node("Range", ["zero", "n8", "one"], ["ramp"]),
        node("Cast", ["ramp"], ["rampf"], to=1),
        const("ax0", np.asarray([0], np.int64)),
        node("Unsqueeze", ["rampf", "ax0"], ["ramp2"]),
        node("Add", ["x", "ramp2"], ["x1"]),
        const("half", np.float32(0.5)),
        node("Sub", ["x1", "half"], ["x2"]),
        const("half64", np.float64(0.5)),
        node("Sub", ["x1", "half64"], ["x2d"]),  # a 0-d float64: numpy's promotion
        node("Mul", ["x2", "w8"], ["x3"]),
        const("three", np.asarray([3.0], np.float32)),
        node("Div", ["x3", "three"], ["x4"]),
        const("by2", np.asarray([2], np.int64)),
        node("Div", ["shape", "by2"], ["shape_half"]),  # integers: a float64 division
        node("Floor", ["x4"], ["x5"]),
        const("lo", np.float32(-1.0)), const("hi", np.float32(1.5)),
        node("Clip", ["x4", "lo", "hi"], ["x6"]),
        node("Clip", ["x4", "", "hi"], ["x6hi"]),
        node("Relu", ["x4"], ["x7"]),
        node("Max", ["x6", "x7", "x5"], ["x8"]),
        node("Transpose", ["x8"], ["x9"], perm=[0, 2, 1]),
        node("Transpose", ["x"], ["xT"]),
        const("s_starts", np.asarray([1, -100], np.int64)),
        const("s_ends", np.asarray([INT_MAX, 2], np.int64)),
        const("s_axes", np.asarray([1, -1], np.int64)),
        const("s_steps", np.asarray([2, 1], np.int64)),
        node("Slice", ["x9", "s_starts", "s_ends", "s_axes", "s_steps"], ["sl1"]),
        const("r_starts", np.asarray([-1], np.int64)),
        const("r_ends", np.asarray([INT_MIN], np.int64)),
        const("r_axes", np.asarray([1], np.int64)),
        const("r_steps", np.asarray([-1], np.int64)),
        node("Slice", ["x9", "r_starts", "r_ends", "r_axes", "r_steps"], ["sl2"]),
        const("p_starts", np.asarray([0, 5], np.int64)),
        const("p_ends", np.asarray([1, -INT_MAX], np.int64)),
        node("Slice", ["x", "p_starts", "p_ends"], ["sl3"]),
        node("Concat", ["sl2", "x9"], ["cat"], axis=1),
        const("shape46", np.asarray([-1, 4, 6], np.int64)),
        node("Reshape", ["x9", "shape46"], ["rs"]),
        node("Flatten", ["x"], ["flat"], axis=1),
        node("Gemm", ["flat", "gw", "gb"], ["gemm"], alpha=0.5, beta=2.0),
        node("Gemm", ["flat", "gwt"], ["gemm_t"], transB=1),
        node("MatMul", ["x", "mm"], ["mmul"]),
        node("Softmax", ["mmul"], ["soft"], axis=-1),
        node("Softmax", ["mmul"], ["soft1"], axis=1),
        node("ReduceMax", ["mmul"], ["rmax"], axes=[1], keepdims=0),
        node("ReduceMax", ["mmul"], ["rmax_all"]),
        node("MaxPool", ["x"], ["pool"], kernel_shape=[3], strides=[2]),
        const("shape23", np.asarray([2, 3], np.int64)),
        node("ConstantOfShape", ["shape23"], ["fill7"], value=np.asarray([7], np.int64)),
        node("ConstantOfShape", ["shape23"], ["fill0"]),
        node("GatherElements", ["x", "gi"], ["ge"], axis=2),
        node("GatherElements", ["x", "gi1"], ["ge1"], axis=-2),
        node("ScatterElements", ["x", "si", "upd"], ["sc"], axis=2),
        node("ScatterElements", ["fill0", "si0", "upd0"], ["sc0"], axis=0),
        const("neg", np.asarray([-1, 0], np.int64)),
        node("Gather", ["x", "neg"], ["gneg"], axis=1),
        node("Gather", ["w8", "two"], ["gscalar"]),
        node("Cast", ["x4"], ["x4i"], to=7),
        node("Cast", ["x4"], ["x4i32"], to=6),
        node("Cast", ["x7"], ["x7b"], to=9),
        node("Cast", ["x4"], ["x4h"], to=10),
        node("Cast", ["x4h"], ["x4d"], to=11),
    ]
    outputs = ["x2d", "shape_half", "x6hi", "xT", "sl1", "sl2", "sl3", "cat", "rs", "gemm",
               "gemm_t", "soft", "soft1", "rmax", "rmax_all", "pool", "fill7", "sc", "sc0",
               "ge", "ge1", "gneg", "gscalar", "x4i", "x4i32", "x7b", "x4d"]
    return nodes, inits, outputs


def _feeds(seed):
    rng = np.random.RandomState(seed)
    gi = rng.randint(-8, 8, (2, 3, 4)).astype(np.int64)
    si = rng.randint(0, 8, (2, 3, 6)).astype(np.int64)  # 6 of 8 slots: repeats
    si[0, 0] = [5, 5, 5, 1, 2, 3]
    si[1, 2] = [-1, 7, -1, 0, 7, -8]
    return {"x": rng.uniform(-3, 3, (2, 3, 8)).astype(np.float32), "gi": gi,
            "gi1": rng.randint(-3, 3, (2, 2, 8)).astype(np.int64), "si": si,
            "upd": rng.randn(2, 3, 6).astype(np.float32),
            "si0": np.asarray([[1, 0, 1], [1, 1, 0]], np.int64),
            "upd0": rng.randint(-5, 5, (2, 3)).astype(np.int64)}


def _check(want, got, label):
    want = np.asarray(want)
    g = got.cpu().numpy()
    assert g.dtype == want.dtype and g.shape == want.shape, (label, g.dtype, want.dtype,
                                                             g.shape, want.shape)
    if want.dtype.kind in "biu":
        assert np.array_equal(g, want), label
    else:
        np.testing.assert_allclose(g.astype(np.float64), want.astype(np.float64), rtol=0,
                                   atol=TOL, err_msg=label)


@pytest.mark.parametrize("seed", [0, 1])
def test_executor_equals_jax(tmp_path, seed):
    """The port's ``run_graph`` (``device="cpu"``) against the JAX executor on
    seeded feeds through graphs that use all 27 ops: every output and, with
    ``trace=True``, every intermediate of the same type and shape, integers
    and booleans bit-equal, float32 within 1e-6."""
    nodes, inits, outputs = _exec_graph()
    path = write(tmp_path / "exec.onnx", model(nodes, inits, list(_feeds(seed)), outputs))
    assert {n["op"] for n in onnx_import.load_onnx_graph(path)[0]} == EXEC_OPS
    feeds = _feeds(seed)
    want = jexec.run_graph(path, feeds)
    got = onnx_exec.run_graph(path, feeds, device="cpu")
    assert list(got) == list(want) == outputs
    for k in outputs:
        _check(want[k], got[k], k)
    want_t = jexec.run_graph(path, feeds, trace=True)
    got_t = onnx_exec.run_graph(path, feeds, trace=True, device="cpu")
    assert got_t.keys() == want_t.keys()
    for k in want_t:
        _check(want_t[k], got_t[k], k)
    # the scatter kept the last of the repeated updates, as numpy does
    assert float(got["sc"][0, 0, 5]) == feeds["upd"][0, 0, 2]


def test_executor_runs_on_the_card_unless_asked_otherwise(tmp_path):
    """Without ``device`` the executor runs on the card, and raises here."""
    nodes, inits, outputs = _exec_graph()
    path = write(tmp_path / "exec.onnx", model(nodes, inits, list(_feeds(0)), outputs))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        onnx_exec.run_graph(path, _feeds(0))


# -- the detector's head from the ONNX file ----------------------------------

@pytest.mark.parametrize("source", ["npz", "onnx", "shipped"])
def test_detector_head_lookup(monkeypatch, tmp_path, s1_onnx, plnet_s1, source):
    """A PLNet given without its head gets the stage-1 head in the JAX
    detector's order: ``plnet_s1.npz`` when found, else the ONNX file of
    ``detector.PLNET_S1_ONNX`` imported (the same weights), else the shipped
    ``plnet_s0.npz``'s head."""
    shipped = wio.load_npz(wio.checkpoint_path("plnet_s0.npz"))
    missing = str(tmp_path / "absent")
    found = wio.checkpoint_path

    def lookup(name):
        return missing if name == "plnet_s1.npz" and source != "npz" else found(name)

    monkeypatch.setattr(wio, "checkpoint_path", lookup)
    monkeypatch.setattr(tdetector, "PLNET_S1_ONNX", s1_onnx if source == "onnx" else missing)
    det = tdetector.FeatureDetector(tdetector.DetectorConfig(use_superpoint=False),
                                    device="cpu", params={"plnet": shipped["plnet"]})
    want = wio.loi_s1_from_flax(shipped["loi"] if source == "shipped" else plnet_s1)
    got = det.loi.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if source != "shipped":  # the two heads differ, so the lookup decided
        assert not torch.equal(want["fc2_0.weight"],
                               wio.loi_s1_from_flax(shipped["loi"])["fc2_0.weight"])
