"""The readers of the program's spans (``metrics/_spans.py`` and the six
metrics on it) on a hand-built trace whose ranges, launch calls and device
operations are known: the nesting, the n-th kernel paired with the n-th
launch call, and nothing read where the counts differ or the program opens
no span."""

import pytest
import torch

from _helpers import ROOT  # the checkout, on the path

from slambench.harness import probes
from slambench.harness.common import load_reader
from slambench.harness.trace import Trace

NEW = ("keyframe_ms", "local_ba_prep_ms", "local_ba_assemble_ms", "local_ba_assemble_launches",
       "ba_assemble_device_ms", "ba_solve_device_ms")

# host ranges (ns): a keyframe whose local BA runs two LM steps and a gate,
# then a GlobalBA solve of one step
RANGES = [("slambench.window", 0, 5000), ("slambench.frame", 10, 990),
          ("insert_keyframe", 50, 700), ("local_map.build", 60, 95), ("local_ba", 100, 600),
          ("lm.step", 110, 300), ("lm.assemble", 120, 200), ("lm.solve", 200, 250),
          ("lm.cost", 250, 300),
          ("lm.step", 310, 500), ("lm.assemble", 320, 400), ("lm.solve", 400, 450),
          ("lm.cost", 450, 500),
          ("ba.gate", 510, 550), ("local_map.write_back", 610, 650),
          ("slambench.solve", 1000, 1900),
          ("lm.step", 1100, 1300), ("lm.assemble", 1110, 1200), ("lm.solve", 1200, 1250),
          ("lm.cost", 1250, 1300)]
# launch calls and the innermost span open at each (None: outside every one)
LAUNCHES = [(130, "lm.assemble"), (150, "lm.assemble"), (210, "lm.solve"), (260, "lm.cost"),
            (330, "lm.assemble"), (520, "ba.gate"), (620, "local_map.write_back"),
            (1150, "lm.assemble"), (1210, "lm.solve"), (1950, None)]


class _Event:
    """The few fields of a kineto event that ``Trace`` reads."""

    def __init__(self, name, start, end, device="CPU", annotation=False):
        self._name, self._start, self._dur = name, start, end - start
        self._device, self._annotation = device, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return "DeviceType." + self._device

    def is_user_annotation(self):
        return self._annotation


def _trace(launches=LAUNCHES, ranges=RANGES):
    events = [_Event(n, s, e, annotation=True) for n, s, e in ranges]
    events += [_Event("cudaLaunchKernel", t, t + 3) for t, _ in launches]
    # the card runs behind the host: every kernel of LAUNCHES starts after
    # the last launch, in launch order, the i-th lasting 10·(i+1) ns; a copy
    # and a fill between them have no launch call
    events += [_Event(f"kernel_{i}", 3000 + 100 * i, 3000 + 100 * i + 10 * (i + 1), "CUDA")
               for i in range(len(LAUNCHES))]
    events += [_Event("Memcpy HtoD (Pageable -> Device)", 3050, 3060, "CUDA"),
               _Event("Memset (Device)", 3650, 3655, "CUDA")]
    return Trace(events)


def _spans():
    import importlib.util
    import os

    path = os.path.join(ROOT, "slambench", "metrics", "_spans.py")
    spec = importlib.util.spec_from_file_location("slambench_metrics_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reading(tr, device="cuda"):
    return probes.Reading(trace=tr, frames=[], probes=None, seconds=1.0, config={},
                          device=torch.device(device), iterations=3)


def test_nested_spans_and_their_launches():
    s, tr = _spans(), _trace()
    inner = s.nested(tr, "lm.assemble", "local_ba")
    assert inner == [(120, 200), (320, 400)]  # the GlobalBA step's is not in a local BA
    assert s.nested(tr, "lm.step", "slambench.solve") == [(1100, 1300)]
    assert s.host_ms(inner) == pytest.approx(160e-6)
    assert s.launches_in(tr, inner) == 3


def test_innermost_spans_cut_the_host_timeline():
    segments = _spans().innermost(_trace())
    assert all(a[1] <= b[0] for a, b in zip(segments, segments[1:]))  # no overlap
    assert "slambench.window" not in {n for _, _, n in segments}
    for t, owner in LAUNCHES:
        hit = [n for s, e, n in segments if s <= t < e]
        assert hit == ([owner] if owner else [])


def test_kernels_go_to_the_span_that_launched_them_in_launch_order():
    by = _spans().device_ms_by_span(_trace())
    want = {}
    for i, (_, owner) in enumerate(LAUNCHES):
        want[owner] = want.get(owner, 0.0) + 10 * (i + 1) * 1e-6
    assert by.keys() == want.keys()
    for k in want:
        assert by[k] == pytest.approx(want[k])
    assert by["lm.assemble"] == pytest.approx((10 + 20 + 50 + 80) * 1e-6)
    assert by["lm.solve"] == pytest.approx((30 + 90) * 1e-6)


@pytest.mark.parametrize("drop", [0, 5, 9], ids=["first", "middle", "last"])
def test_no_device_time_when_kernels_and_launches_differ(drop):
    tr = _trace(launches=[x for i, x in enumerate(LAUNCHES) if i != drop])
    assert _spans().device_ms_by_span(tr) is None
    for name in ("ba_assemble_device_ms", "ba_solve_device_ms"):
        assert load_reader(name)(_reading(tr)) is None


def test_the_six_readers_on_the_hand_built_trace():
    r = _reading(_trace())
    got = {name: load_reader(name)(r) for name in NEW}
    assert got["keyframe_ms"] == pytest.approx(650e-6)
    assert got["local_ba_prep_ms"] == pytest.approx((35 + 40) * 1e-6)
    assert got["local_ba_assemble_ms"] == pytest.approx((80 + 80) * 1e-6)
    assert got["local_ba_assemble_launches"] == 3
    assert got["ba_assemble_device_ms"] == pytest.approx((10 + 20 + 50 + 80) * 1e-6 / 3)
    assert got["ba_solve_device_ms"] == pytest.approx((30 + 90) * 1e-6 / 3)
    # a launch count from a CPU run is no count of the card's
    assert load_reader("local_ba_assemble_launches")(_reading(_trace(), "cpu")) is None


def test_readers_find_nothing_where_the_program_opens_no_span():
    """The harness's own ranges only, as a program without spans leaves."""
    harness = [r for r in RANGES if r[0].startswith("slambench.") or r[0] == "local_ba"]
    r = _reading(_trace(ranges=harness))
    assert {name: load_reader(name)(r) for name in NEW} == dict.fromkeys(NEW)
