"""Every file of the benchmark loads and is named as ``BENCHMARK.json`` says,
the file keeps to the contract's shape, and a cell is added by files and
entries alone."""

import json
import os
import re
import shutil

import pytest

from _helpers import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_the_contract_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["slambench"] and b["command"] == ["python3", "slambench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("slambench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    cfgs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in b["workloads"]:  # every cell reports setup_s, another e2e metric, a per-layer one
        rep = [m["name"] for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in rep and len(rep) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in b["per_layer"])
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_every_entry_has_its_file_named_as_benchmark_json_says(kind):
    for entry in _bench()[kind]:
        path = (entry["file"] if kind == "configs"
                else os.path.join("slambench", "workloads", entry["name"] + ".json"))
        with open(os.path.join(ROOT, path)) as f:
            data = json.load(f)
        assert data["name"] == entry["name"]
        if kind == "workloads":
            assert data["config"] == entry["config"] and data["chips"] == entry["chips"]
            gen = os.path.join(ROOT, "slambench", "traffic", data["traffic"]["generator"] + ".py")
            drv = os.path.join(ROOT, "slambench", "drivers", data["driver"] + ".py")
            assert os.path.exists(gen) and os.path.exists(drv)
            assert all(v == v for v in data["check"]["limits"].values())


def test_every_per_layer_metric_has_a_reader():
    from slambench.harness.common import load_reader

    for m in _bench()["per_layer"]:
        assert callable(load_reader(m["name"]))


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A test-only cell: a new entry in BENCHMARK.json and a new workload file,
    in a copy of the benchmark; nothing existing is edited."""
    from slambench import run as R

    shutil.copytree(os.path.join(ROOT, "slambench", "configs"), tmp_path / "slambench" / "configs")
    shutil.copytree(os.path.join(ROOT, "slambench", "workloads"),
                    tmp_path / "slambench" / "workloads")
    b = _bench()
    b["workloads"].append({"name": "vo_euroc.slow_test", "config": "vo_euroc",
                           "traffic": "slow_test", "chips": 1, "why": "test only"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    with open(os.path.join(ROOT, "slambench", "workloads", "vo_euroc.easy.json")) as f:
        wl = json.load(f)
    wl.update(name="vo_euroc.slow_test")
    wl["traffic"]["time_scale"] = 0.05
    (tmp_path / "slambench" / "workloads" / "vo_euroc.slow_test.json").write_text(json.dumps(wl))
    bench, cell, got, cfg = R.load("vo_euroc.slow_test", root=str(tmp_path))
    assert cell["traffic"] == "slow_test" and got["traffic"]["time_scale"] == 0.05
    assert cfg["name"] == "vo_euroc" and got["driver"] == "vo"
