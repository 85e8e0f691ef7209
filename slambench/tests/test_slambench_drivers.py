"""Each driver runs end to end on the CPU at a small size (a few frames, a
few LM iterations) and prints a line of the contract's shape; a traced run
prints the breakdown and the traced window."""

import pytest

from _helpers import drive

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,trace", [("vo_euroc.fast", False), ("vo_euroc.fast", True),
                                        ("mr_euroc.map1000", False), ("mr_euroc.map1000", True)])
def test_driver_prints_a_contract_line(cell, trace):
    rc, line = drive(cell, seed=2 ** 31 + 11, trace=trace)
    assert rc == 0 and line is not None
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
