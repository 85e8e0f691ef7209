"""The control of each configuration comes out as not correct, on the card
at the cell's own size: for VO the program with TF32 on (its own path in the
precision below the configuration's float32 with TF32 off) and, for the
window backend, which the configuration states in float64, the program with
its map in float32 (its own path, the VO CLI's default); for GlobalBA the plain reference
solver put in the program's place with the operands of its float32 products
rounded to TF32 (the configuration states float32: float32 normal equations
in place of the program's float64 read like sound runs, see PERF.md). The
benchmark's own runs do not run these; they read the numbers PERF.md gives
for the limits."""

import pytest
import torch

from _helpers import drive

SEEDS = (3_000_000_001, 3_000_000_002, 3_000_000_003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control's precision exists on the card only")
    return "cuda"


def _full(name):
    from slambench import run as R

    return R.load(name)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vo_euroc.fast", "vo_euroc.easy"])
@pytest.mark.parametrize("seed", SEEDS)
def test_vo_control_tf32_is_not_correct(card, cell, seed, monkeypatch):
    import _helpers

    monkeypatch.setattr(_helpers, "small_cell", lambda name, tf32=False: _with_tf32(name))
    rc, line = drive(cell, seed=seed, device=card, seconds=10.0)
    assert rc == 0 and line["correct"] is False, line["checks"]


def _with_tf32(name):
    bench, cell, wl, cfg = _full(name)
    cfg = dict(cfg, tf32=True)
    return bench, cell, wl, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_vo_local_ba_control_float32_is_not_correct(card, seed, monkeypatch):
    import _helpers

    def float32_backend(name, tf32=False):
        bench, cell, wl, cfg = _full(name)
        return bench, cell, wl, dict(cfg, backend_dtype="float32")

    monkeypatch.setattr(_helpers, "small_cell", float32_backend)
    # a whole window: the local BAs it compares are those a run compares
    rc, line = drive("vo_euroc.fast", seed=seed, device=card, seconds=50.0)
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert "lba_pose_gap_m" in line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_global_ba_control_tf32_is_not_correct(card, seed, monkeypatch):
    import _helpers
    from slambench.reference import ba_solver
    from slambench.traffic import map_scene

    monkeypatch.setattr(_helpers, "small_cell", lambda name, tf32=False: _full(name))
    bench, cell, wl, cfg = _full("mr_euroc.map1000")

    def control(prob, intr, bacfg, iters1=50, iters2=40, chunk=2048):
        scene = map_scene.generate(wl["traffic"], cfg["camera"], seed)
        n = scene["pts"].shape[0]
        table = map_scene.obs_table(scene["pidx"], scene["ok"], n,
                                    map_scene.table_width(scene["pidx"], scene["ok"], n))
        sched = dict(cfg, global_ba=dict(cfg["global_ba"], iters1=iters1, iters2=iters2))
        R, t, p, inl = ba_solver.solve(scene, sched, table, card, tf32=True)
        return prob._replace(Rwb=R, twb=t, points=p), inl, prob.lobs_mask

    rc, line = drive("mr_euroc.map1000", seed=seed, device=card, seconds=1.0, solver=control)
    assert rc == 0 and line["correct"] is False, line["checks"]
