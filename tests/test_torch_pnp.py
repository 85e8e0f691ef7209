"""The port's device RANSAC PnP (``backend/pnp.py``) against the JAX one on
the CPU in f64: the minimal solver and the reprojection errors on one
minimal set, the whole RANSAC with the JAX key's minimal sets handed over,
``tests/test_pnp.py``'s three cases with the port's own generator, and
``MapBuilder(use_jax_pnp=True)`` on the tracking oracle's pairs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airslam_tpu.backend import pnp as jpnp
from airslam_tpu_torch.backend import pnp as tpnp
from airslam_tpu_torch.core.camera import Intrinsics
from tests.test_pnp import make_case

import chip_smoke

torch.set_num_threads(2)


def _port_intr(intr):
    return Intrinsics(float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy),
                      float(intr.bf))


def _t(a):
    return torch.as_tensor(np.array(a))


def jax_samples(key, mask, iterations=128):
    """The minimal sets ``jpnp.solve_pnp_ransac`` draws from ``key``."""
    keys = jax.random.split(key, iterations)
    logits = jnp.where(jnp.asarray(mask), 0.0, -1e9)
    return np.asarray(jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(6,)))(keys))


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_dlt_and_reprojection_errors_vs_jax(noise):
    """One minimal set of 6 distinct points: the DLT pose and every
    point's reprojection error within 1e-9."""
    intr, _, _, pts, uv, m, _ = make_case(noise=noise, seed=3)
    uvn = np.stack([(uv[:, 0] - intr.cx) / intr.fx, (uv[:, 1] - intr.cy) / intr.fy], 1)
    sel = np.asarray([3, 17, 29, 41, 58, 77])
    Rj, tj = jpnp._dlt_pose(jnp.asarray(pts), jnp.asarray(uvn), jnp.asarray(sel))
    Rt, tt = tpnp._dlt_pose(_t(pts), _t(uvn), _t(sel))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-9)
    ej = np.asarray(jpnp._reproj_errors(Rj, tj, jnp.asarray(pts), jnp.asarray(uv), intr))
    et = tpnp._reproj_errors(Rt, tt, _t(pts), _t(uv), _port_intr(intr)).numpy()
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", [dict(), dict(n_out=25, noise=0.5, seed=1),
                                  dict(n_out=40, noise=1.0, seed=5)])
def test_ransac_with_the_jax_samples(case):
    """The whole RANSAC with the minimal sets of the JAX key handed to both:
    R and t within 1e-8, the same inliers and ``ok``."""
    intr, _, _, pts, uv, m, _ = make_case(**case)
    key = jax.random.PRNGKey(case.get("seed", 0))
    Rj, tj, inlj, okj = jpnp.solve_pnp_ransac(jnp.asarray(pts), jnp.asarray(uv),
                                              jnp.asarray(m), intr, key)
    Rt, tt, inlt, okt = tpnp.solve_pnp_ransac(_t(pts), _t(uv), _t(m), _port_intr(intr),
                                              samples=_t(jax_samples(key, m)))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(inlt.numpy(), np.asarray(inlj))
    assert bool(okt) == bool(okj)


def test_draws_are_the_valid_entries():
    """The generator's minimal sets index valid entries only, and the same
    seed gives the same draws."""
    mask = torch.zeros(128, dtype=torch.bool)
    mask[:40] = True
    a = tpnp.draw_samples(mask, 128, torch.Generator().manual_seed(7))
    b = tpnp.draw_samples(mask, 128, torch.Generator().manual_seed(7))
    assert a.shape == (128, 6) and torch.equal(a, b) and int(a.max()) < 40


def test_map_builder_with_the_device_pnp():
    """``MapBuilder(use_jax_pnp=True)`` over the tracking oracle's pairs
    (f32 geometry, CPU): pair 0 initialises, pairs 1 and 2 take their initial
    pose from the device RANSAC seeded by the frame id, and the tracked pose
    lands within 1e-3 m / 1e-3 of the stored JAX MapBuilder's."""
    from airslam_tpu_torch.pipelines.map_builder import MapBuilder

    cam, _, stored = chip_smoke.tracking_oracle()
    frames = chip_smoke.oracle_pairs()[0]
    first = chip_smoke.tracking_builder(cam, torch.float32, "cpu")
    builder = MapBuilder(first.camera, first.detector, first.matcher, device="cpu",
                         use_jax_pnp=True)
    calls = []
    solve = builder._solve_pnp_jax
    builder._solve_pnp_jax = lambda cur, matched: calls.append(len(matched)) or solve(cur,
                                                                                     matched)
    builder.add_input(0.0, frames[0][0], frames[0][1])
    for i in (1, 2):
        got = builder.track_frame(0.05 * i, frames[i][0], frames[i][1])
        np.testing.assert_allclose(got.Twc[:3, 3], stored[i]["Twc"][:3, 3], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got.Twc[:3, :3], stored[i]["Twc"][:3, :3], rtol=0, atol=1e-3)
    assert len(calls) == 2 and min(calls) >= 8


@pytest.mark.parametrize("name", list(chip_smoke.PNP_CASES))
def test_pnp_cases_with_the_port_generator(name):
    """tests/test_pnp.py's three cases with the port's own draws (a
    ``torch.Generator`` seeded as the JAX test seeds its key), under that
    test's tolerances (``chip_smoke._pnp_check``, which the card's phase
    uses). ``chip_smoke.pnp_case``, numpy alone for the card, draws the same
    case as ``make_case``."""
    kw, seed, _ = chip_smoke.PNP_CASES[name]
    want = make_case(**kw)
    got = chip_smoke.pnp_case(**kw)
    for a, b in zip(got[1:6], want[1:6]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert (got[6] is None) == (want[6] is None)
    if got[6] is not None:
        np.testing.assert_array_equal(got[6], want[6])
    for f in ("fx", "fy", "cx", "cy"):
        assert getattr(got[0], f) == float(getattr(want[0], f))
    got, seed = chip_smoke.pnp_named(name)
    intr, _, _, pts, uv, m, _ = got
    R, t, inl, ok = tpnp.solve_pnp_ransac(_t(pts), _t(uv), _t(m), intr,
                                          generator=torch.Generator().manual_seed(seed))
    assert chip_smoke._pnp_check(name, R.numpy(), t.numpy(), inl.numpy(), bool(ok), got)
