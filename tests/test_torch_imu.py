"""The port's IMU preintegration (``airslam_tpu_torch/core/imu.py``) against
the JAX package's (``airslam_tpu/core/imu.py``) on the CPU, on the
numpy-seeded measurements of tests/test_imu.py: both sides in float64, the
port's tensors on the CPU. Each test states its tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airslam_tpu.core import imu as jimu
from airslam_tpu_torch.core import imu
from tests.test_imu import make_measurements

torch.set_num_threads(2)
F64 = torch.float64
NOISE = (1.7e-4 * np.sqrt(200), 2e-3 * np.sqrt(200), 1.9e-5 / np.sqrt(200), 3e-3 / np.sqrt(200))


def _diags(noise=NOISE):
    gn, an, gw, aw = noise
    return np.array([gn ** 2] * 3 + [an ** 2] * 3), np.array([gw ** 2] * 3 + [aw ** 2] * 3)


def _both(dts, accs, gyrs, bg, ba, noise=NOISE):
    nd, wd = _diags(noise)
    args = (dts, accs, gyrs, bg, ba, nd, wd)
    want = jimu.preintegrate(*(jnp.asarray(a) for a in args))
    got = imu.preintegrate(*(torch.as_tensor(np.asarray(a, np.float64)) for a in args))
    return got, want


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b.double().numpy()).max())


@pytest.mark.parametrize("seed", [0, 3])
def test_preintegration_matches_jax(seed):
    """Every leaf of the state to 1e-10 (the covariance to 1e-10 relative to
    its largest entry): the same recursion in the same order, f64."""
    dts, accs, gyrs = make_measurements(50, seed=seed)
    bg = np.array([0.01, -0.02, 0.005])
    ba = np.array([0.05, 0.02, -0.1])
    got, want = _both(dts, accs, gyrs, bg, ba)
    for name, g, w in zip(imu.PreintState._fields, got, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        assert g.dtype == F64 and g.shape == np.asarray(w).shape, name
        assert _gap(w, g) <= 1e-10 * scale, name
    assert float(np.abs(np.asarray(want.cov)).max()) > 0  # the covariance did accumulate


def test_padding_is_noop():
    """Rows of dt = 0 (with any measurement) leave every leaf bit-equal,
    including the random-walk covariance term."""
    dts, accs, gyrs = make_measurements(20, seed=1)
    nd, wd = (torch.full((6,), 1e-6, dtype=F64), torch.full((6,), 1e-8, dtype=F64))
    z = torch.zeros(3, dtype=F64)
    t = torch.as_tensor
    st1 = imu.preintegrate(t(dts), t(accs), t(gyrs), z, z, nd, wd)
    st2 = imu.preintegrate(t(np.concatenate([dts, np.zeros(12)])),
                           t(np.concatenate([accs, np.ones((12, 3)) * 99])),
                           t(np.concatenate([gyrs, np.ones((12, 3)) * -99])), z, z, nd, wd)
    for name, a, b in zip(imu.PreintState._fields, st1, st2):
        assert torch.equal(a, b), name


def test_bias_corrected_deltas_match_jax_and_repropagation():
    """The first-order bias-corrected deltas equal the JAX getters' to 1e-12
    and approximate a full repropagation at the new bias (1e-6 rotation,
    1e-5 velocity/position, as tests/test_imu.py holds the JAX ones)."""
    dts, accs, gyrs = make_measurements(40, seed=2)
    bg0, ba0 = np.zeros(3), np.zeros(3)
    dbg = np.array([5e-4, -3e-4, 2e-4])
    dba = np.array([2e-3, 1e-3, -2e-3])
    got, want = _both(dts, accs, gyrs, bg0, ba0, noise=(1e-3, 1e-3, 3e-5, 3e-5))
    new, _ = _both(dts, accs, gyrs, bg0 + dbg, ba0 + dba, noise=(1e-3, 1e-3, 3e-5, 3e-5))
    t, j = torch.as_tensor, jnp.asarray
    pairs = [
        (imu.delta_rotation(got, t(bg0), t(bg0 + dbg)),
         jimu.delta_rotation(want, j(bg0), j(bg0 + dbg)), new.dR, 1e-6),
        (imu.delta_velocity(got, t(bg0), t(ba0), t(bg0 + dbg), t(ba0 + dba)),
         jimu.delta_velocity(want, j(bg0), j(ba0), j(bg0 + dbg), j(ba0 + dba)), new.dV, 1e-5),
        (imu.delta_position(got, t(bg0), t(ba0), t(bg0 + dbg), t(ba0 + dba)),
         jimu.delta_position(want, j(bg0), j(ba0), j(bg0 + dbg), j(ba0 + dba)), new.dP, 1e-5),
    ]
    for g, w, full, tol in pairs:
        assert _gap(w, g) <= 1e-12
        assert float((g - full).abs().max()) <= tol


def test_midpoint_batch_equals_jax():
    """Every interpolation case of AddBatchData: the interval covering both
    gaps, t0 inside the first gap, t1 inside the last, and an interval with
    no sample — bit-equal to the JAX rows."""
    rng = np.random.RandomState(4)
    stamps = np.cumsum(0.005 + rng.rand(12) * 1e-3)
    gyr, acc = rng.randn(12, 3), rng.randn(12, 3) + [0, 0, 9.81]
    ours = [imu.ImuData(t, g, a) for t, g, a in zip(stamps, gyr, acc)]
    theirs = [jimu.ImuData(t, g, a) for t, g, a in zip(stamps, gyr, acc)]
    for t0, t1 in ((stamps[0], stamps[-1]), (stamps[0] + 2e-3, stamps[-1]),
                   (stamps[1], stamps[-2] + 1e-3), (stamps[-1] + 1.0, stamps[-1] + 2.0)):
        for g, w in zip(imu.midpoint_batch(ours, t0, t1), jimu.midpoint_batch(theirs, t0, t1)):
            assert g.dtype == w.dtype == np.float64
            np.testing.assert_array_equal(g, w)
    dts, _, gyrs = imu.midpoint_batch(ours[:3], stamps[0], stamps[2])
    assert len(dts) == 2 and np.allclose(gyrs[0], 0.5 * (gyr[0] + gyr[1]))


def test_preintegration_class_and_predict_equal_jax():
    """The host accumulator over two batches: its padded state (64 rows for
    61), dT, updated deltas after a bias update, a bias reset, and
    ``predict`` equal the JAX Preintegration's to 1e-10."""
    rng = np.random.RandomState(6)
    stamps = np.arange(62) * 0.005
    gyr, acc = rng.randn(62, 3) * 0.2, rng.randn(62, 3) * 0.5 + [0, 0, 9.81]
    noise = (1e-3, 1e-2, 1e-5, 1e-4)
    ours = imu.Preintegration(noise=noise, dtype=F64, device="cpu")
    theirs = jimu.Preintegration(noise=noise)
    for lo, hi in ((0, 31), (30, 62)):
        ours.add_batch([imu.ImuData(t, g, a) for t, g, a in
                        zip(stamps[lo:hi], gyr[lo:hi], acc[lo:hi])], stamps[lo], stamps[hi - 1])
        theirs.add_batch([jimu.ImuData(t, g, a) for t, g, a in
                          zip(stamps[lo:hi], gyr[lo:hi], acc[lo:hi])], stamps[lo], stamps[hi - 1])
    assert ours.valid() and len(ours._rows_dt) == len(theirs._rows_dt) == 61
    assert imu.Preintegration._padded_len(61) == jimu.Preintegration._padded_len(61) == 64
    assert [imu.Preintegration._padded_len(n) for n in (1, 8, 9, 17)] == [8, 8, 16, 32]
    assert ours.dT == pytest.approx(theirs.dT, abs=1e-14)
    for g, w in zip(ours.state, theirs.state):
        assert _gap(w, g) <= 1e-10
    ours.update_bias([1e-3, -2e-3, 5e-4], [1e-2, 0.0, -2e-2])
    theirs.update_bias([1e-3, -2e-3, 5e-4], [1e-2, 0.0, -2e-2])
    for g, w in zip(ours.updated_delta(), theirs.updated_delta()):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
    Twb0 = np.eye(4)
    Twb0[:3, 3] = [1.0, -2.0, 0.5]
    v0 = np.array([0.3, 0.1, -0.2])
    (T1, v1), (jT1, jv1) = ours.predict(Twb0, v0, 9.81), theirs.predict(Twb0, v0, 9.81)
    np.testing.assert_allclose(T1, jT1, rtol=0, atol=1e-10)
    np.testing.assert_allclose(v1, jv1, rtol=0, atol=1e-10)
    Rwb1, twb1, vwb1 = imu.predict(ours.state, torch.as_tensor(Twb0[:3, :3]),
                                   torch.as_tensor(Twb0[:3, 3]), torch.as_tensor(v0), 9.81)
    want = jimu.predict(theirs.state, jnp.asarray(Twb0[:3, :3]), jnp.asarray(Twb0[:3, 3]),
                        jnp.asarray(v0), 9.81)
    for g, w in zip((Rwb1, twb1, vwb1), want):
        assert _gap(w, g) <= 1e-10
    ours.set_bias(np.full(3, 0.01), np.zeros(3))
    theirs.set_bias(np.full(3, 0.01), np.zeros(3))
    assert _gap(theirs.state.dR, ours.state.dR) <= 1e-10
    ours.reset()
    assert not ours.valid() and ours.dtype == F64 and ours.device.type == "cpu"
    np.testing.assert_array_equal(ours.noise_diag, theirs.noise_diag)
    # an invalid accumulator predicts no motion
    T2, v2 = ours.predict(Twb0, v0, 9.81)
    assert np.array_equal(T2, Twb0) and np.array_equal(v2, v0)


def test_predict_constant_velocity():
    """Zero gyro and the accelerometer measuring −gravity: the body keeps its
    velocity (tests/test_imu.py's case), in the builder's float32 too."""
    for dtype, tol in ((F64, 1e-9), (torch.float32, 1e-4)):
        pre = imu.Preintegration(noise=(1e-4, 1e-3, 1e-5, 1e-4), dtype=dtype, device="cpu")
        pre._rows_dt = [0.005] * 100
        pre._rows_acc = [np.array([0.0, 0.0, 9.81])] * 100
        pre._rows_gyr = [np.zeros(3)] * 100
        pre.start_time, pre.end_time = 0.0, 0.5
        assert pre.state.dR.dtype == dtype
        Twb1, v1 = pre.predict(np.eye(4), np.array([1.0, 0.0, 0.0]), 9.81)
        np.testing.assert_allclose(Twb1[:3, :3], np.eye(3), atol=tol)
        np.testing.assert_allclose(Twb1[:3, 3], [0.5, 0, 0], atol=10 * tol)
        np.testing.assert_allclose(v1, [1.0, 0, 0], atol=10 * tol)
