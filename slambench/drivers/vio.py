"""Driver of the VI cells: a closed loop of one client handing a rendered
stereo-inertial stream to ``MapBuilder.add_input``, frame after frame, each
frame with its IMU rows as the VO CLI hands them over.

Set-up: the stream (rendered, distorted, stored 8-bit, with its 200 Hz IMU:
``slambench/traffic/stereo_imu_stream.py``), the program as the VO CLI
builds it from the configuration (:func:`slambench.drivers.vo.build_program`,
the camera block with ``use_imu``), and warm-up frames from the head of the
stream until the map's IMU is initialized and one local BA has run with IMU
factors, so that every frame of the window is tracked by the F = 2 VI solve
and every kernel is built. The warm-up takes at most ``warmup_max_frames``
frames; a stream whose IMU has not initialized by then is not measured
(its frames would be vision-only) and the run fails with
``imu_uninitialized`` = 1.

The window then hands the following frames over, one at a time, until
``--seconds`` have passed and the frame under way has returned; each ends
with a synchronization of the card. A stream that ends first fails the run
(``window_short_s`` above 0). A traced run profiles the window's first
``trace.frames`` frames and on until one keyframe (a VI local BA) lies
among them, at most ``trace.max_frames``, and times the rest untraced.

While the window runs, every call of ``windows.pose_only_optimization`` and
of ``windows.local_ba`` is kept (arguments and result), with the time span
and linearization biases of each IMU factor in its problem (the reference
integrates the stream's raw samples over them itself), and the warm-up's
``windows.imu_initialization``. Once the window has closed and the peak
memory is read, the program is freed and
``slambench/reference/vio_check.py`` judges what it produced.

A note on stderr gives the window's work, which the seed could change:
frames, keyframes (each a VI local BA), the window backend's LM steps, the
median latency of the frames without a keyframe, and the host's time per
launch of a small device operation measured after the window.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from slambench.drivers.vo import _sync, build_program
from slambench.harness import common, probes, trace
from slambench.traffic import stereo_imu_stream

WINDOWS = "airslam_tpu_torch.backend.windows"


class _FactorSpans:
    """For each call of ``windows.pose_only_optimization`` and of
    ``windows.local_ba`` while in place, in call order: the (start, end, bg,
    ba) of each IMU factor of its problem, in the factors' order, as the
    builder and the map read them off their preintegrations (None for a
    problem without IMU factors)."""

    def __init__(self, builder):
        import importlib

        self.pose, self.lba = [], []
        latest = {"pose": None, "lba": None}
        self._builder, m = builder, builder.map
        track, factors = builder._tracking_imu_factor, m._imu_factors

        def span(pre):
            return (pre.start_time, pre.end_time, np.array(pre.bg, np.float64),
                    np.array(pre.ba, np.float64))

        def tracking_imu_factor():
            latest["pose"] = [span(builder.preintegration)]
            return track()

        def imu_factors(frames):
            pres = (frames[k - 1].preintegration for k in range(len(frames) - 1, 0, -1))
            latest["lba"] = [span(p) for p in pres if p is not None and p.valid()]
            return factors(frames)

        builder._tracking_imu_factor = tracking_imu_factor
        m._imu_factors = imu_factors
        self._mod = importlib.import_module(WINDOWS)
        self._saved = []
        for attr, key, out in (("pose_only_optimization", "pose", self.pose),
                               ("local_ba", "lba", self.lba)):
            fn = getattr(self._mod, attr)

            def wrapper(problem, *a, _fn=fn, _key=key, _out=out, **k):
                _out.append(latest[_key] if getattr(problem, "imu", None) is not None else None)
                return _fn(problem, *a, **k)

            self._saved.append((attr, fn))
            setattr(self._mod, attr, wrapper)

    def remove(self):
        for attr, fn in self._saved:
            setattr(self._mod, attr, fn)
        del self._builder._tracking_imu_factor, self._builder.map._imu_factors


class _InitSpans:
    """For each call of ``windows.imu_initialization`` while in place: the
    (start, end, bg, ba) of each keyframe preintegration of its input, in
    order, as the map's initialization sets them to the closed-form gyro
    bias (``Preintegration.set_bias``) just before the call."""

    def __init__(self, builder):
        import importlib

        from airslam_tpu_torch.core.imu import Preintegration

        self.calls = []
        current = []
        self._builder, self._cls = builder, Preintegration
        init, set_bias = builder.map.initialize_imu, Preintegration.set_bias
        self._set_bias = set_bias

        def initialize_imu(frame):
            current.clear()
            return init(frame)

        def recorded(pre, bg, ba):
            out = set_bias(pre, bg, ba)
            current.append((pre.start_time, pre.end_time, np.array(bg, np.float64),
                            np.array(ba, np.float64)))
            return out

        builder.map.initialize_imu = initialize_imu
        Preintegration.set_bias = recorded
        self._mod = importlib.import_module(WINDOWS)
        self._fn = fn = self._mod.imu_initialization

        def imu_initialization(*a, **k):
            self.calls.append(list(current))
            return fn(*a, **k)

        self._mod.imu_initialization = imu_initialization

    def remove(self):
        self._mod.imu_initialization = self._fn
        self._cls.set_bias = self._set_bias
        del self._builder.map.initialize_imu


class _Count:
    """Counts the calls of ``module.attr`` while it is in place, those for
    which ``which(*args, **kwargs)`` holds."""

    def __init__(self, module: str, attr: str, which=lambda *a, **k: True):
        import importlib

        self.count = 0
        self._mod, self._attr = importlib.import_module(module), attr
        self._fn = fn = getattr(self._mod, attr)

        def wrapper(*a, **k):
            self.count += bool(which(*a, **k))
            return fn(*a, **k)

        setattr(self._mod, attr, wrapper)

    def remove(self):
        setattr(self._mod, self._attr, self._fn)


def _launch_us(dev, n: int = 2000) -> float:
    """The host's microseconds per launch of a one-element device addition,
    over ``n`` launches: the host's speed at the time."""
    import torch

    x = torch.zeros(1, device=dev)
    _sync(dev)
    t = time.perf_counter()
    for _ in range(n):
        x = x + 1.0
    _sync(dev)
    return 1e6 * (time.perf_counter() - t) / n


def _is_vi(call) -> bool:
    problem = call[0][0]
    return problem.imu is not None and problem.frames.Rwb.shape[0] == 2


def _keyframe_preints(builder, t0: float, t1: float):
    """(start, end, bg, ba, dR, dV, dP, dT, cov) of the preintegration of
    each keyframe inserted between the times t0 and t1, as float64 numpy."""
    out = []
    for fid in builder.map.keyframe_ids:
        kf = builder.map.keyframes[fid]
        pre = kf.preintegration
        if not (t0 <= kf.timestamp <= t1) or pre is None or not pre.valid():
            continue
        st = pre.state
        out.append((pre.start_time, pre.end_time, pre.bg.copy(), pre.ba.copy(),
                    *(x.double().cpu().numpy() for x in (st.dR, st.dV, st.dP, st.dT, st.cov))))
    return out


def run(ctx, program=None) -> int:
    """One run of a VI cell; returns the exit code. ``program``: a callable
    (config, device) → builder in place of :func:`build_program` (the fault
    tests plant a broken one)."""
    import torch

    from airslam_tpu_torch.core.imu import ImuData

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    traffic = wl["traffic"]
    gen = stereo_imu_stream
    stream = gen.generate(traffic, cfg["camera"], ctx.seed, dev)
    batches = gen.imu_batches(stream, ImuData)
    builder = (program or build_program)(cfg, dev)

    # -- warm-up: to the IMU's initialization and one VI local BA -------------
    init = probes.KeptCalls(WINDOWS, "imu_initialization")
    init_spans = _InitSpans(builder)
    vi_lba = _Count(WINDOWS, "local_ba",
                    lambda problem, *a, **k: getattr(problem, "imu", None) is not None)
    cap = min(int(traffic["warmup_max_frames"]), len(stream.timestamps))
    i, t_align, init_at = 0, None, None
    while i < cap and vi_lba.count < 1:
        left, right = gen.as_delivered(stream.images[i])
        builder.add_input(float(stream.timestamps[i]), left, right, batches[i])
        i += 1
        if builder.map.imu_initialized and init_at is None:
            init_at = i - 1
            # the map keeps the keyframes from the initialization's first on,
            # rotated into the gravity-aligned world
            t_align = min(kf.timestamp for kf in builder.map.keyframes.values())
    _sync(dev)
    vi_lba.remove()
    init_spans.remove()
    init.remove()
    if vi_lba.count < 1:
        print(f"error: the warm-up's {i} frames did not initialize the IMU and run a VI local "
              f"BA (imu_initialized {builder.map.imu_initialized})", file=sys.stderr)
        device = common.device_record(dev, ctx.chips)
        return common.emit(False, 0, 0, {}, device, [common.Check("imu_uninitialized", 1, 0)])
    first = i
    print(f"note: the IMU initialized at frame {init_at}; the warm-up ran {i} frames, "
          f"{len(builder.map.keyframe_ids)} keyframes in the map", file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.t0

    # -- the window -------------------------------------------------------------
    t_cfg = wl["trace"]
    n_min = int(t_cfg["frames"]) if ctx.trace else 0
    n_max = int(t_cfg["max_frames"]) if ctx.trace else 0
    frames, lat, vi_calls = {}, [], []
    pose = probes.KeptCalls(WINDOWS, "pose_only_optimization")
    lba = probes.KeptCalls(WINDOWS, "local_ba")
    spans = _FactorSpans(builder)
    steps = _Count("airslam_tpu_torch.backend.gn", "_assemble_and_solve")
    kf_frames = []
    prof = keep_prof = None
    t_start = time.perf_counter()
    t_trace = t_after = None
    kf_traced = 0
    while i < len(stream.timestamps):
        if not lat and n_min:
            prof = probes.start_profiler()
            t_trace = time.perf_counter()
            window_range = torch.profiler.record_function(trace.WINDOW_RANGE)
            window_range.__enter__()
        left, right = gen.as_delivered(stream.images[i])
        n_pose, n_kf, n_lba = len(pose.calls), len(builder.map.keyframe_ids), len(lba.calls)
        t1 = time.perf_counter()
        with torch.profiler.record_function(trace.FRAME_RANGE):
            frames[i] = builder.add_input(float(stream.timestamps[i]), left, right, batches[i])
            _sync(dev)
        lat.append(time.perf_counter() - t1)
        vi_calls.append(sum(_is_vi(c) for c in pose.calls[n_pose:]))
        kf_frames.append(len(lba.calls) > n_lba)
        i += 1
        if prof is not None:
            kf_traced += len(builder.map.keyframe_ids) > n_kf
            if (len(lat) >= n_min and kf_traced) or len(lat) >= n_max:
                window_range.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                t_after = time.perf_counter()
                t_trace = t_after - t_trace
                n_traced = len(lat)
                keep_prof, prof = prof, None
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    t_end = time.perf_counter()
    window_s = t_end - t_start
    pose.remove()
    lba.remove()
    spans.remove()
    steps.remove()
    n = len(lat)
    plain = [t for t, k in zip(lat, kf_frames) if not k]
    print(f"note: the window's work: {n} frames, {sum(kf_frames)} with a keyframe, "
          f"{sum(c[0][0].imu is not None for c in lba.calls)} VI local BAs, {steps.count} LM steps "
          f"of the window backend; a frame without a keyframe {1e3 * np.median(plain):.1f} ms "
          f"(median of {len(plain)}); the host {_launch_us(dev):.2f} us a launch after it",
          file=sys.stderr)
    if window_s < ctx.seconds:
        print(f"warning: the stream's {len(stream.timestamps)} frames ended {window_s:.1f} s "
              f"into the {ctx.seconds:g} s window: the cell needs more frames", file=sys.stderr)
    device = common.device_record(dev, ctx.chips)

    metrics, breakdown = {}, None
    if ctx.trace:
        if prof is not None:  # the window ended inside the traced frames
            window_range.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            t_trace = time.perf_counter() - t_trace
            n_traced, keep_prof = n, prof
        traced = first + n_traced
        tr = trace.record(keep_prof)
        reading = probes.Reading(trace=tr, frames=[frames[k] for k in range(first, traced)],
                                 probes=None, seconds=t_trace, config=cfg, device=dev,
                                 after_frames=[frames[k] for k in range(traced, i)],
                                 after_seconds=t_end - t_after if t_after else 0.0)
        metrics = common.per_layer(ctx.bench, ctx.cell["name"], reading)
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops_top(), "idle_gaps": tr.idle_by_range()}
    else:
        units = {m["name"]: m["unit"] for m in ctx.bench["end_to_end"]}
        values = {"setup_s": setup_s, "vo_fps": n / window_s}
        for m in ctx.bench["end_to_end"]:
            if m["name"] in values and ctx.cell["name"] in m.get("workloads", [ctx.cell["name"]]):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}

    # -- correctness, after the window and the peak -------------------------------
    from slambench.reference import vio_check

    chk = wl["check"]
    trajectory = builder.trajectory
    rng = np.random.default_rng(ctx.seed)
    window = list(range(first, i))
    picks = set(rng.choice(window, size=min(int(chk["frames"]), len(window)),
                           replace=False).tolist()) if window else set()
    if window:
        picks.add(window[int(np.argmax(lat))])
    picked = {k: frames[k] for k in sorted(picks)}

    def sample(calls, k):
        return [calls[j] for j in sorted(rng.choice(len(calls), size=min(int(k), len(calls)),
                                                    replace=False).tolist())]

    vi_pose = sample([(c, sp) for c, sp in zip(pose.calls, spans.pose) if _is_vi(c)],
                     chk["pose_only_calls"])
    all_vi_lba = [c for c in lba.calls if c[0][0].imu is not None]
    vi_lba_calls = sample([(c, sp) for c, sp in zip(lba.calls, spans.lba)
                           if c[0][0].imu is not None], chk["local_ba_calls"])
    # the keyframes from the initialization's first on: a short window may insert none
    kfs = _keyframe_preints(builder, t_align, float(stream.timestamps[i - 1]))
    kfs = sample(kfs, chk["keyframes"])
    t_init = (t_align, float(stream.timestamps[init_at]))
    del builder, frames, pose, lba
    if ctx.trace:
        del reading, keep_prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = vio_check.judge(
        picked, stream, trajectory, i, t_align, cfg, chk["limits"], dev,
        vi_frames_missed=sum(1 for c in vi_calls if c < 1), pose_calls=vi_pose,
        local_ba=vi_lba_calls,
        init_call=(init.calls[0], init_spans.calls[0]) if init.calls else None,
        keyframes=kfs, init_span=t_init, all_local_ba=all_vi_lba)
    checks.append(common.Check("window_short_s", max(0.0, ctx.seconds - window_s), 0.0))
    correct = bool(window) and all(c.ok for c in checks)
    return common.emit(correct, n, 0, metrics, device, checks, breakdown)
