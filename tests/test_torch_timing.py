"""The port's timing utilities (``utils/timing.py``) on the CPU:
``StageTimer.measure`` against the JAX package's on the same calls,
``trace``'s Chrome trace of a traced op, the span and counter recorder
(off, on, bounded), ``stage`` as a span, and the recorder inside the
fleet's loop (test_torch_multicam_app.py's two synthetic cameras)."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from test_torch_multicam_app import FIELD, N_CAMS, PORT, _run, fleet  # noqa: F401
from vision_processor_tpu.utils.timing import StageTimer as JStageTimer
from vision_processor_tpu_torch.utils.timing import (
    NO_SPAN, RECORDER, Recorder, StageTimer, log_means, trace,
)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_measure_counts_as_the_jax_timer(device):
    """Returns fn's output (args and kwargs passed through) and adds one
    run to ``counts`` and its wall time to ``totals`` per call, as the JAX
    ``StageTimer.measure`` does on the same calls; the CPU records no
    device time."""
    import jax.numpy as jnp

    timer, jtimer = StageTimer(device), JStageTimer()
    x = np.arange(8, dtype=np.float32)
    calls = [("double", lambda v, k=2: v * k, {}), ("double", lambda v, k=2: v * k, {"k": 3}),
             ("sum", lambda v: v.sum(), {})]
    for name, fn, kw in calls:
        out = timer.measure(name, fn, torch.from_numpy(x), **kw)
        jout = jtimer.measure(name, fn, jnp.asarray(x), **kw)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert dict(timer.counts) == dict(jtimer.counts) == {"double": 2, "sum": 1}
    assert set(timer.totals) == set(jtimer.totals)
    assert all(t > 0 for t in timer.totals.values())
    assert timer.device_ms("double") == []
    timer.print_runtimes()
    timer.clear()
    assert not timer.totals and not timer.counts


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    """On the CPU, ``trace`` yields its directory and leaves one Chrome
    trace there holding the events of the op run inside it."""
    a = torch.ones(64, 64)
    with trace(str(tmp_path)) as log_dir:
        assert log_dir == str(tmp_path)
        torch.mm(a, a)
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_trace_raises_the_block_error_and_still_writes(tmp_path):
    """An error in the block leaves it; the trace up to it is written."""
    with pytest.raises(ValueError, match="in the block"):
        with trace(str(tmp_path)):
            torch.ones(4).add_(1)
            raise ValueError("in the block")
    events = json.loads(next(tmp_path.iterdir()).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::add_" for e in events)


# -- the span and counter recorder ------------------------------------------

@pytest.fixture
def no_device(monkeypatch):
    """Every CUDA event, launch and sync raises, and every torch operation
    is counted."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def refuse(*args, **kwargs):
        raise AssertionError("touched the device")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)

    class Ops(TorchDispatchMode):
        seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.seen.append(func)
            return func(*args, **(kwargs or {}))

    return Ops


def test_recorder_off_records_and_allocates_nothing(no_device):
    """Off (the default), every call returns at once: one shared no-op span,
    no record, no torch operation, no CUDA event or sync, and the same
    memory after 1,000 frame-sets of calls."""
    import tracemalloc

    from vision_processor_tpu_torch.utils import timing

    rec = Recorder()
    active = torch.ones(3, dtype=torch.bool)

    def frame_set():
        rec.begin_frame_set()
        with rec.span("dispatch") as outer, rec.span("step.blobs", camera=1):
            assert outer is NO_SPAN
        rec.count("rebuild.step", 1)
        rec.record("pending", rec.mark(), rec.mark(), 1)
        assert rec.rounds("kmeans", 24) is None
        rec.reduce_rounds()
        rec.read_rounds(1)

    assert not rec.on and rec.span("x") is NO_SPAN
    def held():  # bytes the recorder's module holds, allocated since the start
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, timing.__file__)])
        return sum(t.size for t in snap.traces)

    with no_device():
        tracemalloc.start()
        try:
            frame_set()
            before = held()
            for _ in range(1000):
                frame_set()
            grown = held() - before
        finally:
            tracemalloc.stop()
    assert grown == 0 and before == 0 and no_device.seen == [] and active.all()
    assert rec.drain() == {"spans": [], "counts": [], "dropped": 0}
    assert rec.frame_set == 0


def test_recorder_records_parents_frame_sets_cameras_and_threads(no_device, caplog):
    """On: a span's parent is the span open on its thread, unless given;
    camera and frame-set come from it too; a span in another thread given
    its parent keeps its own thread; host spans touch no device. The
    ``VPTPU_BENCHMARK=1`` log gives each span's and counter's mean."""
    import logging
    import threading

    rec = Recorder()
    rec.enable()
    fs = rec.begin_frame_set()
    with no_device():
        with rec.span("finish") as finish:
            with rec.span("finish.copy"):
                pass

            def pool():
                with rec.span("finish.camera", camera=3, frame_set=fs, parent=finish.index):
                    with rec.span("inner"):
                        pass
            worker = threading.Thread(target=pool)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
        rec.begin_frame_set()
        with rec.span("dispatch"), rec.span("step.blobs", camera=2), rec.span("sync.tier"):
            rec.count("rebuild.grids", 1)
    assert no_device.seen == []
    drained = rec.drain()
    with caplog.at_level(logging.INFO):
        log_means(drained)
    assert "finish.camera" in caplog.text and "rebuild.grids" in caplog.text
    got = {s.name: s for s in drained["spans"]}
    main = threading.get_ident()
    assert got["finish"].parent == -1 and got["finish"].frame_set == fs == 1
    assert got["finish.copy"].parent == got["finish"].index
    cam = got["finish.camera"]
    assert (cam.parent, cam.camera, cam.frame_set) == (got["finish"].index, 3, 1)
    assert cam.thread != main and got["inner"].thread == cam.thread
    assert (got["inner"].parent, got["inner"].camera) == (cam.index, 3)
    tier = got["sync.tier"]
    assert (tier.parent, tier.camera, tier.frame_set) == (got["step.blobs"].index, 2, 2)
    assert got["dispatch"].camera == -1 and got["dispatch"].frame_set == 2
    for s in got.values():
        assert 0 < s.start_ns <= s.end_ns
        parent = next((p for p in got.values() if p.index == s.parent), None)
        if parent is not None:
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns


def test_recorder_buffer_is_bounded_and_counts_the_dropped():
    rec = Recorder(capacity=8)
    rec.enable()
    for i in range(15):
        rec.count("n", i)
    with rec.span("last"):
        pass
    out = rec.drain()
    assert [c.value for c in out["counts"]] == list(range(8, 15))
    assert [s.name for s in out["spans"]] == ["last"] and out["dropped"] == 8
    assert rec.drain() == {"spans": [], "counts": [], "dropped": 0}


def test_stage_without_the_flag_leaves_nothing_that_grows(no_device):
    """The App's ``stage`` over 1,000 frames with the recorder off (no
    ``VPTPU_BENCHMARK=1``): no CUDA event, no total, no record."""
    timer = StageTimer(torch.device("cuda"))
    assert not RECORDER.on
    for _ in range(1000):
        with timer.stage("device_step"):
            pass
        with timer.stage("host_finish"):
            pass
    assert not timer._events and not timer.totals and not timer.counts
    assert RECORDER.drain() == {"spans": [], "counts": [], "dropped": 0}


FLEET_SPANS = {"read", "dispatch", "dispatch.inputs", "step.blobs", "step.detect",
               "step.finalize", "step.finisher", "sync.tier", "finish", "finish.copy",
               "finish.camera", "finish.send", "stream"}


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "frame_serial"])
def test_fleet_spans_nest_in_both_dispatch_modes(tmp_path, fleet, monkeypatch, pipelined):
    """The wired fleet's run() on two cameras with the recorder on,
    pipelined (batched step) and frame-serial (staggered plan): every span
    of the fleet, each child inside its parent, the step's stages once a
    camera a frame-set and two tier reads a camera; ``pending`` in the
    pipelined loop only."""
    from collections import Counter

    monkeypatch.setenv("VPTPU_PIPELINE", "1" if pipelined else "0")
    monkeypatch.setenv("VPTPU_STAGGERED", "0" if pipelined else "1")
    RECORDER.enable()
    try:
        _run(tmp_path, fleet, f"SYNTH_TRACE{int(pipelined)}", PORT + 40 + 2 * pipelined,
             frames=3)
        out = RECORDER.drain()
    finally:
        RECORDER.disable()
    spans = out["spans"]
    names = {s.name for s in spans}
    assert names == FLEET_SPANS | ({"pending"} if pipelined else set())
    by_index = {s.index: s for s in spans}
    for s in spans:
        parent = by_index.get(s.parent)
        if parent is not None:
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns, s
            assert parent.frame_set == s.frame_set
    dispatched = sorted(s.frame_set for s in spans if s.name == "dispatch")
    assert dispatched == list(range(dispatched[0], dispatched[0] + 3))
    assert out["dropped"] == 0
    for fs in dispatched:
        per = Counter((s.name, s.camera) for s in spans if s.frame_set == fs)
        for c in range(N_CAMS):
            assert per[("step.blobs", c)] == per[("step.detect", c)] == 1
            assert per[("sync.tier", c)] == 2
            assert per[("finish.camera", c)] == per[("finish.send", c)] == 1
        assert per[("pending", -1)] == (1 if pipelined else 0)
        assert per[("finish", -1)] == per[("read", -1)] == 1
    for s in spans:
        if s.name in ("step.blobs", "step.detect"):
            assert by_index[s.parent].name == "dispatch"
        if s.name == "sync.tier":
            assert by_index[s.parent].name in ("step.blobs", "step.detect")


def test_offline_fleet_wrappers_equal_with_the_recorder_on_and_off(fleet):
    """The offline fleet, pipelined, three frame-sets: the wrappers with the
    recorder on (device counting too) equal those with it off."""
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
    from vision_processor_tpu_torch.app.processor import TrackedArrays
    from vision_processor_tpu_torch.io.camera import RawFrame
    from vision_processor_tpu_torch.net.geometry_io import (
        calibration_from_model, geometry_from_dict,
    )
    from vision_processor_tpu_torch.utils.config import VisionConfig

    geometry = geometry_from_dict(FIELD)
    geometry.calib = [calibration_from_model(m, c) for c, m in enumerate(fleet.models)]
    frames = [RawFrame(data=r, fmt="RGGB", width=960, height=720) for r in fleet.raws]

    def wrappers(on):
        configs = []
        for c in range(N_CAMS):
            cfg = VisionConfig()
            cfg.cam_id, cfg.max_blobs, cfg.stream_active = c, 128, False
            configs.append(cfg)
        app = MultiCamApp.offline(configs, device="cpu")
        for proc in app.processors:
            proc.geometry_check(960, 720, geometry, 1)
        if on:
            RECORDER.enable(device_counting=True)
        try:
            got = [app.step_frames(frames, k * 0.01, TrackedArrays.build({}, k * 0.01, 32))
                   for k in range(3)]
            got.append((True, app._finish_pending()))
            counts = RECORDER.drain()["counts"]
        finally:
            RECORDER.disable()
            app.close()
        assert got[0] == (True, None)
        return [[str(w) for w in ws] for _, ws in got[1:]], counts

    off, none = wrappers(False)
    on, counts = wrappers(True)
    assert off == on and none == []
    live = sorted(c.frame_set for c in counts if c.name == "kmeans.live_rounds")
    assert live == list(range(live[0], live[0] + 3))


def test_fleet_logs_its_spans_and_counters_under_the_benchmark_flag(tmp_path, fleet,
                                                                      monkeypatch, caplog):
    """``VPTPU_BENCHMARK=1``: the wired fleet's run() turns the recorder on
    with device counting and, at its end, logs each span's and counter's
    mean, the k-means rounds that still run among them; it leaves the
    recorder off and empty."""
    import logging

    monkeypatch.setenv("VPTPU_BENCHMARK", "1")
    try:
        with caplog.at_level(logging.INFO, logger="vision_processor_tpu_torch.utils.timing"):
            _run(tmp_path, fleet, "SYNTH_TRACE_LOG", PORT + 44, frames=3)
    finally:
        RECORDER.disable()
    logged = {r.getMessage().split()[0] for r in caplog.records
              if r.name == "vision_processor_tpu_torch.utils.timing"}
    assert {"read", "dispatch", "step.finisher", "finish.send", "pending", "kmeans.rounds",
            "kmeans.live_rounds", "rebuild.step"} <= logged
    assert not RECORDER.on and RECORDER.drain() == {"spans": [], "counts": [], "dropped": 0}
