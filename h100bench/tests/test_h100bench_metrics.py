"""The metric arithmetic: the rate is over the whole window and the tail
over every frame, so a stall planted in a synthetic record moves both; the
per-layer readers read the record and find nothing where it holds
nothing."""
import importlib.util
from pathlib import Path

import pytest

import run

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def frames(n_sets=100, period=0.25, cams=4, latency=0.5, stall_at=None, stall=0.0):
    """A steady loop's bus frames: one frame-set a period, each camera's
    frame received ``latency`` after its capture; a stall delays every
    frame-set from ``stall_at`` on."""
    out, t = [], 0.0
    for i in range(n_sets):
        if i == stall_at:
            t += stall
        for c in range(cams):
            out.append({"camera_id": c, "t_capture_camera": t, "t_receive": t + latency
                        + (stall if i == stall_at else 0.0)})
        t += period
    return out


def test_rate_over_the_whole_window_and_tail_over_every_frame():
    seconds = 25.0
    steady = run.rate_and_tail(run.window_frames(frames(), 0.0, seconds), seconds)
    assert steady["frames_per_s"] == pytest.approx(16.0)
    assert steady["latency_p95_ms"] == pytest.approx(500.0)
    stalled = run.rate_and_tail(
        run.window_frames(frames(stall_at=50, stall=2.0), 0.0, seconds), seconds)
    # the stall costs the frame-sets it pushed out of the window ...
    assert stalled["frames_per_s"] == pytest.approx(16.0 - 4 * 8 / seconds)
    # ... and its frames' wait, a handful of 400, still shows at the 95th
    # percentile only when it is more than 5 % of the frames: plant 6 stalls
    many = frames()
    for f in many[200:232]:
        f["t_receive"] += 2.0
    tail = run.rate_and_tail(run.window_frames(many, 0.0, seconds), seconds)
    assert tail["latency_p95_ms"] > 2000.0
    assert tail["latency_p50_ms"] == pytest.approx(500.0)


def test_window_takes_frames_by_capture_time():
    fs = frames(n_sets=10, period=1.0, cams=1)
    assert [f["t_capture_camera"] for f in run.window_frames(fs, 2.0, 5.0)] == [2.0, 3.0, 4.0]


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record(profiled=True):
    host = {"spans": {"read": [(0.0, 0.001), (1.0, 1.003)],
                      "dispatch": [(0.001, 0.201), (1.003, 1.203)],
                      "finish": [(0.201, 0.209), (1.203, 1.207)]},
            "frame_sets": 2, "seconds": 2.0, "cpu_s": 0.5}
    prof = None
    if profiled:
        prof = {"window": (10.0, 11.0), "frame_sets": 4,
                "spans": {"read": [], "dispatch": [(10.0, 10.9)], "finish": []},
                "device": [(10.1, 10.2, "void band_pass_kernel(float const*)"),
                           (10.15, 10.25, "void at::native::reduce_kernel<512>()"),
                           (10.5, 10.6, "Memcpy HtoD (Pageable -> Device)")],
                "calls": [("band_pass", 3.35e8, 0.0)]}
    return {"host": host, "profiled": prof}


def test_readers():
    rec = record()
    assert _reader("read_ms")(rec) == pytest.approx(2.0)
    assert _reader("dispatch_ms")(rec) == pytest.approx(200.0)
    assert _reader("finish_ms")(rec) == pytest.approx(6.0)
    assert _reader("host_cpu_ms")(rec) == pytest.approx(250.0)
    assert _reader("launches_per_frameset")(rec) == pytest.approx(0.75)
    assert _reader("device_idle_share")(rec) == pytest.approx(75.0)
    # 3.35e8 bytes need 0.1 ms; band_pass_kernel was busy 100 ms
    assert _reader("kernels_roofline")(rec) == pytest.approx(0.1)


@pytest.mark.parametrize("name", ["launches_per_frameset", "device_idle_share",
                                  "kernels_roofline"])
def test_device_readers_find_nothing_without_a_profile(name):
    assert _reader(name)(record(profiled=False)) is None


def test_roofline_reads_nothing_without_a_kernel_of_the_twelve():
    rec = record()
    rec["profiled"]["device"] = [d for d in rec["profiled"]["device"] if "band_pass" not in d[2]]
    assert _reader("kernels_roofline")(rec) is None


def test_a_gathers_distinct_rows_are_read_before_the_profiled_part():
    torch = pytest.importorskip("torch")
    import spans as SP

    prof = SP.Profiled(torch, 0.0, lambda: None)
    idx = torch.tensor([[3, 3, 1], [4, 1, 3]])
    assert prof.distinct_rows(idx) == 3  # in the warm-up: read
    prof.active = True
    assert prof.distinct_rows(idx) == 3  # in the profiled part: from the cache
    assert prof.costs["distinct_rows_read_in_profile"] == 0
    assert prof.distinct_rows(torch.tensor([7, 7])) == 1  # a new index there is counted
    assert prof.costs["distinct_rows_read_in_profile"] == 1
