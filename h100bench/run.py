"""The H100 benchmark of the PyTorch and CUDA port: one cell, run once.

    python h100bench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (``BENCHMARK.json``'s ``workloads``) names a deployment,
``configs/<config>.json``, and a traffic mix, ``traffic/<traffic>.json``.
The run drives the port's deployed multi-camera loop,
``vision_processor_tpu_torch.app.multicam_app.MultiCamApp.run``, built
from YAML files in the port's schema: frames go in only through the
benchmark's camera driver (``camera.py``: a capture clock with a
newest-only buffer over frames rendered before the window), detections
come out only on the multicast bus, which a child process (``bus.py``)
records. After the window the plain reference (``reference/truth.py``)
judges every frame whose capture fell in the window against the scene,
with the limits of ``limits/<workload>.json``.

Set-up is everything from the process's start to the capture of the
window's first frame; the window lasts S seconds of capture time. With
``--trace 1`` the benchmark's spans time the loop's layers over the
window's first half, and ``torch.profiler`` traces its second half.

It exits with 2 and prints no result without a CUDA device or with fewer
than the cell's cards, and with 3 when a module of JAX or of the JAX
package was loaded. Its last line on standard output is the result.
"""
from __future__ import annotations

import time

T_PROCESS = time.monotonic()


def _process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``, to the
    clock tick), 0 where that cannot be read."""
    import os

    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME)
                   - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# the start of set-up: the process's own start, before the interpreter's
T_START = T_PROCESS - _process_age()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
if str(ROOT) not in sys.path:  # the program under test: the checkout's port
    sys.path.insert(1, str(ROOT))

import guard  # noqa: E402
import rig as R  # noqa: E402
import scene as S  # noqa: E402
import spans as SP  # noqa: E402
import wire  # noqa: E402
from camera import ClockCamera, FrameClock  # noqa: E402
from reference.truth import COUNTS, NUMBERS, Truth, control_frames, judge  # noqa: E402

STAMPS = {"interpreter": T_PROCESS, "harness_imports": time.monotonic()}
DRIVER = "H100BENCH_CLOCK"
PROFILE_SHARE = 0.5  # the traced window's share under the profiler: its second half


def cell(name: str) -> tuple[dict, dict, dict, dict, dict]:
    """(workload, config, traffic, limits, BENCHMARK.json) of a cell, by
    name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    return (work, R.load_json("configs", work["config"]), R.load_json("traffic", work["traffic"]),
            R.load_json("limits", name), bench)


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _cpu_mhz(cpus) -> list:
    """The current MHz of each CPU in ``cpus`` (``/proc/cpuinfo``)."""
    mhz, cur = {}, None
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("processor"):
                    cur = int(line.split(":")[1])
                elif line.startswith("cpu MHz") and cur is not None:
                    mhz[cur] = float(line.split(":")[1])
    except OSError:
        return []
    return [mhz.get(c) for c in sorted(cpus)]


def _loadavg() -> str:
    try:
        with open("/proc/loadavg") as fh:
            return fh.read().strip()
    except OSError:
        return ""


def gpu_state() -> str:
    """The card's name, power limit and draw, clocks and temperature."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.mem,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def host_state(cpus) -> dict:
    return {"mhz": _cpu_mhz(cpus), "loadavg": _loadavg()}


class Bus:
    """The child process on the vision bus (``bus.py``)."""

    def __init__(self, group: str, port: int, packet: bytes, workdir: Path):
        self.record_path = workdir / "bus.json"
        geometry = workdir / "geometry.bin"
        geometry.write_bytes(packet)
        cmd = [sys.executable, str(HERE / "bus.py"), group, str(port), str(geometry),
               str(self.record_path)]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        line = self.proc.stdout.readline().strip()
        if line != b"ready":
            self.close()
            raise RuntimeError(f"the bus process did not start ({line!r})")

    def say(self, word: str) -> None:
        self.proc.stdin.write(word.encode() + b"\n")
        self.proc.stdin.flush()

    def finish(self) -> dict:
        self.say("finish")
        line = self.proc.stdout.readline().strip()
        self.proc.wait(timeout=30)
        if line != b"done":
            raise RuntimeError(f"the bus process ended without its record ({line!r})")
        return json.loads(self.record_path.read_text())

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)


def _bus_address() -> tuple[str, int]:
    """An administratively scoped multicast group and port of this run's
    own, so that two runs on one host never hear each other."""
    pid = os.getpid()
    return f"239.193.{(pid >> 8) & 255}.{pid & 255}", 20000 + (pid % 20000) * 2


def _quantile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def window_frames(frames: list, t_open: float, t_close: float) -> list:
    """The bus frames whose capture fell in the window [t_open, t_close)."""
    return [f for f in frames if t_open <= f["t_capture_camera"] < t_close]


def rate_and_tail(frames: list, seconds: float) -> dict:
    """``frames_per_s``: every camera's frames over the window's seconds;
    ``latency_p95_ms`` (and the median, ``latency_p50_ms``): over every
    frame, bus receive time minus capture time."""
    latency = [1e3 * (f["t_receive"] - f["t_capture_camera"]) for f in frames]
    return {"frames_per_s": len(frames) / seconds,
            "latency_p95_ms": _quantile(latency, 95) if latency else float("inf"),
            "latency_p50_ms": _quantile(latency, 50) if latency else float("inf")}


def run_cell(config: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
             torch, app_hook=None, control: bool = False) -> dict:
    """One run of a cell on ``device``: set-up, the window, the judge. Returns
    every reading; ``main`` prints them. ``app_hook(app)`` runs after the
    app is built (the benchmark's tests plant faults with it)."""
    mark = [time.monotonic()]
    parts, last = {}, T_START
    for name, t in STAMPS.items():  # the stretches before this call, as stamped
        parts[name], last = t - last, t
    parts["before_set_up"] = mark[0] - last

    def part(name):
        now = time.monotonic()
        parts[name] = now - mark[0]
        mark[0] = now

    rig = R.build_rig(config)
    workdir = Path(tempfile.mkdtemp(prefix="h100bench-"))
    cwd = os.getcwd()
    group, port = _bus_address()
    packet = wire.geometry_packet(rig.field, rig.lines, rig.arcs,
                                  [c.calibration() for c in rig.cameras])
    bus = Bus(group, port, packet, workdir)
    try:
        part("bus_process")
        from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
        from vision_processor_tpu_torch.io.camera import CameraDriver, RawFrame, register_driver
        from vision_processor_tpu_torch.ops import cuda as K

        part("import_port")
        if device.type == "cuda":
            torch.cuda.init()
            torch.zeros(1, device=device)
            torch.cuda.synchronize(device)
        part("cuda_context")
        scene = S.make_scene(rig, mix, seed)
        banks = S.render(rig, scene, seed, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            K.lib()  # the kernel library: built on a checkout's first run, else loaded
        part("inputs_and_kernels")

        warmup = int(mix["warmup_frame_sets"])
        clock = FrameClock(rig.fps, rig.n_cams, warmup, seconds)
        marks = {}
        w, h = config["optics"]["model_width"], config["optics"]["model_height"]

        class Driver(ClockCamera, CameraDriver):
            """The benchmark's camera with the port's driver surface (its
            clock, ``get_time``, is the port's own)."""

        def open_driver(cam_cfg):
            c = int(cam_cfg.id)
            return Driver(clock, c, banks[c], RawFrame, config["optics"]["raw_format"], w, h)

        register_driver(DRIVER, open_driver)
        paths = R.deployment_files(rig, workdir, group, port, port + 1, DRIVER)
        os.chdir(workdir)
        logging.getLogger().setLevel(logging.WARNING)
        app = MultiCamApp([str(p) for p in paths], device=device)
        bus.say("calibrated")
        if app_hook is not None:
            app_hook(app)
        spans = SP.Spans()
        profiled = None

        def at_end():
            marks["end"] = resource.getrusage(resource.RUSAGE_SELF)
            marks["end_t"] = time.monotonic()

        if trace:
            def at_profile():
                marks["host_end"] = resource.getrusage(resource.RUSAGE_SELF)
            profiled = SP.Profiled(torch, float("inf"), at_profile)
            profiled.install()

        def at_open():
            marks["open"] = resource.getrusage(resource.RUSAGE_SELF)
            if profiled is not None:
                profiled.t_start = clock.t_open + (1.0 - PROFILE_SHARE) * seconds

        clock.on_open = at_open
        spans.wrap(app, at_end, profiled)
        part("app")
        gc_pauses = []

        def gc_watch(phase, info, t=[0.0]):
            if phase == "start":
                t[0] = time.monotonic()
            else:
                gc_pauses.append((t[0], time.monotonic() - t[0], info["generation"]))

        gc.callbacks.append(gc_watch)
        diag = {"before": host_state(os.sched_getaffinity(0))}
        clock.start()
        app.run()
        if clock.t_open is None:
            raise RuntimeError("the window never opened: the app stopped in its warm-up")
        t_open, t_close = clock.t_open, clock.t_close
        parts["warmup"] = t_open - mark[0]
        setup_s = t_open - T_START
        diag["after"] = host_state(os.sched_getaffinity(0))
        gc.callbacks.remove(gc_watch)
        record = bus.finish()
        peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
        del app
    finally:
        os.chdir(cwd)
        bus.close()
        shutil.rmtree(workdir, ignore_errors=True)
    if device.type == "cuda":
        diag["gpu_after"] = gpu_state()
        torch.cuda.empty_cache()

    # the window's frames on the bus, and the deliveries that should be there
    frames = window_frames(record["frames"], t_open, t_close)
    delivered = sorted({(c, int(k)) for c in range(rig.n_cams)
                        for k in clock.delivered[c][clock.delivered[c] >= 0]
                        if t_open <= clock.capture_time(int(k)) < t_close})
    seen = {(f["camera_id"], round((f["t_capture_camera"] - clock.t0) * clock.fps))
            for f in frames}
    failed = [d for d in delivered if d not in seen]
    e2e = {**rate_and_tail(frames, seconds), "setup_s": setup_s}
    truth = Truth([c.calibration() for c in rig.cameras], scene.teams, scene.ids,
                  scene.robots, scene.ball, scene.robot_height, scene.ball_radius,
                  float(mix["expect_robot_margin_px"]), float(mix["expect_ball_margin_px"]))
    judged = frames if not control else control_frames(truth, delivered, clock.fps, clock.t0)
    faults = []
    numbers = judge(truth, judged, clock.fps, clock.t0, faults)
    # the control's numbers on this run's own deliveries, for the record
    stale = judge(truth, control_frames(truth, delivered, clock.fps, clock.t0), clock.fps,
                  clock.t0)

    end_t = marks.get("end_t", t_close)
    u0, u1 = marks.get("open"), marks.get("end")
    cpu_s = ((u1.ru_utime + u1.ru_stime) - (u0.ru_utime + u0.ru_stime)) if u0 and u1 else None
    host_end = marks.get("host_end", u1)
    cpu_host = ((host_end.ru_utime + host_end.ru_stime) - (u0.ru_utime + u0.ru_stime)
                if u0 and host_end else None)
    rec = SP.reduce(spans, t_open, end_t, cpu_host)
    dispatch = sorted(a for a, _ in rec["host"]["spans"]["dispatch"])
    periods = np.diff(dispatch) * 1e3 if len(dispatch) > 1 else np.array([])
    half = len(periods) // 2
    diag.update({
        "frame_sets": len(spans.host_part(t_open, end_t)["dispatch"]),
        "frames_taken_per_captured": (len(delivered) / (rig.n_cams * seconds * clock.fps)),
        "period_ms_p50": _quantile(periods, 50) if len(periods) else None,
        "period_ms_first_half": float(np.mean(periods[:half])) if half else None,
        "period_ms_second_half": float(np.mean(periods[half:])) if half else None,
        "cpu_s_window": cpu_s,
        "host_cpu_ms": 1e3 * cpu_s / max(len(dispatch), 1) if cpu_s is not None else None,
        "dispatch_ms": 1e3 * sum(b - a for a, b in rec["host"]["spans"]["dispatch"])
        / max(rec["host"]["frame_sets"], 1),
        "ctx_voluntary": u1.ru_nvcsw - u0.ru_nvcsw if u0 and u1 else None,
        "ctx_involuntary": u1.ru_nivcsw - u0.ru_nivcsw if u0 and u1 else None,
        "affinity": sorted(os.sched_getaffinity(0)),
        "gc_in_window": [sum(1 for t, _, g in gc_pauses if t_open <= t < end_t and g == gen)
                         for gen in (0, 1, 2)],
        "gc_ms_in_window": 1e3 * sum(d for t, d, _ in gc_pauses if t_open <= t < end_t),
        "dispatch_ms_quartiles": ([_quantile(np.diff(np.array(rec["host"]["spans"]["dispatch"]),
                                                     axis=1)[:, 0] * 1e3, q) for q in (25, 50, 75)]
                                  if rec["host"]["spans"]["dispatch"] else None),
        "bus_geometry_packets": record["geometry_packets_seen"],
        "counts": {k: numbers[k] for k in COUNTS},
        "control_numbers": {k: stale[k] for k in NUMBERS},
    })
    if profiled is not None:
        prof = rec["profiled"] or {}
        diag["profiler"] = {**profiled.costs, "frame_sets": prof.get("frame_sets"),
                            "events": len(prof.get("device", [])),
                            "calls": len(prof.get("calls", [])),
                            "window_s": (prof["window"][1] - prof["window"][0]) if prof else None}
    return {"e2e": e2e, "numbers": numbers, "attempted": len(delivered), "failed": len(failed),
            "record": rec, "setup_parts": parts, "diag": diag, "memory_peak_bytes": int(peak),
            "frames": len(frames), "faults": faults,
            "forbidden": guard.forbidden_modules(list(sys.modules))}


def checks(numbers: dict, failed: int, limits: dict) -> dict:
    """Each compared number beside its limit, the frames that never reached
    the bus last (limit 0)."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    out["failed_frames"] = {"value": failed, "limit": 0}
    return out


def is_correct(compared: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the reference's control in the program's place")
    args = ap.parse_args(argv)
    work, config, mix, limits, bench = cell(args.workload)

    STAMPS["cell_files"] = time.monotonic()
    import torch

    STAMPS["import_torch"] = time.monotonic()
    need = int(work["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    STAMPS["cuda_query"] = time.monotonic()
    if found < need:
        print(f"h100bench: the cell needs {need} CUDA device(s); {found} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = run_cell(config, mix, args.seed, args.seconds, bool(args.trace), device, torch,
                   control=args.control)
    if out["forbidden"]:
        print(f"h100bench: modules of JAX or the JAX package were loaded: "
              f"{out['forbidden'][:20]}", file=sys.stderr)
        return 3

    def applies(m):
        return "workloads" not in m or work["name"] in m["workloads"]

    metrics = {}
    result_device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": need, "memory_peak_bytes": out["memory_peak_bytes"]}
    breakdown = None
    if args.trace:
        for m in bench["per_layer"]:
            if applies(m):
                value = _reader(m["name"])(out["record"])
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        prof = out["record"]["profiled"]
        if prof and prof["device"]:
            a, b = prof["window"]
            busy = sum(e - s for s, e in SP.busy_intervals(prof["device"], (a, b)))
            result_device.update({"busy_s": busy, "window_s": b - a})
            gaps = sorted(SP.idle_gaps(prof), key=lambda g: -g[1])[:10]
            breakdown = {"device_ops": SP.top_device_ops(prof),
                         "idle_gaps": [list(g) for g in gaps]}
    else:
        for m in bench["end_to_end"]:
            if applies(m):
                metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    compared = checks(out["numbers"], out["failed"], limits)
    correct = is_correct(compared)

    print("h100bench-setup " + json.dumps({k: round(v, 4) for k, v in out["setup_parts"].items()}))
    print("h100bench-diag " + json.dumps({**out["diag"], **{k: out["e2e"][k] for k in out["e2e"]},
                                          "seed": args.seed, "frames": out["frames"],
                                          "control": args.control}))
    faults = out["faults"]
    if faults:
        print("h100bench-faults " + json.dumps({"count": len(faults), "first": faults[:40]},
                                                default=float))
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared
    for name, c in compared.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
