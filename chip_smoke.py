#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (vision_processor_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # the smoke
    python3 chip_smoke.py --profile  # + a torch.profiler breakdown of 3 frames
    python3 chip_smoke.py --out DIR  # long outputs (ptxas, profile, JSON) to DIR

Phases (any failure exits non-zero and prints no result line):

1. environment: torch/CUDA versions, the card's name and power limit,
   nvcc, and which of protobuf / yaml / cv2 import;
2. build: compiles the port's CUDA kernels (csrc/*.cu) from the checkout;
3. the slice: one 1080p RGGB camera (camera 0 of the bench rig: 960x540
   model, focal 900, k2 0.02, 4.5 m high, Div B field, 4 bots + ball, seed
   7, noise 1.5) through ``Processor.device_step`` -> ``finish_frame`` at
   max_blobs 2000, 32 tracked slots, resampling factor 1.25, on-device
   finishing, resample mode "auto" (must resolve to "warp"), with tracking
   fed back from the previous frame. Every frame after the first must find
   all 4 robot ids within 30 mm and the ball within 40 mm; every kernel
   must have been launched by this run (the band pass twice a frame); no
   tensor may leave the card inside ``device_step``;
4. kernels vs their plain PyTorch versions on the card, on the slice's
   own intermediates plus tie and exhausted-row cases, with times.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
per-kernel JSON record.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "smoke"  # long outputs; --out moves them
FRAMES = 10  # measured frames of the slice; the checks run on every one after the first


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------


def environment(torch) -> str:
    phase("environment")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    from vision_processor_tpu_torch.ops import cuda as K

    nvcc = subprocess.run([K._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    for mod in ("google.protobuf", "yaml", "cv2"):
        try:
            __import__(mod)
            print(f"import {mod}: ok")
        except ImportError as exc:
            print(f"import {mod}: missing ({exc})")
    return card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def build():
    phase("build")
    from vision_processor_tpu_torch.ops import cuda as K

    t0 = time.perf_counter()
    K.lib()
    secs = time.perf_counter() - t0
    print(f"built {Path(K.BUILD_INFO['path']).name} in {secs:.1f} s "
          f"(nvcc {K.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    ptxas = K.BUILD_INFO.get("ptxas", "")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "ptxas.txt").write_text(ptxas)
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line.lower():
            print("ptxas:", line.strip())


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------

FIELD = {
    "field": {
        "field_length": 9000, "field_width": 6000, "goal_width": 1000,
        "goal_depth": 180, "penalty_area_depth": 1000,
        "penalty_area_width": 2000, "boundary_width": 300,
        "center_circle_radius": 500, "line_thickness": 10,
        "ball_radius": 21.5, "max_robot_radius": 90.0,
    }
}


def bench_camera0():
    """Camera 0 of the 4-camera bench rig (bench.py build_rig), numpy only;
    the geometry is the port's plain one (no protobuf)."""
    import numpy as np

    from vision_processor_tpu_torch.io.synthetic import (
        Scene, SceneBall, SceneBot, render_raw,
    )
    from vision_processor_tpu_torch.models.camera import (
        CameraModel, visible_field_extent_estimation,
    )
    from vision_processor_tpu_torch.net.geometry_io import (
        calibration_from_model, geometry_from_dict,
    )

    width, height, n_cams = 960, 540, 4
    geometry = geometry_from_dict(FIELD)
    rng = np.random.default_rng(7)
    lo, hi = visible_field_extent_estimation(0, n_cams, geometry.field, False)
    center = (lo + hi) / 2
    model = CameraModel(
        focal_length=900.0,
        principal_point=np.array([width / 2, height / 2]),
        distortion_k2=0.02,
        pos=np.array([center[0], center[1], 4500.0]),
        size=np.array([width, height]),
    )
    geometry.calib = [calibration_from_model(model, 0)]
    bots = []
    for i in range(4):
        bx = float(rng.uniform(lo[0] + 400, hi[0] - 400))
        by = float(rng.uniform(lo[1] + 400, hi[1] - 400))
        bots.append(SceneBot(i % 16, "yellow" if i % 2 == 0 else "blue", bx, by,
                             float(rng.uniform(-3, 3))))
    scene = Scene(bots=bots, balls=[SceneBall(float(center[0]), float(center[1]))],
                  noise_sigma=1.5, seed=0)
    raw = render_raw(model, geometry.field, scene, "RGGB")
    return geometry, scene, raw, (width, height)


class Recorder:
    """Keeps the inputs of each kernel wrapper's calls on a recorded frame
    (the originals still run; launch counts are unchanged)."""

    def __init__(self):
        import vision_processor_tpu_torch.ops.blob_fused as BF
        import vision_processor_tpu_torch.ops.topk as T
        import vision_processor_tpu_torch.ops.warp as W

        self.on = False
        self.calls = {"band_pass": [], "blob_response_fused": [], "row_topk": [],
                      "query_select_topk": []}
        for mod, name in ((W, "band_pass"), (BF, "blob_response_fused"),
                          (T, "row_topk"), (T, "query_select_topk")):
            setattr(mod, name, self._wrap(name, getattr(mod, name)))

    def _wrap(self, name, fn):
        def rec(*args, **kwargs):
            if self.on:
                keep = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
                self.calls[name].append((keep, dict(kwargs)))
            return fn(*args, **kwargs)
        rec.__wrapped__ = fn
        return rec


def audit_device_step(torch, fn):
    """Runs fn under a dispatch mode that counts device->host reads: returns
    (result, n_item_reads, [names of ops that moved a CUDA tensor to the
    host])."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Audit(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.items = 0
            self.d2h = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.aten._local_scalar_dense.default:
                self.items += 1
                return out
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
            if any(t.is_cuda for t in ins) and any(not t.is_cuda for t in outs):
                self.d2h.append(str(func))
            return out

    with Audit() as audit:
        res = fn()
    return res, audit.items, audit.d2h


def run_slice(torch, profile: bool):
    phase("slice")
    import numpy as np

    from vision_processor_tpu_torch.app.processor import (
        Processor, TrackedArrays, VisionConfig,
    )
    from vision_processor_tpu_torch.ops import cuda as K
    from types import SimpleNamespace

    geometry, scene, raw, (width, height) = bench_camera0()
    cfg = VisionConfig()
    cfg.max_blobs = 2000
    cfg.resampling_factor = 1.25
    cfg.device_finish = True
    cfg.resample_mode = "auto"
    cfg.stream_active = False
    dev = torch.device("cuda", 0)
    proc = Processor(cfg, max_tracked=32, device=dev)
    proc.geometry_check(width, height, geometry, 1)
    recorder = Recorder()

    truth = {(b.bot_id + (16 if b.team == "blue" else 0)): b for b in scene.bots}
    ball = scene.balls[0]

    def tracked_from(wrapper, now):
        ents = []
        det = wrapper.detection
        for team, off in ((det.robots_yellow, 0), (det.robots_blue, 16)):
            for r in team:
                ents.append(SimpleNamespace(
                    id=r.robot_id + off, x=r.x, y=r.y, z=r.height, w=r.orientation,
                    vx=0.0, vy=0.0, vw=0.0, timestamp=now))
        return TrackedArrays.build({0: ents}, now, proc.det_cfg.max_tracked)

    # one warm-up frame (first-use allocations, kernel build already done)
    tracked = TrackedArrays.build({}, 0.0, proc.det_cfg.max_tracked)
    proc.finish_frame(proc.device_step(raw, "RGGB", tracked), 0.0)
    bm = proc._bm_cfg
    if proc.resample_mode != "warp":
        fail(f"resample mode resolved to {proc.resample_mode!r}, expected 'warp'")
    print(f"flat grid {bm.flat_shape}, planes {bm.plane_shape}, o={bm.grad_offset} "
          f"r={bm.sat_radius} dr={bm.disc_radius}, mode {proc.resample_mode}")

    K.reset_launches()
    device_ms, frame_ms = [], []
    tracked = TrackedArrays.build({}, 0.0, proc.det_cfg.max_tracked)
    items_per_frame = None
    for f in range(FRAMES):
        now = f * 0.01
        recorder.on = f == FRAMES - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if f == 1:
            out, items_per_frame, d2h = audit_device_step(
                torch, lambda: proc.device_step(raw, "RGGB", tracked))
            if d2h:
                fail(f"tensors left the card inside device_step: {sorted(set(d2h))}")
        else:
            out = proc.device_step(raw, "RGGB", tracked)
        end.record()
        for part in out:
            for k, v in part.items():
                if not v.is_cuda:
                    fail(f"device_step output {k} is not on the card")
        wrapper, blobs, det = proc.finish_frame(out, now)
        wall = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if f != 1:  # frame 1 runs under the device->host audit: not timed
            frame_ms.append(wall)
            device_ms.append(start.elapsed_time(end))
        recorder.on = False

        d = wrapper.detection
        found = {}
        for team, off in ((d.robots_yellow, 0), (d.robots_blue, 16)):
            for r in team:
                found[r.robot_id + off] = (r.x, r.y)
        errs = []
        for bid, b in truth.items():
            if bid not in found:
                errs.append(float("inf"))
            else:
                errs.append(float(np.hypot(found[bid][0] - b.x, found[bid][1] - b.y)))
        berr = min((float(np.hypot(b.x - ball.x, b.y - ball.y)) for b in d.balls),
                   default=float("inf"))
        print(f"frame {f}: {int(blobs['count'])} candidates, "
              f"{int(blobs['valid'].sum())} blobs, bots {sorted(found)} "
              f"max bot err {max(errs):.2f} mm, ball err {berr:.2f} mm, "
              f"device {start.elapsed_time(end):.3f} ms, frame {wall:.3f} ms")
        if f > 0:
            if not set(truth) <= set(found) or max(errs) > 30.0:
                fail(f"frame {f}: robots {sorted(found)} vs {sorted(truth)}, "
                     f"max error {max(errs):.2f} mm")
            if berr > 40.0:
                fail(f"frame {f}: ball error {berr:.2f} mm")
        tracked = tracked_from(wrapper, now + 0.01)

    launches = dict(K.LAUNCHES)
    print(f"launches in {FRAMES} frames: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the slice")
    if launches["band_pass"] != 2 * FRAMES:
        fail(f"band_pass launched {launches['band_pass']} times, expected {2 * FRAMES}")
    print(f"device->host reads inside device_step: {items_per_frame} per frame; "
          f"no tensor left the card")
    med_dev = statistics.median(device_ms)
    med_frame = statistics.median(frame_ms)
    print(f"median device ms per frame {med_dev:.3f} (CUDA events around device_step); "
          f"median frame-serial wall ms {med_frame:.3f} -> {1e3 / med_frame:.1f} fps "
          f"({len(frame_ms)} frames; the audited frame 1 is left out)")

    prof = None
    if profile:
        prof = profile_frames(torch, proc, raw, tracked)
    return {
        "launches": launches, "calls": recorder.calls, "device_ms": device_ms,
        "frame_ms": frame_ms, "items_per_frame": items_per_frame, "profile": prof,
    }


STAGES = (
    ("app.processor", "blob_machine", "blob machine"),
    ("ops.warp", "resample_flat_warp", "  resample (warp, B1 x2)"),
    ("ops.pipeline", "blob_response_map", "  blob response (B2)"),
    ("ops.blob", "extract_blobs_scored", "  compaction + extraction (B3)"),
    ("app.processor", "detect", "detect"),
    ("models.detector", "detection_hypotheses", "  detection hypotheses (B4 ring)"),
    ("models.detector", "tracked_hypotheses", "  tracked hypotheses (B4 tracked)"),
    ("models.detector", "clipping_nms", "  clipping NMS (64-step loop)"),
    ("app.processor", "estimate_bot_ids", "first-pass ids (k-means, 24 rounds)"),
    ("app.processor", "finish_on_device", "on-device finishing"),
    ("models.device_finish", "update_colors_device", "  color update (2 k-means)"),
    ("app.processor", "to_numpy", "device->host fetch"),
)


def stage_times(torch, proc, raw, tracked, frames: int = 5) -> dict:
    """Host wall ms per stage with a device fence at each stage boundary
    (nested stages are included in their parents)."""
    import importlib

    totals = {label: 0.0 for _, _, label in STAGES}
    patched = []
    for mod_name, fn_name, label in STAGES:
        mod = importlib.import_module(f"vision_processor_tpu_torch.{mod_name}")
        fn = getattr(mod, fn_name)

        def timed(*a, _fn=fn, _label=label, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            totals[_label] += (time.perf_counter() - t0) * 1e3
            return out

        setattr(mod, fn_name, timed)
        patched.append((mod, fn_name, fn))
    try:
        t0 = time.perf_counter()
        for _ in range(frames):
            proc.finish_frame(proc.device_step(raw, "RGGB", tracked), 0.0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / frames
    finally:
        for mod, fn_name, fn in patched:
            setattr(mod, fn_name, fn)
    print(f"per-stage host ms per frame (fenced; frame {wall:.3f} ms):")
    for label, total in totals.items():
        print(f"  {label:40s} {total / frames:8.3f}")
    return {label: total / frames for label, total in totals.items()} | {"frame": wall}


def profile_frames(torch, proc, raw, tracked):
    phase("profile")
    from torch.profiler import ProfilerActivity, profile

    stages = stage_times(torch, proc, raw, tracked)

    for _ in range(2):
        proc.finish_frame(proc.device_step(raw, "RGGB", tracked), 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            proc.finish_frame(proc.device_step(raw, "RGGB", tracked), 0.0)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "profile.txt").write_text(table)
    # device work = kernels and copies on the card (not the aten:: ops
    # that launched them); busy share = union of their intervals / wall
    dev_us = _busy_us(prof.events())
    n_dev = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    kern = sorted((e for e in events if not e.key.startswith("aten::")),
                  key=lambda e: -e.self_device_time_total)[:12]
    print(f"3 frames: wall {wall:.3f} ms, device busy {dev_us / 1e3:.3f} ms "
          f"({100.0 * dev_us / 1e3 / wall:.1f} % busy), {n_dev} device events")
    for e in kern:
        print(f"  {e.key[:70]:70s} {e.self_device_time_total / 3e3:8.3f} ms/frame "
              f"x{e.count // 3}")
    return {"wall_ms": wall, "device_ms": dev_us / 1e3, "stages": stages}


# ---------------------------------------------------------------------------
# phase 4: kernels vs plain versions
# ---------------------------------------------------------------------------


def _busy_us(events) -> float:
    """Union of the intervals of device-side events (kernels, copies), us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type.name == "CUDA")
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy


def time_fn(torch, fn, reps: int = 20) -> tuple[float, float]:
    """(device busy ms per call from the profiler's kernel records, median
    CUDA-event span ms per call). The span also holds any wait for the host
    to launch; the busy time is what the card itself spent."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        spans.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return _busy_us(prof.events()) / 1e3 / reps, statistics.median(spans)


def _add(a, b) -> tuple[float, float]:
    return (a[0] + b[0], a[1] + b[1])


def _fmt(t) -> str:
    return f"{t[1]:.4f} ms span ({t[0]:.4f} ms busy)"


def ulp_close(torch, a, b, n_ulp: int) -> bool:
    fin = torch.isfinite(a) & torch.isfinite(b)
    same_inf = (a == b) | fin
    if not bool(same_inf.all()):
        return False
    spacing = torch.abs(torch.nextafter(b, torch.full_like(b, float("inf"))) - b)
    return bool((torch.abs(a - b)[fin] <= n_ulp * spacing[fin]).all())


def check_kernels(torch, rec) -> list:
    phase("kernels vs plain")
    from vision_processor_tpu_torch.ops import blob_fused as BF
    from vision_processor_tpu_torch.ops import topk as T
    from vision_processor_tpu_torch.ops import warp as W

    band_pass = W.band_pass.__wrapped__
    fused = BF.blob_response_fused.__wrapped__
    row_topk = T.row_topk.__wrapped__
    query = T.query_select_topk.__wrapped__
    calls = rec["calls"]
    results = []

    # B1: both warp passes of the recorded frame
    errs, shapes = [], []
    t_k = t_p = (0.0, 0.0)
    for (src, pos), _ in calls["band_pass"]:
        got = band_pass(src, pos)
        want = W._band_pass_plain(src, pos)
        errs.append(float((got - want).abs().max()))
        t_k = _add(t_k, time_fn(torch, lambda: band_pass(src, pos)))
        t_p = _add(t_p, time_fn(torch, lambda: W._band_pass_plain(src, pos)))
        shapes.append(f"src {tuple(src.shape)} pos {tuple(pos.shape)}")
    err = max(errs)
    print(f"B1 band_pass ({'; '.join(shapes)}): max abs err {err:.3g} (tol 1e-3); "
          f"per frame (2 passes) kernel {_fmt(t_k)} vs plain {_fmt(t_p)}")
    if not err <= 1e-3:
        fail("band_pass disagrees with its plain version")
    results.append(("band_pass", "vision_processor_tpu_torch/csrc/warp.cu",
                    "vision_processor_tpu/ops/warp.py:54", err, t_k, t_p))

    # B2: the recorded flat map
    (flat, th, o, r, dr), _ = calls["blob_response_fused"][0]
    ms_k, circ_k, means_k, _ = fused(flat, th, o, r, dr)
    ms_p, circ_p, means_p = BF._blob_response_fused_plain(flat, th, o, r, dr)
    scale = float(circ_p.abs().max()) + 1.0
    circ_rel = float((circ_k - circ_p).abs().max()) / scale
    fin = torch.isfinite(ms_p)
    mask_eq = bool(((ms_k > float("-inf")) == fin).all())
    both = fin & torch.isfinite(ms_k)
    ms_rel = float(((ms_k - ms_p).abs()[both] / (ms_p.abs()[both] + 1.0)).max()) \
        if bool(both.any()) else 0.0
    mean_err = max(float((a - b).abs().max()) for a, b in zip(means_k, means_p))
    err = max(float((circ_k - circ_p).abs().max()), mean_err,
              float((ms_k - ms_p).abs()[both].max()) if bool(both.any()) else 0.0)
    t_k = time_fn(torch, lambda: fused(flat, th, o, r, dr))
    t_p = time_fn(torch, lambda: BF._blob_response_fused_plain(flat, th, o, r, dr))
    print(f"B2 blob_response_fused (flat {tuple(flat.shape)}, o={o} r={r} dr={dr}): "
          f"circ rel err {circ_rel:.3g} (tol 1e-5), score rel err {ms_rel:.3g} "
          f"(tol 1e-5), masks equal {mask_eq}, mean abs err {mean_err:.3g} "
          f"(tol 1e-3); kernel {_fmt(t_k)} vs plain {_fmt(t_p)}")
    if not (circ_rel <= 1e-5 and ms_rel <= 1e-5 and mask_eq and mean_err <= 1e-3):
        fail("blob_response_fused disagrees with its plain version")
    results.append(("blob_response_fused", "vision_processor_tpu_torch/csrc/blob_fused.cu",
                    "vision_processor_tpu/ops/blob_pallas.py:102", err, t_k, t_p))

    # B3: the recorded masked map, plus ties and exhausted rows
    (masked, mm), _ = calls["row_topk"][0]
    cases = [("slice", masked, mm)]
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(432, 770, device="cuda", generator=g)
    x[torch.rand(432, 770, device="cuda", generator=g) < 0.97] = float("-inf")
    x[3] = float("-inf")
    x[5, 7] = x[5, 200] = x[5, 600] = 2.5
    x[9, :] = 1.0
    for m in (6, 19):
        cases.append((f"ties/exhausted m={m}", x, m))
    err = 0.0
    for label, xx, m in cases:
        v_k, i_k = row_topk(xx, m)
        v_p, i_p = T._row_topk_plain(xx, m)
        ok_v = bool(((v_k == v_p) | (torch.isinf(v_k) & torch.isinf(v_p))).all())
        valid = v_p > float("-inf")
        ok_i = bool((i_k[valid] == i_p[valid]).all())
        if not (ok_v and ok_i):
            fail(f"row_topk {label}: values equal {ok_v}, indices equal {ok_i}")
        if bool(valid.any()):
            err = max(err, float((v_k[valid] - v_p[valid]).abs().max()))
    t_k = time_fn(torch, lambda: row_topk(masked, mm))
    t_p = time_fn(torch, lambda: T._row_topk_plain(masked, mm))
    print(f"B3 row_topk ({tuple(masked.shape)}, m={mm}; +ties/exhausted m=6,19): values "
          f"bit-equal, indices equal where value > -inf; kernel {_fmt(t_k)} vs plain "
          f"{_fmt(t_p)}")
    results.append(("row_topk", "vision_processor_tpu_torch/csrc/topk.cu",
                    "vision_processor_tpu/ops/topk.py:109", err, t_k, t_p))

    # B4: the recorded ring (by rank) and tracked (by distance) selections
    err = 0.0
    t_k = t_p = (0.0, 0.0)
    labels = []
    seen = set()
    for (qxy, r2, bxy, rank), kw in calls["query_select_topk"]:
        m, by_rank = kw["m"], kw["by_rank"]
        if (m, by_rank, qxy.shape[0]) in seen:
            continue
        seen.add((m, by_rank, qxy.shape[0]))
        v_k, i_k = query(qxy, r2, bxy, rank, m=m, by_rank=by_rank)
        v_p, i_p = T._query_select_plain(qxy, r2, bxy, rank, m, by_rank)
        valid = v_p > float("-inf")
        if not bool(((v_k > float("-inf")) == valid).all()):
            fail("query_select_topk validity differs")
        if by_rank:
            ok_v = bool((v_k[valid] == v_p[valid]).all())
        else:
            ok_v = ulp_close(torch, v_k, v_p, 2)
        ok_i = bool((i_k[valid] == i_p[valid]).all())
        if not (ok_v and ok_i):
            fail(f"query_select_topk (m={m}, by_rank={by_rank}) disagrees")
        if bool(valid.any()):
            err = max(err, float((v_k[valid] - v_p[valid]).abs().max()))
        t_k = _add(t_k, time_fn(torch, lambda: query(qxy, r2, bxy, rank, m=m,
                                                     by_rank=by_rank)))
        t_p = _add(t_p, time_fn(torch, lambda: T._query_select_plain(qxy, r2, bxy, rank,
                                                                    m, by_rank)))
        labels.append(f"Q={qxy.shape[0]} K={bxy.shape[0]} m={m} "
                      f"{'rank' if by_rank else '-d2'}")
    # exhausted queries and exact distance ties
    qxy = torch.zeros((3, 2), device="cuda")
    bxy = torch.tensor([[3.0, 4.0], [-3.0, 4.0], [5.0, 0.0], [100.0, 0.0]], device="cuda")
    r2 = torch.tensor([1.0, 25.0, 1e6], device="cuda")
    rank = torch.tensor([1.0, 1.0, float("inf"), 0.0], device="cuda")
    for by_rank in (True, False):
        v_k, i_k = query(qxy, r2, bxy, rank, m=4, by_rank=by_rank)
        v_p, i_p = T._query_select_plain(qxy, r2, bxy, rank, 4, by_rank)
        valid = v_p > float("-inf")
        if not (bool((v_k == v_p).all()) and bool((i_k[valid] == i_p[valid]).all())):
            fail(f"query_select_topk tie/exhausted case (by_rank={by_rank}) disagrees")
    print(f"B4 query_select_topk ({'; '.join(labels)}; +ties/exhausted): rank values "
          f"bit-equal, -d2 values within 2 ulp, indices equal where valid; per frame "
          f"kernel {_fmt(t_k)} vs plain {_fmt(t_p)}")
    results.append(("query_select_topk", "vision_processor_tpu_torch/csrc/topk.cu",
                    "vision_processor_tpu/ops/topk.py:162", err, t_k, t_p))
    return results


def main() -> None:
    global OUT
    parser = argparse.ArgumentParser(description="chip smoke of the PyTorch/CUDA port")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--out", type=Path, default=OUT)
    args = parser.parse_args()
    OUT = args.out.resolve()

    if not (ROOT / "vision_processor_tpu_torch" / "csrc").is_dir():
        fail("run from a checkout of the repository: vision_processor_tpu_torch/ is missing")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs only on a GPU")
    card = environment(torch)
    build()
    rec = run_slice(torch, args.profile)
    results = check_kernels(torch, rec)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": repl,
         "launches": rec["launches"][name], "max_abs_err": err, "ms": ms[1],
         "plain_ms": pms[1], "busy_ms": ms[0], "plain_busy_ms": pms[0]}
        for name, src, repl, err, ms, pms in results
    ]}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "result.json").write_text(json.dumps({
        "card": card, "kernels": record["kernels"], "device_ms": rec["device_ms"],
        "frame_ms": rec["frame_ms"], "items_per_frame": rec["items_per_frame"],
        "profile": rec["profile"],
    }, indent=1))
    jax_mods = sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib")))
    if jax_mods:
        fail(f"the port loaded jax: {jax_mods[:5]}")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
