#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (vision_processor_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # the smoke
    python3 chip_smoke.py --profile  # + a torch.profiler breakdown of each slice
    python3 chip_smoke.py --out DIR  # long outputs (ptxas, profile, JSON) to DIR
    python3 chip_smoke.py --before DIR  # + B2-B6, E1, E5 of the checkout DIR, timed in
                                        #   turns with this checkout's

Phases (any failure exits non-zero and prints no result line):

1. environment: torch/CUDA versions, the card's name and power limit,
   nvcc, and which of protobuf / yaml / cv2 import;
2. build: compiles the port's CUDA kernels from the checkout (csrc/*.cu,
   one nvcc each, and csrc/blob_fused.cu once for each B2/B5 shape the
   smoke calls, all in parallel);
3. slice 1: one 1080p RGGB camera (camera 0 of the 4-camera bench rig, see
   ``bench_rig``) through ``Processor.device_step`` -> ``finish_frame`` at
   max_blobs 2000, 32 tracked slots, resampling factor 1.25, on-device
   finishing, resample mode "auto" (must resolve to "warp"), with tracking
   fed back from the previous frame. Every frame after the first must find
   all 4 robot ids within 30 mm and the ball within 40 mm; B1-B4 must have
   been launched by this run (the band pass twice a frame); no tensor may
   leave the card inside ``device_step``;
4. slice 2: the same camera in the other configuration: resample mode
   "gather" (kernels E4 and B7), ``VPTPU_SCOREFIRST=0`` (circularity-first
   extraction, kernel B5) and ``VPTPU_COMBO_KERNEL=1`` (the fused combo
   chain, kernel B6). The same detection bounds; E4, B7, B5, B6 and B3
   launched once a frame, B4 twice, B1 and B2 never; at most 2
   device->host reads a frame and no tensor leaving the card inside
   ``device_step``;
5. slice 3: the whole 4-camera rig as one frame-set on the card, through
   ``MultiCamApp.dispatch_frames`` -> ``finish_frames`` (the fleet without
   sockets, ``MultiCamApp.offline``) in the default configuration with
   resample mode "gather", for 10 frame-sets with tracking fed back from
   the previous one. Every frame-set after the first must find each
   camera's 4 robot ids within 30 mm and its ball within 40 mm (16 bots);
   per frame-set E4 and B7 launched 4 times, B2 and B3 4 times, B4 8 times,
   B1, B5 and B6 never; at most 2 device->host reads per camera inside the
   dispatch and no tensor leaving the card there. Then 3 frame-sets of the
   same rig in "auto" mode (must resolve to "warp": B1 8 times a frame-set,
   E4 and B7 never), and one frame-set through the staggered plan
   (``percam_core_step`` x 4 + ``staggered_tail_step``), which must equal
   the batched step;
6. slice 4: the same rig through ``parallel.multicam.batched_step`` with
   ``rs_grids=None``, the in-line projection resample (the camera
   projection per flat pixel, then kernel E2/E3), on-device finishing and
   the summaries fed back, for 10 frame-sets: 16 bots within 30 mm and
   each ball within 40 mm on every frame-set after the first; per
   frame-set E2/E3 4, B2 and B3 4, B4 8, and E4, B7, B1 never; at most 2
   device->host reads per camera in the step; the blobs equal to the
   gather-grid step's on the same frames (validity equal, field positions
   within 0.05 mm). Then 3 frame-sets at resampling factor 1.0 (flat grid
   (540, 962)), and camera 0 for one frame through ``BlobMachine`` and one
   through ``full_step(rs_grid=None)``;
   then the idle path: the single-camera ``App`` on the card under the
   default config (``wait_for_geometry`` false) takes 100 frames of camera
   0 before any geometry (frame 100 saved as the sample image), then the
   geometry packet and 10 detection frames within the same bounds, none
   sent before it (``run_idle``);
   then the calibration paths (``run_calibration``, ``run_pair_height``):
   the ``App`` under the default config gets field geometry without any
   calibration for camera 0 of the rig (line corners from its true model
   and its height in the config), calibrates on the first frame (demosaic
   on the card, fit on the host), broadcasts the model, adopts it when the
   bus brings it back and runs 10 detection frames within the same bounds
   (B1-B4 as on slice 1; whether the first of them built a kernel is
   printed); then ``MultiCamApp`` with two cameras and ``camera_height:
   0.0`` self-calibrates both, solves the rig height from the robot both
   see (within 5 % of the truth, the models kept on their field-plane
   manifold) and detects within the same bounds after it;
7. E1 and E5 at their own contracts (no production path runs them): the
   banded warp pass with window starts at its experiment's shapes, and the
   row top-k at rows-per-block 8, 32 and 64 on its experiment's shapes;
8. kernels vs their plain PyTorch versions on the card, on the slices' own
   intermediates plus tie, exhausted-row, invalid-anchor, partial-block,
   edge, GRBG, BGR and packed-plane cases, with kernel, plain and
   library-call times and each kernel's bound; E1 and E5 beside B1 and B3
   at the same shapes. E1 must be bit-equal to its plain version (NaN for
   NaN) on its contract inputs and at its edges (integer positions, 0 and
   win - 1, non-finite sources), with ``--before DIR`` also to DIR's E1
   and timed in turns with it, and is split (one block, the staging alone,
   the win-tap chain everywhere, a cold L2). B2 and B5 must be bit-equal to their plain versions
   (B2's count equal to the plain count) on the slices' maps at both
   resampling factors, at r = 2 and dr = o + r + 1, on 1x1, 3x200, 200x3
   and 37x61 maps, on a constant map and above every threshold; both are
   timed at both factors' shapes and at radii no slice uses, with their
   ``-Xptxas -v`` lines, and with ``--before DIR`` beside the B2 and B5
   of the checkout DIR (its own package and build), in turns. B3 and B4
   must equal select_m (the Pallas ``_select_m``) in every slot,
   exhausted ones included, at every list bucket of csrc/topk.cu and
   above it, on slice 1's calls, slice 4's factor-1.0 map, Q = 512 and
   tie/exhausted cases, and with ``--before DIR`` equal to DIR's B3 and
   B4 and timed in turns with them; B4's ring call is also timed at m = 1
   and with 32 blobs, and a one-element fill gives the card's launch
   floor. B6 must be bit-equal to its plain version in all six outputs on
   slice 2's call (A = 128) and at A = 512 with exact ties and invalid
   anchors, both timed (with ``--before DIR`` also equal to DIR's B6 and
   timed in turns with it). E5 must equal select_m in every slot at every
   (shape, m, rows-per-block) of its sweep and on rows too dense for its
   candidate buffer at m up to 40 (with ``--before DIR`` equal to DIR's E5
   and timed in turns with it), and prints the warps a block it chose.
   B6 and E5 print their ``-Xptxas -v`` registers.

Each slice, and the contract run of E1 and E5, is driven with the launch
counts set to 0 just before it and read just after. The last line is
``{"ok": true, "device": {...}}``; the line before it the per-kernel JSON
record.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "smoke"  # long outputs; --out moves them
FRAMES = 10  # measured frames of each slice; the checks run on every one after the first
WARP_FRAME_SETS = 3  # slice 3 in warp mode
N_CAMS = 4

# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


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


# the shapes of B2 (o, r, dr) and B5 (o, r, None) that the smoke calls:
# the slices' radii at factor 1.25 and 1.0, and the edge cases of
# _blob_cases
BLOB_SHAPES = [(1, 4, 3), (2, 5, 4), (1, 2, 1), (1, 4, 6), (2, 5, 8),
               (1, 4, None), (2, 5, None), (1, 2, None)]


def build():
    phase("build")
    from vision_processor_tpu_torch.ops import blob_fused as BF
    from vision_processor_tpu_torch.ops import cuda as K

    t0 = time.perf_counter()
    BF.build_kernels(BLOB_SHAPES)  # with the one library: every nvcc at once
    nvcc_s = K.BUILD_INFO["seconds"]
    K.lib()
    secs = time.perf_counter() - t0
    print(f"built {Path(K.BUILD_INFO['path']).name} from {len(K.sources())} sources "
          f"and csrc/blob_fused.cu at {len(BLOB_SHAPES)} B2/B5 shapes in {secs:.1f} s "
          f"(nvcc {nvcc_s:.1f} s)")
    ptxas = K.BUILD_INFO.get("ptxas", "")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "ptxas.txt").write_text("\n".join(
        [ptxas, *(K.report(_blob_lib(*shape)) for shape in BLOB_SHAPES)]))
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line.lower() or line.startswith("=="):
            print("ptxas:", line.strip())


def _blob_lib(o, r, dr=None) -> Path:
    """The library of B2 (``dr`` given) or B5 built for these radii."""
    from vision_processor_tpu_torch.ops import blob_fused as BF
    from vision_processor_tpu_torch.ops import cuda as K

    return K.shaped_target("blob_fused.cu", BF.kernel_defines(o, r, dr))[0]


# ---------------------------------------------------------------------------
# phases 3 to 5: the slices
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

# kernel wrappers, by launch-count name: (module, attribute the path calls)
WRAPPERS = {
    "band_pass": ("ops.warp", "band_pass"),
    "blob_response_fused": ("ops.blob_fused", "blob_response_fused"),
    "row_topk": ("ops.topk", "row_topk"),
    "query_select_topk": ("ops.topk", "query_select_topk"),
    "gather_corners": ("ops.frame", "gather_corners"),
    "circularity_fused": ("ops.blob_fused", "circularity_fused"),
    "combo_chain": ("ops.combo_fused", "combo_chain"),
    "corner_stack": ("ops.frame", "corner_stack"),
    "resample_packed": ("ops.pipeline", "resample_packed"),
    "band_warp": ("ops.band_warp", "band_warp"),
    "row_topk_blk": ("ops.topk", "row_topk_blk"),
}

# launches per frame on each slice's path; None: at least one in the run
SLICE1_LAUNCHES = {"band_pass": 2, "blob_response_fused": None, "row_topk": None,
                   "query_select_topk": None, "corner_stack": 0, "resample_packed": 0}
SLICE2_LAUNCHES = {"gather_corners": 1, "circularity_fused": 1, "combo_chain": 1,
                   "row_topk": 1, "query_select_topk": 2, "band_pass": 0,
                   "blob_response_fused": 0, "corner_stack": 1, "resample_packed": 0}
SLICE2_ENV = {"VPTPU_SCOREFIRST": "0", "VPTPU_COMBO_KERNEL": "1"}
# launches per frame-set of the 4-camera rig
SLICE3_LAUNCHES = {"corner_stack": 4, "gather_corners": 4, "blob_response_fused": 4,
                   "row_topk": 4, "query_select_topk": 8, "band_pass": 0,
                   "circularity_fused": 0, "combo_chain": 0, "resample_packed": 0}
SLICE3_WARP_LAUNCHES = {"band_pass": 8, "corner_stack": 0, "gather_corners": 0,
                        "blob_response_fused": 4, "query_select_topk": 8,
                        "circularity_fused": 0, "combo_chain": 0, "resample_packed": 0}
SLICE4_LAUNCHES = {"resample_packed": 4, "blob_response_fused": 4, "row_topk": 4,
                   "query_select_topk": 8, "corner_stack": 0, "gather_corners": 0,
                   "band_pass": 0, "circularity_fused": 0, "combo_chain": 0,
                   "band_warp": 0, "row_topk_blk": 0}
SLICE4_FACTOR1_FRAME_SETS = 3


def bench_rig(n_cams: int = N_CAMS):
    """The 4-camera bench rig (bench.py build_rig), numpy only: one camera
    per field quadrant (960x540 model = 1080p RGGB raw, focal 900, k2 0.02,
    4.5 m high over the Div B field), 4 bots with ids (cam * 4 + i) % 16,
    alternately yellow and blue, and a ball each, seed 7, noise 1.5. The
    geometry is the port's plain one (no protobuf) and holds every camera's
    calibration. Returns (geometry, scenes, raws, (width, height))."""
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

    width, height = 960, 540
    geometry = geometry_from_dict(FIELD)
    geometry.calib = []
    rng = np.random.default_rng(7)
    scenes, raws = [], []
    for cam_id in range(n_cams):
        lo, hi = visible_field_extent_estimation(cam_id, n_cams, geometry.field, False)
        center = (lo + hi) / 2
        model = CameraModel(
            focal_length=900.0,
            principal_point=np.array([width / 2, height / 2]),
            distortion_k2=0.02,
            pos=np.array([center[0], center[1], 4500.0]),
            size=np.array([width, height]),
        )
        geometry.calib.append(calibration_from_model(model, cam_id))
        bots = []
        for i in range(4):
            bx = float(rng.uniform(lo[0] + 400, hi[0] - 400))
            by = float(rng.uniform(lo[1] + 400, hi[1] - 400))
            bots.append(SceneBot((cam_id * 4 + i) % 16, "yellow" if i % 2 == 0 else "blue",
                                 bx, by, float(rng.uniform(-3, 3))))
        scene = Scene(bots=bots, balls=[SceneBall(float(center[0]), float(center[1]))],
                      noise_sigma=1.5, seed=cam_id)
        scenes.append(scene)
        raws.append(render_raw(model, geometry.field, scene, "RGGB"))
    return geometry, scenes, raws, (width, height)


def vision_config(mode: str, factor: float = 1.25, cam_id: int = 0):
    """A rig camera's configuration: max_blobs 2000, on-device finishing,
    the given resample mode and resampling factor, no debug stream."""
    from vision_processor_tpu_torch.utils.config import VisionConfig

    cfg = VisionConfig()
    cfg.cam_id = cam_id
    cfg.max_blobs = 2000
    cfg.resampling_factor = factor
    cfg.device_finish = True
    cfg.resample_mode = mode
    cfg.stream_active = False
    return cfg


def _offline_fleet(torch, rig, mode: str, factor: float):
    """The rig as an offline MultiCamApp on the card, geometry adopted."""
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp

    geometry, _, raws, (width, height) = rig
    configs = [vision_config(mode, factor, cam_id) for cam_id in range(len(raws))]
    app = MultiCamApp.offline(configs, device=torch.device("cuda", 0))
    for proc in app.processors:
        proc.geometry_check(width, height, geometry, 1)
    return app


def detection_errors(scene, wrapper):
    """(ids found, per-truth robot errors in mm (inf where missed), the
    ball's error in mm) of one camera's detection frame."""
    import numpy as np

    truth = {(b.bot_id + (16 if b.team == "blue" else 0)): b for b in scene.bots}
    ball = scene.balls[0]
    d = wrapper.detection
    found = {}
    for team, off in ((d.robots_yellow, 0), (d.robots_blue, 16)):
        for r in team:
            found[r.robot_id + off] = (r.x, r.y)
    errs = [float(np.hypot(found[bid][0] - b.x, found[bid][1] - b.y)) if bid in found
            else float("inf") for bid, b in truth.items()]
    berr = min((float(np.hypot(b.x - ball.x, b.y - ball.y)) for b in d.balls),
               default=float("inf"))
    return found, errs, berr


def check_detections(label: str, scene, wrapper) -> tuple[dict, float, float]:
    """Fails unless every robot id is found within 30 mm and the ball
    within 40 mm; returns (found, worst robot error, ball error)."""
    found, errs, berr = detection_errors(scene, wrapper)
    if max(errs) > 30.0:
        fail(f"{label}: robots {sorted(found)}, max error {max(errs):.2f} mm")
    if berr > 40.0:
        fail(f"{label}: ball error {berr:.2f} mm")
    return found, max(errs), berr


def tracked_from(wrappers: dict, now: float, slots: int):
    """The tracked prior from the previous frame's detection frames, by
    camera, as the UDP tracker builds it."""
    from types import SimpleNamespace

    from vision_processor_tpu_torch.app.processor import TrackedArrays

    ents = {}
    for cam, wrapper in wrappers.items():
        det = wrapper.detection
        ents[cam] = [
            SimpleNamespace(id=r.robot_id + off, x=r.x, y=r.y, z=r.height, w=r.orientation,
                            vx=0.0, vy=0.0, vw=0.0, timestamp=now)
            for team, off in ((det.robots_yellow, 0), (det.robots_blue, 16)) for r in team
        ]
    return TrackedArrays.build(ents, now, slots)


class Recorder:
    """Keeps the inputs of each kernel wrapper's calls on a recorded frame
    (the originals still run; launch counts are unchanged)."""

    def __init__(self):
        import importlib

        self.on = False
        self.calls = {name: [] for name in WRAPPERS}
        for name, (mod_name, attr) in WRAPPERS.items():
            mod = importlib.import_module(f"vision_processor_tpu_torch.{mod_name}")
            setattr(mod, attr, self._wrap(name, getattr(mod, attr)))

    def _wrap(self, name, fn):
        def rec(*args, **kwargs):
            if self.on:
                keep = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
                self.calls[name].append((keep, dict(kwargs)))
            return fn(*args, **kwargs)
        rec.__wrapped__ = fn
        return rec


class Env:
    """Sets environment variables for a block, restoring them after."""

    def __init__(self, values: dict):
        self.values = values
        self.saved = {}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def check_launches(label: str, launches: dict, want: dict, per: int) -> None:
    """want: launches per frame (or frame-set); None: at least one."""
    for name, n_per in want.items():
        n = launches[name]
        if n_per is None and n <= 0:
            fail(f"{label}: kernel {name} was not launched")
        if n_per is not None and n != n_per * per:
            fail(f"{label}: {name} launched {n} times, expected {n_per * per}")


def drive(torch, recorder, label: str, scenes, n_frames: int, want_launches: dict,
          dispatch, finish, what: str, unit: str) -> dict:
    """The measured run of a slice: ``n_frames`` frames or frame-sets, each
    ``dispatch(now)`` (the device outputs, a tuple of tensor dicts, timed
    with CUDA events as ``what``) then ``finish(out, now)`` (one detection
    wrapper per camera; it feeds the tracked prior back). Every camera's
    detections are checked after the first; the launch counts are set to 0
    just before and read just after; the second dispatch runs under the
    device->host audit (at most 2 reads per camera, no tensor leaving the
    card) and is not timed. The last one's kernel inputs are recorded."""
    from vision_processor_tpu_torch.ops import cuda as K

    n_cams = len(scenes)
    for kept in recorder.calls.values():
        kept.clear()
    K.reset_launches()
    device_ms, frame_ms = [], []
    items = None
    for f in range(n_frames):
        now = f * 0.01
        recorder.on = f == n_frames - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if f == 1:
            out, items, d2h = audit_device_step(torch, lambda: dispatch(now))
            if d2h:
                fail(f"{label}: tensors left the card inside {what}: {sorted(set(d2h))}")
        else:
            out = dispatch(now)
        end.record()
        for part in out:
            for k, v in part.items():
                if not v.is_cuda:
                    fail(f"{label}: {what} output {k} is not on the card")
        counts = out[0]["count"].reshape(-1).tolist()
        wrappers = finish(out, now)
        wall = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if f != 1:  # the audited one is not timed
            frame_ms.append(wall)
            device_ms.append(start.elapsed_time(end))
        recorder.on = False

        worst = ball_worst = 0.0
        n_bots = 0
        for cam, wrapper in enumerate(wrappers):
            found, err, berr = detection_errors(scenes[cam], wrapper)
            n_bots += sum(e <= 30.0 for e in err)
            worst, ball_worst = max(worst, max(err)), max(ball_worst, berr)
            if f > 0:
                check_detections(f"{label} {unit} {f} camera {cam}", scenes[cam], wrapper)
        print(f"{unit} {f}: candidates {counts}, bots found {n_bots}/{4 * n_cams}, max bot "
              f"err {worst:.2f} mm, max ball err {ball_worst:.2f} mm, device "
              f"{start.elapsed_time(end):.3f} ms, {unit} {wall:.3f} ms")

    launches = dict(K.LAUNCHES)
    print(f"launches in {n_frames} {unit}s: {launches}")
    check_launches(label, launches, want_launches, n_frames)
    if items is None or items > 2 * n_cams:
        fail(f"{label}: {items} device->host reads in {what}, at most {2 * n_cams}")
    print(f"device->host reads inside {what}: {items} per {unit} ({n_cams} "
          f"camera{'s' if n_cams > 1 else ''}); no tensor left the card")
    med_dev = statistics.median(device_ms)
    med_frame = statistics.median(frame_ms)
    print(f"{label}: median device ms per {unit} {med_dev:.3f} (CUDA events around "
          f"{what}); median {unit}-serial wall ms {med_frame:.3f} -> "
          f"{1e3 / med_frame:.1f} {unit}s/s ({len(frame_ms)} {unit}s; the audited {unit} "
          f"1 is left out)")
    return {
        "launches": launches, "device_ms": device_ms, "frame_ms": frame_ms,
        "median_device_ms": med_dev, "median_frame_ms": med_frame,
        "items_per_frame": items,
        "calls": {name: list(kept) for name, kept in recorder.calls.items()},
    }


def run_slice(torch, recorder, rig, label: str, mode: str, want_mode: str,
              want_launches: dict) -> dict:
    """Drive the bench rig's camera 0 through ``Processor.device_step`` ->
    ``finish_frame`` for FRAMES frames with tracking fed back."""
    phase(label)
    from vision_processor_tpu_torch.app.processor import Processor, TrackedArrays

    geometry, scenes, raws, (width, height) = rig
    raw = raws[0]
    dev = torch.device("cuda", 0)
    proc = Processor(vision_config(mode), max_tracked=32, device=dev)
    proc.geometry_check(width, height, geometry, 1)
    slots = proc.det_cfg.max_tracked

    # one warm-up frame (first-use allocations, kernel build already done)
    state = {"tracked": TrackedArrays.build({}, 0.0, slots)}
    proc.finish_frame(proc.device_step(raw, "RGGB", state["tracked"]), 0.0)
    bm = proc._bm_cfg
    if proc.resample_mode != want_mode:
        fail(f"{label}: resample mode resolved to {proc.resample_mode!r}, "
             f"expected {want_mode!r}")
    print(f"flat grid {bm.flat_shape}, planes {bm.plane_shape}, o={bm.grad_offset} "
          f"r={bm.sat_radius} dr={bm.disc_radius}, mode {proc.resample_mode}")

    def dispatch(now):
        return proc.device_step(raw, "RGGB", state["tracked"])

    def finish(out, now):
        wrapper = proc.finish_frame(out, now)[0]
        state["tracked"] = tracked_from({0: wrapper}, now + 0.01, slots)
        return [wrapper]

    res = drive(torch, recorder, label, scenes[:1], FRAMES, want_launches, dispatch,
                finish, "device_step", "frame")
    res["run"] = lambda: proc.finish_frame(dispatch(0.0), 0.0)
    return res


def run_slice3(torch, recorder, rig, label: str, mode: str, want_mode: str,
               want_launches: dict, frame_sets: int) -> dict:
    """Drive the 4-camera rig as one frame-set on the card through
    ``MultiCamApp.dispatch_frames`` -> ``finish_frames`` for ``frame_sets``
    frame-sets with tracking fed back from the previous one."""
    phase(label)
    from vision_processor_tpu_torch.app.processor import TrackedArrays
    from vision_processor_tpu_torch.io.camera import RawFrame

    _, scenes, raws, (width, height) = rig
    app = _offline_fleet(torch, rig, mode, 1.25)
    frames = [RawFrame(data=r, fmt="RGGB", width=width, height=height) for r in raws]
    slots = app.processors[0].det_cfg.max_tracked

    # one warm-up frame-set (first-use allocations, grids, markings)
    state = {"tracked": TrackedArrays.build({}, 0.0, slots)}
    app.finish_frames(app.dispatch_frames(frames, 0.0, state["tracked"]), 0.0, frames)
    bm = app.mc_cfg.bm
    if bm.resample_mode != want_mode:
        fail(f"{label}: resample mode resolved to {bm.resample_mode!r}, "
             f"expected {want_mode!r}")
    print(f"{app.n_cams} cameras, flat grid {bm.flat_shape}, planes {bm.plane_shape}, "
          f"o={bm.grad_offset} r={bm.sat_radius} dr={bm.disc_radius}, mode "
          f"{bm.resample_mode}, staggered {app.staggered}")

    def dispatch(now):
        return app.dispatch_frames(frames, now, state["tracked"])

    def finish(out, now):
        wrappers = app.finish_frames(out, now, frames)
        state["tracked"] = tracked_from(dict(enumerate(wrappers)), now + 0.01, slots)
        return wrappers

    res = drive(torch, recorder, label, scenes, frame_sets, want_launches, dispatch,
                finish, "dispatch_frames", "frame-set")
    res["run"] = lambda: app.finish_frames(dispatch(0.0), 0.0, frames)
    res["fleet"] = (app, frames, state["tracked"])
    return res


def check_staggered(torch, app, frames, tracked) -> None:
    """One frame-set through the staggered plan against the batched step,
    from the same colour state: ids, validity and ball sets equal, floats
    within the CPU test's tolerance (tests/test_torch_multicam.py)."""
    phase("slice 3: staggered plan vs batched step")
    import numpy as np

    from vision_processor_tpu_torch.utils.state import to_numpy

    colors = app._colors_dev
    outs = {}
    for staggered in (False, True):
        app._colors_dev = colors
        app.staggered = staggered
        outs[staggered] = to_numpy(app.dispatch_frames(frames, 0.0, tracked))
    app.staggered = False
    (b_blobs, b_det, b_fin), (s_blobs, s_det, s_fin) = outs[False], outs[True]
    try:
        np.testing.assert_array_equal(b_blobs["count"], s_blobs["count"])
        np.testing.assert_array_equal(b_blobs["field_pos"], s_blobs["field_pos"])
        for key in ("bot_valid", "bot_blob_idx"):
            np.testing.assert_array_equal(b_det[key], s_det[key])
        np.testing.assert_allclose(b_det["bot_pos"], s_det["bot_pos"], atol=1e-3)
        np.testing.assert_allclose(b_det["bot_score"], s_det["bot_score"], atol=1e-4)
        for key in ("bot_valid", "bot_id", "ball_valid", "colors7"):
            np.testing.assert_array_equal(b_fin[key], s_fin[key])
    except AssertionError as exc:
        fail(f"the staggered plan differs from the batched step: {exc}")
    same = all(np.array_equal(b_det[k], s_det[k]) for k in ("bot_pos", "bot_score"))
    print(f"staggered == batched: ids {[sorted(set(r[v].tolist())) for r, v in zip(s_fin['bot_id'], s_fin['bot_valid'])]}, "
          f"balls {s_fin['ball_valid'].sum(axis=-1).tolist()}; positions and scores "
          f"{'bit-equal' if same else 'within 1e-3 / 1e-4'}")


def run_slice4(torch, recorder, rig, label: str, factor: float, frame_sets: int) -> dict:
    """Drive the 4-camera rig through ``parallel.multicam.batched_step`` with
    ``rs_grids=None`` (the in-line projection resample) and on-device
    finishing for ``frame_sets`` frame-sets, the summaries and the colour
    table fed back; the wrappers come from the fleet's host finishing. Then
    the blobs of the last frame-set against the gather-grid step's."""
    phase(label)
    import numpy as np

    from vision_processor_tpu_torch.app.processor import TrackedArrays
    from vision_processor_tpu_torch.io.camera import RawFrame
    from vision_processor_tpu_torch.parallel.multicam import batched_step, empty_summary
    from vision_processor_tpu_torch.utils.state import to_numpy, to_torch

    _, scenes, raws, (width, height) = rig
    app = _offline_fleet(torch, rig, "gather", factor)
    dev = app.device
    frames = [RawFrame(data=r, fmt="RGGB", width=width, height=height) for r in raws]
    slots = app.processors[0].det_cfg.max_tracked
    if not app._ensure_step("RGGB", raws[0].shape):
        fail(f"{label}: the fleet is not calibrated")
    # the fleet's inputs on the card; the gather grids are kept for the
    # comparison after the run, and the in-line step never reads them
    state, grids = app._device_inputs(TrackedArrays.build({}, 0.0, slots))
    fleet = app._fleet_params()
    fleet["tracked_time_delta"] = np.float32(0.01)
    params = to_torch(fleet, dev)
    cfg = app.mc_cfg
    step = batched_step(cfg)
    raws_t = torch.from_numpy(np.stack(raws)).to(dev)
    bm = cfg.bm
    print(f"{cfg.n_cams} cameras, factor {factor}, flat grid {bm.flat_shape}, planes "
          f"{bm.plane_shape}, o={bm.grad_offset} r={bm.sat_radius} dr={bm.disc_radius}, "
          f"rs_grids=None (in line)")

    def run(colors, summary, prev, rs_grids=None):
        return step(raws_t, state["packed"], state["scales"], state["offsets"], colors,
                    summary, params, rs_grids, prev, state["refs"], app._marks)

    def finish(out, now):
        blobs, det, summary, fin = out
        wrappers = app.finish_frames((blobs, det, fin), now, frames)
        carry.update(last=carry["in"], wrappers=wrappers)
        carry["in"] = (fin["colors7"], summary, carry["in"][1])
        return wrappers

    empty = empty_summary(cfg, dev)
    carry = {"in": (state["colors"], empty, empty)}
    finish(run(*carry["in"]), 0.0)  # warm-up (first-use allocations)
    carry["in"] = (state["colors"], empty, empty)
    res = drive(torch, recorder, label, scenes, frame_sets, SLICE4_LAUNCHES,
                lambda now: run(*carry["in"]), finish, "batched_step", "frame-set")

    # the gather-grid step on the same frames: the same blobs
    inline = to_numpy(run(*carry["last"])[0])
    cached = to_numpy(run(*carry["last"], rs_grids=grids)[0])
    same_valid = bool(np.array_equal(inline["valid"], cached["valid"]))
    v = inline["valid"]
    dpos = float(np.abs(inline["field_pos"][v] - cached["field_pos"][v]).max()) \
        if v.any() else 0.0
    print(f"in line vs gather grid: validity equal {same_valid}, counts "
          f"{inline['count'].tolist()} vs {cached['count'].tolist()}, max field_pos "
          f"difference {dpos:.6f} mm (tol 0.05)")
    if not (same_valid and dpos <= 0.05):
        fail(f"{label}: the in-line blobs differ from the gather grid's")
    res["inline_vs_grid_mm"] = dpos
    res["last_wrappers"] = carry["wrappers"]
    res["run"] = lambda: finish(run(*carry["last"]), 0.0)
    return res


def run_one_camera(torch, rig, wrappers: list) -> None:
    """Camera 0 for one frame through ``BlobMachine`` and one through
    ``full_step(rs_grid=None)`` with on-device finishing, the tracked prior
    from slice 4's last frame-set: 4 bots within 30 mm, the ball within 40
    mm, and the two blob sets equal."""
    phase("slice 4: one camera, BlobMachine and full_step(rs_grid=None)")
    import numpy as np

    from vision_processor_tpu_torch.app.processor import Processor, full_step
    from vision_processor_tpu_torch.ops import cuda as K
    from vision_processor_tpu_torch.ops.pipeline import BlobMachine
    from vision_processor_tpu_torch.utils.state import to_numpy, to_torch

    geometry, scenes, raws, (width, height) = rig
    dev = torch.device("cuda", 0)
    proc = Processor(vision_config("gather"), max_tracked=32, device=dev)
    proc.geometry_check(width, height, geometry, 1)
    proc._ensure_config("RGGB", raws[0].shape)
    tracked = tracked_from({0: wrappers[0]}, 0.1, proc.det_cfg.max_tracked)
    params = proc.params()
    state = to_torch({"packed": proc.perspective.model.packed(),
                      "colors": proc.colors.packed(), "refs": proc.colors.packed_refs(),
                      "tracked": tracked.as_dict(), "params": params}, dev)
    machine = BlobMachine(proc._bm_cfg, device=dev)
    K.reset_launches()
    raw_t = torch.from_numpy(raws[0]).to(dev)
    bm_blobs = to_numpy(machine(raw_t, proc.perspective.model.packed(),
                                params["max_bot_height"], params["min_circularity"]))
    out = full_step(proc._bm_cfg, proc.det_cfg, raw_t, state["packed"], state["colors"],
                    state["tracked"], state["params"], None, state["refs"],
                    proc._field_marks())
    wrapper, blobs, _ = proc.finish_frame(out, 0.1)
    launches = dict(K.LAUNCHES)
    found, err, berr = check_detections("slice 4 full_step(rs_grid=None)", scenes[0],
                                        wrapper)
    if launches["resample_packed"] != 2 or launches["corner_stack"] or \
            launches["gather_corners"] or launches["band_pass"]:
        fail(f"one camera: launches {launches}, expected resample_packed 2 and no "
             f"corner_stack, gather_corners or band_pass")
    same = bool(np.array_equal(bm_blobs["valid"], blobs["valid"])) and bool(
        np.array_equal(bm_blobs["field_pos"], blobs["field_pos"]))
    if not same:
        fail("BlobMachine and full_step(rs_grid=None) disagree on camera 0's blobs")
    print(f"camera 0, flat grid {proc._bm_cfg.flat_shape}: BlobMachine {int(bm_blobs['count'])} "
          f"candidates, {int(bm_blobs['valid'].sum())} blobs, equal to full_step's; "
          f"full_step bots {sorted(found)}, max bot err {err:.2f} mm, ball err "
          f"{berr:.2f} mm; launches {launches}")


IDLE_FRAMES = 100  # the App's idle path saves frame 100 as its sample image
IDLE_AFTER = 10  # detection frames once geometry has arrived
IDLE_GROUP, IDLE_PORT = "224.99.99.61", 17611  # the App's sockets, never sent to by the smoke


def geometry_packet(geometry, cam_id: int | None) -> bytes:
    """The plain geometry (net/geometry_io.py) with camera ``cam_id``'s
    calibration (none when ``cam_id`` is None) as the serialized
    SSL_WrapperPacket a geometry publisher sends."""
    import dataclasses

    from vision_processor_tpu_torch.proto import SSL_WrapperPacket

    pkt = SSL_WrapperPacket()
    plain, field = geometry.field, pkt.geometry.field
    for name in plain.present:
        setattr(field, name, getattr(plain, name))
    for line in plain.field_lines:
        seg = field.field_lines.add()
        seg.name, seg.thickness = line.name, line.thickness
        seg.p1.x, seg.p1.y, seg.p2.x, seg.p2.y = line.p1.x, line.p1.y, line.p2.x, line.p2.y
    for arc in plain.field_arcs:
        out = field.field_arcs.add()
        out.name, out.radius, out.a1, out.a2 = arc.name, arc.radius, arc.a1, arc.a2
        out.center.x, out.center.y, out.thickness = arc.center.x, arc.center.y, arc.thickness
    if cam_id is None:
        return pkt.SerializeToString()
    calib = next(c for c in geometry.calib if c.camera_id == cam_id)
    proto = pkt.geometry.calib.add()
    for f in dataclasses.fields(calib):
        setattr(proto, f.name, getattr(calib, f.name))
    return pkt.SerializeToString()


def run_idle(torch, rig) -> dict:
    """The single-camera ``App`` on the card under the default config
    (``wait_for_geometry`` false, config.yml's resampling factor 1.25, the
    stream off): camera 0 of the rig serves IDLE_FRAMES frames before any
    geometry, which take the idle path (frame 100 saved as
    img/0.raw.jpg, here under OUT/idle/); then the geometry packet with
    camera 0's calibration reaches the App's vision socket through its
    receive handler, as off the wire, and IDLE_AFTER frames take the
    detection path. Fails unless the run ends without error, the sample
    image is the demosaiced frame's size, no detection was sent before
    geometry, IDLE_AFTER were sent after it, each after the first with the
    4 robot ids within 30 mm and the ball within 40 mm, and B1-B4 were
    launched once a detection frame (B1 twice, B4 twice)."""
    phase("idle path: App before and after geometry (default config)")
    import cv2
    import yaml

    from vision_processor_tpu_torch.app.main import App
    from vision_processor_tpu_torch.io.camera import CameraDriver, RawFrame, register_driver
    from vision_processor_tpu_torch.ops import cuda as K

    geometry, scenes, raws, (width, height) = rig
    raw, packet, holder = raws[0], geometry_packet(geometry, 0), {}

    class Camera(CameraDriver):
        def __init__(self):
            self.i = 0

        @property
        def fmt(self):
            return "RGGB"

        def expected_frametime(self):
            return 0.01

        def get_time(self):
            return self.i * 0.01

        def read_image(self):
            if self.i >= IDLE_FRAMES + IDLE_AFTER:
                return None
            if self.i == IDLE_FRAMES:
                holder["app"].socket._parse(packet)
                holder["geometry_at"] = len(holder["sent"])
            self.i += 1
            return RawFrame(data=raw, fmt="RGGB", width=width, height=height)

    register_driver("SMOKE_IDLE", lambda cam_cfg: Camera())
    workdir = OUT / "idle"
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "img" / "0.raw.jpg").unlink(missing_ok=True)
    cfg_path = workdir / "config.yml"
    cfg_path.write_text(yaml.dump({
        "cam_id": 0, "bot_heights_file": str(workdir / "no-heights.yml"),
        "camera": {"driver": "SMOKE_IDLE"},
        "network": {"vision_ip": IDLE_GROUP, "vision_port": IDLE_PORT,
                    "gc_ip": IDLE_GROUP, "gc_port": IDLE_PORT + 1},
        "stream": {"active": False}, "thresholds": {"resampling_factor": 1.25},
    }))
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        app = holder["app"] = App(str(cfg_path), device=torch.device("cuda", 0))
        if app.config.wait_for_geometry:
            fail("idle path: the default config waits for geometry")
        sent = holder["sent"] = []
        send = app.socket.send

        def record(msg):
            sent.append(msg)
            send(msg)

        app.socket.send = record
        K.reset_launches()
        t0 = time.perf_counter()
        app.run()  # closes the App, and with it the snapshot writer
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        os.chdir(cwd)
    sample = cv2.imread(str(workdir / "img" / "0.raw.jpg"))
    if sample is None or sample.shape != (raw.shape[0] // 2, raw.shape[1] // 2, 3):
        fail(f"idle path: no sample image of the demosaiced frame's size "
             f"({None if sample is None else sample.shape})")
    dets = [m for m in sent if m.HasField("detection")]
    early = [m for m in sent[:holder.get("geometry_at", len(sent))] if m.HasField("detection")]
    if early or any(m.detection.t_capture <= IDLE_FRAMES * 0.01 for m in dets):
        fail(f"idle path: {len(early)} detection frames were sent before geometry")
    if len(dets) != IDLE_AFTER:
        fail(f"idle path: {len(dets)} detection frames after geometry, expected {IDLE_AFTER}")
    worst = ball_worst = 0.0
    for f, wrapper in enumerate(dets[1:], start=1):
        _, err, berr = check_detections(f"idle path detection frame {f}", scenes[0], wrapper)
        worst, ball_worst = max(worst, err), max(ball_worst, berr)
    want = {name: 0 for name in launches}
    want.update(band_pass=2, blob_response_fused=1, row_topk=1, query_select_topk=2)
    check_launches("idle path", launches, want, IDLE_AFTER)
    print(f"idle path: {IDLE_FRAMES} frames before geometry, sample image "
          f"{tuple(sample.shape)}, {len(sent) - len(dets)} other packets; {len(dets)} "
          f"detection frames after it, max bot err {worst:.2f} mm, max ball err "
          f"{ball_worst:.2f} mm; launches {launches}; run {wall:.3f} s")
    return {"launches": launches, "detections": len(dets), "max_bot_err_mm": worst,
            "max_ball_err_mm": ball_worst, "run_s": wall}


CALIB_AFTER = 10  # detection frames of the App once its calibration is adopted
CALIB_GROUP, CALIB_PORT = "224.99.99.63", 17631  # never sent to by the smoke
PAIR_H = 4500.0  # the pair rig's true height, mm
PAIR_AFTER = 5  # frame-sets of the pair rig after the height is solved
PAIR_MAX = 80  # frame-sets before the pair phase gives up


class GeometryBus:
    """The vision bus and a geometry publisher (geom_publisher.py) as the
    apps' sockets see them: it holds the field geometry, absorbs every
    calibration an app broadcasts, and hands the merged geometry to every
    socket through its receive handler, as off the wire. Geometry packets
    go to it alone (on the network a camera's broadcast, looped back
    before the publisher absorbed it, would hand the other camera a
    geometry without its calibration, and it would calibrate again);
    detection frames go out as before. It records what each socket sent."""

    def __init__(self, packet: bytes):
        from vision_processor_tpu_torch.proto import SSL_WrapperPacket

        self.geometry = SSL_WrapperPacket()
        self.geometry.ParseFromString(packet)
        self.sockets, self.sent = [], []

    def attach(self, sock) -> None:
        self.sockets.append(sock)
        send = sock.send

        def record(msg):
            self.sent.append((sock.cam_id, time.perf_counter(), msg))
            if msg.HasField("geometry"):
                self.absorb(msg.geometry.calib)
            else:
                send(msg)

        sock.send = record

    def absorb(self, calibs) -> None:
        mine = self.geometry.geometry.calib
        for calib in calibs:
            old = next((c for c in mine if c.camera_id == calib.camera_id), None)
            if old is None:
                mine.append(calib)
            else:
                old.CopyFrom(calib)
        self.publish()

    def publish(self) -> None:
        data = self.geometry.SerializeToString()
        for sock in self.sockets:
            sock._parse(data)

    def calibs(self, cam_id=None) -> list:
        """The calibrations broadcast (by camera ``cam_id``), in order."""
        return [c for cid, _, m in self.sent if m.HasField("geometry")
                for c in m.geometry.calib if cam_id is None or cid == cam_id]

    def detections(self, cam_id: int) -> list:
        return [m for cid, _, m in self.sent if cid == cam_id and m.HasField("detection")]


class BuildLog:
    """Records every kernel build of the port (ops/cuda.py ``_build``) with
    where the app was when it ran: ``where`` names the frame, set by the
    wrapped ``device_step`` / ``dispatch_frames``."""

    def __init__(self, K):
        self.K, self.inner, self.where, self.builds = K, K._build, "set-up", []

    def __enter__(self):
        def build(targets):
            todo = [t[0].name for t in targets if not t[0].exists()]
            secs = self.inner(targets)
            if todo:
                self.builds.append((self.where, todo, secs))
            return secs

        self.K._build = build
        return self

    def __exit__(self, *exc):
        self.K._build = self.inner

    def frame(self, fn, label: str):
        """``fn`` wrapped to set ``where`` to ``label`` and its call number."""
        count = [0]

        def wrapped(*args, **kwargs):
            count[0] += 1
            self.where = f"{label} {count[0]}"
            try:
                return fn(*args, **kwargs)
            finally:
                self.where = f"after {label} {count[0]}"

        return wrapped

    def in_first(self, label: str) -> list:
        return [b for b in self.builds if b[0] == f"{label} 1"]


def pose_errors(fitted, true) -> dict:
    """The fitted model against the true one: camera position (mm),
    rotation angle between them (deg), focal length (px), k2, and the
    largest reprojection difference over the true camera's view (px)."""
    import numpy as np

    rel = fitted.rotation() @ true.rotation().T
    angle = float(np.degrees(np.arccos(np.clip((np.trace(rel) - 1.0) / 2.0, -1.0, 1.0))))
    w, h = (int(v) for v in true.size)
    px = np.array([[x, y] for x in np.linspace(0.1 * w, 0.9 * w, 5)
                   for y in np.linspace(0.1 * h, 0.9 * h, 5)])
    ground = true.image2field(px, 0.0)
    reproj = float(np.max(np.linalg.norm(fitted.field2image(ground) - px, axis=-1)))
    return {"position_mm": float(np.linalg.norm(fitted.pos - true.pos)),
            "angle_deg": angle, "focal_px": float(fitted.focal_length - true.focal_length),
            "k2": float(fitted.distortion_k2 - true.distortion_k2),
            "reprojection_px": reproj}


def _corner_pixels(model, field, cam_id: int, cam_amount: int) -> list:
    """A config's line_corners: the camera's visible extent projected by its
    true model, the min-x/min-y corner first."""
    import numpy as np

    from vision_processor_tpu_torch.models.camera import visible_field_extent_estimation

    lo, hi = visible_field_extent_estimation(cam_id, cam_amount, field, False)
    return [[float(v) for v in model.field2image(np.array([x, y, 0.0]))]
            for x, y in ((lo[0], lo[1]), (lo[0], hi[1]), (hi[0], hi[1]), (hi[0], lo[1]))]


def run_calibration(torch, rig) -> dict:
    """The single-camera ``App`` on the card under the default config with
    camera 0 of the rig: field geometry without any calibration reaches the
    App's socket (line corners from the true model and the measured height
    4.5 m in the config), the first frame takes the calibration path (the
    demosaic on the card, the fit on the host, the model broadcast), the
    GeometryBus brings the model back, and CALIB_AFTER frames take slice
    1's detection path. Fails unless the model is broadcast and adopted,
    reprojects within 5 px of the true camera, the CALIB_AFTER detection
    frames after the first find the 4 robot ids within 30 mm and the ball
    within 40 mm, and B1-B4 launched as on slice 1. Prints the calibration's
    wall time, the fitted pose against the true one, and whether the first
    detection frame built a kernel."""
    phase("calibration path: App calibrates, broadcasts, adopts, detects")
    import numpy as np
    import yaml

    from vision_processor_tpu_torch.app.main import App
    from vision_processor_tpu_torch.io.camera import CameraDriver, RawFrame, register_driver
    from vision_processor_tpu_torch.models.camera import CameraModel
    from vision_processor_tpu_torch.ops import cuda as K

    geometry, scenes, raws, (width, height) = rig
    true = CameraModel.from_proto(next(c for c in geometry.calib if c.camera_id == 0))
    bus, holder = GeometryBus(geometry_packet(geometry, None)), {}

    class Camera(CameraDriver):
        def __init__(self):
            self.i = 0

        @property
        def fmt(self):
            return "RGGB"

        def expected_frametime(self):
            return 0.01

        def get_time(self):
            return self.i * 0.01

        def read_image(self):
            if self.i >= 1 + CALIB_AFTER:
                return None
            if self.i == 0:
                bus.publish()
            self.i += 1
            return RawFrame(data=raws[0], fmt="RGGB", width=width, height=height)

    register_driver("SMOKE_CALIB", lambda cam_cfg: Camera())
    workdir = OUT / "calibration"
    workdir.mkdir(parents=True, exist_ok=True)
    cfg_path = workdir / "config.yml"
    cfg_path.write_text(yaml.dump({
        "cam_id": 0, "bot_heights_file": str(workdir / "no-heights.yml"),
        "camera": {"driver": "SMOKE_CALIB"},
        "geometry": {"camera_amount": N_CAMS, "camera_height": float(true.pos[2]),
                     "line_corners": _corner_pixels(true, geometry.field, 0, N_CAMS)},
        "network": {"vision_ip": CALIB_GROUP, "vision_port": CALIB_PORT,
                    "gc_ip": CALIB_GROUP, "gc_port": CALIB_PORT + 1},
        "stream": {"active": False}, "thresholds": {"resampling_factor": 1.25},
    }))
    cwd = os.getcwd()
    os.chdir(workdir)  # the calibration's diagnostics go to img/
    try:
        app = App(str(cfg_path), device=torch.device("cuda", 0))
        if app.config.wait_for_geometry:
            fail("calibration path: the default config waits for geometry")
        bus.attach(app.socket)
        calibrate = app._calibration_path

        def timed(frame):
            t0 = time.perf_counter()
            calibrate(frame)
            holder.setdefault("calib_s", []).append(time.perf_counter() - t0)

        app._calibration_path = timed
        with BuildLog(K) as builds:
            app.processor.device_step = builds.frame(app.processor.device_step,
                                                     "detection frame")
            K.reset_launches()
            t0 = time.perf_counter()
            app.run()
            wall = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
    finally:
        os.chdir(cwd)
    calibs = bus.calibs(0)
    if len(holder.get("calib_s", [])) != 1 or len(calibs) != 1:
        fail(f"calibration path: {len(holder.get('calib_s', []))} calibration frames, "
             f"{len(calibs)} broadcasts (expected one each)")
    fitted = CameraModel.from_proto(calibs[0])
    errs = pose_errors(fitted, true)
    adopted = app.processor.perspective.model
    if not np.allclose(adopted.pos, fitted.pos) or not app.processor.perspective.geometry_version:
        fail("calibration path: the broadcast model was not adopted")
    if errs["reprojection_px"] > 5.0:
        fail(f"calibration path: the fitted model reprojects {errs['reprojection_px']:.2f} px "
             f"from the true camera")
    dets = bus.detections(0)
    if len(dets) != CALIB_AFTER:
        fail(f"calibration path: {len(dets)} detection frames, expected {CALIB_AFTER}")
    worst = ball_worst = 0.0
    for f, wrapper in enumerate(dets[1:], start=1):
        _, err, berr = check_detections(f"calibration path detection frame {f}", scenes[0],
                                        wrapper)
        worst, ball_worst = max(worst, err), max(ball_worst, berr)
    want = {name: 0 for name in launches}
    want.update(band_pass=2, blob_response_fused=1, row_topk=1, query_select_topk=2)
    check_launches("calibration path", launches, want, CALIB_AFTER)
    first = builds.in_first("detection frame")
    print(f"calibration path: calibration {holder['calib_s'][0]:.3f} s wall (demosaic on the "
          f"card, fit on the host), model broadcast and adopted; fitted vs true: position "
          f"{errs['position_mm']:.2f} mm, angle {errs['angle_deg']:.4f} deg, focal "
          f"{errs['focal_px']:+.3f} px, k2 {errs['k2']:+.5f}, reprojection "
          f"{errs['reprojection_px']:.3f} px; {len(dets)} detection frames, max bot err "
          f"{worst:.2f} mm, max ball err {ball_worst:.2f} mm; launches {launches}; "
          f"kernel builds {builds.builds or 'none'}, in the first detection frame "
          f"{'none' if not first else first}; run {wall:.3f} s")
    return {"calibration_s": holder["calib_s"][0], "pose_errors": errs,
            "launches": launches, "detections": len(dets), "max_bot_err_mm": worst,
            "max_ball_err_mm": ball_worst, "builds": builds.builds,
            "first_frame_built": bool(first), "run_s": wall}


def run_pair_height(torch) -> dict:
    """``MultiCamApp`` on the card with two cameras (tests/test_pair_calib.py's
    pair: 960x720 models over the field halves, 4.5 m high, looking down;
    one robot in the overlap, one of each camera's own, a ball each) and
    ``camera_height: 0.0`` in both configs: field geometry without any
    calibration arrives, the fleet self-calibrates both cameras (their
    heights land on the focal/height manifold), the GeometryBus brings the
    models back, the detections feed the pair-height solve until it has
    its observations, and the solved height is broadcast and adopted;
    PAIR_AFTER frame-sets run after it. Fails unless both cameras are
    calibrated, the solved height is within 5 % of the truth, the refined
    models project the field plane within 2 px of the self-calibrated ones
    (the solve moves along the manifold), and the last frame-set finds
    each camera's robots within 30 mm and its ball within 40 mm."""
    phase("pair-height calibration: MultiCamApp, camera_height 0.0")
    import numpy as np
    import yaml

    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
    from vision_processor_tpu_torch.io.camera import CameraDriver, RawFrame, register_driver
    from vision_processor_tpu_torch.io.synthetic import Scene, SceneBall, SceneBot, render_raw
    from vision_processor_tpu_torch.models.camera import CameraModel
    from vision_processor_tpu_torch.net.geometry_io import geometry_from_dict
    from vision_processor_tpu_torch.ops import cuda as K

    n_cams, size = 2, np.array([960, 720])
    geometry = geometry_from_dict(FIELD)
    models = [CameraModel.initial_guess(size, c, n_cams, PAIR_H, geometry.field)
              for c in range(n_cams)]
    shared = SceneBot(7, "yellow", 0.0, 300.0, 0.5)
    scenes = [Scene(bots=[shared, SceneBot(3 + 6 * c, "blue", float(m.pos[0]),
                                           -500.0 + 1100.0 * c, 1.2 - 1.9 * c)],
                    balls=[SceneBall(float(m.pos[0]) + 600.0, 900.0)], noise_sigma=1.0,
                    seed=c) for c, m in enumerate(models)]
    raws = [render_raw(m, geometry.field, s, "RGGB") for m, s in zip(models, scenes)]
    bus, state = GeometryBus(geometry_packet(geometry, None)), {"sets": 0, "after": 0}

    class Camera(CameraDriver):
        def __init__(self, c):
            self.c = c

        @property
        def fmt(self):
            return "RGGB"

        def expected_frametime(self):
            return 0.01

        def get_time(self):
            return state["sets"] * 0.01

        def read_image(self):
            if self.c == 0:  # camera 0 counts the frame-sets
                app = state["app"]
                if not app._pair_height_active:
                    state["after"] += 1
                if state["after"] > PAIR_AFTER or state["sets"] >= PAIR_MAX:
                    state["eof"] = True
                state["sets"] += 1
            if state.get("eof"):
                return None
            return RawFrame(data=raws[self.c], fmt="RGGB", width=int(size[0]),
                            height=int(size[1]))

    register_driver("SMOKE_PAIR", lambda cam_cfg: Camera(int(cam_cfg.path)))
    workdir = OUT / "pair_height"
    workdir.mkdir(parents=True, exist_ok=True)
    paths = []
    for c in range(n_cams):
        path = workdir / f"config{c}.yml"
        path.write_text(yaml.dump({
            "cam_id": c, "bot_heights_file": str(workdir / "no-heights.yml"),
            "camera": {"driver": "SMOKE_PAIR", "path": str(c)},
            "geometry": {"camera_amount": n_cams, "camera_height": 0.0,
                         "line_corners": _corner_pixels(models[c], geometry.field, c,
                                                        n_cams)},
            "network": {"vision_ip": CALIB_GROUP, "vision_port": CALIB_PORT + 2,
                        "gc_ip": CALIB_GROUP, "gc_port": CALIB_PORT + 3},
            "stream": {"active": False},
        }))
        paths.append(str(path))
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        app = state["app"] = MultiCamApp(paths, device=torch.device("cuda", 0))
        if not app._pair_height_active:
            fail("pair height: camera_height 0.0 did not ask for the pair solve")
        for sock in app.sockets:
            bus.attach(sock)
        bus.publish()
        calibrate, holder = app._calibrate_uncalibrated, {}

        def timed(frames):
            t0 = time.perf_counter()
            calibrate(frames)
            holder.setdefault("calib_s", []).append(time.perf_counter() - t0)

        app._calibrate_uncalibrated = timed
        refine = app._refine_rig_height

        def timed_refine():
            t0 = time.perf_counter()
            refine()
            holder.setdefault("refine_s", []).append(time.perf_counter() - t0)

        app._refine_rig_height = timed_refine
        with BuildLog(K) as builds:
            app.dispatch_frames = builds.frame(app.dispatch_frames, "frame-set")
            t0 = time.perf_counter()
            app.run()
            wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    if app._pair_height_active:
        fail(f"pair height: not solved in {state['sets']} frame-sets")
    if [len(bus.calibs(c)) for c in range(n_cams)] != [2] * n_cams:
        fail(f"pair height: calibrations broadcast by camera "
             f"{[len(bus.calibs(c)) for c in range(n_cams)]}, expected one self-"
             f"calibration and one refined height each")
    self_cal = [CameraModel.from_proto(bus.calibs(c)[0]) for c in range(n_cams)]
    refined = [CameraModel.from_proto(bus.calibs(c)[-1]) for c in range(n_cams)]
    heights = [float(m.pos[2]) for m in refined]
    if any(abs(h - PAIR_H) > 0.05 * PAIR_H for h in heights):
        fail(f"pair height: solved {heights} mm, true {PAIR_H} mm")
    drift = max(pose_errors(b, a)["reprojection_px"] for a, b in zip(self_cal, refined))
    if drift > 2.0:
        fail(f"pair height: the refined models leave the field-plane manifold "
             f"({drift:.2f} px)")
    worst = ball_worst = 0.0
    for c in range(n_cams):
        _, err, berr = check_detections(f"pair height camera {c}", scenes[c],
                                        bus.detections(c)[-1])
        worst, ball_worst = max(worst, err), max(ball_worst, berr)
    self_h = [round(float(m.pos[2]), 1) for m in self_cal]
    print(f"pair height: self-calibration {sum(holder['calib_s']):.3f} s wall "
          f"({len(holder['calib_s'])} frame-sets), heights {self_h} mm; "
          f"solve {sum(holder['refine_s']):.3f} s wall after "
          f"{state['sets'] - state['after']} frame-sets: rig height "
          f"{[round(h, 1) for h in heights]} mm against the true {PAIR_H} mm; refined "
          f"models within {drift:.3f} px of the self-calibrated on the field plane; last "
          f"frame-set max bot err {worst:.2f} mm, max ball err {ball_worst:.2f} mm; "
          f"kernel builds {builds.builds or 'none'}; run {wall:.3f} s")
    return {"self_calibration_s": holder["calib_s"], "solve_s": holder["refine_s"],
            "self_calibrated_heights_mm": [float(m.pos[2]) for m in self_cal],
            "solved_heights_mm": heights, "true_height_mm": PAIR_H,
            "frame_sets": state["sets"], "max_bot_err_mm": worst,
            "max_ball_err_mm": ball_worst, "builds": builds.builds, "run_s": wall}


def _e1_inputs(torch):
    """E1's experiment (pallas_band_warp.py main()): src (4, 720, 896) u8
    values, pos (4, 432, 896) a bent ramp with per-channel quarter-pixel
    offsets, window 16, starts from block_starts."""
    import numpy as np

    from vision_processor_tpu_torch.ops.band_warp import block_starts

    ch, r, c, n_out, win = 4, 720, 896, 432, 16
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (ch, r, c)).astype(np.float32)
    base = np.linspace(1.0, r - 3.0, n_out)
    bend = np.sin(np.linspace(0, np.pi, c)) * 4.0
    pos = np.clip(base[:, None] + bend[None, :] * (base[:, None] / r - 0.5),
                  1.0, r - 3.0).astype(np.float32)
    pos4 = np.stack([pos, pos, pos + 0.25, pos + 0.25]).astype(np.float32)
    dev = torch.device("cuda", 0)
    pos_t = torch.from_numpy(pos).to(dev)
    return (torch.from_numpy(src).to(dev), torch.from_numpy(pos4).to(dev),
            block_starts(pos_t, win, r), win)


E5_SHAPES = ((432, 770), (540, 962))
E5_MS = (19, 16, 6)
E5_BLKS = (8, 32, 64)


def _e5_inputs(torch, h: int, w: int):
    """E5's experiment (rowtopk_blk.py): about 1500 valid entries of
    |normal| + 1 in an (h, w) map, the rest -inf."""
    g = torch.Generator(device="cuda").manual_seed(h)
    x = torch.randn(h, w, device="cuda", generator=g).abs() + 1.0
    keep = torch.rand(h, w, device="cuda", generator=g) < 1500.0 / (h * w)
    return torch.where(keep, x, float("-inf")).contiguous()


def run_contracts(torch) -> dict:
    """E1 and E5 through their own entry points, on their experiments'
    inputs, with the launch counts set to 0 just before and read just
    after: one banded warp pass, and the row top-k sweep (2 shapes x 3 m x
    3 rows-per-block)."""
    phase("E1 and E5 at their own contracts")
    import vision_processor_tpu_torch.ops.band_warp as BW
    import vision_processor_tpu_torch.ops.topk as T
    from vision_processor_tpu_torch.ops import cuda as K

    e1 = _e1_inputs(torch)
    e5 = {shape: _e5_inputs(torch, *shape) for shape in E5_SHAPES}
    torch.cuda.synchronize()
    K.reset_launches()
    out1 = BW.band_warp(*e1)
    out5 = {(shape, m, blk): T.row_topk_blk(x, m, blk)
            for shape, x in e5.items() for m in E5_MS for blk in E5_BLKS}
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"band_warp: src {tuple(e1[0].shape)}, pos {tuple(e1[1].shape)}, r0 "
          f"{tuple(e1[2].shape)}, win {e1[3]} -> {tuple(out1.shape)}; row_topk_blk: "
          f"{len(out5)} calls; launches {launches}")
    want = {name: 0 for name in launches}
    want.update(band_warp=1, row_topk_blk=len(out5))
    if launches != want:
        fail(f"contracts: launches {launches}, expected {want}")
    return {"launches": launches, "e1": e1, "e5": e5}


STAGES_HEAD = (("app.processor", "blob_machine", "blob machine"),)
STAGES_SLICE1 = (
    ("ops.warp", "resample_flat_warp", "  resample (warp, B1 x2)"),
    ("ops.pipeline", "blob_response_map", "  blob response (B2)"),
    ("ops.blob", "extract_blobs_scored", "  compaction + extraction (B3)"),
)
STAGES_SLICE2 = (
    ("ops.frame", "resample_flat_grid_raw", "  resample (gather, B7)"),
    ("ops.pipeline", "circularity_map", "  circularity (B5)"),
    ("ops.blob", "extract_blobs", "  compaction (B3) + disc stats + order"),
)
STAGES_SLICE3 = (
    ("parallel.multicam", "blob_machine", "blob machine (4 cameras)"),
    ("ops.frame", "resample_flat_grid_raw", "  resample (gather: E4 + B7)"),
    ("ops.frame", "corner_stack", "    corner stack (E4)"),
    ("ops.pipeline", "blob_response_map", "  blob response (B2)"),
    ("ops.blob", "extract_blobs_scored", "  compaction + extraction (B3)"),
    ("parallel.multicam", "detect", "detect (4 cameras, before NMS)"),
    ("models.detector", "detection_hypotheses", "  detection hypotheses (B4 ring)"),
    ("models.detector", "tracked_hypotheses", "  tracked hypotheses (B4 tracked)"),
    ("parallel.multicam", "finalize_batched", "finalize (NMS x4, ids over the camera axis)"),
    ("models.detector", "clipping_nms", "  clipping NMS (64-step loop)"),
    ("models.detector", "_guarded_kmeans2", "id 2-means, first pass + finisher (24 rounds)"),
    ("parallel.multicam", "finish_on_device_batched", "on-device finishing (4 cameras)"),
    ("models.device_finish", "update_colors_device", "  color update (2 k-means)"),
    ("app.multicam_app", "to_torch", "host->device inputs"),
    ("app.multicam_app", "to_numpy", "device->host fetch"),
)
# slice 3's stages with the in-line resample in place of the gather; the
# step's inputs are uploaded once, before the run, so it has no upload stage
STAGES_SLICE4 = (
    STAGES_SLICE3[:1]
    + (("ops.pipeline", "resample_frame", "  resample (in line: projection + E2/E3)"),
       ("ops.frame", "flat_image_points", "    projection (per flat pixel)"),
       ("ops.pipeline", "resample_packed", "    sampler (E2/E3)"))
    + STAGES_SLICE3[3:-2] + STAGES_SLICE3[-1:]
)
STAGES_TAIL = (
    ("app.processor", "detect", "detect"),
    ("models.detector", "detection_hypotheses", "  detection hypotheses (B4 ring)"),
    ("models.detector", "tracked_hypotheses", "  tracked hypotheses (B4 tracked)"),
    ("models.detector", "clipping_nms", "  clipping NMS (64-step loop)"),
    ("app.processor", "estimate_bot_ids", "first-pass ids (k-means, 24 rounds)"),
    ("app.processor", "finish_on_device", "on-device finishing"),
    ("models.device_finish", "update_colors_device", "  color update (2 k-means)"),
    ("app.processor", "to_numpy", "device->host fetch"),
)


def stage_times(torch, step, stages, unit: str, reps: int = 5) -> dict:
    """Host wall ms per stage with a device fence at each stage boundary
    (nested stages are included in their parents), over ``reps`` calls of
    ``step`` (one frame or frame-set each)."""
    import importlib

    totals = {label: 0.0 for _, _, label in stages}
    patched = []
    for mod_name, fn_name, label in stages:
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
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    finally:
        for mod, fn_name, fn in patched:
            setattr(mod, fn_name, fn)
    print(f"per-stage host ms per {unit} (fenced; {unit} {wall:.3f} ms):")
    for label, total in totals.items():
        print(f"  {label:48s} {total / reps:8.3f}")
    return {label: total / reps for label, total in totals.items()} | {unit: wall}


def profile_frames(torch, step, stages, label: str, unit: str = "frame"):
    phase(f"profile: {label}")
    from torch.profiler import ProfilerActivity, profile

    table = stage_times(torch, step, stages, unit)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    OUT.mkdir(parents=True, exist_ok=True)
    name = label.replace(" ", "_").replace(",", "").replace("=", "")
    (OUT / f"profile_{name}.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=40))
    # device work = kernels and copies on the card (not the aten:: ops
    # that launched them); busy share = union of their intervals / wall
    dev_us = _busy_us(prof.events())
    n_dev = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    kern = sorted((e for e in events if not e.key.startswith("aten::")),
                  key=lambda e: -e.self_device_time_total)[:12]
    print(f"3 {unit}s: wall {wall:.3f} ms, device busy {dev_us / 1e3:.3f} ms "
          f"({100.0 * dev_us / 1e3 / wall:.1f} % busy), {n_dev} device events "
          f"({n_dev / 3:.0f} per {unit})")
    for e in kern:
        print(f"  {e.key[:70]:70s} {e.self_device_time_total / 3e3:8.3f} ms/{unit} "
              f"x{e.count // 3}")
    return {"wall_ms": wall, "device_ms": dev_us / 1e3, "device_events": n_dev,
            "stages": table}


# ---------------------------------------------------------------------------
# phase 6: kernels vs plain versions
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
    # a profiler session now and then returns no device records at all
    # (busy 0 for a call that launched kernels): profile again, up to 3 times
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy = _busy_us(prof.events())
        if busy > 0:
            break
    return busy / 1e3 / reps, statistics.median(spans)


def _add(a, b) -> tuple[float, float]:
    return (a[0] + b[0], a[1] + b[1])


def _fmt(t) -> str:
    return f"{t[1]:.4f} ms span ({t[0]:.4f} ms busy)"


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take (ms), and what bounds it: the
    bytes that must move over the HBM rate, or the float32 operations over
    the peak rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _result(name, src, repl, err, t_k, t_p, bnd, t_lib):
    return {"name": name, "src": src, "repl": repl, "err": err, "t_k": t_k, "t_p": t_p,
            "bound": bnd, "t_lib": t_lib}


def _lerp_yardstick(torch, src, pos):
    """The library yardstick of a 1-D lerp along axis 1 of src (ch, R, C) at
    pos (ch, n_out, C): grid_sample with one column per batch entry (width
    1, so x is exact); float64, since a float32 grid's normalisation moves
    the taps by up to 1e-4 px. Returns (the call, its result as float32)."""
    ch, r, c = src.shape
    n_out = pos.shape[1]
    inp = src.permute(0, 2, 1).reshape(ch * c, 1, r, 1).double().contiguous()
    y = pos.permute(0, 2, 1).reshape(ch * c, n_out, 1).double() * (2.0 / (r - 1)) - 1.0
    grid = torch.stack([torch.zeros_like(y), y], dim=-1).contiguous()

    def lib():
        return torch.nn.functional.grid_sample(inp, grid, mode="bilinear",
                                               padding_mode="border", align_corners=True)

    return lib, lib().reshape(ch, c, n_out).permute(0, 2, 1).float()


def _check_b1(torch, calls):
    import vision_processor_tpu_torch.ops.warp as W

    band_pass = W.band_pass.__wrapped__
    errs, shapes = [], []
    t_k = t_p = t_l = (0.0, 0.0)
    n_bytes = n_ops = 0.0
    lib_err = 0.0
    for (src, pos), _ in calls:
        got = band_pass(src, pos)
        want = W._band_pass_plain(src, pos)
        errs.append(float((got - want).abs().max()))
        t_k = _add(t_k, time_fn(torch, lambda: band_pass(src, pos)))
        t_p = _add(t_p, time_fn(torch, lambda: W._band_pass_plain(src, pos)))
        lib, lib_out = _lerp_yardstick(torch, src, pos)
        lib_err = max(lib_err, float((lib_out - want).abs().max()))
        t_l = _add(t_l, time_fn(torch, lib))
        shapes.append(f"src {tuple(src.shape)} pos {tuple(pos.shape)}")
        n_bytes += 4 * (src.numel() + 2 * pos.numel())
        n_ops += 5 * pos.numel()
    err = max(errs)
    print(f"B1 band_pass ({'; '.join(shapes)}): max abs err {err:.3g} (tol 1e-3); "
          f"per frame (2 passes) kernel {_fmt(t_k)} vs plain {_fmt(t_p)}; library "
          f"grid_sample (f64) {_fmt(t_l)}, max abs err {lib_err:.3g} (tol 1e-3)")
    if not err <= 1e-3:
        fail("band_pass disagrees with its plain version")
    if not lib_err <= 1e-3:
        fail("the grid_sample yardstick disagrees with the band pass")
    return _result("band_pass", "vision_processor_tpu_torch/csrc/warp.cu",
                   "vision_processor_tpu/ops/warp.py:54", err, t_k, t_p,
                   bound(n_bytes, n_ops), t_l)


def load_checkout(root: Path, name: str):
    """The package vision_processor_tpu_torch of the checkout at ``root``,
    imported as ``name`` beside this checkout's: its own modules, kernel
    build (under ``root/build/``) and launch counts."""
    import importlib.util

    pkg = root / "vision_processor_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    if spec is None:
        fail(f"no vision_processor_tpu_torch package in {root}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def before_kernels(root: Path) -> dict:
    """B2-B6, E1 and E5 of the checkout at ``root``, through its own
    wrappers: {"B2": blob_response_fused, "B3": row_topk, "B4":
    query_select_topk, "B5": circularity_fused, "B6": combo_chain, "E1":
    band_warp's launch (no window check), "E5": row_topk_blk,
    "cuda": its ops.cuda, "root": ``root`` as given}."""
    import importlib

    name = load_checkout(root.resolve(), "vptpu_before").__name__
    bf = importlib.import_module(f"{name}.ops.blob_fused")
    bw = importlib.import_module(f"{name}.ops.band_warp")
    topk = importlib.import_module(f"{name}.ops.topk")
    combo = importlib.import_module(f"{name}.ops.combo_fused")
    return {"B2": bf.blob_response_fused, "B3": topk.row_topk,
            "B4": topk.query_select_topk, "B5": bf.circularity_fused,
            "B6": combo.combo_chain, "E1": bw._launch, "E5": topk.row_topk_blk,
            "cuda": importlib.import_module(f"{name}.ops.cuda"), "root": str(root)}


def _ptxas_of(o, r, dr=None) -> str:
    """The -Xptxas -v lines (registers, stack, spills) of B2 (``dr``
    given) or B5 built for these radii."""
    from vision_processor_tpu_torch.ops import cuda as K

    keep = [ln.replace("ptxas info    :", "").strip()
            for ln in K.report(_blob_lib(o, r, dr)).splitlines()
            if "stack frame" in ln or "registers" in ln]
    return "; ".join(keep) or "not in the build's ptxas report"


def _ptxas_entry(fragment: str) -> str:
    """The -Xptxas -v registers and spill lines of every kernel of the one
    library whose mangled name holds ``fragment``."""
    from vision_processor_tpu_torch.ops import cuda as K

    found, entry = [], None
    for ln in K.report(Path(K.BUILD_INFO["path"])).splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if fragment in ln else None
        elif entry and ("registers" in ln or "spill" in ln):
            found.append(ln.replace("ptxas info    :", "").strip())
    return "; ".join(found) or "not in the build's ptxas report"


def _blob_cases(torch, flat):
    """B2 and B5 beyond the slices' inputs: r = 2, dr = o + r + 1, maps
    smaller than a tile or off the tile grid, a constant map (every
    local-max test ties), a threshold above every value. Yields (label,
    flat, th, o, r, dr)."""
    dev = flat.device
    g = torch.Generator(device="cuda").manual_seed(11)

    def th(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    yield "r=2", flat, th(50.0), 1, 2, 1
    yield "dr=o+r+1", flat, th(300.0), 1, 4, 6
    yield "dr=o+r+1 (factor 1.0 radii)", flat, th(300.0), 2, 5, 8
    for h, w in ((1, 1), (3, 200), (200, 3), (37, 61)):
        small = torch.rand((h, w, 3), generator=g, device=dev) * 255.0
        for o, r, dr in ((1, 4, 3), (2, 5, 4), (1, 2, 1)):
            yield f"{h}x{w} o={o} r={r} dr={dr}", small, th(50.0), o, r, dr
    const = torch.full((45, 70, 3), 100.0, device=dev)
    yield "constant map, th 0 (all kept)", const, th(0.0), 1, 4, 3
    yield "constant map, th 1 (none kept)", const, th(1.0), 1, 4, 3
    yield "threshold above every value", flat, th(3e38), 1, 4, 3


def _b2_equal(torch, fused, flat, th, o, r, dr) -> tuple[bool, int, float]:
    """(bit-equal to the plain version with the count equal, count, max
    abs err over circ, finite scores and means)."""
    import vision_processor_tpu_torch.ops.blob_fused as BF

    ms_k, circ_k, means_k, n_k = fused(flat, th, o, r, dr)
    ms_p, circ_p, means_p = BF._blob_response_fused_plain(flat, th, o, r, dr)
    n_p = int((ms_p > float("-inf")).sum())
    fin = torch.isfinite(ms_p)
    same = (torch.equal(circ_k, circ_p) and torch.equal(torch.isfinite(ms_k), fin)
            and torch.equal(ms_k, ms_p) and all(torch.equal(a, b)
                                                for a, b in zip(means_k, means_p))
            and int(n_k) == n_p)
    errs = [float((circ_k - circ_p).abs().max())] + [
        float((a - b).abs().max()) for a, b in zip(means_k, means_p)]
    if bool(fin.any()) and torch.equal(torch.isfinite(ms_k), fin):
        errs.append(float((ms_k - ms_p)[fin].abs().max()))
    return same, int(n_k), max(errs) if flat.numel() else 0.0


def events_per_call(torch, fn, reps: int = 10) -> float:
    """Device events (kernels, copies, memsets) per call of fn, counted as
    the slices' profiles count them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type.name == "CUDA") / reps


def _before_after(torch, new_fn, old_fn):
    """Busy and span of this checkout's kernel and the other's in turns
    (old, new, new, old); returns (new, old), each the mean of its two
    readings."""
    t_o1 = time_fn(torch, old_fn)
    t_n1 = time_fn(torch, new_fn)
    t_n2 = time_fn(torch, new_fn)
    t_o2 = time_fn(torch, old_fn)
    mean = lambda a, b: ((a[0] + b[0]) / 2, (a[1] + b[1]) / 2)  # noqa: E731
    return mean(t_n1, t_n2), mean(t_o1, t_o2)


def _time_in_turns(torch, fn, old_fn, before):
    """(kernel time, the other checkout's time or None): in turns with it
    where ``--before`` gave one."""
    if before is None:
        return time_fn(torch, fn), None
    return _before_after(torch, fn, old_fn)


def _before_text(t_old, before) -> str:
    return "" if t_old is None else f"; checkout {before['root']} {_fmt(t_old)}"


def _check_b2(torch, calls, calls_f1, before):
    """Bit-equality with the plain version (circ, scores, means, mask and
    count) on slice 1's and slice 4's factor-1.0 inputs and the edge cases;
    times at both factors' shapes and at radii no slice uses, beside the
    other checkout's B2 where ``before`` has it."""
    import vision_processor_tpu_torch.ops.blob_fused as BF

    fused = BF.blob_response_fused.__wrapped__
    main_args = calls[0][0]
    f1_args = calls_f1[0][0]
    err = 0.0
    labels = []
    for label, *args in [("slice 1", *main_args), ("factor 1.0", *f1_args),
                         *_blob_cases(torch, main_args[0])]:
        same, n, e = _b2_equal(torch, fused, *args)
        if not same:
            fail(f"blob_response_fused ({label}) is not bit-equal to its plain version "
                 f"(max abs err {e:.3g}) or its count differs")
        err = max(err, e)
        labels.append(f"{label}: {n}")
    print(f"B2 blob_response_fused: bit-equal to its plain version (circ, scores, means, "
          f"masks) with the count equal in {len(labels)} cases; kept pixels "
          f"{'; '.join(labels)}")
    flat, th, o, r, dr = main_args
    events = {"this checkout": events_per_call(torch, lambda: fused(flat, th, o, r, dr))}
    if before is not None:
        events[before["root"]] = events_per_call(
            torch, lambda: before["B2"](flat, th, o, r, dr))
    print(f"B2 device events per call: {events}")
    times = {}
    other = (main_args[0], main_args[1], 1, 4, 6)  # dr = o + r + 1 on slice 1's map
    for label, (flat, th, o, r, dr) in (("factor 1.25", main_args), ("factor 1.0", f1_args),
                                        ("o=1 r=4 dr=6, no slice's radii", other)):
        h, w = flat.shape[:2]
        plan = BF.tile_plan(o, r, dr)
        t_k, t_old = _time_in_turns(torch, lambda: fused(flat, th, o, r, dr),
                                lambda: before["B2"](flat, th, o, r, dr), before)
        t_p = time_fn(torch, lambda: BF._blob_response_fused_plain(flat, th, o, r, dr))
        # per pixel, the TPU formulation's arithmetic: gradient dot 11, box
        # rows and columns 2(r-2), quadrant min 6, local max 4, disc spans
        # 6(4dr+1), squares 3, mean/var/sd 15, score and mask 5
        ops_px = 11 + 2 * (r - 2) + 6 + 4 + 6 * (4 * dr + 1) + 3 + 15 + 5
        bnd = bound(4 * h * w * (3 + 5) + 4, ops_px * h * w)
        print(f"B2 {label} (flat {tuple(flat.shape)}, o={o} r={r} dr={dr}, tile "
              f"{plan.tile_h}x{plan.tile_w}, {plan.smem_bytes} B shared): kernel "
              f"{_fmt(t_k)}{_before_text(t_old, before)}; plain {_fmt(t_p)}; bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}); no library call")
        print(f"B2 ptxas, o={o} r={r} dr={dr}: {_ptxas_of(o, r, dr)}")
        times[label] = {"t_k": t_k, "t_p": t_p, "t_before": t_old, "bound": bnd,
                        "tile": [plan.tile_h, plan.tile_w], "smem": plan.smem_bytes}
    main = times["factor 1.25"]
    res = _result("blob_response_fused", "vision_processor_tpu_torch/csrc/blob_fused.cu",
                  "vision_processor_tpu/ops/blob_pallas.py:102", err, main["t_k"],
                  main["t_p"], main["bound"], None)
    res["times"] = times
    res["events"] = events
    return res


# m of the tie/exhausted map: every list bucket of csrc/topk.cu, the path's
# m between them, and m above the largest (the block kernels)
TOPK_MS = (1, 3, 4, 6, 8, 16, 19, 32, 40)


def _same_slots(torch, got, want) -> bool:
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _check_b3(torch, calls, calls_f1, before):
    """Every slot, exhausted ones included, equal to select_m's (the
    Pallas _select_m) and, where ``before`` has it, to the other
    checkout's B3; values and valid indices equal to the plain version's;
    on slice 1's map at its m and at 19 (the m-lane tier's), slice 4's
    factor-1.0 map at its m and at 16, and a tie/exhausted map at every m
    of TOPK_MS. Timed at those four path shapes, in turns with the other
    checkout's B3."""
    import vision_processor_tpu_torch.ops.topk as T

    row_topk = T.row_topk.__wrapped__
    (masked, mm), _ = calls[0]
    (masked1, mm1), _ = calls_f1[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(432, 770, device="cuda", generator=g)
    x[torch.rand(432, 770, device="cuda", generator=g) < 0.97] = float("-inf")
    x[3] = float("-inf")
    x[5, 7] = x[5, 200] = x[5, 600] = 2.5
    x[9, :] = 1.0
    x[11, :2] = 3.0
    path = [(f"slice 1 {tuple(masked.shape)} m={mm}", masked, mm),
            (f"slice 1 {tuple(masked.shape)} m=19", masked, 19),
            (f"factor 1.0 {tuple(masked1.shape)} m={mm1}", masked1, mm1),
            (f"factor 1.0 {tuple(masked1.shape)} m=16", masked1, 16)]
    cases = path + [(f"ties/exhausted m={m}", x, m) for m in TOPK_MS]
    err = 0.0
    for label, xx, m in cases:
        got = row_topk(xx, m)
        if not _same_slots(torch, got, T.select_m(xx, m)):
            fail(f"row_topk {label}: a slot differs from select_m's")
        if before is not None and not _same_slots(torch, got, before["B3"](xx, m)):
            fail(f"row_topk {label}: a slot differs from {before['root']}'s B3")
        v_p, i_p = T._row_topk_plain(xx, m)
        valid = v_p > float("-inf")
        if not (torch.equal(got[0], v_p) and torch.equal(got[1][valid], i_p[valid])):
            fail(f"row_topk {label}: values or valid indices differ from the plain version")
        if bool(valid.any()):
            err = max(err, float((got[0][valid] - v_p[valid]).abs().max()))
        v_l, _ = torch.topk(xx, m, dim=1)  # tie order differs: values only
        if not torch.equal(v_l, v_p):
            fail(f"torch.topk yardstick {label}: values differ")
    print(f"B3 row_topk: every slot equal to select_m's"
          f"{'' if before is None else ' and to ' + before['root'] + chr(39) + 's B3'}, "
          f"values and valid indices to the plain version's, in {len(cases)} cases "
          f"({'; '.join(label for label, _, _ in path)}; ties/exhausted m={TOPK_MS})")
    times = {}
    for label, xx, m in path:
        r, l = xx.shape
        t_k, t_old = _time_in_turns(torch, lambda: row_topk(xx, m),
                                    lambda: before["B3"](xx, m), before)
        t_p = time_fn(torch, lambda: T._row_topk_plain(xx, m))
        t_l = time_fn(torch, lambda: torch.topk(xx, m, dim=1))
        bnd = bound(4 * r * l + 8 * r * m, r * l)
        print(f"B3 {label}: kernel {_fmt(t_k)}{_before_text(t_old, before)}; plain "
              f"{_fmt(t_p)}; library torch.topk {_fmt(t_l)}; bound {bnd[0]:.6f} ms "
              f"({bnd[1]})")
        times[label] = {"t_k": t_k, "t_before": t_old, "t_p": t_p, "t_lib": t_l,
                        "bound": bnd}
    main = times[path[0][0]]
    res = _result("row_topk", "vision_processor_tpu_torch/csrc/topk.cu",
                  "vision_processor_tpu/ops/topk.py:109", err, main["t_k"], main["t_p"],
                  main["bound"], main["t_lib"])
    res["times"] = times
    return res


def _query_bound(q, k, m):
    """(bytes, float32 operations) of one B4 call: queries, radii, the blob
    table and ranks read once, values and indices written once; d^2, the
    radius test and the score, 6 operations a pair."""
    return 12 * q + 12 * k + 8 * q * m, 6 * q * k


def _check_b4(torch, calls, before):
    """Every slot, exhausted ones included, equal to the plain version's
    (select_m over the materialized scores) and, where ``before`` has it,
    to the other checkout's B4; on slice 1's ring and tracked calls, the
    ring's inputs at Q = 512 (the dense window's anchors: the 128 queries
    at four offsets) and at every m of TOPK_MS, and a tie/exhausted case.
    Timed per frame (ring + tracked) and per call at Q = 128, 160 and 512,
    in turns with the other checkout's B4."""
    import vision_processor_tpu_torch.ops.topk as T

    query = T.query_select_topk.__wrapped__
    frame, seen = [], set()
    for (qxy, r2, bxy, rank), kw in calls:
        key = (qxy.shape[0], kw["m"], kw["by_rank"])
        if key not in seen:
            seen.add(key)
            frame.append((*(t.contiguous() for t in (qxy, r2, bxy, rank)), kw["m"],
                          kw["by_rank"]))
    ring = next(c for c in frame if c[5])
    q512 = (torch.cat([ring[0] + d for d in (0.0, 3.7, -3.7, 7.4)]).contiguous(),
            ring[1].repeat(4).contiguous(), ring[2], ring[3], ring[4], True)
    cases = [(f"{'ring' if c[5] else 'tracked'} Q={c[0].shape[0]} K={c[2].shape[0]} "
              f"m={c[4]} {'rank' if c[5] else '-d2'}", c) for c in frame]
    cases.append((f"ring at Q=512 m={ring[4]}", q512))
    cases += [(f"ring m={m} {'rank' if by else '-d2'}", (*ring[:4], m, by))
              for m in TOPK_MS for by in (True, False)]
    qxy = torch.zeros((3, 2), device="cuda")
    bxy = torch.tensor([[3.0, 4.0], [-3.0, 4.0], [5.0, 0.0], [100.0, 0.0]], device="cuda")
    r2 = torch.tensor([1.0, 25.0, 1e6], device="cuda")
    rank = torch.tensor([1.0, 1.0, float("inf"), 0.0], device="cuda")
    cases += [(f"ties/exhausted m={m} {'rank' if by else '-d2'}", (qxy, r2, bxy, rank, m, by))
              for m in (4, 40) for by in (True, False)]
    err = 0.0
    for label, (a, b, c, d, m, by) in cases:
        want = T._query_select_plain(a, b, c, d, m, by)
        got = [query(a, b, c, d, m=m, by_rank=by)]
        if before is not None:
            got.append(before["B4"](a, b, c, d, m=m, by_rank=by))
        if not all(_same_slots(torch, gg, want) for gg in got):
            fail(f"query_select_topk {label}: a slot differs from the plain version's")
        valid = want[0] > float("-inf")
        if bool(valid.any()):
            err = max(err, float((got[0][0][valid] - want[0][valid]).abs().max()))
    print(f"B4 query_select_topk: every slot equal to the plain version's"
          f"{'' if before is None else ' and to ' + before['root'] + chr(39) + 's B4'} in "
          f"{len(cases)} cases ({'; '.join(label for label, _ in cases[:len(frame) + 1])}; "
          f"ring m={TOPK_MS}; ties/exhausted)")

    def run_frame(fn):
        return lambda: [fn(a, b, c, d, m=m, by_rank=by) for a, b, c, d, m, by in frame]

    t_k, t_old = _time_in_turns(torch, run_frame(query),
                                run_frame(before["B4"]) if before else None, before)
    t_p = time_fn(torch, lambda: [T._query_select_plain(*c) for c in frame])
    n_bytes = n_ops = 0
    for a, _, c, _, m, _ in frame:
        nb, no = _query_bound(a.shape[0], c.shape[0], m)
        n_bytes, n_ops = n_bytes + nb, n_ops + no
    bnd = bound(n_bytes, n_ops)
    print(f"B4 per frame ({len(frame)} calls): kernel {_fmt(t_k)}"
          f"{_before_text(t_old, before)}; plain {_fmt(t_p)}; bound {bnd[0]:.6f} ms "
          f"({bnd[1]}); no library call")
    per_call = {}
    for label, (a, b, c, d, m, by) in cases[:len(frame) + 1]:
        t_c, t_c_old = _time_in_turns(torch, lambda: query(a, b, c, d, m=m, by_rank=by),
                                      lambda: before["B4"](a, b, c, d, m=m, by_rank=by),
                                      before)
        cb = bound(*_query_bound(a.shape[0], c.shape[0], m))
        print(f"B4 {label}: kernel {_fmt(t_c)}{_before_text(t_c_old, before)}; bound "
              f"{cb[0]:.6f} ms ({cb[1]})")
        per_call[label] = {"t_k": t_c, "t_before": t_c_old, "bound": cb}
    # where the ring call's time goes: one merge round (m = 1), and the
    # scan of 32 blobs in place of 2000 (K = 32)
    a, b, c, d, m, by = ring
    split = {"ring m=1": time_fn(torch, lambda: query(a, b, c, d, m=1, by_rank=by)),
             "ring K=32": time_fn(torch, lambda: query(a, b, c[:32].contiguous(),
                                                       d[:32].contiguous(), m=m,
                                                       by_rank=by))}
    print("B4 " + "; ".join(f"{label}: kernel {_fmt(t)}" for label, t in split.items()))
    res = _result("query_select_topk", "vision_processor_tpu_torch/csrc/topk.cu",
                  "vision_processor_tpu/ops/topk.py:162", err, t_k, t_p, bnd, None)
    res["times"] = {"frame": {"t_k": t_k, "t_before": t_old, "t_p": t_p, "bound": bnd},
                    "calls": per_call, "split": split}
    return res


def _check_b5(torch, calls, calls_f1, before):
    """Bit-equality with the plain version on slice 2's input, on the
    factor-1.0 map at (2, 5) and on the edge cases; times at both factors'
    shapes and at radii no slice uses, beside the other checkout's B5
    where ``before`` has it."""
    import vision_processor_tpu_torch.ops.blob_fused as BF

    circ_fused = BF.circularity_fused.__wrapped__
    (flat, o, r), _ = calls[0]
    flat_f1, _, o1, r1, _ = calls_f1[0][0]
    n = 0
    for label, ff, oo, rr in [("slice 2", flat, o, r), ("factor 1.0", flat_f1, o1, r1),
                              *((lb, f, oo, rr) for lb, f, _, oo, rr, _ in
                                _blob_cases(torch, flat))]:
        if not torch.equal(circ_fused(ff, oo, rr), BF._circularity_fused_plain(ff, oo, rr)):
            fail(f"circularity_fused ({label}) is not bit-equal to its plain version")
        n += 1
    print(f"B5 circularity_fused: bit-equal to its plain version in {n} cases "
          f"(max abs err 0)")
    times = {}
    for label, (ff, oo, rr) in (("factor 1.25", (flat, o, r)), ("factor 1.0", (flat_f1, o1, r1)),
                                ("o=1 r=2, no slice's radii", (flat, 1, 2))):
        h, w = ff.shape[:2]
        plan = BF.tile_plan(oo, rr)
        t_k, t_old = _time_in_turns(torch, lambda: circ_fused(ff, oo, rr),
                                lambda: before["B5"](ff, oo, rr), before)
        t_p = time_fn(torch, lambda: BF._circularity_fused_plain(ff, oo, rr))
        ops_px = 11 + 2 * (rr - 2) + 6  # gradient dot, box rows and columns, quadrant min
        bnd = bound(4 * h * w * (3 + 1), ops_px * h * w)
        print(f"B5 {label} (flat {tuple(ff.shape)}, o={oo} r={rr}, tile {plan.tile_h}x"
              f"{plan.tile_w}, {plan.smem_bytes} B shared): kernel {_fmt(t_k)}"
              f"{_before_text(t_old, before)}; plain {_fmt(t_p)}; bound {bnd[0]:.4f} ms "
              f"({bnd[1]}); no library call")
        print(f"B5 ptxas, o={oo} r={rr}: {_ptxas_of(oo, rr)}")
        times[label] = {"t_k": t_k, "t_p": t_p, "t_before": t_old, "bound": bnd,
                        "tile": [plan.tile_h, plan.tile_w], "smem": plan.smem_bytes}
    main = times["factor 1.25"]
    res = _result("circularity_fused", "vision_processor_tpu_torch/csrc/blob_fused.cu",
                  "vision_processor_tpu/ops/blob_pallas.py:58", 0.0, main["t_k"],
                  main["t_p"], main["bound"], None)
    res["times"] = times
    return res


def _check_b6(torch, calls, before):
    """Bit-equality with the plain version in all six outputs, and with the
    other checkout's B6 where ``before`` has it; no fallback tolerance. On
    slice 2's call (A=128) and on A=512 with exact ties and invalid
    anchors; both timed, in turns with the other checkout's B6."""
    import vision_processor_tpu_torch.ops.combo_fused as CF

    chain = CF.combo_chain.__wrapped__
    (maps, anchor_pos, ring_count, anchor_valid, combo_max, pat, pbar), _ = calls[0]
    a, c = maps.shape[1:]
    # A = 512: the recorded maps four times over, the last half made valid
    # anchors with full rings, every fifth anchor with combos 7 and 40 tied,
    # every third of the first half invalid
    maps4 = maps.repeat(1, 4, 1)
    maps4[:, ::5, 40] = maps4[:, ::5, 7]
    pos4 = anchor_pos.repeat(4, 1)
    rc4 = ring_count.repeat(4)
    av4 = anchor_valid.repeat(4)
    rc4[2 * a:] = 8
    av4[2 * a:] = True
    av4[: 2 * a: 3] = False
    cases = [(f"A={a} (slice)", (maps, anchor_pos, ring_count, anchor_valid)),
             (f"A={4 * a} (ties, invalid)", (maps4, pos4, rc4, av4))]
    times = {}
    for label, (mp, ap, rc, av) in cases:
        args = (mp, ap, rc, av, combo_max, pat, pbar)
        got = chain(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, CF._combo_chain_plain(*args))):
            fail(f"combo_chain {label} is not bit-equal to its plain version")
        if before is not None and not all(
                torch.equal(g, w) for g, w in zip(got, before["B6"](*args))):
            fail(f"combo_chain {label} is not bit-equal to {before['root']}'s B6")
        wins = int((got[0] > 0).sum())
        n = mp.shape[1]
        # bytes: the 12 maps, anchor position / ring count / validity, the
        # combo table, 6 outputs; about 120 float32 operations per pair
        bnd = bound(4 * 12 * n * c + 13 * n + 4 * c + 24 * n, 120 * n * c)
        t_k, t_old = _time_in_turns(torch, lambda: chain(*args),
                                    lambda: before["B6"](*args), before)
        t_p = time_fn(torch, lambda: CF._combo_chain_plain(*args))
        blocks, threads = CF.combo_plan(n, c)
        print(f"B6 combo_chain {label}, C={c}: bit-equal (six outputs)"
              f"{'' if before is None else ' and to ' + before['root'] + chr(39) + 's B6'}, "
              f"{wins} anchors with a winner; {blocks} blocks of {threads} threads; kernel "
              f"{_fmt(t_k)}{_before_text(t_old, before)}; plain {_fmt(t_p)}; bound "
              f"{bnd[0]:.6f} ms ({bnd[1]})")
        times[label] = {"t_k": t_k, "t_before": t_old, "t_p": t_p, "bound": bnd,
                        "plan": [blocks, threads]}
    # what an anchor's block costs: one anchor alone (latency), and every
    # anchor gated off (one thread runs combo 0's chain: launch and gate)
    args = (maps[:, :1].contiguous(), anchor_pos[:1].contiguous(),
            torch.full_like(ring_count[:1], 8), torch.ones_like(anchor_valid[:1]),
            combo_max, pat, pbar)
    off = (maps, anchor_pos, ring_count, torch.zeros_like(anchor_valid), combo_max, pat,
           pbar)
    split = {"A=1 (one block)": time_fn(torch, lambda: chain(*args)),
             f"A={a}, every anchor gated off": time_fn(torch, lambda: chain(*off))}
    print("B6 split: " + "; ".join(f"{k} {_fmt(t)}" for k, t in split.items()))
    times["split"] = split
    print(f"B6 ptxas: {_ptxas_entry('combo_chain_kernel')}")
    print("B6: max abs err 0 (tol: bit-equal); no library call")
    main = times[cases[0][0]]
    res = _result("combo_chain", "vision_processor_tpu_torch/csrc/combo.cu",
                  "vision_processor_tpu/ops/combo_pallas.py:62", 0.0, main["t_k"],
                  main["t_p"], main["bound"], None)
    res["times"] = times
    return res


def _check_b7(torch, calls):
    import vision_processor_tpu_torch.ops.frame as F
    import vision_processor_tpu_torch.ops.gather_corners as G

    gather = F.gather_corners.__wrapped__  # the binding the gather path calls
    (stacked, idx), _ = calls[0]
    got = gather(stacked, idx)
    want = G._gather_corners_plain(stacked, idx)
    err = float((got - want).abs().max())
    flat_idx = idx.reshape(-1).long()
    lib_rows = stacked.index_select(0, flat_idx)
    if not torch.equal(lib_rows.float().reshape(got.shape), got):
        fail("index_select yardstick differs from gather_corners")
    t_k = time_fn(torch, lambda: gather(stacked, idx))
    t_p = time_fn(torch, lambda: G._gather_corners_plain(stacked, idx))
    t_l = time_fn(torch, lambda: stacked.index_select(0, flat_idx))
    print(f"B7 gather_corners (stack {tuple(stacked.shape)} u8, idx {tuple(idx.shape)}): "
          f"max abs err {err:.3g} (tol 0, bit-equal); kernel {_fmt(t_k)} vs plain "
          f"{_fmt(t_p)}; library index_select (u8 rows, equal) {_fmt(t_l)}")
    if err != 0.0:
        fail("gather_corners disagrees with its plain version")
    n = idx.numel()
    rows = int(torch.unique(idx).numel())  # the stack rows this grid reads
    return _result("gather_corners", "vision_processor_tpu_torch/csrc/gather.cu",
                   "vision_processor_tpu/ops/pallas_resample.py:88", err, t_k, t_p,
                   bound(4 * n + 16 * rows + 64 * n, 16 * n), t_l)


def _check_e4(torch, calls):
    import vision_processor_tpu_torch.ops.corner_stack as CS

    stack = CS.corner_stack  # the wrapper itself: the gather path's binding is recorded
    (raw, fmt), _ = calls[-1]  # the last camera of the last frame-set
    h, w = raw.shape[0] // 2, raw.shape[1] // 2
    g = torch.Generator(device="cuda").manual_seed(11)

    def rand(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)

    cases = [(f"slice 3 {fmt} raw {tuple(raw.shape)}", raw, fmt),
             ("RGGB raw (140, 1920): 70 plane rows, not a multiple of 64", rand((140, 1920)),
              "RGGB"),
             ("BGR (540, 960, 3)", rand((540, 960, 3)), "BGR")]
    err = 0.0
    for label, r, f in cases:
        got = stack(r, f)
        want = CS._corner_stack_plain(r, f)
        err = max(err, float((got.int() - want.int()).abs().max()))
        print(f"E4 corner_stack {label} -> {tuple(got.shape)}: max abs err "
              f"{float((got.int() - want.int()).abs().max()):.3g}")
    packed2d = CS._corner_stack_plain(raw, fmt)[..., :4].reshape(h, 4 * w).contiguous()
    got = CS.corner_stack_packed(packed2d)
    want = CS._corner_stack_packed_plain(packed2d)
    err = max(err, float((got.int() - want.int()).abs().max()))
    print(f"E4 corner_stack_packed (the experiment's contract) {tuple(packed2d.shape)} -> "
          f"{tuple(got.shape)}: equal {torch.equal(got, want)}")
    if err != 0.0:
        fail("corner_stack disagrees with its plain version")
    t_k = time_fn(torch, lambda: stack(raw, fmt))
    t_p = time_fn(torch, lambda: CS._corner_stack_plain(raw, fmt))
    print(f"E4 corner_stack (raw {tuple(raw.shape)} u8 -> ({h}, {w}, 16) u8): max abs err "
          f"{err:.3g} (tol 0, bit-equal); kernel {_fmt(t_k)} vs plain {_fmt(t_p)}; no "
          f"library call")
    # bytes: the raw frame read once (4 per cell), the stack written once
    return _result("corner_stack", "vision_processor_tpu_torch/csrc/corner_stack.cu",
                   "experiments/pallas_stack.py:31", err, t_k, t_p,
                   bound(20 * h * w, 0), None)


# per flat pixel of the in-line sampler: u, v 2; floor + clip 6; per plane
# the clipped fractions 8 and three lerps 12 (x 4); RGGB green 3; dRGB 15
_E2_OPS_PER_PIXEL = 106


def _exact_yardstick(torch, raw, px, py, fmt):
    """The library yardstick of the sampler: one grid_sample call over the
    4 planes as a batch, each at its own quarter-pixel positions (the
    exact per-plane bilinear resample, not E2/E3's shared-cell function:
    it differs at cell boundaries and clamps at the edges another way);
    float64 for the grid's normalisation. Returns (the call, its (4, Hf,
    Wf) samples as float32, the port's exact per-plane samples)."""
    from vision_processor_tpu_torch.ops import frame as F

    planes = F.raw2quad(raw, fmt)  # (4, H, W)
    h, w = planes.shape[1:]
    offs = torch.tensor(F._PLANE_OFFSETS[fmt], dtype=torch.float64, device=raw.device)
    gx = (px.double()[None] + offs[:, 0, None, None]) * (2.0 / w) - 1.0
    gy = (py.double()[None] + offs[:, 1, None, None]) * (2.0 / h) - 1.0
    grid = torch.stack([gx, gy], dim=-1).contiguous()
    inp = planes.double()[:, None].contiguous()

    def lib():
        return torch.nn.functional.grid_sample(inp, grid, mode="bilinear",
                                               padding_mode="border", align_corners=False)

    exact = torch.stack([F.bilinear_sample(planes[c], px + offs[c, 0].float(),
                                           py + offs[c, 1].float()) for c in range(4)])
    return lib, lib()[:, 0].float(), exact


def _check_e2e3(torch, calls, calls_f1):
    """E2/E3's kernel (the in-line sampler) on slice 4's last inputs at both
    factors, the projection's interleaved layout, positions off every edge,
    GRBG, BGR and the packed-plane entries at E2/E3's own shape: bit-equal
    to the plain version in every case."""
    import vision_processor_tpu_torch.ops.resample_packed as RP
    from vision_processor_tpu_torch.ops.frame import raw2planes_packed

    sample = RP.resample_packed
    (raw, px, py, fmt), _ = calls[-1]  # the last camera of slice 4's last frame-set
    (raw1, px1, py1, _), _ = calls_f1[-1]  # factor 1.0: flat (540, 962)
    h, w = raw.shape[0] // 2, raw.shape[1] // 2
    g = torch.Generator(device="cuda").manual_seed(13)
    hf, wf = px.shape
    epx = (torch.rand(hf, wf, device="cuda", generator=g) * (w + 8.0) - 4.0).contiguous()
    epy = (torch.rand(hf, wf, device="cuda", generator=g) * (h + 8.0) - 4.0).contiguous()
    bgr = torch.randint(0, 256, (h, w, 3), dtype=torch.uint8, device="cuda", generator=g)
    img = torch.stack([px, py], dim=-1)
    planes1 = raw2planes_packed(raw1, fmt)
    cases = [
        (f"slice 4 {fmt} raw {tuple(raw.shape)}, flat {tuple(px.shape)} (factor 1.25)",
         lambda: sample(raw, px, py, fmt), lambda: RP._resample_raw_plain(raw, px, py, fmt)),
        (f"factor 1.0 raw, flat {tuple(px1.shape)}",
         lambda: sample(raw1, px1, py1, fmt),
         lambda: RP._resample_raw_plain(raw1, px1, py1, fmt)),
        ("interleaved px/py (the projection's (Hf, Wf, 2) layout)",
         lambda: sample(raw, img[..., 0], img[..., 1], fmt),
         lambda: RP._resample_raw_plain(raw, px, py, fmt)),
        ("positions up to 4 px off all four sides",
         lambda: sample(raw, epx, epy, fmt), lambda: RP._resample_raw_plain(raw, epx, epy, fmt)),
        ("GRBG raw", lambda: sample(raw, epx, epy, "GRBG"),
         lambda: RP._resample_raw_plain(raw, epx, epy, "GRBG")),
        (f"BGR {tuple(bgr.shape)}", lambda: sample(bgr, epx, epy, "BGR"),
         lambda: RP._resample_raw_plain(bgr, epx, epy, "BGR")),
        (f"packed planes f32 {tuple(planes1.shape)} (E2/E3's contract and shape)",
         lambda: RP.resample_packed_planes(planes1, px1, py1, fmt),
         lambda: RP._resample_packed_plain(planes1, px1, py1, fmt)),
        ("packed planes u8", lambda: RP.resample_packed_planes(planes1.to(torch.uint8), px1,
                                                               py1, fmt),
         lambda: RP._resample_packed_plain(planes1.to(torch.uint8), px1, py1, fmt)),
    ]
    err = 0.0
    for label, kern, plain in cases:
        got, want = kern(), plain()
        e = float((got - want).abs().max())
        err = max(err, e)
        print(f"E2/E3 resample_packed {label} -> {tuple(got.shape)}: bit-equal "
              f"{torch.equal(got, want)}, max abs err {e:.3g}")
        if not torch.equal(got, want):
            fail(f"resample_packed ({label}) disagrees with its plain version")
    t_k = time_fn(torch, lambda: sample(raw, px, py, fmt))
    t_p = time_fn(torch, lambda: RP._resample_raw_plain(raw, px, py, fmt))
    t_k1 = time_fn(torch, lambda: sample(raw1, px1, py1, fmt))
    t_p1 = time_fn(torch, lambda: RP._resample_raw_plain(raw1, px1, py1, fmt))
    t_pk = time_fn(torch, lambda: RP.resample_packed_planes(planes1, px1, py1, fmt))
    # the same call over a bank of 8 distinct frames and position grids, so
    # that the inputs and outputs (about 70 MB) do not stay in the 50 MB L2
    bank = [(torch.roll(raw, 2 * i, dims=1).contiguous(), (px + 0.001 * i).contiguous(),
             (py - 0.001 * i).contiguous()) for i in range(8)]
    outs = [torch.empty((hf, wf, 3), device="cuda") for _ in range(8)]
    turn = [0]

    def banked():
        i = turn[0] % 8
        turn[0] += 1
        outs[i] = sample(*bank[i], fmt)

    t_bank = time_fn(torch, banked, reps=24)
    lib, lib_out, exact = _exact_yardstick(torch, raw, px, py, fmt)
    inner = ((px > 2) & (px < w - 2) & (py > 2) & (py < h - 2))[None].expand_as(exact)
    lib_err = float((lib_out - exact)[inner].abs().max()) if bool(inner.any()) else 0.0
    t_l = time_fn(torch, lib)
    n, n1 = px.numel(), px1.numel()
    print(f"E2/E3 resample_packed (raw {tuple(raw.shape)} u8 + px/py {tuple(px.shape)} -> "
          f"({hf}, {wf}, 3) f32): max abs err {err:.3g} (tol 0, bit-equal); kernel "
          f"{_fmt(t_k)} vs plain {_fmt(t_p)} (the same inputs each call, L2-resident as on "
          f"the path); over a bank of 8 input sets {_fmt(t_bank)}; factor 1.0 flat "
          f"{tuple(px1.shape)}: kernel {_fmt(t_k1)} vs plain {_fmt(t_p1)}, packed-plane "
          f"f32 entry {_fmt(t_pk)}; bound at factor 1.0 "
          f"{bound(raw1.numel() + 20 * n1, _E2_OPS_PER_PIXEL * n1)[0]:.6f} ms; library "
          f"grid_sample (f64, the exact per-plane bilinear, not this function) {_fmt(t_l)}, "
          f"max abs err vs the exact sampler away from the edges {lib_err:.3g} (tol 1e-3)")
    if not lib_err <= 1e-3:
        fail("the grid_sample yardstick disagrees with the exact sampler")
    # bytes: the raw frame read once, px and py, the 3 output planes
    return _result("resample_packed", "vision_processor_tpu_torch/csrc/resample_packed.cu",
                   "experiments/k2_proto.py:43", err, t_k, t_p,
                   bound(raw.numel() + 20 * n, _E2_OPS_PER_PIXEL * n), t_l)


def _e1_edges(torch):
    """E1 at its edges (tests/test_torch_band_warp.py ``_edge_case``): per-
    block starts, positions on integers, at 0 and at win - 1 of their
    window, u8-valued sources with +inf, -inf and NaN in window columns
    outside the two taps and a NaN at a tap."""
    import numpy as np

    ch, r, c, n_out, win = 2, 48, 256, 16, 16
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (ch, r, c)).astype(np.float32)
    nb, nt = n_out // 8, c // 128
    r0 = rng.integers(0, r - win + 1, (nb, nt)).astype(np.int32)
    rel = rng.uniform(2.0, win - 4.0, (ch, n_out, c)).astype(np.float32)
    rel[:, :, 0::8] = np.floor(rel[:, :, 0::8])
    rel[:, :, 1::8] = win - 1
    rel[:, :, 2::8] = 0.0
    rel[:, :, 3], rel[:, :, 4], rel[:, :, 5] = 5.5, 7.0, 3.25
    pos = (np.repeat(np.repeat(r0, 8, 0), 128, 1)[None] + rel).astype(np.float32)
    for b in range(nb):
        for t in range(nt):
            src[:, r0[b, t] + 12, t * 128 + 3] = np.inf
            src[:, r0[b, t], t * 128 + 4] = np.nan
            src[:, r0[b, t] + win - 1, t * 128 + 5] = -np.inf
            src[:, r0[b, t] + 6, t * 128 + 6] = np.nan
    dev = torch.device("cuda", 0)
    return (torch.from_numpy(src).to(dev), torch.from_numpy(pos).to(dev),
            torch.from_numpy(r0).to(dev), win)


def _check_e1(torch, contract, before):
    """E1 on its contract run's inputs and at its edges (integer positions,
    0 and win - 1, non-finite sources), bit-equal to its plain version (NaN
    for NaN), timed in turns with the other checkout's E1 where ``before``
    has it, beside B1 (the band pass) at the same shapes; then a split:
    one block alone, the staging alone (loads and finite flags, no sums),
    every window column non-finite (the win-tap chain everywhere)."""
    import vision_processor_tpu_torch.ops.band_warp as BW
    import vision_processor_tpu_torch.ops.warp as W
    from vision_processor_tpu_torch.ops import cuda as K

    band_warp = getattr(BW.band_warp, "__wrapped__", BW.band_warp)
    band_pass = W.band_pass.__wrapped__
    src, pos, r0, win = contract["e1"]
    got = band_warp(src, pos, r0, win)
    want = BW._band_warp_plain(src, pos, r0, win)
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        fail(f"band_warp disagrees with its plain version (max abs err {err:.3g})")
    if before is not None and not torch.equal(got, before["E1"](src, pos, r0, win)):
        fail(f"band_warp disagrees with {before['root']}'s E1")
    e_src, e_pos, e_r0, e_win = _e1_edges(torch)
    e_got = band_warp(e_src, e_pos, e_r0, e_win)
    e_want = BW._band_warp_plain(e_src, e_pos, e_r0, e_win)
    if not (torch.equal(e_got.isnan(), e_want.isnan())
            and torch.equal(e_got.nan_to_num(7.0), e_want.nan_to_num(7.0))):
        fail("band_warp disagrees with its plain version at the edges (integer "
             "positions, 0 and win - 1, non-finite sources)")
    n_bad = int((~torch.isfinite(e_got)).sum())
    if n_bad == 0:
        fail("band_warp at the edges: no non-finite source reached an output")
    b1 = band_pass(src, pos)
    b1_err = float((b1 - got).abs().max())
    lib, lib_out = _lerp_yardstick(torch, src, pos)
    lib_err = float((lib_out - got).abs().max())
    # the kernel alone; the wrapper adds its precondition check (device
    # comparisons and one device->host read) to every call
    t_k, t_old = _time_in_turns(torch, lambda: BW._launch(src, pos, r0, win),
                                lambda: before["E1"](src, pos, r0, win), before)
    t_w = time_fn(torch, lambda: band_warp(src, pos, r0, win))
    t_p = time_fn(torch, lambda: BW._band_warp_plain(src, pos, r0, win))
    t_b1 = time_fn(torch, lambda: band_pass(src, pos))
    t_l = time_fn(torch, lib)
    print(f"E1 band_warp (src {tuple(src.shape)}, pos {tuple(pos.shape)}, r0 "
          f"{tuple(r0.shape)}, win {win}): bit-equal, max abs err {err:.3g} (tol 0); at "
          f"the edges (src {tuple(e_src.shape)}, pos {tuple(e_pos.shape)}) bit-equal, NaN "
          f"for NaN, {n_bad} non-finite outputs; kernel {_fmt(t_k)}"
          f"{_before_text(t_old, before)} (with the wrapper's window check {_fmt(t_w)}) vs "
          f"plain {_fmt(t_p)}; B1 band_pass at the same shapes "
          f"{_fmt(t_b1)}, max abs diff from E1 {b1_err:.3g} (tol 1e-3: hat sum vs 2-tap "
          f"rounding); library grid_sample (f64) {_fmt(t_l)}, max abs diff {lib_err:.3g} "
          f"(tol 1e-3)")
    if not (b1_err <= 1e-3 and lib_err <= 1e-3):
        fail("band_warp disagrees with the band pass or the grid_sample yardstick")
    # what is left of a call: one (8, 128) block alone, the staging alone,
    # and the win-tap chain everywhere (a NaN in every window column)
    one = (src[:1, :, :128].contiguous(), pos[:1, :8, :128].contiguous(),
           r0[:1, :1].contiguous(), win)
    stage_out = torch.empty_like(pos)

    def staging():
        ch, r, c = src.shape
        K.check(K.lib().vp_band_warp_staging(
            src.data_ptr(), pos.data_ptr(), r0.data_ptr(), stage_out.data_ptr(), ch, r, c,
            pos.shape[1], win, K.stream(src)), "band_warp_staging")

    nan_src = src.clone()
    nan_src[:, ::win] = float("nan")  # every window holds one of these rows
    # the timed calls find src (10.3 MB) in the 50 MB L2; a 64 MB write
    # before each call evicts it (the write's own time taken off)
    flush = torch.empty(16 * 2**20, device=src.device)
    t_flush = time_fn(torch, flush.zero_)
    t_cold = time_fn(torch, lambda: (flush.zero_(), BW._launch(src, pos, r0, win)))
    split = {"one block (8, 128)": time_fn(torch, lambda: BW._launch(*one)),
             "staging alone": time_fn(torch, staging),
             "every window non-finite": time_fn(
                 torch, lambda: BW._launch(nan_src, pos, r0, win)),
             "cold L2 (64 MB write before each call, its time taken off)":
                 (t_cold[0] - t_flush[0], t_cold[1] - t_flush[1])}
    print("E1 split: " + "; ".join(f"{k} {_fmt(t)}" for k, t in split.items()))
    print(f"E1 ptxas: {_ptxas_entry('band_warp_kernel')}")
    res = _result("band_warp", "vision_processor_tpu_torch/csrc/band_warp.cu",
                  "experiments/pallas_band_warp.py:42", err, t_k, t_p,
                  bound(4 * (src.numel() + 2 * pos.numel() + r0.numel()),
                        5 * win * pos.numel()), t_l)
    res["b1_same_shapes"] = t_b1
    res["times"] = {"t_k": t_k, "t_before": t_old, "t_wrapper": t_w, "split": split}
    return res


def _check_e5(torch, contract, before):
    """E5 at every rows-per-block of the sweep, bit-equal (values and
    indices) to its plain version and, where ``before`` has it, to the
    other checkout's E5, value-equal to B3, timed beside B3 at the same
    shapes and in turns with the other checkout's E5; then rows too dense
    for the kernel's candidate buffer (ties, a full row) at m up to 40. The
    record row is (540, 962), m 19, 64 rows a block."""
    import vision_processor_tpu_torch.ops.topk as T

    blk_topk = getattr(T.row_topk_blk, "__wrapped__", T.row_topk_blk)
    row_topk = T.row_topk.__wrapped__
    regs, most = T.blk_attrs()
    plan = {blk: T.blk_warps(blk, regs) for blk in E5_BLKS}
    print(f"E5 row_topk_blk_warps: {regs} registers a thread, at most {most} threads a "
          f"block (runtime); ptxas {_ptxas_entry('row_topk_blk_warps')}; warps a block "
          + ", ".join(f"blk {b} {w}" for b, w in plan.items()))
    if any(32 * w > most for w in plan.values()):
        fail(f"row_topk_blk: a plan {plan} asks for more than {most} threads a block")
    rows = []
    for shape, x in contract["e5"].items():
        for m in E5_MS:
            pv, pi = T.select_m(x, m)
            valid = pv > float("-inf")
            bv, bi = row_topk(x, m)
            if not (torch.equal(bv, pv) and torch.equal(bi[valid], pi[valid])):
                fail(f"B3 and E5's plain version differ at {shape} m={m}")
            times, before_t = {}, {}
            for blk in E5_BLKS:
                kv, ki = blk_topk(x, m, blk)
                if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
                    fail(f"row_topk_blk {shape} m={m} blk={blk} disagrees with its plain "
                         f"version")
                if before is not None and not _same_slots(
                        torch, (kv, ki), before["E5"](x, m, blk)):
                    fail(f"row_topk_blk {shape} m={m} blk={blk}: a slot differs from "
                         f"{before['root']}'s E5")
                times[blk], before_t[blk] = _time_in_turns(
                    torch, lambda: blk_topk(x, m, blk), lambda: before["E5"](x, m, blk),
                    before)
            t_b3 = time_fn(torch, lambda: row_topk(x, m))
            rows.append((shape, m, times, t_b3, before_t))
            print(f"E5 row_topk_blk {shape} m={m}: bit-equal (values, indices); "
                  + ", ".join(f"blk {b} {_fmt(t)}{_before_text(before_t[b], before)}"
                              for b, t in times.items())
                  + f"; B3 row_topk (one warp a row) {_fmt(t_b3)}")
    shape = E5_SHAPES[-1]
    dense = contract["e5"][shape].clone()
    dense[2, ::7] = 2.0  # 138 tied entries
    dense[5] = torch.linspace(0.0, 1.0, shape[1], device=dense.device).flip(0)
    dense[6, :40] = 3.0
    for m in (1, 19, 32, 40):
        want = T.select_m(dense, m)
        for blk in E5_BLKS:
            if not _same_slots(torch, blk_topk(dense, m, blk), want):
                fail(f"row_topk_blk dense rows m={m} blk={blk}: a slot differs from "
                     f"select_m's")
    print(f"E5 dense rows (ties, a full row) at m 1, 19, 32, 40: every slot equal to "
          f"select_m's at blk {E5_BLKS}")
    shape, m, blk = (540, 962), 19, 64
    x = contract["e5"][shape]
    # what a block of 64 rows costs: m = 1, no entry above -inf, one block
    # alone, one row alone (one warp's latency)
    empty = torch.full_like(x, float("-inf"))
    split = {"m=1": time_fn(torch, lambda: blk_topk(x, 1, blk)),
             "every entry -inf": time_fn(torch, lambda: blk_topk(empty, m, blk)),
             "64 rows (one block)": time_fn(torch, lambda: blk_topk(x[:64], m, blk)),
             "1 row (one warp)": time_fn(torch, lambda: blk_topk(x[:1], m, blk))}
    print(f"E5 split at {shape} blk={blk}, m={m} unless named: "
          + "; ".join(f"{k} {_fmt(t)}" for k, t in split.items()))
    t_k = dict((r[1], r[2]) for r in rows if r[0] == shape)[m][blk]
    t_p = time_fn(torch, lambda: T.select_m(x, m))
    t_l = time_fn(torch, lambda: torch.topk(x, m, dim=1))
    print(f"E5 record row: {shape} m={m} blk={blk}: kernel {_fmt(t_k)} vs plain (select_m) "
          f"{_fmt(t_p)}; library torch.topk {_fmt(t_l)}")
    res = _result("row_topk_blk", "vision_processor_tpu_torch/csrc/topk.cu",
                  "experiments/rowtopk_blk.py:48", 0.0, t_k, t_p,
                  bound(4 * shape[0] * shape[1] + 8 * shape[0] * m, shape[0] * shape[1]), t_l)
    res["sweep"] = [{"shape": list(r[0]), "m": r[1],
                     "ms": {str(b): t[1] for b, t in r[2].items()},
                     "busy_ms": {str(b): t[0] for b, t in r[2].items()},
                     "before_busy_ms": {str(b): None if t is None else t[0]
                                        for b, t in r[4].items()},
                     "b3_ms": r[3][1], "b3_busy_ms": r[3][0]} for r in rows]
    res["warps"] = {"registers": regs, "max_threads": most, "plan": plan, "split": split}
    return res


def check_kernels(torch, s1: dict, s2: dict, s3: dict, s4: dict, s4f1: dict,
                  contracts: dict, before) -> list:
    """Each kernel on the last frame's inputs of the slice whose path it
    belongs to: B1-B4 slice 1's, B5-B7 slice 2's, E4 slice 3's, E2/E3 slice
    4's; E1 and E5 on their contract run's inputs; B2 and B5 also on slice
    4's factor-1.0 map, beside the other checkout's where ``before`` has it."""
    phase("kernels vs plain")
    one = torch.zeros(1, device="cuda")
    floor = time_fn(torch, one.zero_)
    print(f"one launch of a one-element fill (the least a kernel takes on this card): "
          f"{_fmt(floor)}")
    c1, c2, c3, c4 = s1["calls"], s2["calls"], s3["calls"], s4["calls"]
    b2_f1 = s4f1["calls"]["blob_response_fused"]
    return [
        ("B1", _check_b1(torch, c1["band_pass"])),
        ("B2", _check_b2(torch, c1["blob_response_fused"], b2_f1, before)),
        ("B3", _check_b3(torch, c1["row_topk"], s4f1["calls"]["row_topk"], before)),
        ("B4", _check_b4(torch, c1["query_select_topk"], before)),
        ("B5", _check_b5(torch, c2["circularity_fused"], b2_f1, before)),
        ("B6", _check_b6(torch, c2["combo_chain"], before)),
        ("B7", _check_b7(torch, c2["gather_corners"])),
        ("E1", _check_e1(torch, contracts, before)),
        ("E2", _check_e2e3(torch, c4["resample_packed"], s4f1["calls"]["resample_packed"])),
        ("E4", _check_e4(torch, c3["corner_stack"])),
        ("E5", _check_e5(torch, contracts, before)),
    ]


def main() -> None:
    global OUT
    parser = argparse.ArgumentParser(description="chip smoke of the PyTorch/CUDA port")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--out", type=Path, default=OUT)
    parser.add_argument("--before", type=Path, default=None,
                        help="another checkout of the repository whose B2-B6, E1 and E5 "
                             "are timed in turns with this one's (B3, B4, B6 and E5 held "
                             "equal to this one's in every slot)")
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
    before = None
    if args.before:
        phase(f"build: the checkout {args.before}")
        before = before_kernels(args.before)
        before["cuda"].lib()
        print(f"built {before['cuda'].BUILD_INFO['path']}")
    recorder = Recorder()
    rig = bench_rig()
    s1 = run_slice(torch, recorder, rig, "slice 1", "auto", "warp", SLICE1_LAUNCHES)
    with Env(SLICE2_ENV):
        s2 = run_slice(torch, recorder, rig, "slice 2", "gather", "gather", SLICE2_LAUNCHES)
    s3 = run_slice3(torch, recorder, rig, "slice 3", "gather", "gather", SLICE3_LAUNCHES,
                    FRAMES)
    s3w = run_slice3(torch, recorder, rig, "slice 3, warp", "auto", "warp",
                     SLICE3_WARP_LAUNCHES, WARP_FRAME_SETS)
    check_staggered(torch, *s3["fleet"])
    s4 = run_slice4(torch, recorder, rig, "slice 4", 1.25, FRAMES)
    s4f1 = run_slice4(torch, recorder, rig, "slice 4, factor 1.0", 1.0,
                      SLICE4_FACTOR1_FRAME_SETS)
    run_one_camera(torch, rig, s4["last_wrappers"])
    idle = run_idle(torch, rig)
    calib = run_calibration(torch, rig)
    pair = run_pair_height(torch)
    contracts = run_contracts(torch)
    for label, s, unit in (("slice 1 (warp, score-first)", s1, "frame"),
                           ("slice 2 (gather, circ-first, fused combo)", s2, "frame"),
                           ("slice 3 (4 cameras, gather)", s3, "frame-set"),
                           ("slice 3 (4 cameras, warp)", s3w, "frame-set"),
                           ("slice 4 (4 cameras, in line)", s4, "frame-set"),
                           ("slice 4 (4 cameras, in line, factor 1.0)", s4f1, "frame-set")):
        print(f"{label}: median device span {s['median_device_ms']:.3f} ms per {unit}, "
              f"{unit}-serial {1e3 / s['median_frame_ms']:.1f} {unit}s/s")
    if args.profile:
        # after every timed run, so that no profiler session precedes them
        s1["profile"] = profile_frames(torch, s1["run"],
                                       STAGES_HEAD + STAGES_SLICE1 + STAGES_TAIL, "slice 1")
        stages2 = STAGES_HEAD + STAGES_SLICE2 + STAGES_TAIL
        with Env(SLICE2_ENV):
            s2["profile"] = profile_frames(torch, s2["run"], stages2, "slice 2")
            # the question of ROADMAP B6: the same frames with the unfused chain
            with Env({"VPTPU_COMBO_KERNEL": "0"}):
                s2["profile_combo_off"] = profile_frames(
                    torch, s2["run"], stages2, "slice 2, VPTPU_COMBO_KERNEL=0")
        s3["profile"] = profile_frames(torch, s3["run"], STAGES_SLICE3, "slice 3",
                                       "frame-set")
        s4["profile"] = profile_frames(torch, s4["run"], STAGES_SLICE4, "slice 4",
                                       "frame-set")
    results = check_kernels(torch, s1, s2, s3, s4, s4f1, contracts, before)
    # E3 computes E2's function: one kernel, one measurement, two rows
    e2 = dict(results)["E2"]
    results.insert([row for row, _ in results].index("E4"),
                   ("E3", dict(e2, repl="experiments/k2_stages.py:30")))

    path_of = {name: s1 for name in WRAPPERS}
    path_of.update(gather_corners=s2, circularity_fused=s2, combo_chain=s2, corner_stack=s3,
                   resample_packed=s4, band_warp=contracts, row_topk_blk=contracts)
    record = {"kernels": [
        {"name": r["name"], "row": row, "route": "cuda", "source": r["src"],
         "replaces": r["repl"],
         "launches": path_of[r["name"]]["launches"][r["name"]], "max_abs_err": r["err"],
         "ms": r["t_k"][1], "plain_ms": r["t_p"][1], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1],
         "library_ms": None if r["t_lib"] is None else r["t_lib"][1],
         "busy_ms": r["t_k"][0], "plain_busy_ms": r["t_p"][0],
         "library_busy_ms": None if r["t_lib"] is None else r["t_lib"][0]}
        for row, r in results
    ]}
    OUT.mkdir(parents=True, exist_ok=True)
    skip = ("calls", "run", "fleet", "last_wrappers", "e1", "e5")
    (OUT / "result.json").write_text(json.dumps({
        "card": card, "kernels": record["kernels"],
        "e1_vs_b1": {"b1_busy_ms": dict(results)["E1"]["b1_same_shapes"][0],
                     "b1_ms": dict(results)["E1"]["b1_same_shapes"][1]},
        "e1_times": dict(results)["E1"]["times"],
        "e5_sweep": dict(results)["E5"]["sweep"],
        "b2_b5_times": {row: dict(results)[row]["times"] for row in ("B2", "B5")},
        "b3_b4_times": {row: dict(results)[row]["times"] for row in ("B3", "B4")},
        "b6_times": dict(results)["B6"]["times"],
        "e5_warps": dict(results)["E5"]["warps"],
        "b2_events_per_call": dict(results)["B2"]["events"],
        "slices": {label: {k: v for k, v in s.items() if k not in skip}
                   for label, s in (("slice 1", s1), ("slice 2", s2), ("slice 3", s3),
                                    ("slice 3, warp", s3w), ("slice 4", s4),
                                    ("slice 4, factor 1.0", s4f1),
                                    ("E1 and E5 contracts", contracts))},
        "idle path": idle,
        "calibration path": calib,
        "pair height": pair,
    }, indent=1))
    jax_mods = sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib")))
    if jax_mods:
        fail(f"the port loaded jax: {jax_mods[:5]}")
    ref = str(ROOT / "vision_processor_tpu") + os.sep
    ref_mods = sorted(n for n, m in list(sys.modules.items())
                      if (getattr(m, "__file__", None) or "").startswith(ref))
    if ref_mods:
        fail(f"the port loaded modules of the JAX package: {ref_mods[:5]}")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
