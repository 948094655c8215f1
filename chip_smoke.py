#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (vision_processor_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # the smoke
    python3 chip_smoke.py --profile  # + a torch.profiler breakdown of each slice
    python3 chip_smoke.py --out DIR  # long outputs (ptxas, profile, JSON) to DIR
    python3 chip_smoke.py --before DIR  # + B2-B6, E1, E5 of the checkout DIR, timed in
                                        #   turns with this checkout's
    python3 chip_smoke.py --soak-frames N  # the soak's pipelined run for 30 + N
                                           #   frame-sets (default 300)

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
   then the debug stream and the file replay (``run_replay``): rig camera
   0's frame as 14 BGR frames of an MJPG AVI that cv2 writes and reads back,
   with its gt.yml and geometry.yml, under build/smoke/replay/; the ``App``
   under the repository's config.yml as shipped (the stream on by default,
   the OPENCV driver), only the camera path, the addresses, a 200 ms
   snapshot interval and the debug images changed, geometry from the
   GeometryBus. The codec must be h264-native (the native host library,
   built with g++ from native/ beside the kernels' build), RTP packets must
   arrive on the stream group and depacketize into access units behind
   an SPS and a PPS, the detections on the wire must meet the same bounds,
   the snapshots and debug images must decode, each frame must launch B2,
   B3 once and B4 twice with B1 twice (warp) or E4 and B7 once (gather),
   and no tensor may leave the card inside ``device_step``; the device
   span of ``debug_views`` and the frame wall with the stream on and off
   are printed. Then ``app/blob_benchmark.py`` (the ``[BlobMachine]``
   line: 5 blobs a robot and 1 a ball each frame, finite) and
   ``app/geometry_benchmark.py`` (a finite ``[Model score]``) with
   ``--device cuda`` on the same dataset;
   then the camera drivers (``run_camera_drivers``): the ``App`` under
   the repository's config.yml with ``driver: MVIMPACT`` (only the
   addresses moved) reads rig camera 0 rendered as a 1080p GRBG mosaic
   from a fake mvIMPACT SDK (``fake_mvimpact``, put in ``sys.modules``
   for the phase only): 10 detection frames within the same bounds, the
   frame resolved to warp, B1 twice, B2 and B3 once and B4 twice a
   frame; then a ``NativeMulticast`` loopback round trip, and
   ``V4L2Driver`` on /dev/video0 where it exists;
   then the camera mesh (``run_camera_mesh``): an NCCL world of one rank
   (``make_camera_group``, a file rendezvous under ``--out``) holding the
   rig's 4 cameras; ``sharded_step(fused=True)`` for 10 frame-sets, the
   gathered summaries and the colour table fed back, 16 bots within the
   same bounds, E2/E3, B2 and B3 4 times and B4 8 times a frame-set, at
   most 2 device->host reads per camera, every output bit-equal to slice
   4's ``batched_step(rs_grids=None)`` on the same frames; then
   ``sharded_rollout`` for 10 frames (4 bots a camera within 30 mm after
   the first; its launches printed); the process group destroyed at the
   end, and a failure to set it up fails the smoke;
   then one port process per camera (``run_processes``): one slice-1
   ``device_step`` under ``utils/timing.py`` ``StageTimer.measure`` and
   ``trace`` (the Chrome trace must name B2's kernel), then rig cameras 0
   and 1 replayed from MJPG AVIs, each by the vision_processor launcher
   (vision_processor_tpu_torch/scripts/) in a child process with no
   ``--device``, under config.yml as shipped with the dataset harness's
   camera id and ``wait_for_geometry``; the geometry with both
   calibrations published on the wire once both wait for it. Both must
   exit 0 within PROC_LIMIT_S, hold the card's device file open while
   they run (nvidia-smi lists two more compute processes), send 14
   detection frames each within the same bounds after the first, receive
   each other's detections (t_offsets) and launch B2, B3 once, B4 twice
   and B1 twice (or E4 and B7 once) a frame, counted in each child; then
   the blob-benchmark launcher as a process on the replay phase's AVI
   must print the replay phase's ``[BlobMachine]`` line but for the
   processing time;
   then the port's headline bench (``run_bench``,
   ``vision_processor_tpu_torch/bench.py``): its four rigs (4 x 1080p
   RGGB, max_blobs 2000, factor 1.25 and 1.0, dense with 1900 extra blobs
   a camera) and ``main`` in warp mode, BENCH_ROUNDS rounds of
   BENCH_FRAMES frame-sets and a tracked rollout of BENCH_TRACKED, its
   JSON line printed as ``bench: {...}``. It must find 16 bots plain and
   at factor 1.0, recall 16/16 of the planted robots on the dense scene
   in the sustained run, untracked and after the tracked rollout, agree
   with the uncapped oracle (1.0), and launch B1
   twice, B2 once, B3 once (where the row stage ran) and B4 twice for each
   camera step it ran. The dense counts are printed beside the JAX
   package's on the same rig (``JAX_DENSE_COUNTS``, computed on the CPU).
   Then one dense frame-set with its kernel inputs recorded for phase 8,
   and ``main`` in gather mode at one round on the same raws (E4 and B7
   once a camera step, 16 bots);
   then the soak (``run_soak``): the real ``MultiCamApp`` on the card
   over a bank of 12 frames a camera of the bench's dense rig (robots and
   ball on a 300 mm loop, 2 entries with the clutter), 30 + 300
   frame-sets pipelined and 30 + 200 staggered, with a geometry packet
   every 3rd frame-set, a hot reload of camera 0's circularity and a
   4-frame-set outage of camera 1. No kernel may be built after the first
   frame-set, nor a step, grid or marks after the warm-up; the CUDA
   allocator's live blocks and bytes, the threads and the descriptors
   stay flat; every frame reaches the wire, with its planted robots, and
   with their ids and the ball wherever the JAX package finds them on the
   same frames (``JAX_SOAK_FOUND``); in every frame the outcome is the JAX
   package's or, where it is not, the port's on the CPU from the tracked
   prior, colour tables and params the card's fleet dispatched for that
   frame-set (recorded in ``dispatched.json``, replayed by
   ``replay_dispatched``); B1-B4 launch 8/4/4/8 times every frame-set;
   the clock sync's suppressed backwards jumps and the offset of
   ``get_real_time()`` before and after each run are printed;
   then degraded optics (``run_perturbation``): the six rows of
   tests/test_perturbation.py (profile, circularity, resampling factor)
   on the 4 x 1080p rig, six frames a camera of the soak's loop rendered,
   perturbed by python/perturb.py's optical steps in numpy (blur,
   vignette, white balance, noise; no JPEG) and mosaicked, each row
   through ``MultiCamApp.offline`` with the prior from the previous
   frame-set. The raws' digests, every frame's outcome and each row's mean
   robot error (within 1 mm) must be the JAX package's on the same frames
   (``JAX_PERTURB_FOUND``, from tests/jax_perturb_witness.py), "auto"
   must resolve to warp and B1-B4 launch 8/4/4/8 times a frame-set;
   recall, ball recall and mean error are printed against the JAX test's
   bars;
   then the codec round trip (``run_codec``): camera 0 of the rig (1080p
   RGGB) over the soak loop's six plain entries, rendered, encoded by the
   port's H.264 encoder at qp 24, decoded by cv2 and mosaicked again,
   through the ``App`` on the card under config.yml as shipped (a
   registered driver, geometry from the GeometryBus, detections off an
   isolated group). The decoded frames' digest and every frame's robots
   (ids within 1 mm) and balls must be the JAX App's on the same frames
   (``JAX_CODEC_FOUND``, from tests/jax_codec_witness.py), every frame
   after the first within 30 / 40 mm, "auto" resolved to warp, B1 twice,
   B2 and B3 once and B4 twice a frame, and B1-B4 on the last frame's
   inputs equal to their plain versions;
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
   above it, on slice 1's calls, slice 4's factor-1.0 map, Q = 512, the
   bench's dense frame-set (B3 at the m-lane tier's m, B4's ring at Q =
   512) and tie/exhausted cases, and with ``--before DIR`` equal to DIR's
   B3 and
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

Each slice, each App phase (the codec round trip's too), the camera mesh,
each bench run and the contract run of E1 and E5 is driven with the launch counts set to 0 just
before it and read just after; each child process of the processes phase
starts at 0 and writes its counts when it exits. The last line is
``{"ok": true, "device": {...}}``; the line before it the per-kernel JSON
record.
"""
from __future__ import annotations

import argparse
import gc
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path
from types import SimpleNamespace

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


def start_native_build():
    """Builds the native host library (io/native.py, the debug stream's
    H.264 encoder, g++ from native/) in a thread, beside the kernels'
    nvcc builds; ``.info`` gets the library and the seconds it took."""
    import threading

    from vision_processor_tpu_torch.io import native as N

    def run():
        t0 = time.perf_counter()
        thread.info["lib"] = N.load_native()
        thread.info["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=run)
    thread.info = {}
    thread.start()
    return thread


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
    """The 4-camera bench rig, ``vision_processor_tpu_torch/bench.py
    build_rig`` (bench.py's rig without JAX): one camera per field quadrant
    (960x540 model = 1080p RGGB raw, focal 900, k2 0.02, 4.5 m high over
    the Div B field), 4 bots with ids (cam * 4 + i) % 16, alternately
    yellow and blue, and a ball each, seed 7, noise 1.5. The geometry is
    the port's plain one (no protobuf) and holds every camera's
    calibration. Returns (geometry, scenes, raws, (width, height))."""
    from vision_processor_tpu_torch.bench import build_rig

    rig = build_rig(n_cams, resampling_factor=1.25, return_scenes=True,
                    resample_mode="gather", device="cuda")
    geometry, scenes, raws = rig[7], rig[9], list(rig[1])
    width, height = (int(v) for v in rig[8][0][0].size)
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


def fleet_packet(geometry, cams) -> bytes:
    """``geometry_packet`` with the calibrations of every camera in ``cams``,
    as a geometry publisher sends it to a fleet."""
    from vision_processor_tpu_torch.proto import SSL_WrapperPacket

    merged = SSL_WrapperPacket()
    for cam in cams:
        one = SSL_WrapperPacket()
        one.ParseFromString(geometry_packet(geometry, cam))
        if merged.HasField("geometry"):
            merged.geometry.calib.extend(one.geometry.calib)
        else:
            merged.CopyFrom(one)
    return merged.SerializeToString()


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

        def timed(frame, real_start):
            t0 = time.perf_counter()
            calibrate(frame, real_start)
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


REPLAY_FRAMES = 14  # frames of the replayed video
REPLAY_WARM = 4  # frames before the stream's cost is measured (snapshots, debug images)
REPLAY_GROUP, REPLAY_PORT = "224.99.99.65", 17651  # the App's vision and GC sockets
REPLAY_STREAM_END = 66  # the debug stream's group: 224.99.99.(66 + cam_id)


class Datagrams:
    """Every datagram sent to ``group:port`` (a receive buffer of 8 MB,
    for the stream's bursts of RTP packets), with its arrival time
    (``time.perf_counter``)."""

    def __init__(self, group: str, port: int):
        import socket

        from vision_processor_tpu_torch.net.udp import UDPSocket

        self.got, self.times = [], []
        got, times = self.got, self.times

        class Sock(UDPSocket):
            def _parse(self, data):
                times.append(time.perf_counter())
                got.append(data)

        self.sock = Sock(group, port)
        self.sock.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)

    def close(self) -> None:
        self.sock.close()


def access_units(packets) -> list:
    """RTP/H.264 packets -> annex-B access units, one per RTP timestamp, in
    arrival order (io/rtp.py depacketize_h264)."""
    import struct

    from vision_processor_tpu_torch.io.rtp import depacketize_h264

    by_ts = {}
    for pkt in packets:
        by_ts.setdefault(struct.unpack("!I", pkt[4:8])[0], []).append(pkt)
    return [depacketize_h264(group) for group in by_ts.values()]


def write_replay_dataset(rig, root: Path, cam: int = 0) -> str:
    """Rig camera ``cam``'s scene as REPLAY_FRAMES BGR frames in a video
    file (the Bayer frame's own RGB, so no second render), its gt.yml and
    its geometry.yml (the field and the camera's calibration), in ``root``.
    Returns the container and codec, as read back."""
    import dataclasses

    import cv2
    import numpy as np
    import yaml

    from vision_processor_tpu_torch.models.camera import CameraModel

    geometry, scenes, raws, (width, height) = rig
    raw = raws[cam]  # RGGB: r, g / g, b cells
    bgr = np.ascontiguousarray(np.stack([raw[1::2, 1::2], raw[0::2, 1::2], raw[0::2, 0::2]],
                                        axis=-1))
    path = root / "scene.avi"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30.0,
                             (width, height))
    if not writer.isOpened():
        fail("replay: cv2 cannot write an MJPG AVI")
    writer.set(cv2.VIDEOWRITER_PROP_QUALITY, 100)
    for _ in range(REPLAY_FRAMES):
        writer.write(bgr)
    writer.release()
    cap = cv2.VideoCapture(str(path))
    fourcc = int(cap.get(cv2.CAP_PROP_FOURCC))
    codec = "".join(chr((fourcc >> (8 * i)) & 0xFF) for i in range(4))
    n, first = 0, None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        first = frame if first is None else first
        n += 1
    cap.release()
    if n != REPLAY_FRAMES or first is None or first.shape != bgr.shape:
        fail(f"replay: read back {n} frames of {None if first is None else first.shape} "
             f"from {path.name}, wrote {REPLAY_FRAMES} of {bgr.shape}")
    calib = next(c for c in geometry.calib if c.camera_id == cam)
    model = CameraModel.from_proto(calib)
    (root / "geometry.yml").write_text(yaml.dump({
        "field": FIELD["field"],
        "calib": [{f.name: getattr(calib, f.name) for f in dataclasses.fields(calib)}]}))
    truth = []
    for f in range(REPLAY_FRAMES):
        entry = {"camera_id": cam, "frame_number": f + 1, "t_capture": f / 30.0,
                 "t_sent": f / 30.0, "balls": [], "robots_yellow": [], "robots_blue": []}
        for ball in scenes[cam].balls:
            px = model.field2image(np.array([ball.x, ball.y, 0.0]))
            entry["balls"].append({"confidence": 1.0, "x": ball.x, "y": ball.y,
                                   "pixel_x": float(px[0]), "pixel_y": float(px[1])})
        for bot in scenes[cam].bots:
            px = model.field2image(np.array([bot.x, bot.y, bot.height]))
            entry[f"robots_{bot.team}"].append({
                "confidence": 1.0, "robot_id": bot.bot_id, "x": bot.x, "y": bot.y,
                "orientation": bot.orientation, "pixel_x": float(px[0]),
                "pixel_y": float(px[1]), "height": bot.height})
        truth.append(entry)
    (root / "gt.yml").write_text(yaml.dump(truth))
    return (f"AVI container, {codec} codec (cv2.VideoWriter, quality 100), "
            f"{REPLAY_FRAMES} frames {width}x{height} BGR, read back {n}")


def shipped_config(root: Path, group: str = REPLAY_GROUP, port: int = REPLAY_PORT,
                   stream_end: int = REPLAY_STREAM_END) -> Path:
    """The repository's config.yml as shipped, with only what a run here has
    to change: the camera path (the replayed video), the vision, GC and
    stream addresses (an isolated group), a 200 ms snapshot interval and
    the debug images."""
    import yaml

    config = yaml.safe_load((ROOT / "config.yml").read_text())
    config["camera"] = {**(config.get("camera") or {}), "path": str(root / "scene.avi")}
    config["network"] = {"vision_ip": group, "vision_port": port,
                         "gc_ip": group, "gc_port": port + 1}
    config["stream"] = {**(config.get("stream") or {}), "ip_base_prefix": "224.99.99.",
                        "ip_base_end": stream_end, "port": port + 2}
    config["debug"] = {**(config.get("debug") or {}), "debug_stream_interval_ms": 200,
                       "debug_images": True}
    path = root / "config.yml"
    path.write_text(yaml.dump(config))
    return path


def _bench_lines(fn, argv) -> list:
    """``fn(argv)``'s standard output, as lines; fails unless it returns 0."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(line)
    if rc != 0:
        fail(f"{fn.__module__}.main returned {rc}")
    return lines


# python/blob_benchmark.py's names for the values of the [BlobMachine] line
BLOB_MACHINE_FIELDS = ("frames", "blobs", "error", "sq_error", "worst_blob", "percentile",
                       "balls", "ball_error", "ball_sq", "bots", "bot_error", "bot_sq",
                       "field_scale", "processing_time")


def run_replay(torch, rig, native_build) -> dict:
    """The debug stream and the file replay under the repository's
    config.yml as shipped (``shipped_config``; the stream on by default,
    the OPENCV driver): rig camera 0's frames replayed from a video file by
    the ``App`` on the card, geometry from the GeometryBus, the debug
    stream, snapshots and debug images written under OUT/replay/. Fails
    unless the codec is h264-native, RTP packets arrive on the stream group
    and depacketize into access units, the first behind its SPS and PPS,
    the detection frames on the wire find the 4 robot ids within 30 mm and
    the ball within 40 mm after the first, the four snapshots and the three
    debug images decode at the views' shapes, each frame launched B2 and B3
    once and B4 twice with B1 twice (warp) or E4 and B7 once (gather) and
    B5, B6 never, and no tensor left the card inside ``device_step``. After
    REPLAY_WARM frames the snapshots stop (the shipped interval, 0) and the
    stream is switched off every other frame: the frame walls with the
    stream on and off, and the device span of ``debug_views``, are printed.
    Then ``app/blob_benchmark.py`` and ``app/geometry_benchmark.py`` on the
    same dataset with ``--device cuda``: the ``[BlobMachine]`` line parses
    into python/blob_benchmark.py's fields, 5 blobs a robot and 1 a ball
    each frame, a finite error; ``[Model score]`` finite."""
    phase("debug stream and replay: App under config.yml as shipped, the benchmarks")
    import cv2

    from vision_processor_tpu_torch.app import blob_benchmark, geometry_benchmark
    from vision_processor_tpu_torch.app.main import App
    from vision_processor_tpu_torch.io.rtp import split_annexb
    from vision_processor_tpu_torch.ops import cuda as K

    geometry, scenes, raws, (width, height) = rig
    workdir = OUT / "replay"
    workdir.mkdir(parents=True, exist_ok=True)
    for old in [*workdir.glob(".*.1.png"), *(workdir / "img").glob("*.jpg")]:
        old.unlink()
    t_phase = t0 = time.perf_counter()
    container = write_replay_dataset(rig, workdir)
    cfg_path = shipped_config(workdir)
    print(f"replay dataset: {container} ({time.perf_counter() - t0:.3f} s)")
    native_build.join()
    if native_build.info.get("lib") is None:
        fail("replay: the native host library (io/native.py) did not build")
    print(f"native host library {native_build.info['lib']._name}: built or loaded in "
          f"{native_build.info['s']:.3f} s, beside the kernels' build")
    bus = GeometryBus(geometry_packet(geometry, 0))
    wire = Datagrams(REPLAY_GROUP, REPLAY_PORT)
    rtp = Datagrams(f"224.99.99.{REPLAY_STREAM_END}", REPLAY_PORT + 2)
    state = {"n": 0, "walls": {True: [], False: []}}
    cwd = os.getcwd()
    os.chdir(workdir)  # img/ and the debug images go under the working directory
    try:
        app = App(str(cfg_path), device=torch.device("cuda", 0))
        cfg = app.config
        if not cfg.stream_active or cfg.wait_for_geometry:
            fail(f"replay: config.yml gives stream.active {cfg.stream_active}, "
                 f"wait_for_geometry {cfg.wait_for_geometry}")
        if app.streamer.codec != "h264-native":
            fail(f"replay: the stream picked {app.streamer.codec}, not h264-native")
        bus.attach(app.socket)
        bus.publish()
        proc = app.processor
        step, detection_path, stream = (proc.device_step, app._detection_path,
                                        app._stream_and_snapshot)

        def audited_step(*args):
            if state["n"] != 2:
                return step(*args)
            out, items, d2h = audit_device_step(torch, lambda: step(*args))
            state["items"], state["d2h"] = items, d2h
            return out

        def timed_path(frame, start, real_start):
            state["n"] += 1
            on = state["n"] <= REPLAY_WARM or state["n"] % 2 == 0
            if state["n"] == REPLAY_WARM + 1:
                cfg.debug_stream_interval_ms = 0  # config.yml's own interval
            state["on"] = on
            torch.cuda.synchronize()
            t = time.perf_counter()
            detection_path(frame, start, real_start)
            wall = (time.perf_counter() - t) * 1e3
            if state["n"] > REPLAY_WARM:
                state["walls"][on].append(wall)

        def switched_stream(frame, real_start):
            if state["on"]:
                stream(frame, real_start)

        proc.device_step = audited_step
        app._detection_path = timed_path
        app._stream_and_snapshot = switched_stream
        K.reset_launches()
        t0 = time.perf_counter()
        app.run()  # closes the App, its streamer and its snapshot writer
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        time.sleep(0.3)
    finally:
        os.chdir(cwd)
        wire.close()
        rtp.close()
    from vision_processor_tpu_torch.proto import SSL_WrapperPacket

    dets = []
    for data in wire.got:
        msg = SSL_WrapperPacket()
        msg.ParseFromString(data)
        if msg.HasField("detection"):
            dets.append(msg)
    if len(dets) != REPLAY_FRAMES:
        fail(f"replay: {len(dets)} detection frames on the wire, expected {REPLAY_FRAMES}")
    worst = ball_worst = 0.0
    for f, wrapper in enumerate(dets[1:], start=1):
        _, err, berr = check_detections(f"replay detection frame {f}", scenes[0], wrapper)
        worst, ball_worst = max(worst, err), max(ball_worst, berr)
    units = access_units(rtp.got)
    if not units:
        fail("replay: no RTP packets on the stream group")
    nals = [[nal[0] & 0x1F for nal in split_annexb(au)] for au in units]
    if nals[0][:2] != [7, 8] or 5 not in nals[0]:
        fail(f"replay: the first access unit's NAL units are {nals[0][:4]}, not SPS, PPS, "
             f"IDR")
    if any(not n for n in nals):
        fail("replay: an access unit held no NAL unit")
    hf, wf = proc._bm_cfg.flat_shape
    images = {f".{n}.1.png": (hf, wf, 3) for n in ("flat", "gradDot", "blob")}
    images.update({f"img/0.{n}.jpg": (hf, wf, 3) for n in ("flat", "gradient", "blob")})
    images["img/0.raw.jpg"] = (height, width, 3)
    for name, shape in images.items():
        img = cv2.imread(str(workdir / name))
        if img is None or img.shape != shape:
            fail(f"replay: {name} is {None if img is None else img.shape}, expected {shape}")
    mode = proc.resample_mode
    want = {name: 0 for name in launches}
    want.update(blob_response_fused=1, row_topk=1, query_select_topk=2)
    if mode == "warp":
        want.update(band_pass=2)
    else:
        want.update(corner_stack=1, gather_corners=1)
    check_launches("replay", launches, want, REPLAY_FRAMES)
    if state.get("d2h") or state.get("items", 3) > 2:
        fail(f"replay: device_step moved {state.get('d2h')} to the host, "
             f"{state.get('items')} reads")
    # the cost of streaming: debug_views' device span (every view, as a
    # snapshot renders them; one view, as the stream does) and the frame walls
    bgr = cv2.VideoCapture(str(workdir / "scene.avi")).read()[1]
    spans = {}
    for label, keys in (("four views", None), ("one view", ("raw_rgb",))):
        args = (bgr, "BGR") if keys is None else (bgr, "BGR", keys)
        for _ in range(3):
            proc.debug_views(*args)
        ms = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            proc.debug_views(*args)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        spans[label] = statistics.median(ms)
    on, off = (statistics.median(state["walls"][k]) for k in (True, False))
    print(f"replay: BGR frame {width}x{height} resolved to {mode}; {len(dets)} detection "
          f"frames on the wire, max bot err {worst:.2f} mm, max ball err {ball_worst:.2f} "
          f"mm; launches {launches}; device->host reads in device_step "
          f"{state['items']}, no tensor left the card")
    print(f"replay: stream {app.streamer.codec}, {len(rtp.got)} RTP packets, "
          f"{len(units)} access units ({sum(map(len, units))} bytes; first NAL types "
          f"{nals[0][:3]}); snapshots and debug images written {sorted(images)}; run "
          f"{wall:.3f} s")
    print(f"cost of streaming: debug_views device span, median of 10: four views "
          f"{spans['four views']:.3f} ms, one view {spans['one view']:.3f} ms; frame wall "
          f"(the detection path, medians of {len(state['walls'][True])} and "
          f"{len(state['walls'][False])} alternating frames) stream on {on:.3f} ms, "
          f"off {off:.3f} ms")

    t0 = time.perf_counter()
    os.chdir(workdir)  # the config's ground_truth (gt.yml) is relative to it
    try:
        argv = [str(cfg_path), "--device", "cuda"]
        blob_lines = _bench_lines(blob_benchmark.main, argv)
        geom_lines = _bench_lines(geometry_benchmark.main, argv)
    finally:
        os.chdir(cwd)
    bench_s = time.perf_counter() - t0
    machine = [ln for ln in blob_lines if ln.startswith("[BlobMachine]")]
    values = machine[0].split()[1:] if len(machine) == 1 else []
    if len(values) != len(BLOB_MACHINE_FIELDS):
        fail(f"blob benchmark: {machine} does not parse into {len(BLOB_MACHINE_FIELDS)} "
             f"fields")
    blob = dict(zip(BLOB_MACHINE_FIELDS, map(float, values)))
    per_frame = 5 * len(scenes[0].bots) + len(scenes[0].balls)
    if blob["frames"] != REPLAY_FRAMES or blob["blobs"] != per_frame * REPLAY_FRAMES:
        fail(f"blob benchmark: {blob['blobs']:.0f} blobs in {blob['frames']:.0f} frames, "
             f"expected {per_frame} a frame in {REPLAY_FRAMES}")
    if not all(map(math.isfinite, blob.values())):
        fail(f"blob benchmark: a value is not finite: {blob}")
    score = [ln for ln in geom_lines if ln.startswith("[Model score]")]
    model_score = float(score[0].split()[2]) if len(score) == 1 else float("nan")
    if not math.isfinite(model_score):
        fail(f"geometry benchmark: no finite [Model score] in {score}")
    phase_s = time.perf_counter() - t_phase
    print(f"benchmarks: {bench_s:.3f} s; blob error {blob['error'] / blob['blobs']:.3f} mm "
          f"a blob, model score {model_score}; the phase {phase_s:.3f} s")
    return {"container": container, "resample_mode": mode, "launches": launches,
            "detections": len(dets), "max_bot_err_mm": worst, "max_ball_err_mm": ball_worst,
            "rtp_packets": len(rtp.got), "access_units": len(units),
            "debug_views_ms": spans, "frame_wall_ms": {"stream_on": on, "stream_off": off},
            "frame_walls_ms": {"on": state["walls"][True], "off": state["walls"][False]},
            "blob_machine": blob, "blob_machine_line": machine[0],
            "model_score": model_score, "run_s": wall, "benchmarks_s": bench_s,
            "phase_s": phase_s}


DRIVER_FRAMES = 10  # detection frames from the fake mvIMPACT camera
DRIVER_GROUP, DRIVER_PORT = "224.99.99.67", 17671  # the App's vision and GC sockets
DRIVER_STREAM_END = 68  # the debug stream's group: 224.99.99.68
LOOPBACK_GROUP, LOOPBACK_PORT = "224.99.99.69", 17691  # NativeMulticast's round trip


def fake_mvimpact(frames: list):
    """A stand-in for the mvIMPACT Acquire SDK's Python module (the calls
    ``io/vendor.py MVImpactDriver`` makes; no SDK is on the machine): one
    device; each wait with a timeout completes one request holding the next
    of ``frames`` (a Mono8 buffer carrying the mosaic, hardware time 10 ms
    a frame), a wait without one finds nothing newer, and after the last
    frame every wait times out. Returns (package, acquire module)."""
    import types

    acquire = types.ModuleType("mvIMPACT.acquire")
    package = types.ModuleType("mvIMPACT")
    package.acquire = acquire
    queue = list(frames)

    def read(value):
        return types.SimpleNamespace(read=lambda: value)

    class Request:
        def __init__(self, data, ts_us):
            self.data = data
            self.imageHeight, self.imageWidth = read(data.shape[0]), read(data.shape[1])
            self.infoTimeStamp_us = read(ts_us)
            self.requestResult = types.SimpleNamespace(readS=lambda: "OK")

        def getImageBufferDesc(self):
            return types.SimpleNamespace(getBuffer=lambda: self.data.data)

        def unlock(self):
            pass

    class FunctionInterface:
        def __init__(self, device):
            self.requests, self.n = {}, 0

        def imageRequestSingle(self):
            pass

        def imageRequestWaitFor(self, timeout_ms):
            if timeout_ms <= 0 or not queue:
                return -1
            self.n += 1
            self.requests[self.n] = Request(queue.pop(0), 10_000 * self.n)
            return self.n

        def isRequestNrValid(self, nr):
            return nr > 0

        def getRequest(self, nr):
            return self.requests.pop(nr)

    class Prop:
        def write(self, value):
            pass

        writeS = write

    device = types.SimpleNamespace(open=lambda: None, close=lambda: None)
    acquire.DeviceManager = lambda: types.SimpleNamespace(
        deviceCount=lambda: 1, getDevice=lambda i: device)
    acquire.FunctionInterface = FunctionInterface
    acquire.SettingsBlueDevice = lambda dev: types.SimpleNamespace(
        imageDestination=types.SimpleNamespace(pixelFormat=Prop()),
        cameraSettings=types.SimpleNamespace(exposeUsec=Prop(), gain_dB=Prop()))
    return package, acquire


def run_camera_drivers(torch, rig, card: str) -> dict:
    """The camera drivers (io/vendor.py, io/native.py). The ``App`` on the
    card under the repository's config.yml as shipped, with ``driver:
    MVIMPACT`` and only the addresses moved, reads rig camera 0 rendered
    as a 1080p GRBG mosaic from a fake mvIMPACT SDK (``fake_mvimpact``,
    installed for this phase), geometry from the GeometryBus. Fails unless
    the App opened ``MVImpactDriver`` (format GRBG), sent DRIVER_FRAMES
    detection frames, each after the first with the 4 robot ids within 30
    mm and the ball within 40 mm, the frame resolved to warp, and each
    frame launched B1 twice, B2 and B3 once and B4 twice (nothing else).
    Then ``NativeMulticast`` sends a datagram to itself through a second
    socket on the same group (the loopback) and times out on the next
    receive; and ``V4L2Driver`` reads one frame from /dev/video0 where the
    device exists."""
    phase("camera drivers: App on a GRBG mvIMPACT camera, native multicast, V4L2")
    import yaml

    from vision_processor_tpu_torch.app.main import App
    from vision_processor_tpu_torch.io import native as N
    from vision_processor_tpu_torch.io.synthetic import render_raw
    from vision_processor_tpu_torch.models.camera import CameraModel
    from vision_processor_tpu_torch.ops import cuda as K
    from vision_processor_tpu_torch.utils.config import CameraSection

    geometry, scenes, _, (width, height) = rig
    model = CameraModel.from_proto(next(c for c in geometry.calib if c.camera_id == 0))
    grbg = render_raw(model, geometry.field, scenes[0], "GRBG")
    workdir = OUT / "drivers"
    workdir.mkdir(parents=True, exist_ok=True)
    config = yaml.safe_load((ROOT / "config.yml").read_text())
    config["camera"] = {**(config.get("camera") or {}), "driver": "MVIMPACT", "id": 0}
    config["network"] = {"vision_ip": DRIVER_GROUP, "vision_port": DRIVER_PORT,
                         "gc_ip": DRIVER_GROUP, "gc_port": DRIVER_PORT + 1}
    config["stream"] = {**(config.get("stream") or {}), "ip_base_prefix": "224.99.99.",
                        "ip_base_end": DRIVER_STREAM_END, "port": DRIVER_PORT + 2}
    cfg_path = workdir / "config.yml"
    cfg_path.write_text(yaml.dump(config))
    bus = GeometryBus(geometry_packet(geometry, 0))
    sdk = fake_mvimpact([grbg] * DRIVER_FRAMES)
    saved = {name: sys.modules.get(name) for name in ("mvIMPACT", "mvIMPACT.acquire")}
    sys.modules.update({"mvIMPACT": sdk[0], "mvIMPACT.acquire": sdk[1]})
    cwd = os.getcwd()
    os.chdir(workdir)  # the snapshots go under the working directory
    try:
        app = App(str(cfg_path), device=torch.device("cuda", 0))
        camera = app.camera
        if type(camera).__name__ != "MVImpactDriver" or camera.fmt != "GRBG":
            fail(f"camera drivers: MVIMPACT opened {type(camera).__name__} ({camera.fmt})")
        bus.attach(app.socket)
        bus.publish()
        K.reset_launches()
        t0 = time.perf_counter()
        app.run()  # to the camera's timeout; closes the App
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        os.chdir(cwd)
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
    dets = bus.detections(0)
    if len(dets) != DRIVER_FRAMES:
        fail(f"camera drivers: {len(dets)} detection frames, expected {DRIVER_FRAMES}")
    worst = ball_worst = 0.0
    for f, wrapper in enumerate(dets[1:], start=1):
        _, err, berr = check_detections(f"camera drivers detection frame {f}", scenes[0],
                                        wrapper)
        worst, ball_worst = max(worst, err), max(ball_worst, berr)
    mode = app.processor.resample_mode
    if mode != "warp":
        fail(f"camera drivers: the GRBG frame resolved to {mode!r}, expected 'warp'")
    want = {name: 0 for name in launches}
    want.update(band_pass=2, blob_response_fused=1, row_topk=1, query_select_topk=2)
    check_launches("camera drivers", launches, want, DRIVER_FRAMES)
    stamps = [d.detection.t_capture_camera for d in dets]
    print(f"camera drivers: MVImpactDriver, GRBG {grbg.shape[1]}x{grbg.shape[0]} (model "
          f"{width}x{height}) under config.yml as shipped (stream {app.streamer.codec}), "
          f"resolved to {mode}; {len(dets)} detection frames, max bot err {worst:.2f} mm, "
          f"max ball err {ball_worst:.2f} mm, camera timestamps {stamps[0]:.2f}.."
          f"{stamps[-1]:.2f} s; launches {launches}; run {wall:.3f} s ({card})")

    a = N.NativeMulticast(LOOPBACK_GROUP, LOOPBACK_PORT)
    b = N.NativeMulticast(LOOPBACK_GROUP, LOOPBACK_PORT)
    try:
        payload = b"\x01\x02\x03 camera drivers"
        t0 = time.perf_counter()
        a.send(payload)
        got = b.recv(500)
        rtt = time.perf_counter() - t0
        late = b.recv(10)
    finally:
        a.close()
        b.close()
    if got != payload or late is not None:
        fail(f"native multicast: received {got!r}, then {late!r}")
    print(f"native multicast: {len(payload)} bytes round trip on {LOOPBACK_GROUP}:"
          f"{LOOPBACK_PORT} in {rtt * 1e3:.3f} ms, the next receive timed out")

    v4l2 = "no /dev/video0"
    if Path("/dev/video0").exists():
        drv = N.V4L2Driver(CameraSection(driver="V4L2", path="/dev/video0"))
        try:
            frame = drv.read_image()
        finally:
            drv.close()
        v4l2 = ("/dev/video0: no frame within 1 s" if frame is None else
                f"/dev/video0: one {frame.fmt} frame {frame.data.shape}")
    print(f"V4L2: {v4l2}")
    return {"launches": launches, "resample_mode": mode, "detections": len(dets),
            "max_bot_err_mm": worst, "max_ball_err_mm": ball_worst, "run_s": wall,
            "multicast_round_trip_ms": rtt * 1e3, "v4l2": v4l2}


MESH_FRAME_SETS = 10


def _equal_trees(label: str, got, want) -> int:
    """Fails unless every tensor of ``got`` equals ``want``'s bit for bit
    (NaN where NaN); returns the number of tensors compared."""
    import numpy as np

    from vision_processor_tpu_torch.utils.state import to_numpy

    got, want = to_numpy(got), to_numpy(want)
    n = 0
    for part, (g, w) in enumerate(zip(got, want)):
        if sorted(g) != sorted(w):
            fail(f"{label}: output {part} has keys {sorted(g)}, expected {sorted(w)}")
        for k in w:
            same = g[k].shape == w[k].shape and np.array_equal(
                g[k], w[k], equal_nan=g[k].dtype.kind == "f")
            if not same:
                fail(f"{label}: {k} of output {part} differs")
            n += 1
    return n


def run_camera_mesh(torch, recorder, rig, card: str) -> dict:
    """The camera mesh over torch.distributed (parallel/multicam.py): an
    NCCL world of one rank on the card (a file rendezvous under OUT), the
    4-camera rig as the rank's n_local = 4 cameras. ``sharded_step(fused=
    True)`` runs MESH_FRAME_SETS frame-sets, the all-gathered summaries and
    the colour table fed back, the wrappers from the fleet's host
    finishing: 16 bots within 30 mm and each ball within 40 mm on every
    frame-set after the first; per frame-set E2/E3 4, B2 and B3 4, B4 8,
    nothing else; at most 2 device->host reads per camera in the step. The
    same frame-sets through slice 4's ``batched_step(rs_grids=None)``, its
    own summaries fed back, must give every output bit for bit (the
    summaries as the gathered ones). Then ``sharded_rollout`` for
    MESH_FRAME_SETS frames (the gather grids, built once): 4 bots a camera
    within 30 mm after the first frame; its launches are printed. The
    process group is destroyed at the end; a failure to set it up fails
    the phase."""
    phase("camera mesh: NCCL world of 1, sharded_step and sharded_rollout")
    import numpy as np
    import torch.distributed as dist

    from vision_processor_tpu_torch.app.processor import TrackedArrays
    from vision_processor_tpu_torch.io.camera import RawFrame
    from vision_processor_tpu_torch.ops import cuda as K
    from vision_processor_tpu_torch.parallel import multicam as M
    from vision_processor_tpu_torch.utils.state import to_torch

    _, scenes, raws, (width, height) = rig
    OUT.mkdir(parents=True, exist_ok=True)
    rdzv = OUT / "mesh-rdzv"
    rdzv.unlink(missing_ok=True)
    t0 = time.perf_counter()
    try:
        group = M.make_camera_group(device=torch.device("cuda", 0),
                                    init_method=f"file://{rdzv}", rank=0, world_size=1)
    except Exception as exc:  # any failure of the group's set-up ends the smoke
        fail(f"camera mesh: the NCCL process group did not initialise: {exc!r}")
    init_s = time.perf_counter() - t0
    try:
        if dist.get_backend() != "nccl":
            fail(f"camera mesh: backend {dist.get_backend()}, expected nccl")
        app = _offline_fleet(torch, rig, "gather", 1.25)
        dev = app.device
        frames = [RawFrame(data=r, fmt="RGGB", width=width, height=height) for r in raws]
        if not app._ensure_step("RGGB", raws[0].shape):
            fail("camera mesh: the fleet is not calibrated")
        state, _ = app._device_inputs(
            TrackedArrays.build({}, 0.0, app.processors[0].det_cfg.max_tracked))
        fleet = app._fleet_params()
        fleet["tracked_time_delta"] = np.float32(0.01)
        params = to_torch(fleet, dev)
        marks = {k: v[0] for k, v in app._marks.items()}  # one field, replicated
        cfg = app.mc_cfg
        n_local = cfg.n_cams // group.world
        print(f"process group: {dist.get_backend()}, rank {group.rank} of {group.world} "
              f"on {group.device}, set up in {init_s:.3f} s; n_local {n_local}, flat grid "
              f"{cfg.bm.flat_shape}, in line")
        step = M.sharded_step(cfg, group, fused=True)
        raws_t = torch.from_numpy(np.stack(raws)).to(dev)

        def run(colors, prev):
            return step(raws_t, state["packed"], state["scales"], state["offsets"], colors,
                        prev, params, state["refs"], marks)

        outs = []

        def finish(out, now):
            blobs, det, gathered, fin = out
            outs.append(out)
            carry["in"] = (fin["colors7"], gathered)
            return app.finish_frames((blobs, det, fin), now, frames)

        empty = M.empty_summary(cfg, dev)
        carry = {"in": (state["colors"], empty)}
        finish(run(*carry["in"]), 0.0)  # warm-up (first-use allocations, the communicator)
        outs.clear()
        carry["in"] = (state["colors"], empty)
        res = drive(torch, recorder, "camera mesh", scenes, MESH_FRAME_SETS,
                    SLICE4_LAUNCHES, lambda now: run(*carry["in"]), finish, "sharded_step",
                    "frame-set")

        bstep = M.batched_step(cfg)
        prev, colors, n_equal = empty, state["colors"], 0
        for f, out in enumerate(outs):
            want = bstep(raws_t, state["packed"], state["scales"], state["offsets"], colors,
                         prev, params, None, None, state["refs"], app._marks)
            gathered = {k: v.reshape(want[2][k].shape) for k, v in out[2].items()}
            n_equal += _equal_trees(f"camera mesh frame-set {f} against batched_step",
                                    (out[0], out[1], gathered, out[3]), want)
            prev, colors = want[2], want[3]["colors7"]
        print(f"sharded_step == batched_step(rs_grids=None): {n_equal} tensors over "
              f"{len(outs)} frame-sets, bit for bit")

        roll = M.sharded_rollout(cfg, group, MESH_FRAME_SETS)
        bank = raws_t.unsqueeze(0).expand(MESH_FRAME_SETS, *raws_t.shape)
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rolled = roll(bank, state["packed"], state["scales"], state["offsets"],
                      state["colors"], params)
        torch.cuda.synchronize()
        roll_s = time.perf_counter() - t0
        roll_launches = dict(K.LAUNCHES)
        valid = rolled["bot_valid"].cpu().numpy()
        pos = rolled["bot_pos"].cpu().numpy()
        worst_roll = 0.0
        for f in range(1, MESH_FRAME_SETS):
            for c, scene in enumerate(scenes):
                got = pos[f, c][valid[f, c]]
                if len(got) != len(scene.bots):
                    fail(f"camera mesh rollout frame {f} camera {c}: {len(got)} bots, "
                         f"expected {len(scene.bots)}")
                for bot in scene.bots:
                    err = float(np.hypot(*(got - [bot.x, bot.y]).T).min())
                    if err > 30.0:
                        fail(f"camera mesh rollout frame {f} camera {c}: bot error "
                             f"{err:.2f} mm")
                    worst_roll = max(worst_roll, err)
        ids = rolled["summary_id"].cpu().numpy()
        print(f"sharded_rollout: {MESH_FRAME_SETS} frames in {roll_s:.3f} s (wall, "
              f"{roll_s / MESH_FRAME_SETS * 1e3:.3f} ms a frame-set; {card}); 4 bots a "
              f"camera after the first frame, max err {worst_roll:.2f} mm; summary ids of "
              f"the last frame {[sorted(set(r[r >= 0].tolist())) for r in ids[-1]]}; "
              f"launches {roll_launches}")
        print(f"camera mesh: median device span {res['median_device_ms']:.3f} ms a "
              f"frame-set, {1e3 / res['median_frame_ms']:.1f} frame-sets/s ({card})")
    finally:
        dist.destroy_process_group()
    res.update(init_s=init_s, tensors_equal=n_equal, rollout_s=roll_s,
               rollout_launches=roll_launches, rollout_max_bot_err_mm=worst_roll)
    return res


PROC_CAMS = (0, 1)  # the rig cameras, one OS process each
PROC_GROUP, PROC_PORT = "224.99.99.135", 17731  # the processes' vision and GC sockets
PROC_STREAM_END = 136  # their debug streams: 224.99.99.(136 + cam_id)
PROC_LIMIT_S = 180.0  # each child process, from spawn to exit
LAUNCHER_DIR = ROOT / "vision_processor_tpu_torch" / "scripts"
# runs a launcher as __main__ in this process, then writes the port's launch
# counts (ops/cuda.py LAUNCHES, 0 at the process's start) to a file
COUNTING_RUNNER = """import json, runpy, sys
launcher, counts = sys.argv[1], sys.argv[2]
sys.argv = [launcher, *sys.argv[3:]]
try:
    runpy.run_path(launcher, run_name="__main__")
finally:
    from vision_processor_tpu_torch.ops import cuda
    with open(counts, "w") as fh:
        json.dump(dict(cuda.LAUNCHES), fh)
"""


def _card_files(pid: int) -> list:
    """The card's device files (/dev/nvidiaN) process ``pid`` holds open."""
    import re

    out = []
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if re.fullmatch(r"/dev/nvidia\d+", target):
                out.append(target)
    except OSError:
        pass
    return out


def _compute_apps() -> list:
    """nvidia-smi's compute processes, as its pid column gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi --query-compute-apps: {smi.stderr.strip()}")
    return [line.strip() for line in smi.stdout.splitlines() if line.strip()]


def _device_step_traced(torch, rig) -> dict:
    """One ``Processor.device_step`` of rig camera 0 (slice 1's
    configuration) under ``utils/timing.py`` ``StageTimer.measure`` and
    ``trace``: fails unless the Chrome trace it writes names B2's kernel
    (csrc/blob_fused.cu ``blob_tile_kernel``) and the timer kept one device
    time for the call."""
    from vision_processor_tpu_torch.app.processor import Processor, TrackedArrays
    from vision_processor_tpu_torch.utils.timing import StageTimer, trace

    geometry, _, raws, (width, height) = rig
    device = torch.device("cuda", 0)
    proc = Processor(vision_config("auto"), device=device)
    proc.geometry_check(width, height, geometry, 1)
    tracked = TrackedArrays.build({}, 0.0, proc.det_cfg.max_tracked)
    proc.device_step(raws[0], "RGGB", tracked)  # the first call's set-up stays out
    timer = StageTimer(device)
    log_dir = OUT / "trace"
    for old in log_dir.glob("*.json"):
        old.unlink()
    with trace(str(log_dir)) as where:
        timer.measure("device_step", proc.device_step, raws[0], "RGGB", tracked)
    files = sorted(Path(where).glob("*.json"))
    if len(files) != 1:
        fail(f"trace: {len(files)} trace files in {where}, expected 1")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    b2 = [k for k in kernels if "blob_tile_kernel" in k]
    device_ms = timer.device_ms("device_step")
    if not b2:
        fail(f"trace: no blob_tile_kernel among {len(kernels)} kernel events of "
             f"device_step ({sorted(set(k[:40] for k in kernels))[:8]})")
    if timer.counts["device_step"] != 1 or len(device_ms) != 1 or not device_ms[0] > 0:
        fail(f"measure: counts {dict(timer.counts)}, device ms {device_ms}")
    host_ms = timer.totals["device_step"] * 1e3
    print(f"device_step under StageTimer.measure and trace: host {host_ms:.3f} ms to the "
          f"fence, device span {device_ms[0]:.3f} ms; {len(kernels)} kernel events in "
          f"{files[0].name}, B2 as {b2[0]!r}")
    return {"host_ms": host_ms, "device_ms": device_ms[0], "kernel_events": len(kernels),
            "b2_events": len(b2), "trace": str(files[0])}


def run_processes(torch, rig, replay: dict, card: str) -> dict:
    """The port as SSL teams run it, one OS process per camera: rig cameras
    0 and 1 as MJPG AVIs (``write_replay_dataset``, 1080p RGGB frames of the
    960x540 models as BGR) with their gt.yml and geometry.yml under
    OUT/processes/cam<N>/, each under config.yml as shipped
    (``shipped_config``, on this phase's group) with the dataset harness's
    two changes (python/binary.py run_processor): the camera id and
    ``wait_for_geometry``. Each runs the vision_processor launcher with no
    ``--device`` (the card) in a child process (``COUNTING_RUNNER``, which
    writes its launch counts at exit). Once both wait for geometry, the
    smoke publishes the geometry with both calibrations every 100 ms
    through the port's net/udp.py and records the wire. Fails unless both
    exit 0 within PROC_LIMIT_S, each held the card's device file open
    while it ran and nvidia-smi listed two more compute processes than
    before them, each camera sent REPLAY_FRAMES detection frames with its
    4 robot ids within 30 mm and its ball within 40 mm after the first,
    each received the other's (t_offsets), and each launched B2 and B3
    once, B4 twice and B1 twice (warp) or E4 and B7 once (gather) a frame.
    Then the blob-benchmark launcher as a process on the replay phase's
    dataset (camera 0's AVI): its ``[BlobMachine]`` line must equal the
    replay phase's in-process line but for the processing time. Before
    all, ``_device_step_traced``."""
    phase("processes: one port process per camera")
    import threading

    import yaml

    from vision_processor_tpu_torch.proto import SSL_WrapperPacket

    traced = _device_step_traced(torch, rig)
    geometry, scenes, _, _ = rig
    workdir = OUT / "processes"
    runner = workdir / "counting_runner.py"
    workdir.mkdir(parents=True, exist_ok=True)
    runner.write_text(COUNTING_RUNNER)
    configs = {}
    for cam in PROC_CAMS:
        root = workdir / f"cam{cam}"
        root.mkdir(exist_ok=True)
        write_replay_dataset(rig, root, cam)
        path = shipped_config(root, PROC_GROUP, PROC_PORT, PROC_STREAM_END)
        config = yaml.safe_load(path.read_text())
        config["cam_id"] = cam
        config["debug"]["wait_for_geometry"] = True
        path.write_text(yaml.dump(config))
        configs[cam] = path
    packet = fleet_packet(geometry, PROC_CAMS)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    before_apps = _compute_apps()
    wire = Datagrams(PROC_GROUP, PROC_PORT)
    stop = threading.Event()

    def publish():
        while not stop.is_set():
            wire.sock.sock.sendto(packet, wire.sock.address)
            time.sleep(0.1)

    publisher = threading.Thread(target=publish, daemon=True)
    procs, logs, spawned = {}, {}, {}
    most_apps, card_files = before_apps, {cam: [] for cam in PROC_CAMS}
    try:
        for cam in PROC_CAMS:
            logs[cam] = open(workdir / f"cam{cam}.log", "wb")
            spawned[cam] = time.perf_counter()
            procs[cam] = subprocess.Popen(
                [sys.executable, str(runner), str(LAUNCHER_DIR / "vision_processor.py"),
                 str(workdir / f"cam{cam}.launches.json"), str(configs[cam])],
                cwd=str(configs[cam].parent), env=env, stdout=logs[cam],
                stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        while True:  # both wait for geometry: publish, so that their frames overlap
            texts = {cam: (workdir / f"cam{cam}.log").read_text(errors="replace")
                     for cam in PROC_CAMS}
            if all("Waiting for geometry" in t for t in texts.values()):
                break
            for cam, proc in procs.items():
                if proc.poll() is not None:
                    fail(f"processes: camera {cam} exited with {proc.returncode} before "
                         f"geometry:\n{texts[cam][-3000:]}")
            if time.perf_counter() - t0 > PROC_LIMIT_S:
                fail(f"processes: not both waiting for geometry after {PROC_LIMIT_S} s")
            time.sleep(0.05)
        ready = {cam: time.perf_counter() - spawned[cam] for cam in PROC_CAMS}
        publisher.start()
        while any(p.poll() is None for p in procs.values()):
            for cam, proc in procs.items():
                if proc.poll() is None:
                    card_files[cam] = card_files[cam] or _card_files(proc.pid)
            most_apps = max(most_apps, _compute_apps(), key=len)
            if time.perf_counter() - t0 > PROC_LIMIT_S:
                fail(f"processes: still running after {PROC_LIMIT_S} s")
            time.sleep(0.1)
        exited = {cam: time.perf_counter() - spawned[cam] for cam in PROC_CAMS}
        time.sleep(0.3)
    finally:
        stop.set()
        if publisher.is_alive():
            publisher.join()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs.values():
            log.close()
        wire.close()
    for cam, proc in procs.items():
        if proc.returncode != 0:
            text = (workdir / f"cam{cam}.log").read_text(errors="replace")
            fail(f"processes: camera {cam} exited with {proc.returncode}:\n{text[-3000:]}")
    for cam in PROC_CAMS:
        if not card_files[cam]:
            fail(f"processes: camera {cam}'s process (pid {procs[cam].pid}) never held a "
                 f"/dev/nvidiaN file open")
    if len(most_apps) < len(before_apps) + len(PROC_CAMS):
        fail(f"processes: nvidia-smi listed at most {len(most_apps)} compute processes while "
             f"the children ran, {len(before_apps)} before them")
    dets = {cam: [] for cam in PROC_CAMS}
    for data, t in zip(wire.got, wire.times):
        if data == packet:
            continue
        msg = SSL_WrapperPacket()
        msg.ParseFromString(data)
        if msg.HasField("detection"):
            dets.setdefault(msg.detection.camera_id, []).append((t, msg))
    out = {}
    for cam in PROC_CAMS:
        got = dets[cam]
        if len(got) != REPLAY_FRAMES:
            fail(f"processes: camera {cam} sent {len(got)} detection frames, expected "
                 f"{REPLAY_FRAMES}")
        worst = ball_worst = 0.0
        for f, (_, wrapper) in enumerate(got[1:], start=1):
            _, err, berr = check_detections(f"processes camera {cam} frame {f}", scenes[cam],
                                            wrapper)
            worst, ball_worst = max(worst, err), max(ball_worst, berr)
        launches = json.loads((workdir / f"cam{cam}.launches.json").read_text())
        warp = launches.get("band_pass", 0) > 0
        want = {name: 0 for name in launches}
        want.update(blob_response_fused=1, row_topk=1, query_select_topk=2)
        if warp:
            want.update(band_pass=2)
        else:
            want.update(corner_stack=1, gather_corners=1)
        check_launches(f"processes camera {cam}", launches, want, REPLAY_FRAMES)
        first, last = got[0][0], got[-1][0]
        out[cam] = {"pid": procs[cam].pid, "ready_s": ready[cam], "exit_s": exited[cam],
                    "first_detection_s": first - spawned[cam],
                    "fps": (len(got) - 1) / (last - first), "max_bot_err_mm": worst,
                    "max_ball_err_mm": ball_worst, "launches": launches,
                    "resample_mode": "warp" if warp else "gather",
                    "card_files": card_files[cam]}
    # t_offsets: a camera's entry for a sender is set when its detection arrives
    offsets = {cam: [list(m.detection.t_offsets) for _, m in dets[cam]] for cam in PROC_CAMS}
    for cam in PROC_CAMS:
        for other in PROC_CAMS:
            if other != cam and not any(len(o) > other and o[other] != 0.0
                                        for o in offsets[cam]):
                fail(f"processes: camera {cam} never received camera {other}'s detections "
                     f"(t_offsets {offsets[cam][-1]})")
    for cam, res in out.items():
        print(f"process camera {cam} (pid {res['pid']}, {res['resample_mode']}, held "
              f"{res['card_files']}): waiting for geometry {res['ready_s']:.3f} s after "
              f"spawn, first detection on the wire {res['first_detection_s']:.3f} s, exit "
              f"{res['exit_s']:.3f} s; {REPLAY_FRAMES} detection frames, {res['fps']:.2f} "
              f"frames/s from the first to the last; max bot err {res['max_bot_err_mm']:.2f} "
              f"mm, max ball err {res['max_ball_err_mm']:.2f} mm; launches {res['launches']}; "
              f"t_offsets of the last frame {offsets[cam][-1]} ({card})")
    print(f"nvidia-smi compute processes: {len(before_apps)} before, {len(most_apps)} at "
          f"most while the children ran (pids as listed: {before_apps} before, {most_apps} "
          f"then; the children's pids: {[procs[cam].pid for cam in PROC_CAMS]})")

    t0 = time.perf_counter()
    bench = subprocess.run(
        [sys.executable, str(LAUNCHER_DIR / "blob_benchmark.py"),
         str(OUT / "replay" / "config.yml")],
        cwd=str(OUT / "replay"), env=env, capture_output=True, text=True,
        timeout=PROC_LIMIT_S)
    bench_s = time.perf_counter() - t0
    if bench.returncode != 0:
        fail(f"processes: the blob-benchmark launcher exited with {bench.returncode}:\n"
             f"{bench.stderr[-3000:]}")
    machine = [ln for ln in bench.stdout.splitlines() if ln.startswith("[BlobMachine]")]
    if len(machine) != 1 or machine[0].split()[:-1] != replay["blob_machine_line"].split()[:-1]:
        fail(f"processes: the blob-benchmark launcher printed {machine}, the in-process run "
             f"{replay['blob_machine_line']!r}")
    print(f"blob-benchmark launcher as a process: [BlobMachine] equal to the replay phase's "
          f"in-process line but for the processing time ({machine[0].split()[-1]} s against "
          f"{replay['blob_machine_line'].split()[-1]} s); {bench_s:.3f} s from spawn to exit")
    return {"cameras": out, "compute_apps_before": before_apps,
            "compute_apps_most": most_apps, "blob_benchmark_s": bench_s,
            "blob_machine_line": machine[0], "device_step_traced": traced}


# the bench phase's warp run: timed rounds, frame-sets a round, and the
# tracked rollout's frame-sets (20, the frame its precision keys name)
BENCH_ROUNDS, BENCH_FRAMES, BENCH_TRACKED = 3, 5, 20
BENCH_GATHER = dict(rounds=1, frames=2, production_frames=3, tracked_frames=2)
# launches per camera step of the bench (one camera through the blob machine
# and the hypothesis search), by resample mode; B3 only where the step took
# a row stage (not the flat-map tier)
BENCH_LAUNCHES = {
    "warp": {"band_pass": 2, "blob_response_fused": 1, "query_select_topk": 2,
             "corner_stack": 0, "gather_corners": 0, "resample_packed": 0,
             "circularity_fused": 0, "combo_chain": 0},
    "gather": {"band_pass": 0, "blob_response_fused": 1, "query_select_topk": 2,
               "corner_stack": 1, "gather_corners": 1, "resample_packed": 0,
               "circularity_fused": 0, "combo_chain": 0},
}
# the JAX package's counts on the same dense rig (bench.py's, factor 1.25),
# on the CPU, from tests/jax_bench_counts.py (printed beside the port's,
# not gated; the blob counts are the rolled bank's entry (BENCH_FRAMES - 1)
# % 4, where a round of BENCH_FRAMES frame-sets ends):
#   JAX_PLATFORMS=cpu python tests/jax_bench_counts.py --resample warp --frames 5
#   JAX_PLATFORMS=cpu python tests/jax_bench_counts.py --resample gather --frames 5
JAX_DENSE_COUNTS = {
    "warp": {"bank_entry": 0, "blob_counts_dense": [1475, 1370, 1466, 1469],
              "dense_bots_device_untracked": 93, "dense_bots_oracle": 194,
              "dense_oracle_hypotheses": 412},
    "gather": {"bank_entry": 0, "blob_counts_dense": [1472, 1353, 1460, 1473],
              "dense_bots_device_untracked": 99, "dense_bots_oracle": 198,
              "dense_oracle_hypotheses": 420},
}


class CallCounts:
    """Counts the calls of a module function while installed (the original
    still runs): ``by`` keys each call by ``key(result)``."""

    def __init__(self, module, attr: str, key=lambda out: None):
        self.module, self.attr, self.key = module, attr, key
        self.by = {}

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.attr)

        def counted(*args, **kwargs):
            out = fn(*args, **kwargs)
            k = self.key(out)
            self.by[k] = self.by.get(k, 0) + 1
            return out

        setattr(self.module, self.attr, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)

    @property
    def n(self) -> int:
        return sum(self.by.values())


def _bench_main(torch, label: str, mode: str, rigs, **kw) -> tuple[dict, dict, int, dict]:
    """The port's bench ``main`` on ``rigs`` with its JSON line captured:
    (result, launches, camera steps, compaction tiers taken). Launch counts
    set to 0 just before, read just after; the camera steps
    (``parallel.multicam._single_cam_step``) and the tiers
    (``ops.blob.compaction_tier``) counted alongside."""
    import contextlib
    import io

    from vision_processor_tpu_torch import bench as PB
    from vision_processor_tpu_torch.ops import blob as OB
    from vision_processor_tpu_torch.ops import cuda as K
    from vision_processor_tpu_torch.parallel import multicam as M

    buf = io.StringIO()
    t0 = time.perf_counter()
    with CallCounts(M, "_single_cam_step") as steps, \
            CallCounts(OB, "compaction_tier", key=tuple) as tiers, \
            contextlib.redirect_stdout(buf):
        K.reset_launches()
        result = PB.main(resample_mode=mode, device="cuda", out=str(OUT / "bench" / mode),
                         rigs=rigs, **kw)
        launches = dict(K.LAUNCHES)
    secs = time.perf_counter() - t0
    line = buf.getvalue().strip().splitlines()[-1]
    if json.loads(line) != result:
        fail(f"{label}: the bench's last line is not its result")
    print(f"bench: {line}")
    n = steps.n
    tiers = {f"{kind} m={m}": c for (kind, m), c in sorted(tiers.by.items())}
    print(f"{label}: {secs:.1f} s; {n} camera steps, compaction tiers {tiers}; launches "
          f"{launches}")
    want = {k: v * n for k, v in BENCH_LAUNCHES[mode].items()}
    want["row_topk"] = n - sum(c for k, c in tiers.items() if k.startswith("flat"))
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad or n == 0:
        fail(f"{label}: launches (got, expected) {bad} over {n} camera steps")
    return result, launches, n, {"tiers": tiers, "seconds": secs}


def run_bench(torch, recorder) -> dict:
    """The port's headline bench (``vision_processor_tpu_torch/bench.py``)
    at full width: 4 x 1080p RGGB, max_blobs 2000, factor 1.25 and 1.0,
    dense with 1900 extra blobs a camera, warp, BENCH_ROUNDS rounds of
    BENCH_FRAMES frame-sets; its JSON line printed as ``bench: ...``. Fails
    unless 16 bots are found plain and at factor 1.0, the dense recall is
    16/16 in the sustained run, untracked and tracked, the oracle agrees
    (1.0), and B1-B4 were launched as many times as the camera steps the
    bench ran ask for. Then one dense frame-set with its kernel inputs
    recorded (the m-lane B3 and the Q = 512 B4 that phase 8 holds against
    their plain versions), and the bench once more in gather mode at one
    round on the same raws (E4 and B7 launched, 16 bots)."""
    phase("bench: vision_processor_tpu_torch/bench.py (warp, then gather)")
    from vision_processor_tpu_torch import bench as PB
    from vision_processor_tpu_torch.parallel import multicam as M

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rigs = PB.build_rigs("warp", dev)
    rig_s = time.perf_counter() - t0
    result, launches, steps, info = _bench_main(
        torch, "bench (warp)", "warp", rigs, rounds=BENCH_ROUNDS, frames=BENCH_FRAMES,
        tracked_frames=BENCH_TRACKED)
    d = result["detail"]
    gates = {"bots_found_4cams": 16, "bots_found_factor1": 16, "dense_bot_recall": "16/16",
             "dense_planted_recall_untracked": "16/16", "dense_recall_tracked_t20": "16/16",
             "dense_oracle_agreement": 1.0}
    bad = {k: (d[k], v) for k, v in gates.items() if d[k] != v}
    if bad:
        fail(f"bench (warp): (got, expected) {bad}")
    for mode, jax_counts in JAX_DENSE_COUNTS.items():
        print(f"dense rig, port on the card (warp) against the JAX package on the CPU "
              f"({mode}, tests/jax_bench_counts.py): blob_counts_dense "
              f"{d['blob_counts_dense']} / {jax_counts['blob_counts_dense']}, "
              f"dense_bots_device_untracked {d['dense_bots_device_untracked']} / "
              f"{jax_counts['dense_bots_device_untracked']}, dense_bots_oracle "
              f"{d['dense_bots_oracle']} / {jax_counts['dense_bots_oracle']}")

    # one dense frame-set with its kernel inputs recorded, for phase 8
    cfg, raws, packed, scales, offsets, colors, params, _, cams, _ = rigs["dense"]
    refs, marks = PB.finisher_inputs(cams, cfg.n_cams, dev)
    from vision_processor_tpu_torch.utils.state import to_torch

    grids = M.make_resample_grids(cfg, packed, 150.0, scales, offsets, device=dev)
    inputs = (to_torch(raws, dev), *to_torch((packed, scales, offsets, colors), dev),
              PB.untracked_prior(cfg, dev))
    for kept in recorder.calls.values():
        kept.clear()
    step = M.batched_step_host_tracked(cfg)
    recorder.on = True
    _, items, d2h = audit_device_step(
        torch, lambda: step(*inputs, params, grids, refs, marks))
    torch.cuda.synchronize()
    recorder.on = False
    # reported, not gated: the dense tiers may read more than the slices' 2
    print(f"dense frame-set: {items} device->host reads in the step ({items / cfg.n_cams:.1f} "
          f"a camera); tensors that left the card: {sorted(set(d2h)) or 'none'}")
    calls = {name: list(recorder.calls[name]) for name in ("row_topk", "query_select_topk")}
    row_m = sorted({mm for (_, mm), _ in calls["row_topk"]})
    ring_q = sorted({q.shape[0] for (q, *_), kw in calls["query_select_topk"]
                     if kw["by_rank"]})
    print(f"dense frame-set recorded: B3 at m {row_m}, B4 ring at Q {ring_q}")
    if max(ring_q) != 512:
        fail(f"bench: the dense frame-set's ring ran at Q {ring_q}, not 512")

    t1 = time.perf_counter()
    rigs_g = PB.build_rigs("gather", dev,
                           raws={k: rigs[k][1] for k in ("plain", "dense")})
    result_g, launches_g, steps_g, info_g = _bench_main(
        torch, "bench (gather, one round)", "gather", rigs_g, **BENCH_GATHER)
    if result_g["detail"]["bots_found_4cams"] != 16:
        fail(f"bench (gather): bots_found_4cams {result_g['detail']['bots_found_4cams']}")
    gather_s = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    print(f"bench phase: {wall:.1f} s (rigs {rig_s:.1f} s, warp bench {info['seconds']:.1f} "
          f"s, gather rigs and bench {gather_s:.1f} s)")
    return {"warp": result, "gather": result_g, "launches": launches,
            "launches_gather": launches_g, "camera_steps": steps,
            "camera_steps_gather": steps_g, "tiers": info["tiers"],
            "tiers_gather": info_g["tiers"], "seconds": wall, "rig_seconds": rig_s,
            "dense_reads": items, "dense_calls": calls}


# ---------------------------------------------------------------------------
# the soak: the fleet for hundreds of frame-sets (the port's test_soak.py)
# ---------------------------------------------------------------------------

SOAK_GROUP, SOAK_PORT, SOAK_GC_PORT = "224.99.99.151", 17811, 17812  # no other phase's
SOAK_BANK = 12  # distinct frames a camera: its robots and ball on a loop
SOAK_DENSE = (5, 11)  # the bank entries with the bench's dense clutter
SOAK_RADIUS = 300.0  # mm, the loop's radius (tests/test_soak.py:150-163)
SOAK_EDGE = 250.0  # mm a robot's loop keeps inside its camera's visible extent
SOAK_CLEAR = 250.0  # mm of clutter-free ground around each robot (bench.py's)
SOAK_WARM = 30  # frame-sets before the gates' first reading (W)
SOAK_FRAMES = {"pipelined": 300, "staggered": 200}  # N, the frame-sets after W
SOAK_OUTAGE = 4  # frame-sets of camera 1's outage, from W + N/2
SOAK_CIRC = (15.0, 12.0)  # camera 0's thresholds.circularity before and after W + N/3
SOAK_ENV = {"pipelined": {"VPTPU_PIPELINE": "1", "VPTPU_STAGGERED": "0"},
            "staggered": {"VPTPU_PIPELINE": "0", "VPTPU_STAGGERED": "1"}}
# launches in every frame-set, plain or dense: warp (B1 twice a camera),
# score-first, B3 at the row stage's m (6 plain, 19 dense), B4 ring + tracked
SOAK_LAUNCHES = {"band_pass": 8, "blob_response_fused": 4, "row_topk": 4,
                 "query_select_topk": 8, "corner_stack": 0, "gather_corners": 0,
                 "circularity_fused": 0, "combo_chain": 0, "resample_packed": 0,
                 "band_warp": 0, "row_topk_blk": 0}
SOAK_DENSE_TIER = ([19], [512])  # a dense frame-set's B3 m and B4 ring Q (the bench's)
SOAK_BLOCKS, SOAK_BYTES = 8, 1 << 20  # allowed growth of live blocks and bytes
SOAK_HANDLES = 2  # allowed change of threads and of open file descriptors
SOAK_FOUND = 0.98  # share of a camera's frames with every planted robot (ball) found
SOAK_REKEYS = ("batched_step_host_tracked", "make_resample_grids", "pack_field_marks")
# The JAX package on the soak's frames, on the CPU (tests/jax_soak_witness.py
# --camera C --frames 60: warp, the tracked prior from the previous frame):
# for each pass over the bank, "1" at entry k where it named every planted
# robot within 30 mm ("ids") or found the ball within 40 mm ("ball"); the
# port on the CPU gave the same in every frame. The last pass listed
# repeated to the end of the 60 frames and stands for every later one.
JAX_SOAK_FOUND = {
    0: {"ids": ["111110111110"],
        "ball": ["111111010100", "001001010100"]},
    1: {"ids": ["111110111110"],
        "ball": ["111111111010", "001101111010", "101011111010", "111011111010"]},
    2: {"ids": ["111111111111"],
        "ball": ["111111111011", "111011111011"]},
    3: {"ids": ["111110111110"],
        "ball": ["111110001100", "000001100010", "111011100010"]},
}


def jax_soak_found(c: int, number: int) -> dict:
    """Whether the JAX package named every planted robot of camera c (and
    found its ball) in the soak's frame ``number`` (1, 2, ...)."""
    found = JAX_SOAK_FOUND[c]
    k, loop = (number - 1) % SOAK_BANK, (number - 1) // SOAK_BANK
    return {key: found[key][min(loop, len(found[key]) - 1)][k] == "1" for key in found}


def soak_scenes(cams, base) -> list:
    """Each camera's SOAK_BANK scenes from the bench rig's cameras and
    scenes (``bench.py build_rig``, dense): at entry k each robot and the
    ball move by SOAK_RADIUS (cos, sin) of 2 pi k / SOAK_BANK (a robot's
    loop centre pulled in to keep SOAK_EDGE inside the camera's visible
    extent) and turn by the same angle; the entries in SOAK_DENSE keep the
    clutter that lies SOAK_CLEAR from every robot, the others drop it."""
    import numpy as np

    from vision_processor_tpu_torch.io.synthetic import Scene, SceneBall, SceneBot

    scenes = []
    for c, ((_, persp), scene) in enumerate(zip(cams, base)):
        ext = persp.visible_field_extent
        pad = SOAK_RADIUS + SOAK_EDGE
        centres = [(float(np.clip(b.x, ext[0] + pad, ext[1] - pad)),
                    float(np.clip(b.y, ext[2] + pad, ext[3] - pad))) for b in scene.bots]
        ball, clutter = scene.balls[0], scene.balls[1:]
        cam_scenes = []
        for k in range(SOAK_BANK):
            a = 2 * math.pi * k / SOAK_BANK
            dx, dy = SOAK_RADIUS * math.cos(a), SOAK_RADIUS * math.sin(a)
            bots = [SceneBot(b.bot_id, b.team, x + dx, y + dy, b.orientation + a)
                    for b, (x, y) in zip(scene.bots, centres)]
            kept = [SceneBall(ball.x + dx, ball.y + dy)]
            if min(math.hypot(b.x - kept[0].x, b.y - kept[0].y) for b in bots) < SOAK_CLEAR:
                fail(f"soak: camera {c}'s ball comes within {SOAK_CLEAR} mm of a robot")
            if k in SOAK_DENSE:
                kept += [s for s in clutter if all(math.hypot(s.x - b.x, s.y - b.y) >= SOAK_CLEAR
                                                   for b in bots)]
            cam_scenes.append(Scene(bots=bots, balls=kept, noise_sigma=scene.noise_sigma,
                                    seed=c * SOAK_BANK + k))
        scenes.append(cam_scenes)
    return scenes


def soak_bank(torch) -> dict:
    """The bench's dense rig (``bench.py build_rig``, 1900 extra blobs a
    camera, factor 1.25) as the bank of ``soak_scenes``, rendered in
    threads (numpy releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from vision_processor_tpu_torch.bench import build_rig
    from vision_processor_tpu_torch.io.synthetic import render_raw

    rig = build_rig(N_CAMS, dense=True, dense_blobs=1900, resampling_factor=1.25,
                    return_scenes=True, raws=np.zeros((N_CAMS, 1080, 1920), np.uint8),
                    device=torch.device("cuda", 0))
    geometry, cams = rig[7], rig[8]
    scenes = soak_scenes(cams, rig[9])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        raws = [list(pool.map(lambda s, m=model: render_raw(m, geometry.field, s, "RGGB"),
                              cam_scenes))
                for (model, _), cam_scenes in zip(cams, scenes)]
    width, height = (int(v) for v in cams[0][0].size)
    print(f"soak bank: {N_CAMS} cameras x {SOAK_BANK} frames (dense at {SOAK_DENSE}, "
          f"{[len(scenes[c][SOAK_DENSE[0]].balls) - 1 for c in range(N_CAMS)]} clutter blobs) "
          f"rendered in {time.perf_counter() - t0:.1f} s")
    return {"geometry": geometry, "scenes": scenes, "raws": raws, "size": (width, height),
            "packet": fleet_packet(geometry, range(N_CAMS))}


def _soak_probe(torch) -> dict:
    """The device's allocator and the host's handles, now."""
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    return {"blocks": stats["allocation.all.current"],
            "allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved(),
            "max_allocated": torch.cuda.max_memory_allocated(),
            "alloc_retries": stats.get("num_alloc_retries", 0),
            "ooms": stats.get("num_ooms", 0),
            "threads": threading.active_count(),
            "fds": len(os.listdir("/proc/self/fd"))}


def _rss_kb() -> float:
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e3


class LogCount(logging.Handler):
    """Sends every log record of a block to ``path`` in place of stderr and
    counts them by level; keeps the ERROR ones and counts the clock sync's
    suppressed backwards jumps."""

    def __init__(self, path: Path):
        super().__init__(level=logging.DEBUG)
        self.path, self.levels, self.errors, self.jumps = path, {}, [], 0

    def emit(self, record):
        self.levels[record.levelname] = self.levels.get(record.levelname, 0) + 1
        if "backwards time jump suppressed" in record.getMessage():
            self.jumps += 1  # net/udp.py update_time (ROADMAP Q1)
        if record.levelno >= logging.ERROR:
            self.errors.append(self.format(record))

    def __enter__(self):
        root = logging.getLogger()
        self.saved = list(root.handlers)
        self.file = logging.FileHandler(self.path, mode="w")
        self.file.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s "
                                                 "%(message)s"))
        for h in self.saved:
            root.removeHandler(h)
        root.addHandler(self.file)
        root.addHandler(self)
        return self

    def __exit__(self, *exc):
        root = logging.getLogger()
        root.removeHandler(self)
        root.removeHandler(self.file)
        self.file.close()
        for h in self.saved:
            root.addHandler(h)


def soak_outcome(frame) -> dict:
    """A soak wire frame's outcome: every planted robot named within 30 mm
    ("ids"), the ball within 40 mm ("ball")."""
    _, _, errs, _, berr, *_ = frame
    return {"ids": max(errs) <= 30.0, "ball": berr <= 40.0}


def soak_found(c: int, frames: list, replayed: dict | None = None) -> dict:
    """Camera c's detection frames on the soak's wire (number, bank entry,
    each planted robot's error by id and by position, the ball's error,
    ...) counted: all frames; with every planted robot within 30 mm by
    position ("robots"); where the JAX package named every one by id
    ("jax_ids"), and of those where the port did too ("ids"); the same
    for the ball within 40 mm ("jax_ball", "ball"); and the frames where
    the port's outcome equals the JAX package's ("ids_agree",
    "ball_agree"). ``replayed`` maps a frame number to the outcome of the
    port on the CPU from the inputs the card's fleet dispatched for it
    (``replay_dispatched``): a frame whose outcome differs from the JAX
    package's on the previous frame's prior agrees where it equals that."""
    out = dict.fromkeys(("frames", "robots", "jax_ids", "ids", "ids_agree", "jax_ball",
                         "ball", "ball_agree"), 0)
    for frame in frames:
        number, near = frame[0], frame[3]
        want = jax_soak_found(c, number)
        got = soak_outcome(frame)
        again = (replayed or {}).get(number, {})
        ids, ball = got["ids"], got["ball"]
        for key, hit in (("frames", True), ("robots", max(near) <= 30.0),
                         ("jax_ids", want["ids"]), ("ids", want["ids"] and ids),
                         ("ids_agree", ids in (want["ids"], again.get("ids"))),
                         ("jax_ball", want["ball"]), ("ball", want["ball"] and ball),
                         ("ball_agree", ball in (want["ball"], again.get("ball")))):
            out[key] += bool(hit)
    return out


SOAK_RING = 24  # frame-sets whose dispatched inputs are kept until their wire frames come


def arrays_json(arrays: dict) -> dict:
    """numpy arrays (or scalars) as JSON: dtype, shape and values (float32
    values round-trip exactly through Python floats)."""
    import numpy as np

    return {k: {"dtype": str(np.asarray(v).dtype), "shape": list(np.shape(v)),
                "data": np.asarray(v).ravel().tolist()} for k, v in arrays.items()}


def json_arrays(stored: dict) -> dict:
    """``arrays_json``'s inverse."""
    import numpy as np

    return {k: np.asarray(v["data"], dtype=v["dtype"]).reshape(v["shape"])
            for k, v in stored.items()}


class Dispatched:
    """What a wired fleet's ``dispatch_frames`` received in each frame-set
    (the tracked prior ``_device_inputs`` was given, the colour tables the
    step reads, the reference colours, the fleet params), kept for the last
    SOAK_RING frame-sets, and ``records``: those of every camera's frame
    whose outcome on the wire differs from ``JAX_SOAK_FOUND``. The colour
    tables carried on the card are copied into pinned host buffers without
    a wait, so recording leaves the dispatch's timing as it was."""

    def __init__(self, torch, app, by_cam: dict, mode: str):
        self.torch, self.app, self.by_cam, self.mode = torch, app, by_cam, mode
        self.ring, self.pinned, self.records, self.lost = {}, {}, [], []
        self.read = {c: 0 for c in by_cam}
        self.i = -1
        inputs = app._device_inputs

        def device_inputs(tracked):
            import numpy as np

            rec = self.ring[self.i]
            rec["tracked"] = {k: np.array(v) for k, v in tracked.as_dict().items()}
            rec["params"] = {k: np.array(v) for k, v in app._fleet_params().items()}
            rec["refs"] = np.stack([p.colors.packed_refs() for p in app.processors])
            return inputs(tracked)

        app._device_inputs = device_inputs

    def before(self, i: int, now: float) -> None:
        """Frame-set i is about to be dispatched: its colour tables."""
        import numpy as np

        self.i = i
        rec = {"frame_set": i, "now": now}
        dev = self.app._colors_dev
        if dev is None:
            rec["colors"] = np.stack([p.colors.packed() for p in self.app.processors])
        else:
            slot = self.pinned.get(i % SOAK_RING)
            if slot is None:
                slot = self.pinned[i % SOAK_RING] = self.torch.empty(
                    dev.shape, dtype=dev.dtype, pin_memory=True)
            slot.copy_(dev, non_blocking=True)
            rec["pinned"] = slot
        self.ring[i] = rec
        self.ring.pop(i - SOAK_RING, None)

    def harvest(self) -> None:
        """Keep the inputs of each newly arrived wire frame whose outcome
        differs from the JAX package's (its frame-set has finished, so
        its pinned copy has landed)."""
        for c, frames in self.by_cam.items():
            n = len(frames)
            for frame in frames[self.read[c]:n]:
                number, k = frame[0], frame[1]
                got, want = soak_outcome(frame), jax_soak_found(c, number)
                if got == want:
                    continue
                rec = self.ring.get(number - 1)
                if rec is None or "tracked" not in rec:
                    self.lost.append((c, number))
                    continue
                colors = rec["colors"] if "pinned" not in rec else rec["pinned"].numpy()
                self.records.append({
                    "mode": self.mode, "camera": c, "frame": number, "entry": k,
                    "card": got, "jax": want, "sent": frame[5], "errs": frame[2],
                    "now": rec["now"],
                    "inputs": arrays_json({"colors": colors.copy(), "refs": rec["refs"],
                                           **{f"tracked.{key}": v
                                              for key, v in rec["tracked"].items()},
                                           **{f"params.{key}": v
                                              for key, v in rec["params"].items()}})})
            self.read[c] = n


def replay_fleet(torch, geometry, size, c: int):
    """Camera c of the soak's rig as a one-camera offline fleet on the CPU
    (warp, factor 1.25, max_blobs 2000, on-device finishing): the fleet
    ``replay_dispatched`` and tests/jax_soak_witness.py run."""
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp

    fleet = MultiCamApp.offline([vision_config("warp", 1.25, c)], device=torch.device("cpu"))
    fleet.processors[0].geometry_check(*size, geometry, 1)
    return fleet


def record_inputs(record: dict) -> dict:
    """A dispatched record's camera lane: its colour tables (1, 7, 3), its
    reference colours, the tracked prior's arrays and the params, per-camera
    ones cut to its camera."""
    from vision_processor_tpu_torch.parallel.multicam import _PER_CAMERA_PARAM_KEYS

    arrays, c = json_arrays(record["inputs"]), record["camera"]
    params = {k[7:]: v for k, v in arrays.items() if k.startswith("params.")}
    for k in _PER_CAMERA_PARAM_KEYS:
        params[k] = params[k][c:c + 1]
    return {"colors": arrays["colors"][c:c + 1], "refs": arrays["refs"][c:c + 1],
            "tracked": {k[8:]: v for k, v in arrays.items() if k.startswith("tracked.")},
            "params": params}


def fin_detections(fin: dict, c: int = 0) -> tuple[dict, list]:
    """Camera c's robots by id (blue + 16) -> (x, y, z, orientation), and
    its balls (x, y), from a step's finished outputs (numpy)."""
    import numpy as np

    fin = {k: np.asarray(v)[c] for k, v in fin.items()}
    bots = {int(fin["bot_id"][i]): (*map(float, fin["bot_world"][i, :3]),
                                    float(fin["bot_orientation"][i]))
            for i in np.flatnonzero(fin["bot_valid"])}
    balls = [tuple(map(float, fin["ball_world"][j, :2]))
             for j in np.flatnonzero(fin["ball_valid"])]
    return bots, balls


def judged(scene, bots: dict, balls: list) -> dict:
    """Which planted robots were found with their id within 30 mm, and
    whether the ball was found within 40 mm (the soak's bounds)."""
    truth = {b.bot_id + (16 if b.team == "blue" else 0): b for b in scene.bots}
    ok = sorted(i for i, b in truth.items()
                if i in bots and math.hypot(bots[i][0] - b.x, bots[i][1] - b.y) <= 30.0)
    ball = scene.balls[0]
    return {"ids": ok, "all_ids": len(ok) == len(truth),
            "ball": any(math.hypot(x - ball.x, y - ball.y) <= 40.0 for x, y in balls),
            "sent": sorted(bots), "balls": len(balls)}


def replay_dispatched(torch, fleet, raw, scene, record: dict) -> dict:
    """The port on the CPU (``fleet``, from ``replay_fleet``) over the
    record's frame from the inputs the card's fleet dispatched for it:
    its tracked prior, colour tables and params. Returns ``judged``."""
    from vision_processor_tpu_torch.app.processor import TrackedArrays
    from vision_processor_tpu_torch.io.camera import RawFrame

    import numpy as np

    inputs = record_inputs(record)
    refs = fleet.processors[0].colors.packed_refs()
    if not np.array_equal(refs, inputs["refs"][0]):
        fail(f"replay of camera {record['camera']} frame {record['frame']}: the reference "
             f"colours differ from the dispatched ones")
    fleet._colors_dev = torch.from_numpy(inputs["colors"])
    fleet._fleet_params = lambda: inputs["params"]
    height, width = raw.shape
    out = fleet.dispatch_frames([RawFrame(data=raw, fmt="RGGB", width=width, height=height)],
                                record["now"], TrackedArrays(**inputs["tracked"]))
    return judged(scene, *fin_detections({k: v.cpu().numpy() for k, v in out[2].items()}))


def _soak_run(torch, recorder, bank: dict, mode: str, n: int) -> dict:
    """One ``MultiCamApp`` over the bank (``run_soak`` says what it checks)."""
    from contextlib import ExitStack

    import numpy as np
    import yaml

    from vision_processor_tpu_torch.app import multicam_app as MA
    from vision_processor_tpu_torch.io.camera import CameraDriver, RawFrame, register_driver
    from vision_processor_tpu_torch.net import udp as UDP
    from vision_processor_tpu_torch.net.udp import UDPSocket
    from vision_processor_tpu_torch.ops import blob as OB
    from vision_processor_tpu_torch.ops import cuda as K
    from vision_processor_tpu_torch.proto import SSL_WrapperPacket

    total = SOAK_WARM + n
    reload_at = SOAK_WARM + n // 3
    outage = range(SOAK_WARM + n // 2, SOAK_WARM + n // 2 + SOAK_OUTAGE)
    raws, scenes, (width, height) = bank["raws"], bank["scenes"], bank["size"]
    entry = {id(raw): k for cam in raws for k, raw in enumerate(cam)}
    t_zero = time.perf_counter()

    class Camera(CameraDriver):
        """Camera c's bank in a loop for ``total`` reads, on the host clock;
        camera 1 delivers nothing during the outage."""

        def __init__(self, c):
            self.c, self.i = c, 0

        @property
        def fmt(self):
            return "RGGB"

        def expected_frametime(self):
            return 0.01

        def get_time(self):
            return time.perf_counter() - t_zero

        def read_image(self):
            if self.i >= total:
                return None
            i, self.i = self.i, self.i + 1
            if self.c == 1 and i in outage:
                return None
            return RawFrame(data=raws[self.c][i % SOAK_BANK], fmt="RGGB", width=width,
                            height=height)

    register_driver("SMOKE_SOAK", lambda cam_cfg: Camera(int(cam_cfg.path)))
    workdir = OUT / "soak" / mode
    workdir.mkdir(parents=True, exist_ok=True)
    paths = []
    for c in range(N_CAMS):
        path = workdir / f"config{c}.yml"
        path.write_text(yaml.dump({
            "cam_id": c, "bot_heights_file": str(workdir / "no-heights.yml"),
            "camera": {"driver": "SMOKE_SOAK", "path": str(c)},
            "geometry": {"camera_amount": N_CAMS},
            "network": {"vision_ip": SOAK_GROUP, "vision_port": SOAK_PORT,
                        "gc_ip": SOAK_GROUP, "gc_port": SOAK_GC_PORT},
            "stream": {"active": False}, "debug": {"wait_for_geometry": True},
            "thresholds": {"blobs": 2000, "circularity": SOAK_CIRC[0],
                           "resampling_factor": 1.25},
        }))
        paths.append(path)
    by_cam = {c: [] for c in range(N_CAMS)}
    seen = {"geometry": 0}

    def frame_errors(d) -> tuple:
        """A detection frame as it arrives, kept small (the wire's protos
        would grow the host's memory with the run): its number, bank entry,
        each planted robot's error by id and by position alone, the ball's
        error, the robots and balls sent."""
        k = (d.frame_number - 1) % SOAK_BANK
        scene = scenes[d.camera_id][k]
        _, errs, berr = detection_errors(scene, SimpleNamespace(detection=d))
        emitted = [(r.x, r.y) for r in (*d.robots_yellow, *d.robots_blue)]
        near = [min((math.hypot(x - b.x, y - b.y) for x, y in emitted), default=float("inf"))
                for b in scene.bots]
        return (d.frame_number, k, [round(e, 2) for e in errs], [round(e, 2) for e in near],
                round(berr, 2), len(emitted), len(d.balls))

    class Wire(UDPSocket):
        def _parse(self, data):
            got = SSL_WrapperPacket()
            got.ParseFromString(data)
            if got.HasField("detection"):
                by_cam[got.detection.camera_id].append(frame_errors(got.detection))
            if got.HasField("geometry"):
                seen["geometry"] += 1

    packet = bank["packet"]
    state = {"i": 0}
    stop = threading.Event()
    wire = Wire(SOAK_GROUP, SOAK_PORT)

    def send_geometry():
        wire.sock.sendto(packet, wire.address)

    def publish():  # until the fleet has run 2 frame-sets; then frame-locked churn
        while not stop.is_set() and state["i"] < 2:
            send_geometry()
            stop.wait(0.05)

    publisher = threading.Thread(target=publish, daemon=True)
    rekeys = {name: CallCounts(MA, name, key=lambda out: state["i"]) for name in SOAK_REKEYS}
    probes, walls, rss, per_set, fleet = {}, [], [], [], {}
    gc.collect()  # an earlier app's reference cycles (its wrapped methods)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    probes["start"] = _soak_probe(torch)
    cwd = os.getcwd()
    t0 = time.perf_counter()
    try:
        publisher.start()
        while seen["geometry"] == 0:  # the group loops back to this host
            if time.perf_counter() - t0 > 10.0:
                fail(f"soak ({mode}): no datagram came back on {SOAK_GROUP}:{SOAK_PORT}")
            time.sleep(0.01)
        os.chdir(workdir)
        with Env(SOAK_ENV[mode]), LogCount(workdir / "log.txt") as logs, BuildLog(K) as builds, \
                CallCounts(OB, "compaction_tier", key=tuple) as tiers, ExitStack() as stack:
            for counts in rekeys.values():
                stack.enter_context(counts)
            app = MA.MultiCamApp([str(p) for p in paths], device=torch.device("cuda", 0))
            if app.staggered != (mode == "staggered") or app.pipeline != (mode == "pipelined"):
                fail(f"soak ({mode}): the app runs pipeline={app.pipeline} "
                     f"staggered={app.staggered}")
            inner, close = app.dispatch_frames, app.close
            dispatched = Dispatched(torch, app, by_cam, mode)

            def dispatch(frames, now, tracked=None):
                i = state["i"]
                dispatched.harvest()
                dispatched.before(i, now)
                walls.append(time.perf_counter())
                rss.append(_rss_kb())
                if i % 3 == 0:
                    send_geometry()  # frame-locked churn, tests/test_soak.py:248-257
                if i == reload_at:
                    cfg = yaml.safe_load(paths[0].read_text())
                    cfg["thresholds"]["circularity"] = SOAK_CIRC[1]
                    paths[0].write_text(yaml.dump(cfg))
                if i == SOAK_WARM:
                    probes["warm"] = _soak_probe(torch)
                kinds = {"dense" if entry[id(f.data)] in SOAK_DENSE else "plain"
                         for f in frames}
                kind = kinds.pop() if len(kinds) == 1 else "mixed"
                # one dense frame-set's kernel inputs for phase 8, kept from
                # before the warm-up's reading to the end of the run
                record = (kind == "dense" and i >= SOAK_WARM - SOAK_BANK
                          and "dense" not in fleet)
                if record:
                    for kept in recorder.calls.values():
                        kept.clear()
                    recorder.on = True
                launched = dict(K.LAUNCHES)
                try:
                    out = inner(frames, now, tracked)
                finally:
                    recorder.on = False
                    state["i"] += 1
                per_set.append((kind, {k: K.LAUNCHES[k] - launched[k] for k in launched}))
                if record:
                    fleet["dense"] = {name: list(recorder.calls[name])
                                      for name in ("row_topk", "query_select_topk")}
                    for kept in recorder.calls.values():
                        kept.clear()
                return out

            def closing():
                probes["end"] = _soak_probe(torch)
                fleet["params"] = app._fleet_params()
                close()

            def watchdog():  # a run that outlives its time is stopped and fails
                if not stop.wait(max(300.0, 4.0 * total)):
                    state["timed_out"] = True
                    app.stop()

            app.dispatch_frames = builds.frame(dispatch, "frame-set")
            app.close = closing
            threading.Thread(target=watchdog, daemon=True).start()
            t_run = time.perf_counter()
            offset = {"start": UDP.get_real_time() - time.time()}
            app.run()
            run_s = time.perf_counter() - t_run
            offset["end"] = UDP.get_real_time() - time.time()
            time.sleep(0.3)  # the last datagrams
            dispatched.harvest()
    finally:
        os.chdir(cwd)
        stop.set()
        publisher.join()
        wire.close()
    label = f"soak ({mode})"
    if state.get("timed_out"):
        fail(f"{label}: stopped after {state['i']} of {total} frame-sets")
    if state["i"] != total or "end" not in probes or "warm" not in probes:
        fail(f"{label}: {state['i']} frame-sets dispatched, expected {total}")
    if "dense" not in fleet:
        fail(f"{label}: no dense frame-set in the warm-up's last {SOAK_BANK}")
    records = dispatched.records
    (workdir / "dispatched.json").write_text(json.dumps(records))
    print(f"{label}: {len(records)} frames whose outcome differs from the JAX package's on "
          f"the previous frame's prior, their dispatched inputs in "
          f"{workdir / 'dispatched.json'}; {len(dispatched.lost)} without them")
    replayed, t_replay = {c: {} for c in range(N_CAMS)}, time.perf_counter()
    fleets = {}
    for rec in records:
        c, k = rec["camera"], rec["entry"]
        if c not in fleets:
            fleets[c] = replay_fleet(torch, bank["geometry"], bank["size"], c)
        again = replay_dispatched(torch, fleets[c], raws[c][k], scenes[c][k], rec)
        replayed[c][rec["frame"]] = {"ids": again["all_ids"], "ball": again["ball"]}
        print(f"{label}: camera {c} frame {rec['frame']} (entry {k}): card ids "
              f"{rec['card']['ids']} ball {rec['card']['ball']}, the JAX package on the "
              f"previous frame's prior {rec['jax']}; the port on the CPU from the dispatched "
              f"inputs: ids {again['ids']} sent {again['sent']} ball {again['ball']}")
    del fleets
    t_replay = time.perf_counter() - t_replay
    print(f"{label}: {len(records)} frame-sets replayed on the CPU in {t_replay:.1f} s")

    # every reading first, then every gate, so that one run shows them all
    rekeyed = {name: dict(sorted(c.by.items())) for name, c in rekeys.items()}
    warm, end = probes["warm"], probes["end"]
    got = {c: len(by_cam[c]) for c in range(N_CAMS)}
    dark = {i + 1 for i in outage}
    found, noise, order = {}, [], {}
    for c in range(N_CAMS):
        numbers = [f[0] for f in by_cam[c]]
        order[c] = all(b > a for a, b in zip(numbers, numbers[1:])) and not (
            c == 1 and dark & set(numbers))
        found[c] = soak_found(c, by_cam[c], replayed[c])
        noise += [n_robots - sum(e <= 30.0 for e in near)
                  for _, k, _, near, _, n_robots, _ in by_cam[c] if k in SOAK_DENSE]
    (workdir / "wire.json").write_text(json.dumps(by_cam))
    recovered = [max(f[3]) for f in by_cam[1] if f[0] > max(dark)][:2]
    circ = [float(v) for v in fleet["params"]["min_circularity"]]
    dense_m = sorted({m for (_, m), _ in fleet["dense"]["row_topk"]})
    ring_q = sorted({q.shape[0] for (q, *_), kw in fleet["dense"]["query_select_topk"]
                     if kw["by_rank"]})
    q = n // 4
    steps = [1e3 * (b - a) for a, b in zip(walls, walls[1:])][SOAK_WARM:]
    quarters = {"first": steps[:q], "last": steps[-q:]}
    sums = {}
    for part, rng in (("first", range(SOAK_WARM, SOAK_WARM + q)),
                      ("last", range(total - q, total))):
        for kind in ("plain", "dense"):
            sets = [per_set[i][1] for i in rng if per_set[i][0] == kind]
            sums[f"{part} quarter, {kind}"] = {
                "frame-sets": len(sets),
                **{k: sum(s[k] for s in sets) for k in ("band_pass", "blob_response_fused",
                                                       "row_topk", "query_select_topk")}}
    late = np.asarray(rss[len(rss) - n // 2:], dtype=np.float64)
    slope = float(np.polyfit(np.arange(len(late)), late, 1)[0])
    out = {
        "frame_sets": total, "warm": SOAK_WARM, "n": n, "run_s": run_s,
        "reload_at": reload_at, "outage": [outage[0], outage[-1]],
        "probes": probes, "rekeys": rekeyed, "builds": builds.builds,
        "tiers": {f"{kind} m={m}": c for (kind, m), c in sorted(tiers.by.items())},
        "wall_ms": {part: {"p50": float(np.percentile(xs, 50)),
                           "p95": float(np.percentile(xs, 95)), "n": len(xs)}
                    for part, xs in quarters.items()},
        "launch_sums": sums, "found": found, "recovered_max_err_mm": recovered,
        "noise_bots_per_dense_frame": float(np.mean(noise)) if noise else None,
        "rss_slope_kb_per_frame_set": slope, "log_levels": logs.levels,
        "min_circularity": circ, "dense_m": dense_m, "dense_ring_q": ring_q,
        "suppressed_time_jumps": logs.jumps, "real_time_offset_s": offset,
    }
    print(f"{label}: {total} frame-sets ({SOAK_WARM} warm-up) in {run_s:.1f} s; churn every "
          f"3rd, reload at {reload_at}, camera 1 dark {outage[0]}-{outage[-1]}; kernel builds "
          f"{builds.builds}; step, grids, marks built at frame-sets "
          f"{ {k: sorted(v) for k, v in rekeyed.items()} }; compaction tiers {out['tiers']}")
    for part in ("start", "warm", "end"):
        p = probes[part]
        print(f"{label} {part}: blocks {p['blocks']}, memory_allocated {p['allocated']}, "
              f"memory_reserved {p['reserved']}, max_memory_allocated {p['max_allocated']}, "
              f"alloc retries {p['alloc_retries']}, OOMs {p['ooms']}, threads {p['threads']}, "
              f"fds {p['fds']}")
    print(f"{label}: frame-set wall p50/p95 ms first quarter "
          f"{out['wall_ms']['first']['p50']:.3f}/{out['wall_ms']['first']['p95']:.3f}, last "
          f"quarter {out['wall_ms']['last']['p50']:.3f}/{out['wall_ms']['last']['p95']:.3f}; "
          f"RSS slope over the late half {slope:.3f} KB a frame-set; frames found {found}; "
          f"camera 1 after the outage, worst robot by position {recovered} mm; noise "
          f"bots a dense frame {out['noise_bots_per_dense_frame']}; log records {logs.levels}; "
          f"min_circularity {circ}")
    print(f"{label}: clock sync (ROADMAP Q1): {logs.jumps} suppressed backwards jumps in "
          f"{total} frame-sets; get_real_time() - time.time() {offset['start']:.6f} s before "
          f"the run, {offset['end']:.6f} s after it")
    print(f"{label}: launches {sums}; dense frame-set B3 m {dense_m}, ring Q {ring_q}")

    bad = []
    # (a) builds: none after the first frame-set
    late = [b for b in builds.builds if b[0] not in ("set-up", "frame-set 1")]
    if late:
        bad.append(f"kernels built after the first frame-set: {late}")
    # (b) re-keys: none after the warm-up
    late = {name: [i for i in by if i >= SOAK_WARM] for name, by in rekeyed.items()}
    if any(late.values()):
        bad.append(f"rebuilt after the warm-up, at frame-sets {late}")
    # (c) device memory, (d) host handles
    if end["blocks"] > warm["blocks"] + SOAK_BLOCKS:
        bad.append(f"live blocks {warm['blocks']} -> {end['blocks']}")
    if end["allocated"] > warm["allocated"] + SOAK_BYTES:
        bad.append(f"memory_allocated {warm['allocated']} -> {end['allocated']}")
    if end["alloc_retries"] or end["ooms"]:
        bad.append(f"{end['alloc_retries']} allocation retries, {end['ooms']} OOMs")
    for k in ("threads", "fds"):
        if abs(end[k] - warm[k]) > SOAK_HANDLES:
            bad.append(f"{k} {warm[k]} -> {end[k]}")
    # (e) the wire
    want = {c: total - (SOAK_OUTAGE if c == 1 else 0) for c in range(N_CAMS)}
    if got != want:
        bad.append(f"detection frames per camera {got}, expected {want}")
    if not all(order.values()):
        bad.append(f"frame numbers not increasing or sent in the outage: {order}")
    # every planted robot by position (the bench's recall) in every frame;
    # every planted robot by id, and the ball, in every frame where the JAX
    # package finds them on the same frames (a dense frame-set teaches the
    # colour chain the clutter in both packages: ROADMAP section 3); and
    # the port's outcome the JAX package's, frame by frame, or, in a frame
    # where the pipelined prior differs from the previous frame's, the
    # port's on the CPU from the same dispatched inputs (ROADMAP section 3)
    for c, f in found.items():
        for hit, of in (("robots", "frames"), ("ids", "jax_ids"), ("ball", "jax_ball")):
            if f[hit] < SOAK_FOUND * f[of]:
                bad.append(f"camera {c}: {hit} in {f[hit]} of {f[of]} {of} frames")
        for hit in ("ids_agree", "ball_agree"):
            if f[hit] != f["frames"]:
                bad.append(f"camera {c}: {hit} in {f[hit]} of {f['frames']} frames")
    if dispatched.lost:
        bad.append(f"frames whose outcome differs from the JAX package's without their "
                   f"dispatched inputs (camera, frame): {dispatched.lost[:5]}")
    if not any(e <= 30.0 for e in recovered):
        bad.append(f"camera 1 missed a robot by position in the 2 frame-sets after the "
                   f"outage: {recovered} mm")
    if logs.errors:
        bad.append(f"{len(logs.errors)} ERROR records, the first: {logs.errors[0]}")
    if circ != [SOAK_CIRC[1]] + [SOAK_CIRC[0]] * (N_CAMS - 1):
        bad.append(f"min_circularity per camera {circ} after the reload")
    # (f) launches
    for i, (kind, launched) in enumerate(per_set):
        wrong = {k: (launched[k], v) for k, v in SOAK_LAUNCHES.items() if launched[k] != v}
        if wrong:
            bad.append(f"frame-set {i} ({kind}) launched (got, expected) {wrong}")
            break
    if (dense_m, ring_q) != SOAK_DENSE_TIER:
        bad.append(f"the dense frame-set ran B3 at m {dense_m} and B4's ring at Q {ring_q}, "
                   f"expected {SOAK_DENSE_TIER}")
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    out["dense_calls"] = fleet["dense"]
    return out


def run_soak(torch, recorder, card: str, frames: dict) -> dict:
    """The port's counterpart of tests/test_soak.py on the card: the real
    ``MultiCamApp`` (4 cameras, 1080p RGGB, max_blobs 2000, factor 1.25,
    "auto" -> warp, on-device finishing) over the bank of ``soak_bank``,
    SOAK_WARM + N frame-sets in each dispatch mode of ``frames`` (mode ->
    N), each as its own app with a synthetic driver, a geometry publisher
    and a wire recorder on SOAK_GROUP. Events: the geometry packet every
    3rd frame-set, camera 0's ``thresholds.circularity`` rewritten at W +
    N/3 (the app's hot reload), camera 1 dark for SOAK_OUTAGE frame-sets at
    W + N/2. Fails unless (a) no kernel is built after the first frame-set;
    (b) after the warm-up no step, resample grid or field marks is built
    again; (c) from warm-up to the end the allocator's live blocks grow by
    at most SOAK_BLOCKS and ``memory_allocated`` by at most SOAK_BYTES,
    with no allocation retry or OOM; (d) threads and open descriptors
    within SOAK_HANDLES; (e) every camera sends one detection frame a
    frame-set (camera 1 none in its outage), frame numbers increasing,
    every planted robot within 30 mm by position in SOAK_FOUND of its
    frames, and with its id in SOAK_FOUND of the frames where the JAX
    package names them all on the same frames, its ball within 40 mm in
    SOAK_FOUND of the frames where the JAX package finds it, and the
    port's outcome (ids, ball) in every frame the JAX package's on the
    previous frame's prior or, where not, the port's on the CPU from the
    inputs the card's fleet dispatched for that frame-set (``Dispatched``,
    ``replay_dispatched``; the pipelined prior lags: ROADMAP section 3;
    after a dense frame-set both packages lose the ball in some frames),
    camera 1 its robots again within 2 frame-sets of
    the outage, no ERROR record, and the reload reaches camera 0 alone;
    (f) every frame-set launches B1 8, B2 4, B3 4 and B4 8 times, the
    dense ones B3 at m = 19 and B4's ring at Q = 512 (one such frame-set's
    calls kept for phase 8). Walls, memory, RSS slope and noise are
    printed."""
    phase("soak: MultiCamApp over hundreds of frame-sets, both dispatch modes")
    t0 = time.perf_counter()
    bank = soak_bank(torch)
    runs = {mode: _soak_run(torch, recorder, bank, mode, n) for mode, n in frames.items()}
    wall = time.perf_counter() - t0
    print(f"soak phase: {wall:.1f} s ({card})")
    dense_calls = next(iter(runs.values()))["dense_calls"]
    return {"modes": {m: {k: v for k, v in r.items() if k != "dense_calls"}
                      for m, r in runs.items()},
            "seconds": wall, "card": card, "dense_calls": dense_calls}


# ---------------------------------------------------------------------------
# degraded optics: tests/test_perturbation.py's rows on the production rig
# ---------------------------------------------------------------------------

PERTURB_ENTRIES = (0, 1, 2, 3, 4, 6)  # the soak bank's plain entries, in order
# tests/test_perturbation.py:35-72, row for row: profile, thresholds.circularity,
# robot recall bar, ball recall bar, mean robot error bar (mm), resampling factor
PERTURB_ROWS = (
    ("light", 15.0, 0.9, 0.5, 25.0, 1.0),
    ("moderate", 8.0, 0.8, 0.5, 30.0, 1.0),
    ("medium", 8.0, 0.7, 0.15, 40.0, 1.0),
    ("light", 15.0, 0.9, 0.5, 27.0, 1.5),
    ("light", 15.0, 0.9, 0.15, 27.0, 1.25),
    ("medium", 8.0, 0.7, 0.15, 42.0, 1.25),
)
PERTURB_ERR_MM = 1.0  # a row's mean robot error within this of the JAX package's
PERTURB_TAP_BITS = 24  # the blur's taps are multiples of 2^-24
# The JAX package on the perturbed frames, on the CPU (tests/jax_perturb_witness.py:
# a one-camera fleet a camera, warp, the tracked prior from the previous
# frame): per row, per camera, "1" at frame j where it named every planted
# robot within 30 mm ("ids") or found the ball within 40 mm ("ball"); its
# mean robot error over the row (mm, robots matched by id); the SHA-256 of
# each camera's six raws. The port on the CPU gave the same in every frame.
JAX_PERTURB_FOUND = {
    0: {"ids": ["111111", "111111", "111111", "111111"],
        "ball": ["111111", "111111", "111111", "111111"],
        "err": 4.7232006194540155,
        "digests": [
            "f4a595f34bcfe6e0288c21e149a99125edbe85e1b2ec49e0ac237a5c0c238882",
            "9efa751b27c115b1b607f7bc729d273b5175bc9840acb53e4677aa24b35d54f0",
            "1e010591712003aa8799593a3f95bd09452c44f713863a8292fb725ddd3cfb2f",
            "e2d8354ec1c47afb3f12b3bd549da5011b0824575b91c885cd8ecb8d68582b53",
        ]},
    1: {"ids": ["111111", "111111", "111111", "111111"],
        "ball": ["111111", "111111", "111111", "111111"],
        "err": 4.731707665171476,
        "digests": [
            "f998ab7fe8a4f107de4c221cc94972bd821984d8ec37188ecbf45745516eff64",
            "69b0d9982538fb0511096d85860bc2997e0fdef4affa8ca588c84ad8daa38cfb",
            "473ef00a29ceb947b0721c1d3dba32214f1612786eac7c2d8dd68cb8c2aa5619",
            "c918a4a42538ec6c243d2fcf0b5ad9061879914bd1bf7ae7bc968cdda83532df",
        ]},
    2: {"ids": ["111111", "111111", "111111", "111111"],
        "ball": ["111111", "111111", "111111", "111111"],
        "err": 4.78567242013519,
        "digests": [
            "866bdfba556dd3158995968b16907d2535b29ed82a87d5958480aa57e0470123",
            "fc5a2101dc736b7eeff051056b341283513b7f021e57a971df17b22557e06380",
            "3481599b2a1b4f5faf5f9154ae203880fe14b514c5825194c53f5189121d998a",
            "7fc4fe5293350aca940c9e7504cd1fba04adcb8721d9ae60784dd987a021c77f",
        ]},
    3: {"ids": ["111111", "111111", "111111", "111111"],
        "ball": ["111111", "111111", "111111", "111111"],
        "err": 6.091375717132209,
        "digests": [
            "f4a595f34bcfe6e0288c21e149a99125edbe85e1b2ec49e0ac237a5c0c238882",
            "9efa751b27c115b1b607f7bc729d273b5175bc9840acb53e4677aa24b35d54f0",
            "1e010591712003aa8799593a3f95bd09452c44f713863a8292fb725ddd3cfb2f",
            "e2d8354ec1c47afb3f12b3bd549da5011b0824575b91c885cd8ecb8d68582b53",
        ]},
    4: {"ids": ["111111", "111111", "111111", "111111"],
        "ball": ["111111", "111111", "111111", "111111"],
        "err": 5.4802515313075375,
        "digests": [
            "f4a595f34bcfe6e0288c21e149a99125edbe85e1b2ec49e0ac237a5c0c238882",
            "9efa751b27c115b1b607f7bc729d273b5175bc9840acb53e4677aa24b35d54f0",
            "1e010591712003aa8799593a3f95bd09452c44f713863a8292fb725ddd3cfb2f",
            "e2d8354ec1c47afb3f12b3bd549da5011b0824575b91c885cd8ecb8d68582b53",
        ]},
    5: {"ids": ["111111", "111111", "111111", "111111"],
        "ball": ["111111", "111111", "111111", "111111"],
        "err": 5.47665032793167,
        "digests": [
            "866bdfba556dd3158995968b16907d2535b29ed82a87d5958480aa57e0470123",
            "fc5a2101dc736b7eeff051056b341283513b7f021e57a971df17b22557e06380",
            "3481599b2a1b4f5faf5f9154ae203880fe14b514c5825194c53f5189121d998a",
            "7fc4fe5293350aca940c9e7504cd1fba04adcb8721d9ae60784dd987a021c77f",
        ]},
}


def perturb_profiles() -> dict:
    """``python/perturb.py PROFILES``, read from that file: blur sigma (px),
    vignette corner gain, noise sigma, white-balance gains (B, G, R), JPEG
    quality."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("perturb_profiles",
                                                  ROOT / "python" / "perturb.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PROFILES


def gaussian_taps(sigma: float):
    """cv2's Gaussian for a float image (``GaussianBlur`` with ksize 0:
    round(8 sigma + 1) | 1 taps), normalised, each rounded to a multiple of
    2^-PERTURB_TAP_BITS so that no last bit of ``exp`` moves them."""
    import numpy as np

    n = int(round(sigma * 8 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - n // 2
    taps = np.exp(-x * x / (2.0 * sigma * sigma))
    return np.round(taps / taps.sum() * 2.0 ** PERTURB_TAP_BITS) / 2.0 ** PERTURB_TAP_BITS


def gaussian_blur(img, sigma: float):
    """A separable Gaussian blur of an (H, W, C) float64 image with cv2's
    default border (reflect-101): along the rows, then the columns, each a
    sum of shifted copies in a fixed order. Every step is one IEEE
    operation an element, so the same input gives the same bytes on any
    machine."""
    import numpy as np

    taps = gaussian_taps(sigma)
    r = len(taps) // 2
    for axis in (1, 0):
        pad = [(0, 0)] * img.ndim
        pad[axis] = (r, r)
        src = np.pad(img, pad, mode="reflect")
        n = img.shape[axis]
        out = np.zeros_like(img)
        for i, w in enumerate(taps):
            out += w * np.take(src, np.arange(i, i + n), axis=axis)
        img = out
    return img


def vignette_mask(h: int, w: int, corner_gain: float):
    """python/perturb.py ``_vignette_mask`` in float64."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    r = np.sqrt((xx - (w - 1) / 2.0) ** 2 + (yy - (h - 1) / 2.0) ** 2)
    r /= r.max()
    return (1.0 - (1.0 - corner_gain) * r * r)[..., None]


def perturb_rgb(rgb, p: dict, rng, mask=None):
    """python/perturb.py ``perturb_frame``'s optical steps, without its JPEG
    step (a raw camera has none), on an (H, W, 3) u8 RGB image: the blur,
    the vignette, the white balance, the noise (drawn over the BGR image,
    as ``perturb_frame`` draws it), the clip to u8. In numpy float64."""
    import numpy as np

    bgr = rgb[..., ::-1].astype(np.float64)
    if p["blur"] > 0:
        bgr = gaussian_blur(bgr, p["blur"])
    bgr = bgr * (vignette_mask(*bgr.shape[:2], p["vignette"]) if mask is None else mask)
    bgr = bgr * np.asarray(p["wb"], dtype=np.float64)  # B, G, R gains
    bgr = bgr + rng.normal(0.0, p["noise"], bgr.shape)
    return np.ascontiguousarray(np.clip(bgr, 0, 255).astype(np.uint8)[..., ::-1])


def perturb_seed(profile: str, c: int, j: int) -> list:
    """The noise seed of camera c's frame j under a profile."""
    return [zlib.crc32(profile.encode()), c, j]


def perturb_bank(cams, geometry, base, profiles=None, pool=None) -> dict:
    """The perturbed raws: for each profile, each camera's PERTURB_ENTRIES
    of ``soak_scenes`` rendered to RGB (``render_rgb``), perturbed
    (``perturb_rgb``, seed ``perturb_seed``) and mosaicked to 1080p RGGB
    (``rgb_to_bayer``). Returns {"raws": {profile: [camera][frame]},
    "digests": {profile: [SHA-256 of camera c's raws]}, "scenes":
    [camera][frame]}."""
    import hashlib

    import numpy as np

    from vision_processor_tpu_torch.io.synthetic import render_rgb, rgb_to_bayer

    table = perturb_profiles()
    profiles = sorted({row[0] for row in PERTURB_ROWS}) if profiles is None else profiles
    scenes = [[cam[k] for k in PERTURB_ENTRIES] for cam in soak_scenes(cams, base)]
    jobs = [(c, j) for c in range(len(cams)) for j in range(len(PERTURB_ENTRIES))]
    mapper = map if pool is None else pool.map
    rgb = dict(zip(jobs, mapper(lambda cj: render_rgb(cams[cj[0]][0], geometry.field,
                                                      scenes[cj[0]][cj[1]]), jobs)))
    h, w = next(iter(rgb.values())).shape[:2]
    raws, digests = {}, {}
    for profile in profiles:
        p = table[profile]
        mask = vignette_mask(h, w, p["vignette"])

        def one(cj, p=p, mask=mask, profile=profile):
            rng = np.random.default_rng(perturb_seed(profile, *cj))
            return rgb_to_bayer(perturb_rgb(rgb[cj], p, rng, mask), "RGGB")

        done = dict(zip(jobs, mapper(one, jobs)))
        raws[profile] = [[done[(c, j)] for j in range(len(PERTURB_ENTRIES))]
                         for c in range(len(cams))]
        digests[profile] = []
        for cam_raws in raws[profile]:
            sha = hashlib.sha256()
            for raw in cam_raws:
                sha.update(raw.tobytes())
            digests[profile].append(sha.hexdigest())
    return {"raws": raws, "digests": digests, "scenes": scenes}


def fleet_prior(bots_by_cam: dict, now: float) -> dict:
    """The tracked prior a fleet's socket would hold after sending each
    camera's ``bots`` (``fin_detections``) one frame before ``now``."""
    return {c: [SimpleNamespace(id=i, x=x, y=y, z=z, w=w, vx=0.0, vy=0.0, vw=0.0,
                                timestamp=now - 0.01) for i, (x, y, z, w) in bots.items()]
            for c, bots in bots_by_cam.items()}


def perturb_score(scene, bots: dict, balls: list) -> dict:
    """tests/test_perturbation.py's scoring of one frame: the planted robots
    named by id (at any distance) and their errors, and whether a ball was
    sent; with ``judged``'s outcome (ids within 30 mm, ball within 40 mm)."""
    truth = {b.bot_id + (16 if b.team == "blue" else 0): b for b in scene.bots}
    errs = [math.hypot(bots[i][0] - b.x, bots[i][1] - b.y) for i, b in truth.items()
            if i in bots]
    out = judged(scene, bots, balls)
    return {"named": len(errs), "planted": len(truth), "errs": errs,
            "any_ball": bool(balls), "ids": out["all_ids"], "ball": out["ball"]}


def perturb_row_summary(frames: list) -> dict:
    """A row's frames (``perturb_score`` by camera, then frame) summed:
    robot recall, ball recall, mean robot error, and the outcome strings."""
    import numpy as np

    errs = [e for cam in frames for f in cam for e in f["errs"]]
    n = sum(len(cam) for cam in frames)
    return {"recall": sum(f["named"] for cam in frames for f in cam)
            / max(sum(f["planted"] for cam in frames for f in cam), 1),
            "ball_recall": sum(f["any_ball"] for cam in frames for f in cam) / max(n, 1),
            "mean_err": float(np.mean(errs)) if errs else float("inf"),
            "ids": ["".join("1" if f["ids"] else "0" for f in cam) for cam in frames],
            "ball": ["".join("1" if f["ball"] else "0" for f in cam) for cam in frames]}


def _perturb_fleet(torch, geometry, size, circularity: float, factor: float):
    """The 4-camera fleet on the card for one row: max_blobs 2000,
    on-device finishing, "auto" resample, the row's circularity."""
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp

    configs = []
    for c in range(N_CAMS):
        cfg = vision_config("auto", factor, c)
        cfg.min_circularity = circularity
        configs.append(cfg)
    app = MultiCamApp.offline(configs, device=torch.device("cuda", 0))
    for proc in app.processors:
        proc.geometry_check(*size, geometry, 1)
    return app


def run_perturbation(torch, recorder, card: str) -> dict:
    """Degraded optics on the card at production scale: the six rows of
    tests/test_perturbation.py:35-72 (profile, circularity, factor) on
    ``bench_rig``'s 4 cameras (1080p RGGB, max_blobs 2000, "auto" -> warp,
    on-device finishing), six frames a camera (``perturb_bank``: the soak
    loop's plain entries, perturbed by python/perturb.py's optical steps),
    each row through ``MultiCamApp.offline`` frame-set by frame-set with
    the tracked prior from the previous frame-set. Fails unless (a) each
    camera's raws have the digest the JAX witness had; (b) in every frame
    the outcome (every planted robot named within 30 mm, the ball within
    40 mm) equals ``JAX_PERTURB_FOUND``; (c) each row's mean robot error is
    within PERTURB_ERR_MM of the JAX package's; (d) "auto" resolves to
    warp and every frame-set launches SOAK_LAUNCHES. One frame-set's B2,
    B3 and B4 inputs a profile are kept for phase 8. Recall, ball recall
    and mean error are printed against the JAX test's bars, with B3's m,
    B4's ring Q and the flat grid's mm a pixel."""
    phase("degraded optics: tests/test_perturbation.py's rows on the 4 x 1080p rig")
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from vision_processor_tpu_torch.app.processor import TrackedArrays
    from vision_processor_tpu_torch.bench import build_rig
    from vision_processor_tpu_torch.io.camera import RawFrame
    from vision_processor_tpu_torch.ops import cuda as K

    t0 = time.perf_counter()
    if sorted(JAX_PERTURB_FOUND) != list(range(len(PERTURB_ROWS))):
        fail("degraded optics: JAX_PERTURB_FOUND has no entry for every row")
    rig = build_rig(N_CAMS, dense=True, dense_blobs=1900, resampling_factor=1.25,
                    return_scenes=True, raws=np.zeros((N_CAMS, 1080, 1920), np.uint8),
                    device=torch.device("cuda", 0))
    geometry, cams = rig[7], rig[8]
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        bank = perturb_bank(cams, geometry, rig[9], pool=pool)
    size = tuple(int(v) for v in cams[0][0].size)
    t_bank = time.perf_counter() - t0
    print(f"degraded optics: {N_CAMS} cameras x {len(PERTURB_ENTRIES)} frames x "
          f"{len(bank['raws'])} profiles rendered and perturbed in {t_bank:.1f} s")
    bad, rows, kept = [], [], {}
    for r, (profile, circ, bar_recall, bar_ball, bar_err, factor) in enumerate(PERTURB_ROWS):
        want = JAX_PERTURB_FOUND[r]
        label = f"row {r} ({profile}, circularity {circ}, factor {factor})"
        # (a) the frames are the witness's
        if bank["digests"][profile] != want["digests"]:
            fail(f"degraded optics {label}: the raws' digests {bank['digests'][profile]} "
                 f"differ from the witness's {want['digests']}: the frames differ")
        app = _perturb_fleet(torch, geometry, size, circ, factor)
        slots = app.processors[0].det_cfg.max_tracked
        scores = [[] for _ in range(N_CAMS)]
        last, ms, qs, per_set = {}, set(), set(), []
        for j in range(len(PERTURB_ENTRIES)):
            now = 0.01 * j
            frames = [RawFrame(data=bank["raws"][profile][c][j], fmt="RGGB", width=size[0],
                               height=size[1]) for c in range(N_CAMS)]
            for calls in recorder.calls.values():
                calls.clear()
            launched = dict(K.LAUNCHES)
            recorder.on = True
            try:
                out = app.dispatch_frames(frames, now, TrackedArrays.build(
                    fleet_prior(last, now), now, slots))
                fin = {k: v.cpu().numpy() for k, v in out[2].items()}
            finally:
                recorder.on = False
            per_set.append({k: K.LAUNCHES[k] - launched[k] for k in launched})
            ms |= {m for (_, m), _ in recorder.calls["row_topk"]}
            qs |= {q.shape[0] for (q, *_), kw in recorder.calls["query_select_topk"]
                   if kw["by_rank"]}
            if profile not in kept and j == len(PERTURB_ENTRIES) - 1:
                kept[profile] = {name: list(recorder.calls[name]) for name in
                                 ("blob_response_fused", "row_topk", "query_select_topk")}
            last = {}
            for c in range(N_CAMS):
                bots, balls = fin_detections(fin, c)
                last[c] = bots
                scores[c].append(perturb_score(bank["scenes"][c][j], bots, balls))
        for calls in recorder.calls.values():
            calls.clear()
        mode = app.mc_cfg.bm.resample_mode
        scale = [float(p.perspective.field_scale) for p in app.processors]
        got = perturb_row_summary(scores)
        del app
        row = {"profile": profile, "circularity": circ, "factor": factor, "mode": mode,
               "mm_per_flat_px": scale, "b3_m": sorted(ms), "b4_ring_q": sorted(qs), **got,
               "jax_mean_err": want["err"],
               "bars": {"recall": bar_recall, "ball_recall": bar_ball, "mean_err": bar_err}}
        rows.append(row)
        clears = (got["recall"] >= bar_recall and got["ball_recall"] >= bar_ball
                  and got["mean_err"] < bar_err)
        print(f"degraded optics {label}: mode {mode}, {scale[0]:.4f} mm a flat pixel; robot "
              f"recall {got['recall']:.4f} (bar {bar_recall}), ball recall "
              f"{got['ball_recall']:.4f} (bar {bar_ball}), mean robot error "
              f"{got['mean_err']:.4f} mm (bar {bar_err}; the JAX package {want['err']:.4f}) "
              f"-> {'clears' if clears else 'misses'} the JAX test's bars; ids by camera "
              f"{got['ids']} (JAX {want['ids']}), ball {got['ball']} (JAX {want['ball']}); "
              f"B3 m {sorted(ms)}, B4 ring Q {sorted(qs)}")
        # (b) every frame's outcome the JAX package's
        for key in ("ids", "ball"):
            if got[key] != want[key]:
                bad.append(f"{label}: {key} by camera {got[key]}, the JAX package "
                           f"{want[key]}")
        # (c) the mean robot error
        if not abs(got["mean_err"] - want["err"]) <= PERTURB_ERR_MM:
            bad.append(f"{label}: mean robot error {got['mean_err']:.4f} mm, the JAX "
                       f"package {want['err']:.4f}")
        # (d) the path and its launches
        if mode != "warp":
            bad.append(f"{label}: \"auto\" resolved to {mode!r}, expected 'warp'")
        for i, launched in enumerate(per_set):
            wrong = {k: (launched[k], v) for k, v in SOAK_LAUNCHES.items()
                     if launched[k] != v}
            if wrong:
                bad.append(f"{label}: frame-set {i} launched (got, expected) {wrong}")
                break
    wall = time.perf_counter() - t0
    print(f"degraded optics phase: {wall:.1f} s ({card}); the perturbed B2/B3/B4 inputs "
          f"of one frame-set a profile ({sorted(kept)}) go to phase 8")
    if bad:
        fail("degraded optics: " + "; ".join(bad))
    return {"rows": rows, "seconds": wall, "bank_seconds": t_bank, "card": card,
            "digests": bank["digests"], "calls": kept}


# ---------------------------------------------------------------------------
# codec round trip: tests/test_codec_roundtrip.py at the rig's full width
# ---------------------------------------------------------------------------

CODEC_QP = 24  # tests/test_codec_roundtrip.py:95
CODEC_SLICES = 4  # the encoder's slices, fixed: the stream must not depend on the cores
CODEC_ENTRIES = PERTURB_ENTRIES  # camera 0's frames: the soak loop's plain entries
CODEC_GROUP, CODEC_PORT = "224.99.99.181", 18181  # the App's vision and GC sockets
CODEC_STREAM_END = 182  # its debug stream: 224.99.99.182
CODEC_GAP_S = 0.05  # between reads: a frame's detections reach the App's socket first
CODEC_ERR_MM = 1.0  # a detection within this of the JAX package's on the same frames
CODEC_LAUNCHES = {"band_pass": 2, "blob_response_fused": 1, "row_topk": 1,
                  "query_select_topk": 2}  # a frame, on the warp path
# The JAX package's App on the decoded frames, on the CPU, in the warp
# resample (tests/jax_codec_witness.py): the SHA-256 of the decoded RGB
# frames and, a detection frame, the robots [team, id, x, y] and the balls
# [x, y] it sent. The port's App on the CPU sent the same ids, within
# 0.000492 mm.
JAX_CODEC_FOUND = {
    "digest": "6731599720d3b46b4d60046544eadb71b50d1ee9ec232fa48d0e1d5d6290c4a3",
    "frames": [
        {"number": 1, "bots": [
            ["b", 1, -2964.056640625, -1947.9078369140625],
            ["b", 3, -2068.310791015625, -1940.430419921875],
            ["y", 0, -1487.67626953125, -742.0733642578125],
            ["y", 2, -3736.71142578125, -799.5391845703125],
        ], "balls": [[-1950.0927734375, -1506.1446533203125]]},
        {"number": 2, "bots": [
            ["b", 1, -3005.612548828125, -1795.8387451171875],
            ["b", 3, -2107.615478515625, -1789.039794921875],
            ["y", 0, -1527.65087890625, -590.6537475585938],
            ["y", 2, -3776.761962890625, -650.6134643554688],
        ], "balls": [[-1992.1512451171875, -1359.8125], [-1989.006591796875, -1357.1292724609375]]},
        {"number": 3, "bots": [
            ["b", 1, -3114.6396484375, -1687.539794921875],
            ["b", 3, -2218.466552734375, -1679.8946533203125],
            ["y", 0, -1637.6175537109375, -480.6017761230469],
            ["y", 2, -3886.001953125, -539.44140625],
        ], "balls": [[-2099.52001953125, -1248.6217041015625]]},
        {"number": 4, "bots": [
            ["b", 1, -3266.560546875, -1646.1591796875],
            ["b", 3, -2368.056396484375, -1638.813232421875],
            ["y", 0, -1787.746337890625, -440.9791564941406],
            ["y", 2, -4036.3759765625, -501.54071044921875],
        ], "balls": [[-2249.62890625, -1210.236083984375]]},
        {"number": 5, "bots": [
            ["b", 1, -3414.695068359375, -1685.794189453125],
            ["b", 3, -2518.00830078125, -1681.0223388671875],
            ["y", 0, -1935.6024169921875, -481.7979736328125],
            ["y", 2, -4185.8427734375, -538.33203125],
        ], "balls": [[-2398.61279296875, -1248.8662109375]]},
        {"number": 6, "bots": [
            ["b", 1, -3564.554443359375, -1947.0604248046875],
            ["b", 3, -2668.22412109375, -1939.6229248046875],
            ["y", 0, -2088.306396484375, -741.3490600585938],
            ["y", 2, -4336.00390625, -800.2764282226562],
        ], "balls": [[-2548.886474609375, -1508.333251953125]]},
    ],
}


def codec_bank(cams, geometry, base, path: Path) -> dict:
    """Rig camera 0's CODEC_ENTRIES of ``soak_scenes`` rendered to RGB
    (``render_rgb``), encoded to one H.264 stream at ``path`` by the port's
    native encoder (CAVLC at qp CODEC_QP, CODEC_SLICES slices), decoded by
    cv2 and mosaicked to 1080p RGGB (``rgb_to_bayer``), as
    tests/test_codec_roundtrip.py:25-49 does. Returns {"raws", "scenes",
    "digest" (SHA-256 of the decoded RGB frames), "stream_bytes",
    "mean_abs" (the codec's mean change of a pixel value)}."""
    import hashlib

    import cv2
    import numpy as np

    from vision_processor_tpu_torch.io.native import H264Encoder
    from vision_processor_tpu_torch.io.synthetic import render_rgb, rgb_to_bayer

    scenes = [soak_scenes(cams[:1], base[:1])[0][k] for k in CODEC_ENTRIES]
    rgb = [render_rgb(cams[0][0], geometry.field, s) for s in scenes]
    enc = H264Encoder(qp=CODEC_QP, n_slices=CODEC_SLICES)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"".join(enc.encode_rgb(f) for f in rgb))
    h, w = rgb[0].shape[:2]
    cap = cv2.VideoCapture(str(path))
    decoded = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        decoded.append(np.ascontiguousarray(bgr[:h, :w, ::-1]))  # BGR -> RGB, unpad
    cap.release()
    if len(decoded) != len(rgb):
        fail(f"codec round trip: cv2 decoded {len(decoded)} of {len(rgb)} frames")
    sha = hashlib.sha256()
    for f in decoded:
        sha.update(f.tobytes())
    mean_abs = float(np.mean([np.abs(d.astype(np.int16) - r.astype(np.int16)).mean()
                              for d, r in zip(decoded, rgb)]))
    return {"raws": [rgb_to_bayer(f, "RGGB") for f in decoded], "scenes": scenes,
            "digest": sha.hexdigest(), "stream_bytes": path.stat().st_size,
            "mean_abs": mean_abs}


def codec_config(workdir: Path, stream: bool = True, mode: str | None = None) -> Path:
    """The repository's config.yml as shipped, with the SMOKE_CODEC driver,
    the isolated vision, GC and stream addresses, (``stream`` false) the
    debug stream off and (``mode``) ``thresholds.resample_mode`` set: on
    the CPU "auto" takes the gather, on the card the warp."""
    import yaml

    config = yaml.safe_load((ROOT / "config.yml").read_text())
    config["camera"] = {**(config.get("camera") or {}), "driver": "SMOKE_CODEC"}
    config["network"] = {"vision_ip": CODEC_GROUP, "vision_port": CODEC_PORT,
                         "gc_ip": CODEC_GROUP, "gc_port": CODEC_PORT + 1}
    config["stream"] = {**(config.get("stream") or {}), "ip_base_prefix": "224.99.99.",
                        "ip_base_end": CODEC_STREAM_END, "port": CODEC_PORT + 2}
    if not stream:
        config["stream"]["active"] = False
    if mode is not None:
        config["thresholds"] = {**(config.get("thresholds") or {}), "resample_mode": mode}
    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / "config.yml"
    path.write_text(yaml.dump(config))
    return path


def codec_app_run(pkg: str, cfg_path: Path, raws: list, size, packet: bytes, last=None,
                  **app_kw) -> tuple:
    """Package ``pkg``'s App under ``cfg_path``, its camera the SMOKE_CODEC
    driver over ``raws`` (one read every CODEC_GAP_S after the first; the
    clock 10 ms a frame), the geometry ``packet`` from a GeometryBus, every
    datagram on the group recorded off the wire; ``last()`` runs before
    the last frame is handed over. Returns (the detection frames off the
    wire as ``codec_frame`` dicts, the App, the run's seconds)."""
    import importlib

    from vision_processor_tpu_torch.proto import SSL_WrapperPacket

    camera = importlib.import_module(f"{pkg}.io.camera")

    class Camera(camera.CameraDriver):
        def __init__(self):
            self.i = 0

        @property
        def fmt(self):
            return "RGGB"

        def expected_frametime(self):
            return 0.01

        def get_time(self):
            return self.i / 100.0

        def read_image(self):
            if self.i >= len(raws):
                return None
            if self.i:
                time.sleep(CODEC_GAP_S)
            if self.i == len(raws) - 1 and last is not None:
                last()
            self.i += 1
            return camera.RawFrame(data=raws[self.i - 1], fmt="RGGB", width=size[0],
                                   height=size[1])

    camera.register_driver("SMOKE_CODEC", lambda cam_cfg: Camera())
    bus, wire = GeometryBus(packet), Datagrams(CODEC_GROUP, CODEC_PORT)
    cwd = os.getcwd()
    os.chdir(cfg_path.parent)  # the snapshots go under the working directory
    try:
        app = importlib.import_module(f"{pkg}.app.main").App(str(cfg_path), **app_kw)
        bus.attach(app.socket)
        bus.publish()
        t0 = time.perf_counter()
        app.run()  # to the camera's end; closes the App
        wall = time.perf_counter() - t0
        time.sleep(0.3)  # the last datagrams
    finally:
        os.chdir(cwd)
        wire.close()
    frames = []
    for data in wire.got:
        wrapper = SSL_WrapperPacket()
        wrapper.ParseFromString(data)
        if wrapper.HasField("detection"):
            frames.append(codec_frame(wrapper.detection))
    return frames, app, wall


def codec_frame(d) -> dict:
    """A detection frame as the witness keeps it: its number, the robots
    [team, id, x, y] and the balls [x, y], sorted."""
    return {"number": d.frame_number,
            "bots": sorted([team, r.robot_id, r.x, r.y]
                           for team, robots in (("y", d.robots_yellow), ("b", d.robots_blue))
                           for r in robots),
            "balls": sorted([b.x, b.y] for b in d.balls)}


def codec_verdict(frames: list, scenes: list, want: dict, mode: str = "warp",
                  launches: dict | None = None) -> tuple[dict, list]:
    """The codec phase's readings and what fails it: one detection frame a
    scene; in every frame after the first each planted robot named within
    30 mm and the ball within 40 mm; in every frame the robots (team, id)
    and the count of balls the JAX package's (``want``, JAX_CODEC_FOUND's
    shape), each position within CODEC_ERR_MM of its; the resample mode
    warp; ``launches`` (where given) CODEC_LAUNCHES a frame and nothing
    else."""
    bad = []
    if mode != "warp":
        bad.append(f"\"auto\" resolved to {mode!r}, expected 'warp'")
    if launches is not None:
        want_n = {k: CODEC_LAUNCHES.get(k, 0) * len(scenes) for k in launches}
        wrong = {k: (launches[k], n) for k, n in want_n.items() if launches[k] != n}
        if wrong:
            bad.append(f"launched (got, expected) {wrong}")
    if [f["number"] for f in frames] != list(range(1, len(scenes) + 1)):
        bad.append(f"detection frames {[f['number'] for f in frames]}, expected 1.."
                   f"{len(scenes)}")
    ids, jax_ids, bot_errs, ball_errs, diffs = [], [], [], [], []
    for k, (f, scene, w) in enumerate(zip(frames, scenes, want["frames"])):
        found = {(t, i): (x, y) for t, i, x, y in f["bots"]}
        errs = []
        for b in scene.bots:
            at = found.get(("b" if b.team == "blue" else "y", b.bot_id))
            errs.append(math.inf if at is None else math.hypot(at[0] - b.x, at[1] - b.y))
        ball = scene.balls[0]
        berr = min((math.hypot(x - ball.x, y - ball.y) for x, y in f["balls"]),
                   default=math.inf)
        bot_errs.append(max(errs))
        ball_errs.append(berr)
        ids.append([b[:2] for b in f["bots"]])
        jax_ids.append([b[:2] for b in w["bots"]])
        if k and (max(errs) > 30.0 or berr > 40.0):
            bad.append(f"frame {k + 1}: robots {sorted(found)} worst {max(errs):.2f} mm, "
                       f"ball {berr:.2f} mm (bars 30 / 40 mm)")
        if ids[-1] != jax_ids[-1] or len(f["balls"]) != len(w["balls"]):
            bad.append(f"frame {k + 1}: robots {ids[-1]} and {len(f['balls'])} balls, the "
                       f"JAX package {jax_ids[-1]} and {len(w['balls'])}")
            continue
        pairs = ([(a[2:], b[2:]) for a, b in zip(f["bots"], w["bots"])]
                 + list(zip(f["balls"], w["balls"])))
        diff = max((math.hypot(a[0] - b[0], a[1] - b[1]) for a, b in pairs), default=0.0)
        diffs.append(diff)
        if diff > CODEC_ERR_MM:
            bad.append(f"frame {k + 1}: a detection {diff:.4f} mm from the JAX package's "
                       f"(within {CODEC_ERR_MM} mm)")
    out = {"frames": len(frames), "ids": ids, "jax_ids": jax_ids,
           "max_bot_err_mm": bot_errs, "ball_err_mm": ball_errs,
           "max_diff_from_jax_mm": max(diffs, default=math.inf)}
    return out, bad


def run_codec(torch, recorder, card: str) -> dict:
    """tests/test_codec_roundtrip.py on the card at the rig's full width:
    camera 0 of the bench rig (960x540 model, 1080p RGGB) over the soak
    loop's plain entries, through the port's H.264 encoder and cv2's
    decoder (``codec_bank``), into the port's ``App`` on the card under
    config.yml as shipped (``codec_config``: stream on, "auto" resample)
    through a registered driver, detections recorded off CODEC_GROUP.
    Fails unless (a) the decoded frames' digest is the JAX witness's
    (``JAX_CODEC_FOUND``); (b) ``codec_verdict`` finds nothing: 30 / 40
    mm, ids and positions the JAX package's, "auto" resolved to warp and
    every frame launching CODEC_LAUNCHES, nothing else; (c) B1-B4 on the
    last frame's inputs equal their plain versions (``_check_recorded``).
    Prints the digests, ids, errors, the phase's seconds and B1-B4's max
    abs err."""
    phase("codec round trip: the App on H.264-decoded frames at the rig's full width")
    import numpy as np

    from vision_processor_tpu_torch.bench import build_rig
    from vision_processor_tpu_torch.ops import cuda as K

    t0 = time.perf_counter()
    rig = build_rig(N_CAMS, dense=True, dense_blobs=1900, resampling_factor=1.25,
                    return_scenes=True, raws=np.zeros((N_CAMS, 1080, 1920), np.uint8),
                    device=torch.device("cuda", 0))
    geometry, cams = rig[7], rig[8]
    bank = codec_bank(cams, geometry, rig[9], OUT / "codec" / "codec.h264")
    size = tuple(int(v) for v in cams[0][0].size)
    print(f"codec round trip: {len(bank['raws'])} frames of camera 0 ({size[0]}x{size[1]} "
          f"model, {bank['raws'][0].shape[1]}x{bank['raws'][0].shape[0]} RGGB), H.264 qp "
          f"{CODEC_QP} {bank['stream_bytes']} bytes, mean change of a pixel value "
          f"{bank['mean_abs']:.3f}; decoded digest {bank['digest']}, the witness's "
          f"{JAX_CODEC_FOUND['digest']}")
    if bank["digest"] != JAX_CODEC_FOUND["digest"]:
        fail("codec round trip: the decoded frames differ from the witness's")

    def last():  # the last frame's kernel inputs, for (c)
        for calls in recorder.calls.values():
            calls.clear()
        recorder.on = True

    K.reset_launches()
    try:
        frames, app, run_s = codec_app_run(
            "vision_processor_tpu_torch", codec_config(OUT / "codec"), bank["raws"], size,
            geometry_packet(geometry, 0), last, device=torch.device("cuda", 0))
    finally:
        recorder.on = False
    launches = dict(K.LAUNCHES)
    kept = {name: list(recorder.calls[name]) for name in CODEC_LAUNCHES}
    for calls in recorder.calls.values():
        calls.clear()
    mode = app.processor.resample_mode
    got, bad = codec_verdict(frames, bank["scenes"], JAX_CODEC_FOUND, mode, launches)
    errs = _check_recorded(torch, {"codec": kept}, "the codec round trip's last frame")
    wall = time.perf_counter() - t0
    print(f"codec round trip: App on the card (stream {app.streamer.codec}, {mode}); "
          f"{got['frames']} detection frames; ids {got['ids']} (JAX {got['jax_ids']}); worst "
          f"robot error a frame {[round(e, 3) for e in got['max_bot_err_mm']]} mm (bar 30 "
          f"after the first), ball {[round(e, 3) for e in got['ball_err_mm']]} mm (bar 40); "
          f"largest distance from the JAX package's detections "
          f"{got['max_diff_from_jax_mm']:.6f} mm (within {CODEC_ERR_MM}); launches "
          f"{ {k: v for k, v in launches.items() if v} }; B1-B4 max abs err against their "
          f"plain versions {errs}; run {run_s:.3f} s, phase {wall:.1f} s ({card})")
    if bad:
        fail("codec round trip: " + "; ".join(bad))
    return {**got, "digest": bank["digest"], "stream_bytes": bank["stream_bytes"],
            "mean_abs": bank["mean_abs"], "mode": mode, "launches": launches,
            "max_abs_err": errs, "run_s": run_s, "seconds": wall, "card": card}


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
    # the finisher replays as one CUDA graph: its inner stages run (and
    # read) only in the capture, so it is timed whole
    ("parallel.multicam", "_finish", "on-device finishing (4 cameras, graph replay)"),
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


def _check_b3(torch, calls, calls_f1, before, calls_dense=None):
    """Every slot, exhausted ones included, equal to select_m's (the
    Pallas _select_m) and, where ``before`` has it, to the other
    checkout's B3; values and valid indices equal to the plain version's;
    on slice 1's map at its m and at 19 (the m-lane tier's), slice 4's
    factor-1.0 map at its m and at 16, each dense frame-set's map at each m
    it ran (``calls_dense``: source -> calls; the m-lane tier), and a
    tie/exhausted map at every m of TOPK_MS. Timed at those path shapes, in turns with
    the other checkout's B3."""
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
    for source, dense in (calls_dense or {}).items():
        seen_m = set()
        for (xd, md), _ in dense:
            if md not in seen_m:
                seen_m.add(md)
                path.append((f"{source} {tuple(xd.shape)} m={md}", xd, md))
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


def _check_b4(torch, calls, before, calls_dense=None):
    """Every slot, exhausted ones included, equal to the plain version's
    (select_m over the materialized scores) and, where ``before`` has it,
    to the other checkout's B4; on slice 1's ring and tracked calls, the
    ring's inputs at Q = 512 (the dense window's anchors: the 128 queries
    at four offsets) and at every m of TOPK_MS, each dense frame-set's
    first ring call (``calls_dense``: source -> calls; Q = 512, its own blob
    table) and tracked call, and a tie/exhausted case. Timed per frame
    (ring + tracked) and per call at Q = 128, 160 and 512 and on the dense
    calls, in turns with the other checkout's B4."""
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
    dense = {}
    for source, dense_calls in (calls_dense or {}).items():
        for (qxy, r2, bxy, rank), kw in dense_calls:
            dense.setdefault((source, kw["by_rank"]),
                             (*(t.contiguous() for t in (qxy, r2, bxy, rank)), kw["m"],
                              kw["by_rank"]))
    cases += [(f"{source} {'ring' if c[5] else 'tracked'} Q={c[0].shape[0]} "
               f"K={c[2].shape[0]} m={c[4]}", c) for (source, _), c in dense.items()]
    n_timed = len(frame) + 1 + len(dense)
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
          f"{len(cases)} cases ({'; '.join(label for label, _ in cases[:n_timed])}; "
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
    for label, (a, b, c, d, m, by) in cases[:n_timed]:
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


def _check_recorded(torch, calls_by_set: dict, label: str) -> dict:
    """B1-B4 on the calls a phase recorded (a list of calls a kernel, by
    set): B1 against its plain version (max abs err), B2 bit-equal to its
    plain version with the count equal, B3 every slot select_m's and values
    and valid indices the plain version's, B4 every slot the plain
    version's. Returns each kernel's max abs err."""
    import vision_processor_tpu_torch.ops.blob_fused as BF
    import vision_processor_tpu_torch.ops.topk as T
    import vision_processor_tpu_torch.ops.warp as W

    band_pass = W.band_pass.__wrapped__
    fused = BF.blob_response_fused.__wrapped__
    row_topk, query = T.row_topk.__wrapped__, T.query_select_topk.__wrapped__
    err = {"B1": 0.0, "B2": 0.0, "B3": 0.0, "B4": 0.0}
    seen = []
    for name, calls in calls_by_set.items():
        for (src, pos), _ in calls.get("band_pass", []):
            e = float((band_pass(src, pos) - W._band_pass_plain(src, pos)).abs().max())
            if not e <= 1e-3:
                fail(f"band_pass ({name}): max abs err {e:.3g} against its plain version")
            err["B1"] = max(err["B1"], e)
        for args, kw in calls["blob_response_fused"]:
            same, n, e = _b2_equal(torch, fused, *args, **kw)
            if not same:
                fail(f"blob_response_fused ({name}): not bit-equal to its plain version "
                     f"(max abs err {e:.3g}) or its count differs")
            err["B2"] = max(err["B2"], e)
        for (x, m), _ in calls["row_topk"]:
            got, (v_p, i_p) = row_topk(x, m), T._row_topk_plain(x, m)
            valid = v_p > float("-inf")
            if not (_same_slots(torch, got, T.select_m(x, m)) and torch.equal(got[0], v_p)
                    and torch.equal(got[1][valid], i_p[valid])):
                fail(f"row_topk ({name}, m={m}): a slot differs from select_m's or the "
                     f"plain version's")
        for (a, b, c, d), kw in calls["query_select_topk"]:
            want = T._query_select_plain(a, b, c, d, kw["m"], kw["by_rank"])
            if not _same_slots(torch, query(a, b, c, d, **kw), want):
                fail(f"query_select_topk ({name}, Q={a.shape[0]}, m={kw['m']}): a slot "
                     f"differs from the plain version's")
        seen.append(f"{name}: " + ", ".join(
            f"{row} {len(calls.get(key, []))}" for row, key in (
                ("B1", "band_pass"), ("B2", "blob_response_fused"), ("B3", "row_topk"),
                ("B4", "query_select_topk")) if key in calls) + " calls")
    print(f"B1-B4 on {label}: equal to their plain versions ({'; '.join(seen)})")
    return err


def check_kernels(torch, s1: dict, s2: dict, s3: dict, s4: dict, s4f1: dict,
                  contracts: dict, bench: dict, soak: dict, perturbed: dict, codec: dict,
                  before) -> list:
    """Each kernel on the last frame's inputs of the slice whose path it
    belongs to: B1-B4 slice 1's, B5-B7 slice 2's, E4 slice 3's, E2/E3 slice
    4's; E1 and E5 on their contract run's inputs; B2 and B5 also on slice
    4's factor-1.0 map, B3 and B4 also on the bench's and the soak's dense
    frame-sets, beside the other checkout's where ``before`` has it; B2, B3
    and B4 also on the degraded-optics phase's frame-sets; every row's max
    abs err also over the codec round trip's B1-B4 (held in that phase)."""
    phase("kernels vs plain")
    one = torch.zeros(1, device="cuda")
    floor = time_fn(torch, one.zero_)
    print(f"one launch of a one-element fill (the least a kernel takes on this card): "
          f"{_fmt(floor)}")
    c1, c2, c3, c4 = s1["calls"], s2["calls"], s3["calls"], s4["calls"]
    b2_f1 = s4f1["calls"]["blob_response_fused"]
    recorded = _check_recorded(torch, perturbed["calls"], "the degraded-optics frame-sets")
    for row, e in codec["max_abs_err"].items():
        recorded[row] = max(recorded[row], e)
    rows = [
        ("B1", _check_b1(torch, c1["band_pass"])),
        ("B2", _check_b2(torch, c1["blob_response_fused"], b2_f1, before)),
        ("B3", _check_b3(torch, c1["row_topk"], s4f1["calls"]["row_topk"], before,
                         {"bench dense": bench["dense_calls"]["row_topk"],
                          "soak dense": soak["dense_calls"]["row_topk"]})),
        ("B4", _check_b4(torch, c1["query_select_topk"], before,
                         {"bench dense": bench["dense_calls"]["query_select_topk"],
                          "soak dense": soak["dense_calls"]["query_select_topk"]})),
        ("B5", _check_b5(torch, c2["circularity_fused"], b2_f1, before)),
        ("B6", _check_b6(torch, c2["combo_chain"], before)),
        ("B7", _check_b7(torch, c2["gather_corners"])),
        ("E1", _check_e1(torch, contracts, before)),
        ("E2", _check_e2e3(torch, c4["resample_packed"], s4f1["calls"]["resample_packed"])),
        ("E4", _check_e4(torch, c3["corner_stack"])),
        ("E5", _check_e5(torch, contracts, before)),
    ]
    for row, res in rows:
        if row in recorded:
            res["err"] = max(res["err"], recorded[row])
    return rows


def main() -> None:
    global OUT
    parser = argparse.ArgumentParser(description="chip smoke of the PyTorch/CUDA port")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--out", type=Path, default=OUT)
    parser.add_argument("--before", type=Path, default=None,
                        help="another checkout of the repository whose B2-B6, E1 and E5 "
                             "are timed in turns with this one's (B3, B4, B6 and E5 held "
                             "equal to this one's in every slot)")
    parser.add_argument("--soak-frames", type=int, default=SOAK_FRAMES["pipelined"],
                        help="N, the pipelined soak run's frame-sets after its warm-up "
                             f"(default {SOAK_FRAMES['pipelined']}; the staggered run keeps "
                             f"{SOAK_FRAMES['staggered']})")
    args = parser.parse_args()
    OUT = args.out.resolve()
    soak_frames = dict(SOAK_FRAMES, pipelined=args.soak_frames)

    if not (ROOT / "vision_processor_tpu_torch" / "csrc").is_dir():
        fail("run from a checkout of the repository: vision_processor_tpu_torch/ is missing")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs only on a GPU")
    card = environment(torch)
    native_build = start_native_build()
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
    replay = run_replay(torch, rig, native_build)
    drivers = run_camera_drivers(torch, rig, card)
    mesh = run_camera_mesh(torch, recorder, rig, card)
    processes = run_processes(torch, rig, replay, card)
    bench = run_bench(torch, recorder)
    soak = run_soak(torch, recorder, card, soak_frames)
    perturbed = run_perturbation(torch, recorder, card)
    codec = run_codec(torch, recorder, card)
    contracts = run_contracts(torch)
    for label, s, unit in (("slice 1 (warp, score-first)", s1, "frame"),
                           ("slice 2 (gather, circ-first, fused combo)", s2, "frame"),
                           ("slice 3 (4 cameras, gather)", s3, "frame-set"),
                           ("slice 3 (4 cameras, warp)", s3w, "frame-set"),
                           ("slice 4 (4 cameras, in line)", s4, "frame-set"),
                           ("slice 4 (4 cameras, in line, factor 1.0)", s4f1, "frame-set"),
                           ("camera mesh (NCCL world of 1, 4 cameras, in line)", mesh,
                            "frame-set")):
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
    results = check_kernels(torch, s1, s2, s3, s4, s4f1, contracts, bench, soak, perturbed,
                            codec, before)
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
                                    ("camera mesh", mesh),
                                    ("E1 and E5 contracts", contracts))},
        "idle path": idle,
        "calibration path": calib,
        "pair height": pair,
        "debug stream and replay": replay,
        "camera drivers": drivers,
        "processes": processes,
        "bench": {k: v for k, v in bench.items() if k != "dense_calls"},
        "soak": {k: v for k, v in soak.items() if k != "dense_calls"},
        "degraded optics": {k: v for k, v in perturbed.items() if k != "calls"},
        "codec round trip": codec,
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
