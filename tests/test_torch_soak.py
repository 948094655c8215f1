"""The port's long-run guarantees on the CPU: the counterpart of
tests/test_soak.py for ``vision_processor_tpu_torch``.

The real port ``MultiCamApp(device="cpu")`` runs two synthetic cameras
(960x720 models, ``thresholds.blobs`` 128, the fleet of
tests/test_torch_multicam_app.py) for N_FRAMES frame-sets in each dispatch
mode, through the events of tests/test_soak.py scaled to the run:

* frame-locked geometry churn: the publisher's packet (the field and both
  calibrations) every 3rd frame-set;
* a hot reload of a tunable at N/3: camera 0's ``thresholds.circularity``
  rewritten in its config file (``VisionConfig.reload_if_changed``, the
  0.5 s mtime poll of ``MultiCamApp.run``);
* a 4-frame-set outage of camera 1 at N/2.

After WARM frame-sets it gates, at the stated tolerances:

* no rebuild: ``MultiCamApp._ensure_step`` builds no step
  (``batched_step_host_tracked``), and neither the resample grids
  (``make_resample_grids``) nor the field marks (``pack_field_marks``)
  are made again (the port's "zero steady-state recompiles");
* no growth: the live ``torch.Tensor`` objects (by ``gc``) at the end at
  most 8 above warm-up (the live-array gate of tests/test_soak.py), and
  the threads and open file descriptors within 2 of warm-up;
* a drop-free wire: camera 0 emits exactly N detection frames, camera 1
  N - 4, frame numbers strictly increasing;
* detections throughout: each camera's robot within 30 mm in at least
  98 % of its frames, camera 0's ball within 40 mm in as many, and
  camera 1's robot again within 2 frame-sets after the outage;
* the reload: the port's reloaded ``VisionConfig`` tunables and
  ``Processor.params()`` equal the JAX package's
  ``VisionConfig.reload_if_changed`` + ``Processor.apply_tunables`` on
  the same two files, and the fleet's ``min_circularity`` holds the new
  value for camera 0 and the old one for camera 1.
"""
from __future__ import annotations

import gc
import os
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import yaml

from vision_processor_tpu.models.camera import CameraModel as JCameraModel
from vision_processor_tpu.net.geometry_io import geometry_from_dict as jgeometry_from_dict

N_FRAMES = 36  # frame-sets a mode (tests/test_soak.py: 1000, on the JAX package)
WARM = 9  # frame-sets before the steady-state gates
BANK = 12  # distinct frames a camera, the robot on a 300 mm circle
OUTAGE = tuple(range(N_FRAMES // 2, N_FRAMES // 2 + 4))  # camera 1 dark
RELOAD_AT = N_FRAMES // 3
CIRC_BEFORE, CIRC_AFTER = 15.0, 12.0
N_CAMS = 2
ROBOT_MM, BALL_MM, FOUND_SHARE = 30.0, 40.0, 0.98
TENSOR_SLACK, HANDLE_SLACK = 8, 2
FIELD = {"field": {
    "field_length": 9000, "field_width": 6000, "goal_width": 1000,
    "goal_depth": 180, "penalty_area_depth": 1000,
    "penalty_area_width": 2000, "boundary_width": 300,
    "center_circle_radius": 500, "line_thickness": 10,
    "ball_radius": 21.5, "max_robot_radius": 90.0,
}}
# each mode on its own group and ports, used by no other test
GROUPS = {"pipelined": ("224.99.99.141", 18711), "staggered": ("224.99.99.143", 18713)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def soak_rig():
    """The cameras of tests/test_soak.py (960x720 initial guesses over the
    two halves), each with a bank of BANK frames: camera 0's yellow robot 3
    and camera 1's blue robot 4 circling 300 mm around the camera's axis,
    camera 0's ball fixed 900 mm off it."""
    from vision_processor_tpu_torch.io.synthetic import Scene, SceneBall, SceneBot
    from vision_processor_tpu_torch.io.synthetic import render_raw
    from vision_processor_tpu_torch.models.camera import CameraModel

    field = jgeometry_from_dict(FIELD).geometry.field
    jmodels = [JCameraModel.initial_guess(np.array([960, 720]), c, N_CAMS, 4500.0, field)
               for c in range(N_CAMS)]
    models = [CameraModel(focal_length=m.focal_length, principal_point=m.principal_point,
                          distortion_k2=m.distortion_k2, pos=m.pos, quat=m.quat, size=m.size)
              for m in jmodels]
    scenes = []
    for c, model in enumerate(models):
        cx = float(model.pos[0])
        cam_scenes = []
        for k in range(BANK):
            ang = 2 * np.pi * k / BANK
            cam_scenes.append(Scene(
                bots=[SceneBot(3 + c, "yellow" if c == 0 else "blue",
                               cx + 300 * np.cos(ang), 300 * np.sin(ang), float(ang))],
                balls=[SceneBall(cx, -900.0)] if c == 0 else [],
                noise_sigma=1.0, seed=k))
        scenes.append(cam_scenes)
    with ThreadPoolExecutor(4) as pool:  # numpy releases the GIL
        raws = [list(pool.map(lambda s, m=model: render_raw(m, field, s, "RGGB"), cam_scenes))
                for model, cam_scenes in zip(models, scenes)]
    return field, jmodels, scenes, raws


def _register(name, raws):
    """Bank drivers: camera c serves its bank in a loop for N_FRAMES reads;
    camera 1 returns None during OUTAGE."""
    from vision_processor_tpu_torch.io.camera import CameraDriver, RawFrame, register_driver

    class Bank(CameraDriver):
        def __init__(self, c):
            self.c, self.i = c, 0

        @property
        def fmt(self):
            return "RGGB"

        def expected_frametime(self):
            return 0.01

        def get_time(self):
            return self.i * 0.01

        def read_image(self):
            if self.i >= N_FRAMES:
                return None
            i, self.i = self.i, self.i + 1
            if self.c == 1 and i in OUTAGE:
                return None
            return RawFrame(data=raws[self.c][i % BANK], fmt="RGGB", width=960, height=720)

    register_driver(name, lambda cam_cfg: Bank(int(cam_cfg.path)))


def _write_configs(tmp_path, driver, group, port):
    paths = []
    for c in range(N_CAMS):
        p = tmp_path / f"config{c}.yml"
        p.write_text(yaml.dump({
            "cam_id": c,
            "bot_heights_file": str(tmp_path / "none.yml"),
            "camera": {"driver": driver, "path": str(c)},
            "geometry": {"camera_amount": N_CAMS},
            "network": {"vision_ip": group, "vision_port": port,
                        "gc_ip": group, "gc_port": port + 1},
            "stream": {"active": False},
            "debug": {"wait_for_geometry": True},
            "thresholds": {"blobs": 128, "circularity": CIRC_BEFORE},
        }))
        paths.append(str(p))
    return paths


def _live_tensors() -> int:
    gc.collect()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # isinstance on torch's deprecated aliases
        return sum(1 for o in gc.get_objects() if isinstance(o, torch.Tensor))


def _handles() -> tuple[int, int]:
    return threading.active_count(), len(os.listdir("/proc/self/fd"))


def _found(det, truth, ball) -> tuple[bool, bool]:
    team = det.robots_yellow if truth.team == "yellow" else det.robots_blue
    robot = any(r.robot_id == truth.bot_id
                and np.hypot(r.x - truth.x, r.y - truth.y) <= ROBOT_MM for r in team)
    ball_ok = ball is None or any(np.hypot(b.x - ball.x, b.y - ball.y) <= BALL_MM
                                  for b in det.balls)
    return robot, ball_ok


@pytest.mark.parametrize("mode", ["pipelined", "staggered"])
def test_torch_soak_stability(tmp_path, soak_rig, monkeypatch, mode):
    from vision_processor_tpu_torch.app import multicam_app as MA
    from vision_processor_tpu_torch.net.udp import UDPSocket
    from vision_processor_tpu_torch.proto import SSL_WrapperPacket

    if mode == "staggered":
        monkeypatch.setenv("VPTPU_PIPELINE", "0")
        monkeypatch.setenv("VPTPU_STAGGERED", "1")
    else:
        monkeypatch.setenv("VPTPU_PIPELINE", "1")
        monkeypatch.setenv("VPTPU_STAGGERED", "0")
    field, jmodels, scenes, raws = soak_rig
    group, port = GROUPS[mode]
    driver = f"SYNTH_SOAK_{mode.upper()}"
    _register(driver, raws)
    paths = _write_configs(tmp_path, driver, group, port)
    first_cfg = (tmp_path / "config0.yml").read_text()

    geometry = SSL_WrapperPacket()
    geometry.geometry.field.CopyFrom(field)
    for c, m in enumerate(jmodels):
        geometry.geometry.calib.append(m.to_proto(c))
    by_cam = {c: [] for c in range(N_CAMS)}

    class Bus(UDPSocket):
        def _parse(self, data):
            got = SSL_WrapperPacket()
            got.ParseFromString(data)
            if got.HasField("detection"):
                by_cam[got.detection.camera_id].append(got.detection)

    # every build of the fleet's step, grids and marks, by the frame-set
    # that made it
    rebuilds = {name: [] for name in ("batched_step_host_tracked", "make_resample_grids",
                                      "pack_field_marks")}
    dispatched = [0]
    for name, calls in rebuilds.items():
        def counted(*args, _fn=getattr(MA, name), _calls=calls, **kwargs):
            _calls.append(dispatched[0])
            return _fn(*args, **kwargs)
        monkeypatch.setattr(MA, name, counted)

    bus = Bus(group, port)
    stop = threading.Event()

    def publish():  # until the fleet has its geometry; then frame-locked
        while not stop.is_set() and dispatched[0] < 2:
            bus.send(geometry)
            stop.wait(0.05)

    publisher = threading.Thread(target=publish, daemon=True)
    publisher.start()
    probes = {}
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)
        app = MA.MultiCamApp(paths, device="cpu")
        assert app.staggered == (mode == "staggered")
        dispatch = app.dispatch_frames

        def dispatch_wrapped(frames, now, tracked=None):
            i = dispatched[0]
            if i % 3 == 0:
                bus.send(geometry)  # frame-locked churn, tests/test_soak.py:248-257
            if i == RELOAD_AT:
                cfg = yaml.safe_load(first_cfg)
                cfg["thresholds"]["circularity"] = CIRC_AFTER
                (tmp_path / "config0.yml").write_text(yaml.dump(cfg))
            if i in (WARM, N_FRAMES - 1):
                probes[i] = (_live_tensors(), *_handles())
            dispatched[0] += 1
            return dispatch(frames, now, tracked)

        app.dispatch_frames = dispatch_wrapped
        try:
            app.run()  # closes the app at its end
        except BaseException:
            app.close()
            raise
        fleet_circ = app._fleet_params()["min_circularity"]
        port_cfg, port_params = app.configs[0], app.processors[0].params()
        gc_socket = app.gc_socket
        stop.wait(0.3)
    finally:
        os.chdir(cwd)
        stop.set()
        publisher.join()
        bus.close()

    assert dispatched[0] == N_FRAMES
    # no rebuild after warm-up
    for name, calls in rebuilds.items():
        assert calls and max(calls) < WARM, f"{name} ran at frame-sets {calls}"
    # no growth
    (t0, th0, fd0), (t1, th1, fd1) = probes[WARM], probes[N_FRAMES - 1]
    assert t1 <= t0 + TENSOR_SLACK, f"live tensors {t0} -> {t1}"
    assert abs(th1 - th0) <= HANDLE_SLACK, f"threads {th0} -> {th1}"
    assert abs(fd1 - fd0) <= HANDLE_SLACK, f"fds {fd0} -> {fd1}"
    # drop-free wire
    assert len(by_cam[0]) == N_FRAMES
    assert len(by_cam[1]) == N_FRAMES - len(OUTAGE)
    for c in range(N_CAMS):
        fn = [d.frame_number for d in by_cam[c]]
        assert all(b > a for a, b in zip(fn, fn[1:])), f"camera {c}: {fn}"
    assert {d.frame_number for d in by_cam[1]}.isdisjoint({i + 1 for i in OUTAGE})
    # detections throughout (frame number f is the driver's read f - 1)
    for c in range(N_CAMS):
        hits = [_found(d, scenes[c][(d.frame_number - 1) % BANK].bots[0],
                       (scenes[c][(d.frame_number - 1) % BANK].balls or [None])[0])
                for d in by_cam[c]]
        robots, balls = (sum(h[k] for h in hits) for k in (0, 1))
        assert robots >= FOUND_SHARE * len(hits), f"camera {c}: robot in {robots}/{len(hits)}"
        assert balls >= FOUND_SHARE * len(hits), f"camera {c}: ball in {balls}/{len(hits)}"
    after = [d for d in by_cam[1] if d.frame_number > OUTAGE[-1] + 1][:2]
    truth = [scenes[1][(d.frame_number - 1) % BANK].bots[0] for d in after]
    assert any(_found(d, t, None)[0] for d, t in zip(after, truth)), \
        "camera 1 did not detect its robot within 2 frame-sets of the outage"
    # the reload took effect on camera 0 only, as the JAX package applies it
    np.testing.assert_array_equal(fleet_circ, np.float32([CIRC_AFTER, CIRC_BEFORE]))
    _check_reload_parity(tmp_path, first_cfg, port_cfg, port_params, gc_socket)


def _tunables(cfg) -> dict:
    """A config's values, its sections (the camera's) as dicts."""
    return {k: vars(v) if hasattr(v, "__dataclass_fields__") else v
            for k, v in vars(cfg).items() if k not in ("config_path", "_mtime", "_last_check")}


def _check_reload_parity(tmp_path, first_cfg, port_cfg, port_params, gc_socket):
    """The JAX package's VisionConfig and Processor on the same two files:
    the first config loaded, the rewritten one picked up by
    reload_if_changed and applied by apply_tunables, the Processor reading
    the fleet's game-controller state (bot heights) as the port's does.
    Equal tunables, and params() equal in value and dtype."""
    from vision_processor_tpu.app.processor import Processor as JProcessor
    from vision_processor_tpu.utils.config import VisionConfig as JVisionConfig

    path = tmp_path / "jax_config0.yml"
    path.write_text(first_cfg)
    jcfg = JVisionConfig.load(str(path))
    assert jcfg.min_circularity == CIRC_BEFORE
    os.utime(path, ns=(0, 1))  # an mtime the rewrite cannot share
    path.write_text((tmp_path / "config0.yml").read_text())
    jcfg._last_check = 0.0
    assert jcfg.reload_if_changed()
    jproc = JProcessor(jcfg, gc_socket=gc_socket)
    jproc.apply_tunables()
    want, got = _tunables(jcfg), _tunables(port_cfg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert got[k] == v, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
    jparams = jproc.params()
    assert sorted(port_params) == sorted(jparams)
    for k, v in jparams.items():
        v = np.asarray(v)
        assert port_params[k].dtype == v.dtype, k
        np.testing.assert_array_equal(port_params[k], v, err_msg=k)
