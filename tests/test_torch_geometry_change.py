"""Mid-run geometry updates on the port: the counterparts of
tests/test_geometry_change.py, each beside the JAX ``Processor`` on the
same sequence.

* A changed calibration is adopted, re-keys the step for the new flat
  grid, and detection goes on, equal to the JAX package's (ids and blob
  count equal, positions within 0.5 mm, orientations within 1e-3 rad:
  tests/test_torch_slice.py's tolerances).
* A cleared calibration returns the camera to the calibration state
  (``geometry_version`` 0).
* The resample grid is rebuilt exactly when a projection input changes
  (calibration, bot height, field scale or offset), its sampling
  positions within 1e-3 px of the JAX grid's; the fleet's grid key
  (``MultiCamApp._device_inputs``) rebuilds the stacked grids when a
  camera's scale or offset moves under the same flat shape.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from vision_processor_tpu.app.processor import Processor as JProcessor
from vision_processor_tpu.io.camera import RawFrame as JRawFrame
from vision_processor_tpu.models.camera import CameraModel as JCameraModel
from vision_processor_tpu.utils.config import VisionConfig as JVisionConfig
from vision_processor_tpu_torch.app.processor import Processor
from vision_processor_tpu_torch.io.camera import RawFrame
from vision_processor_tpu_torch.io.synthetic import Scene, SceneBot, render_raw
from vision_processor_tpu_torch.models.camera import CameraModel
from vision_processor_tpu_torch.utils.config import VisionConfig

POS_MM, ORIENT_RAD, UV_PX = 0.5, 1e-3, 1e-3
# the moved and zoomed camera of tests/test_geometry_change.py
MOVED = dict(focal_length=1000.0, principal_point=np.array([470.0, 350.0]),
             distortion_k2=0.01, pos=np.array([-2100.0, 150.0, 4200.0]),
             size=np.array([960, 720]))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(max_blobs: int, mode: str = "gather"):
    """The JAX and the port's Processor on one configuration."""
    procs = []
    for cls, proc_cls, kw in ((JVisionConfig, JProcessor, {}),
                              (VisionConfig, Processor, {"device": "cpu"})):
        cfg = cls()
        cfg.max_blobs = max_blobs
        cfg.resample_mode = mode
        procs.append(proc_cls(cfg, **kw))
    return procs


def _geometry(divb_field, *models):
    geometry = divb_field.geometry
    geometry.ClearField("calib")
    for cam_id, model in enumerate(models):
        geometry.calib.append(model.to_proto(cam_id))
    return geometry


def _detections(wrapper):
    d = wrapper.detection
    bots = {r.robot_id + off: (r.x, r.y, r.orientation)
            for team, off in ((d.robots_yellow, 0), (d.robots_blue, 16)) for r in team}
    return bots, sorted((b.x, b.y) for b in d.balls)


def _frame_both(jp, tp, raw, now):
    jw, jblobs, _ = jp.process_frame(JRawFrame(raw, "RGGB", 960, 720, 0.0),
                                     tracked_by_cam={}, now=now)
    tw, tblobs, _ = tp.process_frame(RawFrame(raw, "RGGB", 960, 720, 0.0),
                                     tracked_by_cam={}, now=now)
    assert int(tblobs["count"]) == int(jblobs["count"])
    jbots, jballs = _detections(jw)
    tbots, tballs = _detections(tw)
    assert sorted(tbots) == sorted(jbots)
    for bid, (x, y, w) in jbots.items():
        tx, ty, tw_ = tbots[bid]
        assert abs(tx - x) < POS_MM and abs(ty - y) < POS_MM
        assert abs(tw_ - w) < ORIENT_RAD
    assert len(tballs) == len(jballs)
    return tbots


def test_recalibration_rekeys_and_detects(divb_field, overhead_model):
    """tests/test_geometry_change.py:15 on both packages: the first
    calibration, a frame, the moved camera's calibration (version 2), a
    frame; the step's key changes with the flat grid, the same in both."""
    jp, tp = _pair(128)
    geometry = _geometry(divb_field, overhead_model)
    for p in (jp, tp):
        p.geometry_check(960, 720, geometry=geometry, version=1)
    scene = Scene(bots=[SceneBot(8, "yellow", -2700.0, 400.0, 0.3)], balls=[])
    raw = render_raw(CameraModel.from_proto(geometry.calib[0]), geometry.field, scene, "RGGB")
    assert sorted(_frame_both(jp, tp, raw, 0.0)) == [8]
    key1, cfg1 = tp._geom_key, tp._bm_cfg
    assert key1 is not None and key1 == jp._geom_key

    moved = JCameraModel(**MOVED)
    geometry = _geometry(divb_field, moved)
    for p in (jp, tp):
        p.geometry_check(960, 720, geometry=geometry, version=2)
        assert p.perspective.geometry_version == 2
    raw2 = render_raw(CameraModel(**MOVED), geometry.field, scene, "RGGB")
    bots = _frame_both(jp, tp, raw2, 0.02)
    assert tp._geom_key != key1, "the step was not re-keyed"
    assert tp._geom_key == jp._geom_key
    assert tp._bm_cfg != cfg1
    assert tp._bm_cfg.flat_shape == jp._bm_cfg.flat_shape
    assert tp._bm_cfg.field_scale == pytest.approx(jp._bm_cfg.field_scale, rel=1e-12)
    assert sorted(bots) == [8]
    x, y, _ = bots[8]
    assert abs(x - -2700.0) < 30 and abs(y - 400.0) < 30


def test_cleared_calibration_returns_to_calibration(divb_field, overhead_model):
    """tests/test_geometry_change.py:59 on both packages: a geometry without
    any calibration (an operator reset) sends the camera back to the
    calibration state; a geometry with only another camera's calibration
    does not."""
    jp, tp = _pair(2000)
    geometry = _geometry(divb_field, overhead_model)
    for p in (jp, tp):
        p.geometry_check(960, 720, geometry=geometry, version=1)
        assert p.perspective.geometry_version == 1
    other = _geometry(divb_field)
    other.calib.append(overhead_model.to_proto(5))
    for p in (jp, tp):
        p.geometry_check(960, 720, geometry=other, version=2)
        assert p.perspective.geometry_version == 1
    cleared = _geometry(divb_field)
    for p in (jp, tp):
        p.geometry_check(960, 720, geometry=cleared, version=3)
        assert p.perspective.geometry_version == 0


def _uv(grid, width):
    """A gather grid's sampling positions, from the corner index and the
    fractions."""
    idx = np.asarray(grid["idx"])
    return np.stack([idx % width + np.asarray(grid["ub"]),
                     idx // width + np.asarray(grid["vb"])])


class _GC:
    def __init__(self, height):
        self.max_bot_height = height
        self.yellow_bot_height = self.blue_bot_height = 150.0


def test_resample_grid_rebuilt_exactly_on_projection_inputs(divb_field, overhead_model):
    """tests/test_geometry_change.py:75 on both packages: the cached grid is
    reused while no projection input changes (a config equal in value
    included) and rebuilt on a new calibration, a bot-height change and a
    field offset or scale shift that keeps the flat shape; every grid's
    positions equal the JAX grid's."""
    jp, tp = _pair(64)
    geometry = _geometry(divb_field, overhead_model)
    for p in (jp, tp):
        p.geometry_check(960, 720, geometry=geometry, version=1)
    jp._ensure_step("RGGB", (1440, 1920))
    tp._ensure_config("RGGB", (1440, 1920))
    width = tp._bm_cfg.plane_shape[1]

    def both():
        packed = torch.from_numpy(tp.perspective.model.packed())
        g = tp._resample_grid(packed)
        np.testing.assert_allclose(_uv(g, width), _uv(jp._resample_grid(), width),
                                   atol=UV_PX)
        return g

    g1 = both()
    assert both() is g1
    for p in (jp, tp):  # a config equal in value: no rebuild
        p._bm_cfg = replace(p._bm_cfg)
    assert both() is g1

    for p in (jp, tp):  # same calibration, another bot height
        p.gc_socket = _GC(160.0)
    g2 = both()
    assert g2 is not g1 and not torch.equal(g1["idx"], g2["idx"])
    assert both() is g2

    for p in (jp, tp):
        p._bm_cfg = replace(p._bm_cfg, field_offset=(p._bm_cfg.field_offset[0] + 100.0,
                                                     p._bm_cfg.field_offset[1]))
    g3 = both()
    assert g3 is not g2 and not torch.equal(g2["idx"], g3["idx"])

    for p in (jp, tp):
        p._bm_cfg = replace(p._bm_cfg, field_scale=p._bm_cfg.field_scale * 1.01)
    g4 = both()
    assert g4 is not g3 and not torch.equal(g3["idx"], g4["idx"])
    assert both() is g4

    nudged = JCameraModel(**{**MOVED, "focal_length": 905.0,
                             "principal_point": overhead_model.principal_point,
                             "pos": overhead_model.pos, "distortion_k2": 0.02})
    geometry = _geometry(divb_field, nudged)
    for p in (jp, tp):
        p.geometry_check(960, 720, geometry=geometry, version=2)
    jp._ensure_step("RGGB", (1440, 1920))
    tp._ensure_config("RGGB", (1440, 1920))
    g5 = both()
    assert g5 is not g4


def test_fleet_grid_key_follows_scale_and_offset(divb_field, overhead_model):
    """The fleet's grid cache (app/multicam_app.py ``_device_inputs``):
    reused while nothing changes, rebuilt when one camera's field scale or
    offset moves with the flat shape (and the step's key) unchanged, and
    equal to the JAX package's ``make_resample_grids`` on the same inputs
    each time."""
    from vision_processor_tpu.models.detector import DetectorConfig as JDetectorConfig
    from vision_processor_tpu.ops.pipeline import BlobMachineConfig as JBlobMachineConfig
    from vision_processor_tpu.parallel import multicam as JM
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
    from vision_processor_tpu_torch.app.processor import TrackedArrays

    second = JCameraModel(**{**MOVED, "focal_length": 900.0,
                             "principal_point": overhead_model.principal_point,
                             "pos": np.array([2250.0, 0.0, 4500.0]),
                             "distortion_k2": 0.02})
    geometry = _geometry(divb_field, overhead_model, second)
    configs = []
    for cam_id in range(2):
        cfg = VisionConfig()
        cfg.cam_id, cfg.max_blobs, cfg.resample_mode = cam_id, 64, "gather"
        configs.append(cfg)
    app = MultiCamApp.offline(configs, device="cpu")
    for proc in app.processors:
        proc.geometry_check(960, 720, geometry, 1)
    assert app._ensure_step("RGGB", (1440, 1920))
    step = app._step
    tracked = TrackedArrays.build({}, 0.0, 32)
    bm = app.mc_cfg.bm
    jcfg = JM.MultiCamConfig(bm=JBlobMachineConfig(**vars(bm)),
                             det=JDetectorConfig(**vars(app.mc_cfg.det)), n_cams=2)

    def grids():
        state, g = app._device_inputs(tracked)
        jg = JM.make_resample_grids(jcfg, state["packed"].numpy(), 150.0,
                                    state["scales"].numpy(), state["offsets"].numpy())
        np.testing.assert_allclose(_uv(g, bm.plane_shape[1]), _uv(jg, bm.plane_shape[1]),
                                   atol=UV_PX)
        return g

    g1 = grids()
    assert grids() is g1
    p1 = app.processors[1].perspective
    p1.field_scale *= 1.01
    g2 = grids()
    assert g2 is not g1
    assert torch.equal(g2["idx"][0], g1["idx"][0])
    assert not torch.equal(g2["idx"][1], g1["idx"][1])
    assert grids() is g2
    p1.visible_field_extent[0] += 100.0
    g3 = grids()
    assert g3 is not g2 and not torch.equal(g3["idx"][1], g2["idx"][1])
    assert torch.equal(g3["idx"][0], g2["idx"][0])
    # neither move re-keyed the step: same flat shape, same geometry version
    assert app._ensure_step("RGGB", (1440, 1920)) and app._step is step
    assert app.mc_cfg.bm == bm
