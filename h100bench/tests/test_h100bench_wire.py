"""The bus codec against the port's generated SSL bindings: the geometry
packet the benchmark publishes parses to the rig, and a detection frame
the port serialises decodes to its fields."""
import numpy as np
import pytest

import rig as R
import wire

proto = pytest.importorskip("vision_processor_tpu_torch.proto")


def test_geometry_packet_parses_to_the_rig():
    r = R.build_rig(R.load_json("configs", "divB_4cam"))
    pkt = wire.geometry_packet(r.field, r.lines, r.arcs, [c.calibration() for c in r.cameras])
    w = proto.SSL_WrapperPacket()
    w.ParseFromString(pkt)
    g = w.geometry
    assert (g.field.field_length, g.field.field_width) == (9000, 6000)
    assert len(g.field.field_lines) == 12 and len(g.field.field_arcs) == 1
    assert len(g.calib) == 4
    for calib, cam in zip(g.calib, r.cameras):
        assert calib.camera_id == cam.cam_id
        assert calib.derived_camera_world_tx == pytest.approx(cam.pos[0])
        assert calib.pixel_image_width == 960


def test_detection_frame_decodes():
    w = proto.SSL_WrapperPacket()
    d = w.detection
    d.frame_number, d.t_capture, d.t_sent, d.camera_id = 7, 1.5, 2.5, 3
    d.t_capture_camera = 1234.0625
    b = d.balls.add()
    b.confidence, b.x, b.y, b.pixel_x, b.pixel_y = 0.5, 10.0, -20.0, 1.0, 2.0
    for team, rid in ((d.robots_yellow, 4), (d.robots_blue, 15)):
        r = team.add()
        r.confidence, r.robot_id, r.x, r.y, r.orientation = 0.75, rid, 100.0, -50.0, 1.25
        r.pixel_x = r.pixel_y = 0.0
    d.t_offsets.extend([0.5, -0.25])
    got = wire.decode_detection(w.SerializeToString())
    assert got["camera_id"] == 3 and got["frame_number"] == 7
    assert got["t_capture_camera"] == 1234.0625
    assert got["balls"] == [(10.0, -20.0, 0.5)]
    assert got["yellow"] == [(4, 100.0, -50.0, 1.25, 0.75)]
    assert got["blue"] == [(15, 100.0, -50.0, 1.25, 0.75)]
    assert np.isnan(wire.decode_detection(_robot_without_heading())["yellow"][0][3])


def _robot_without_heading():
    w = proto.SSL_WrapperPacket()
    r = w.detection.robots_yellow.add()
    r.confidence, r.robot_id, r.x, r.y, r.pixel_x, r.pixel_y = 1.0, 1, 0.0, 0.0, 0.0, 0.0
    w.detection.frame_number, w.detection.t_capture, w.detection.t_sent = 1, 0.0, 0.0
    w.detection.camera_id = 0
    return w.SerializeToString()


def test_geometry_packet_is_not_a_detection():
    r = R.build_rig(R.load_json("configs", "divB_4cam"))
    assert wire.decode_detection(wire.geometry_packet(r.field, r.lines, r.arcs, [])) is None
