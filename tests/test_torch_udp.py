"""The port's multicast bus (net/udp.py, app/processor.py ``TrackedArrays``,
proto/) against the JAX package's, on the same datagrams.

Both packages' sockets join one group and receive the same bytes from one
bare sender. Each package's ``net.udp`` reads its clock through its module's
``time``; the tests give both modules one scripted clock and a zero offset,
so the offsets a socket computes do not depend on when its thread woke up
and can be compared exactly.

The fleet's clock sync (ROADMAP Q1) runs as ``MultiCamApp`` runs it: four
``VisionSocket``s in one process (cameras 0-3 on one group), each sending
its camera's detection frame and calling ``update_time`` after the send.
Each package keeps one module-global offset, so each package's fleet runs
in its own process: this file is also that process
(``python tests/test_torch_udp.py PACKAGE OUT.json``). Both replay the same
scripted frame-sets; the suppressed backwards jumps, the trajectory of
``get_real_time() - time.time()`` and the ``TrackedArrays.time_delta`` the
tracked prior is built with must be equal.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PKGS = ("vision_processor_tpu", "vision_processor_tpu_torch")
T0 = 1_760_000_000.0  # the scripted clock's start (an epoch time, as time.time())
JOIN_S = 120.0
WAIT_S = 5.0  # for a datagram to reach every socket

# the fleet's script: frame-sets, the host's wall a frame-set (the soak's
# p50 is about 0.3 s), the camera clock and where t_offsets come from
FLEET_SETS = 40
FLEET_WALL = 0.3
FLEET_CAMS = 4
SCENARIOS = {
    # the soak's driver: a camera clock apart from the process's real time
    # (time.perf_counter() since start); t_offsets as Processor.finish_frame
    # fills them, from the sending camera's socket
    "host clock": ("host", "socket"),
    # io/camera.py CameraDriver.get_time: the process's real time
    "real clock": ("real", "socket"),
    # t_offsets drawn from the seed instead of the sending socket
    "scripted offsets": ("host", "script"),
}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class ScriptedClock:
    """Stands in for a module's ``time``: ``time()`` returns ``now``."""

    def __init__(self, now: float = T0):
        self.now = now

    def time(self) -> float:
        return self.now


def _script_clock(monkeypatch, clock) -> None:
    for pkg in PKGS:
        udp = _mod(pkg, "net.udp")
        monkeypatch.setattr(udp, "time", clock)
        monkeypatch.setattr(udp, "_real_time_offset", 0.0)


class Sender:
    """A bare multicast sender: the same bytes reach every socket."""

    def __init__(self, group: str, port: int):
        self.address = (group, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM, socket.IPPROTO_UDP)
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)

    def send(self, data: bytes) -> None:
        self.sock.sendto(data, self.address)

    def close(self) -> None:
        self.sock.close()


def _wait(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _parsed(sock, det) -> bool:
    """Whether ``sock`` has parsed detection frame ``det``: its camera's
    first tracked object (the tracker takes balls, then yellow, then blue
    robots) is this frame's first."""
    first = [*det.balls, *det.robots_yellow, *det.robots_blue][0]
    entries = sock.get_tracked_objects().get(det.camera_id, [])
    return bool(entries) and (entries[0].timestamp, entries[0].x) == (det.t_capture,
                                                                      first.x)


def _states(tracked: dict) -> dict:
    return {cam: [dataclasses.astuple(t) for t in entries]
            for cam, entries in sorted(tracked.items())}


# ---------------------------------------------------------------------------
# tracked objects, offsets, malformed datagrams, the referee, the protos
# ---------------------------------------------------------------------------


def _detection_frames(rng) -> list:
    """Seeded detection frames from cameras 0-2: robots of both teams (some
    with a height), balls with and without z, a robot id twice in one
    frame, and a frame whose t_capture repeats the last (dt 0); t_offsets
    of varying length."""
    from vision_processor_tpu_torch.proto import SSL_WrapperPacket

    frames, t = [], {0: 10.0, 1: 20.0, 2: 30.0}
    for i in range(12):
        cam = i % 3
        wrapper = SSL_WrapperPacket()
        det = wrapper.detection
        det.frame_number = i + 1
        if i != 10:  # frame 10 repeats camera 1's last t_capture
            t[cam] += 0.1
        det.t_capture = det.t_sent = t[cam]
        det.t_sent += float(rng.uniform(0.0, 0.01))
        det.camera_id = cam
        det.t_offsets.extend(rng.normal(-0.005, 0.01, size=i % 4).tolist())
        for team, ids in ((det.robots_yellow, (4, 7)), (det.robots_blue, (2, 4))):
            for bot_id in ids + ((4,) if i % 5 == 0 else ()):
                bot = team.add()
                bot.confidence = float(rng.uniform(0.5, 1.0))
                bot.robot_id = bot_id
                bot.x, bot.y = (float(v) for v in rng.uniform(-3000, 3000, 2))
                bot.orientation = float(rng.uniform(-3, 3))
                bot.pixel_x = bot.pixel_y = 0.0
                if i % 2:
                    bot.height = 140.0 + bot_id
        for k in range(1 + i % 2):
            ball = det.balls.add()
            ball.confidence = 0.8
            ball.x, ball.y = (float(v) for v in rng.uniform(-3000, 3000, 2))
            ball.pixel_x = ball.pixel_y = 0.0
            if k:
                ball.z = 40.0
        frames.append(wrapper)
    return frames


def test_tracked_objects_and_offsets_equal_the_jax_package(monkeypatch):
    """tests/test_components.py:200 on both packages' sockets: the same
    detection datagrams give equal ``TrackingState`` lists, field by field
    (finite-difference velocities, the nearest previous object, dt 0 as
    no velocity, ages), and equal received offsets; the JAX test's frames
    give its velocities; ``update_time`` moves both offsets alike."""
    from vision_processor_tpu_torch.proto import SSL_WrapperPacket

    clock = ScriptedClock()
    _script_clock(monkeypatch, clock)
    group, port = "224.99.99.171", 19171
    socks = {pkg: _mod(pkg, "net.udp").VisionSocket(group, port, 1, 145.0) for pkg in PKGS}
    sender = Sender(group, port)
    try:
        # the JAX test's two frames: robot 4 from (100, 200) to (160, 280)
        for i, (x, y) in enumerate([(100.0, 200.0), (160.0, 280.0)]):
            wrapper = SSL_WrapperPacket()
            det = wrapper.detection
            det.frame_number, det.camera_id = i + 1, 0
            det.t_capture = det.t_sent = 10.0 + i * 0.1
            bot = det.robots_yellow.add()
            bot.confidence, bot.robot_id, bot.orientation = 0.9, 4, 0.5
            bot.x, bot.y, bot.pixel_x, bot.pixel_y = x, y, 0.0, 0.0
            ball = det.balls.add()
            ball.confidence, ball.x, ball.y = 0.8, -500.0 - 50 * i, 0.0
            ball.pixel_x = ball.pixel_y = 0.0
            clock.now = T0 + i * 0.1
            sender.send(wrapper.SerializeToString())
            for s in socks.values():
                _wait(lambda s=s, d=det: _parsed(s, d), "the JAX test's frame")
        for s in socks.values():
            objs = {t.id: t for t in s.get_tracked_objects()[0]}
            assert objs[4].x == pytest.approx(160.0)
            assert objs[4].vx == pytest.approx(600.0, rel=1e-3)
            assert objs[4].age == 2
            assert objs[-1].vx == pytest.approx(-500.0, rel=1e-3)

        for i, wrapper in enumerate(_detection_frames(np.random.default_rng(16))):
            det = wrapper.detection
            clock.now = T0 + 1.0 + 0.05 * i
            sender.send(wrapper.SerializeToString())
            for s in socks.values():
                _wait(lambda s=s, d=det: _parsed(s, d), f"frame {i}")
            got = {pkg: _states(s.get_tracked_objects()) for pkg, s in socks.items()}
            assert got[PKGS[1]] == got[PKGS[0]], f"frame {i}"
            offsets = {pkg: s.get_received_offsets() for pkg, s in socks.items()}
            assert offsets[PKGS[1]] == offsets[PKGS[0]], f"frame {i}"
        states = got[PKGS[1]]
        assert sorted(states) == [0, 1, 2]
        assert max(t[11] for entries in states.values() for t in entries) >= 4
        # frame 10 repeated camera 1's t_capture: its velocities are 0 (dt inf)
        assert all(t[6:10] == (0.0, 0.0, 0.0, 0.0) for t in states[1])
        for pkg, s in socks.items():
            s.update_time()
        udp = {pkg: _mod(pkg, "net.udp") for pkg in PKGS}
        moved = [u.get_real_time() - clock.now for u in udp.values()]
        assert moved[1] == moved[0]
    finally:
        sender.close()
        for s in socks.values():
            s.close()


def test_receiver_outlives_malformed_datagrams(divb_field):
    """tests/test_components.py:355 on both packages: garbage datagrams on
    the group leave both receiver threads alive, and the next valid
    geometry is adopted by both, equal to the one sent."""
    group, port = "224.99.99.172", 19172
    socks = {pkg: _mod(pkg, "net.udp").VisionSocket(group, port, 0, 150.0) for pkg in PKGS}
    sender = Sender(group, port)
    try:
        for payload in (b"\x00", b"not-a-proto" * 50, b"\xff" * 2048):
            sender.send(payload)
        time.sleep(0.3)
        assert [s.geometry_version for s in socks.values()] == [0, 0]
        from vision_processor_tpu_torch.proto import SSL_WrapperPacket

        wrapper = SSL_WrapperPacket()
        wrapper.geometry.ParseFromString(divb_field.geometry.SerializeToString())
        sender.send(wrapper.SerializeToString())
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            for s in socks.values():
                s.geometry_check()
            if all(s.geometry_version for s in socks.values()):
                break
            time.sleep(0.05)
        assert [s.geometry_version for s in socks.values()] == [1, 1], (
            "a receiver thread died on malformed input")
        want = wrapper.geometry.SerializeToString(deterministic=True)
        for s in socks.values():
            assert s.geometry.SerializeToString(deterministic=True) == want
            assert s.geometry.field.field_length == 9000
            assert s._thread.is_alive()
    finally:
        sender.close()
        for s in socks.values():
            s.close()


def _referee(yellow: str, blue: str) -> bytes:
    """tests/test_more_components.py:10's full Referee packet, with a goal."""
    from vision_processor_tpu_torch.proto import Referee

    ref = Referee()
    ref.packet_timestamp = 1_700_000_000_000_000
    ref.stage = Referee.NORMAL_FIRST_HALF
    ref.command = Referee.FORCE_START
    ref.command_counter = 17
    ref.command_timestamp = 1_700_000_000_000_000
    for team, name in ((ref.yellow, yellow), (ref.blue, blue)):
        team.name = name
        team.score = 2
        team.red_cards = 0
        team.yellow_cards = 1
        team.yellow_card_times.append(30_000_000)
        team.timeouts = 4
        team.timeout_time = 300_000_000
        team.goalkeeper = 0
        team.max_allowed_bots = 11
    ref.blue_team_on_positive_half = True
    ev = ref.game_events.add()
    ev.type = ev.GOAL
    ev.goal.by_team = 1
    ev.goal.kicking_bot = 7
    ev.goal.location.x = 4.5
    ev.goal.location.y = 0.25
    return ref.SerializeToString()


def test_gc_socket_sets_referee_heights_as_the_jax_package():
    """tests/test_more_components.py:10 on both packages' ``GCSocket``: the
    same Referee datagrams set the same team heights (an unknown team name
    leaves its height), then swap them."""
    heights = {"Alpha": 150.0, "Beta": 120.0, "Gamma": 141.0}
    group, port = "224.99.99.173", 19173
    socks = {pkg: _mod(pkg, "net.udp").GCSocket(group, port, heights) for pkg in PKGS}
    sender = Sender(group, port)

    def heights_of(s):
        return (s.max_bot_height, s.default_bot_height, s.yellow_bot_height,
                s.blue_bot_height)

    try:
        for s in socks.values():
            assert heights_of(s) == (150.0, pytest.approx(137.0), pytest.approx(137.0),
                                     pytest.approx(137.0))
        for (yellow, blue), want in ((("Beta", "Unknown Team"), (120.0, 137.0)),
                                     (("Gamma", "Alpha"), (141.0, 150.0))):
            sender.send(_referee(yellow, blue))
            for s in socks.values():
                _wait(lambda s=s: (s.yellow_bot_height, s.blue_bot_height) == want,
                      f"{yellow} and {blue}")
            got = {pkg: heights_of(s) for pkg, s in socks.items()}
            assert got[PKGS[1]] == got[PKGS[0]]
            assert got[PKGS[1]][2:] == pytest.approx(want)
    finally:
        sender.close()
        for s in socks.values():
            s.close()


def test_tracked_vision_protos_round_trip_between_the_packages():
    """tests/test_more_components.py:156: the full tracked-vision packet
    built with the port's protos parses with the JAX package's and back,
    byte for byte."""
    from vision_processor_tpu.proto import TrackerWrapperPacket as JPacket
    from vision_processor_tpu_torch.proto import TrackerWrapperPacket

    pkt = TrackerWrapperPacket()
    pkt.uuid = "6f2b8e00-1111-2222-3333-444455556666"
    pkt.source_name = "vision-processor-tpu"
    fr = pkt.tracked_frame
    fr.frame_number = 42
    fr.timestamp = 1234.5
    ball = fr.balls.add()
    ball.pos.x, ball.pos.y, ball.pos.z = 1.0, -2.0, 0.02
    ball.vel.x, ball.vel.y, ball.vel.z = 0.5, 0.0, 0.0
    ball.visibility = 0.9
    bot = fr.robots.add()
    bot.robot_id.id = 7
    bot.robot_id.team = 2
    bot.pos.x, bot.pos.y = -1.5, 0.75
    bot.orientation = 1.2
    bot.visibility = 1.0
    fr.capabilities.append(2)
    kb = fr.kicked_ball
    kb.pos.x, kb.pos.y = 0.0, 0.0
    kb.vel.x, kb.vel.y, kb.vel.z = 3.0, 1.0, 0.0
    kb.start_timestamp = 1234.0

    wire = pkt.SerializeToString(deterministic=True)
    jax_side = JPacket()
    jax_side.ParseFromString(wire)
    assert jax_side.SerializeToString(deterministic=True) == wire
    back = TrackerWrapperPacket()
    back.ParseFromString(jax_side.SerializeToString())
    assert back == pkt
    assert back.tracked_frame.robots[0].robot_id.id == 7
    assert back.tracked_frame.balls[0].pos.y == -2.0
    assert back.tracked_frame.kicked_ball.vel.x == 3.0
    assert back.tracked_frame.capabilities == [2]


def _tracked_arrays(pkg: str, tracked_by_cam: dict, now: float, slots: int) -> dict:
    arr = _mod(pkg, "app.processor").TrackedArrays.build(tracked_by_cam, now, slots)
    return {k: np.asarray(v) for k, v in arr.as_dict().items()}


def test_tracked_arrays_dedupe_across_cameras_as_the_jax_package():
    """tests/test_more_components.py:194 on both packages, then seeded
    fleets with timestamp ties (processor.py:85 keeps the first camera's
    on a tie), balls and more robots than slots: equal arrays."""
    def obj(i, ts, x):
        return SimpleNamespace(id=i, x=x, y=0.0, z=0.0, w=0.0, vx=0.0, vy=0.0, vw=0.0,
                               timestamp=ts)

    example = {0: [obj(3, 10.0, 100.0), obj(4, 10.0, 200.0)], 1: [obj(3, 11.0, 105.0)],
               2: [obj(3, 9.0, 90.0), obj(7, 10.0, 300.0)]}
    got = {pkg: _tracked_arrays(pkg, example, 12.0, 8) for pkg in PKGS}
    for pkg, arr in got.items():
        assert sorted(arr["id"][arr["valid"]].tolist()) == [3, 4, 7]
        i3 = arr["id"].tolist().index(3)
        assert arr["x"][i3] == 105.0
        assert arr["time_delta"][i3] == pytest.approx(1.0)
    rng = np.random.default_rng(194)
    cases = [example]
    for n_cams, n_ids in ((4, 12), (3, 40), (2, 1)):
        cases.append({c: [SimpleNamespace(
            id=int(i), x=float(rng.uniform(-4500, 4500)), y=float(rng.uniform(-3000, 3000)),
            z=float(rng.uniform(0, 150)), w=float(rng.uniform(-3, 3)),
            vx=float(rng.normal()), vy=float(rng.normal()), vw=float(rng.normal()),
            timestamp=float(rng.choice([9.9, 10.0, 10.1])))
            for i in rng.choice(np.arange(-1, n_ids), size=min(n_ids, 10), replace=False)]
            for c in rng.permutation(n_cams).tolist()})
    for k, case in enumerate(cases):
        for slots in (8, 32):
            arrs = [_tracked_arrays(pkg, case, 10.25, slots) for pkg in PKGS]
            assert sorted(arrs[1]) == sorted(arrs[0])
            for key in arrs[0]:
                assert arrs[1][key].dtype == arrs[0][key].dtype, key
                np.testing.assert_array_equal(arrs[1][key], arrs[0][key],
                                              err_msg=f"case {k} slots {slots} {key}")


# ---------------------------------------------------------------------------
# ROADMAP Q1: the fleet's clock sync, one process per package
# ---------------------------------------------------------------------------


class _Count(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.n = 0

    def emit(self, record):
        if "backwards time jump suppressed" in record.getMessage():
            self.n += 1


def _fleet_script(offsets_from: str) -> dict:
    """The seeded schedule both fleets replay: a latency a datagram (a few
    ms, with stalls of 20-120 ms in one datagram of ten, as a receiver
    thread that waits for the GIL), and scripted t_offsets."""
    rng = np.random.default_rng(1)
    lat = np.abs(rng.normal(0.0, 0.004, (FLEET_SETS, FLEET_CAMS)))
    stall = rng.random((FLEET_SETS, FLEET_CAMS)) < 0.1
    lat += stall * rng.uniform(0.02, 0.12, (FLEET_SETS, FLEET_CAMS))
    script = rng.normal(-0.01, 0.02, (FLEET_SETS, FLEET_CAMS, FLEET_CAMS))
    return {"latency": lat, "t_offsets": script if offsets_from == "script" else None}


def fleet_run(pkg: str, group: str, port: int, clock_kind: str, offsets_from: str) -> dict:
    """One package's fleet of FLEET_CAMS ``VisionSocket``s over FLEET_SETS
    scripted frame-sets, in this process. A frame-set k: the dispatch at
    ``T0 + k * FLEET_WALL`` builds the tracked prior from socket 0's
    tracker (``TrackedArrays.build``, now = the camera clock); then each
    camera c finishes at 50 + 10 c ms, sends its detection frame (its
    robot c, ``t_capture`` the dispatch's camera time, ``t_sent`` the
    camera time at the send, ``t_offsets``) which every socket parses
    ``latency`` later, and calls ``update_time``. Returns the suppressed
    jumps and, a send, ``get_real_time() - time.time()``; the prior's
    ``time_delta`` and its shift from the true age of the frame (the
    scripted real time between capture and dispatch)."""
    udp = _mod(pkg, "net.udp")
    TrackedArrays = _mod(pkg, "app.processor").TrackedArrays
    SSL_WrapperPacket = _mod(pkg, "proto").SSL_WrapperPacket
    clock = ScriptedClock()
    udp.time = clock
    udp._real_time_offset = 0.0
    count = _Count()
    logging.getLogger(udp.__name__).addHandler(count)
    script = _fleet_script(offsets_from)

    def camera_time():
        if clock_kind == "real":
            return udp.get_real_time()  # CameraDriver.get_time
        return clock.now - T0 + 5.0  # time.perf_counter() since start

    socks = [udp.VisionSocket(group, port, c, 145.0) for c in range(FLEET_CAMS)]
    offsets, deltas, shifts, captured = [], [], [], {}
    try:
        for k in range(FLEET_SETS):
            clock.now = T0 + k * FLEET_WALL
            now = camera_time()
            prior = TrackedArrays.build(socks[0].get_tracked_objects(), now, 32)
            valid = np.asarray(prior.valid)
            td = np.asarray(prior.time_delta)[valid].astype(float)
            deltas.append(td.tolist())
            shifts.append([float(d - (clock.now - captured[int(i)])) for d, i in
                           zip(td, np.asarray(prior.id)[valid])])
            t_capture, t_dispatch = now, clock.now
            for c in range(FLEET_CAMS):
                clock.now = t_dispatch + 0.05 + 0.01 * c
                wrapper = SSL_WrapperPacket()
                det = wrapper.detection
                det.frame_number, det.camera_id = k + 1, c
                det.t_capture = t_capture
                det.t_sent = camera_time()
                bot = det.robots_yellow.add()
                bot.confidence, bot.robot_id = 0.9, c
                bot.x, bot.y = 100.0 * c + 10.0 * k, 50.0 * c
                bot.orientation = bot.pixel_x = bot.pixel_y = 0.0
                if script["t_offsets"] is None:
                    det.t_offsets.extend(socks[c].get_received_offsets())
                else:
                    det.t_offsets.extend(script["t_offsets"][k, c].tolist())
                clock.now += float(script["latency"][k, c])  # when the sockets parse it
                socks[c].send(wrapper)
                for s in socks:
                    _wait(lambda s=s: _parsed(s, det), f"frame-set {k} cam {c}")
                captured[c] = t_dispatch
                socks[c].update_time()
                offsets.append(udp.get_real_time() - clock.now)
    finally:
        for s in socks:
            s.close()
        logging.getLogger(udp.__name__).removeHandler(count)
    return {"suppressed": count.n, "offsets": offsets, "time_delta": deltas,
            "time_delta_shift": shifts}


def worker(pkg: str, out: Path) -> None:
    sys.path.insert(0, str(ROOT))
    side = PKGS.index(pkg)  # each package's fleet on its own group and ports
    res = {}
    for i, (name, (clock_kind, offsets_from)) in enumerate(SCENARIOS.items()):
        res[name] = fleet_run(pkg, f"224.99.99.{174 + side}", 19174 + 2 * i + side,
                              clock_kind, offsets_from)
    out.write_text(json.dumps(res))


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """Each package's fleet in its own process, both at once."""
    run_dir = tmp_path_factory.mktemp("fleet")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    procs = {pkg: subprocess.Popen(
        [sys.executable, __file__, pkg, str(run_dir / f"{pkg}.json")], env=env,
        stdout=subprocess.DEVNULL, stderr=open(run_dir / f"{pkg}.log", "w"))
        for pkg in PKGS}
    deadline = time.monotonic() + JOIN_S
    try:
        for pkg, proc in procs.items():
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            assert rc == 0, (f"{pkg}'s fleet exited {rc}:\n"
                             + (run_dir / f"{pkg}.log").read_text()[-3000:])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {pkg: json.loads((run_dir / f"{pkg}.json").read_text()) for pkg in PKGS}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_fleet_clock_sync_equals_the_jax_package(fleets, scenario):
    """ROADMAP Q1: the same scripted frame-sets through both packages'
    four-socket fleets give the same count of suppressed backwards jumps,
    the same offset after every ``update_time`` (exactly) and the same
    ``time_delta`` in every tracked prior."""
    jax_run, port_run = (fleets[pkg][scenario] for pkg in PKGS)
    assert port_run["suppressed"] == jax_run["suppressed"]
    assert port_run["offsets"] == jax_run["offsets"]
    assert port_run["time_delta"] == jax_run["time_delta"]
    assert len(port_run["offsets"]) == FLEET_SETS * FLEET_CAMS
    # every camera's robot is in every prior after the first frame-set
    assert [len(d) for d in port_run["time_delta"]] == [0] + [FLEET_CAMS] * (FLEET_SETS - 1)


def test_fleet_nudges_move_time_delta_only_on_the_real_clock(fleets):
    """What the nudges do to the prior (ROADMAP Q1): with a camera clock
    apart from the process's real time (the soak's driver) the prior's
    time_delta is the frame's true age to float32 rounding, whatever the
    offset does; with the default ``CameraDriver.get_time`` it is the age
    plus the offset's change between capture and dispatch."""
    port = fleets[PKGS[1]]
    host = port["host clock"]
    assert max(abs(s) for d in host["time_delta_shift"] for s in d) < 1e-6
    # t_offsets is a float (proto/ssl_vision_detection.proto:32): offsets of
    # about -1.76e9 s travel in steps of 128 s, so frame-set 1's nudges are
    # seconds forward, and every later update is a suppressed backwards jump
    offs = np.asarray(host["offsets"]).reshape(FLEET_SETS, FLEET_CAMS)
    assert offs[1, -1] > 1.0
    assert np.all(offs[2:] == offs[2, 0])
    assert host["suppressed"] >= FLEET_CAMS * (FLEET_SETS - 2)
    real = port["real clock"]
    offs = np.asarray(real["offsets"]).reshape(FLEET_SETS, FLEET_CAMS)
    # the offset when frame-set k was captured (after k - 1's last send) and
    # when k + 1 was dispatched (after k's last send)
    at_capture = np.concatenate([[0.0], offs[:-1, -1]])
    moved = offs[:, -1] - at_capture
    for k in range(1, FLEET_SETS):
        np.testing.assert_allclose(real["time_delta_shift"][k], moved[k - 1], atol=1e-6)


if __name__ == "__main__":
    worker(sys.argv[1], Path(sys.argv[2]))
