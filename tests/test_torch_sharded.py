"""The port's camera mesh (parallel/multicam.py ``make_camera_group``,
``sharded_step``, ``sharded_rollout``) over gloo, against the JAX package's
``shard_map`` mesh and against the port's own one-process batch.

Each world is a set of processes: this file is also the worker script
(``python tests/test_torch_sharded.py DIR RANK WORLD DEVICE``, DEVICE
``cpu`` for gloo or ``cuda`` for NCCL on card RANK). A worker imports
only the port: it joins the group through a file rendezvous in DIR, reads
the rig from DIR/inputs.npz, runs its own cameras and writes what it
computed to DIR/out<RANK>.npz. The parent builds the rig with numpy (small
cameras over a miniature field, the sizes of ``__graft_entry__.py``'s
handoff check: 192x144 models, 2 m high, about 6.5 mm a flat pixel), runs
the JAX package on the conftest's 8 virtual CPU devices and compares:

(a) worlds of 2 and 4 (1 and 2 cameras a rank): ``sharded_step`` against
    the JAX ``sharded_step(fused=True)`` on a 2- and a 4-device mesh, two
    frame-sets with the gathered summaries and the colour table fed back,
    per-camera tunables differing, the last camera in outage (its first
    frame again): counts, validity, ids and tracked ids equal; field and
    bot positions within 0.5 mm; orientations within 1e-3 rad; scores
    within 1e-4 relative (tests/test_torch_multicam.py's tolerances);
(b) the same runs against the port's ``batched_step(rs_grids=None)`` over
    all cameras in this process, bit for bit (the JAX package's
    ``run_production_parity_check`` at small size), the plain step (fed
    the colour table the fused step fed itself) equal to the fused one's
    first three outputs;
(c) ``sharded_rollout`` on the world of 2 with a robot crossing from
    camera 0's view into camera 1's: camera 1 first sees it through the
    tracked search seeded by the gathered summaries, and every per-frame
    output equals the JAX rollout's (``run_handoff_check``);
(d) ``ValueError`` when the cameras do not divide over the world.

On a machine with two or more cards, ``-m cuda`` runs a world of one NCCL
rank per card (up to 4) against ``batched_step`` on one card, bit for bit.
Every world is joined with a timeout that fails the test when it expires.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
W, H = 192, 144  # camera model (the raw frame is twice as large)
MAXH = 150.0
STEP_FRAME_SETS = 2
ROLL_FRAMES = 10
ROLL_BOT = 9  # yellow 9 crosses from camera 0 into camera 1
JOIN_S = 120.0


# ---------------------------------------------------------------------------
# the worker: imports only the port
# ---------------------------------------------------------------------------


def _flat(prefix: str, tree, out: dict) -> None:
    for k, v in tree.items():
        out[f"{prefix}.{k}"] = v


def worker(run_dir: Path, rank: int, world: int, kind: str) -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    from vision_processor_tpu_torch.models.detector import DetectorConfig
    from vision_processor_tpu_torch.ops.pipeline import BlobMachineConfig
    from vision_processor_tpu_torch.parallel import multicam as M
    from vision_processor_tpu_torch.utils.state import to_numpy, to_torch

    torch.set_num_threads(1)
    spec = json.loads((run_dir / "spec.json").read_text())
    data = dict(np.load(run_dir / "inputs.npz"))
    dev = torch.device("cuda", rank) if kind == "cuda" else torch.device("cpu")
    group = M.make_camera_group(device=dev, init_method=f"file://{run_dir / 'rdzv'}",
                                rank=rank, world_size=world)
    assert (group.rank, group.world, group.device) == (rank, world, dev)
    cfg = M.MultiCamConfig(bm=BlobMachineConfig(**spec["bm"]),
                           det=DetectorConfig(**spec["det"]), n_cams=spec["n_cams"])
    n_local = cfg.n_cams // world
    mine = slice(rank * n_local, (rank + 1) * n_local)

    def part(prefix, cams=True):
        return {k[len(prefix) + 1:]: (v[mine] if cams else v)
                for k, v in data.items() if k.startswith(prefix + ".")}

    cams = to_torch({k: data[k][mine] for k in ("packed", "scales", "offsets", "colors",
                                                "refs")}, dev)
    params = to_torch(part("params", cams=False), dev)
    marks = to_torch(part("marks", cams=False), dev)
    out = {}
    # the plain step finishes nothing on the device: it takes the colour
    # table the fused step fed itself at the same frame-set
    fed = [cams["colors"]]
    for fused in (True, False):
        step = M.sharded_step(cfg, group, fused=fused)
        prev = M.empty_summary(cfg, dev)
        name = "fused" if fused else "plain"
        for f in range(STEP_FRAME_SETS):
            raws = torch.from_numpy(data[f"raws{f}"][mine]).to(dev)
            res = step(raws, cams["packed"], cams["scales"], cams["offsets"], fed[f], prev,
                       params, *((cams["refs"], marks) if fused else ()))
            for key, tree in zip(("blobs", "det", "gathered", "fin"), to_numpy(res)):
                _flat(f"{name}.{f}.{key}", tree, out)
            prev = res[2]
            if fused:
                fed.append(res[3]["colors7"])
    if "bank" in data:
        roll = M.sharded_rollout(cfg, group, ROLL_FRAMES)
        res = roll(torch.from_numpy(data["bank"][:, mine]).to(dev), cams["packed"],
                   cams["scales"], cams["offsets"], cams["colors"],
                   to_torch(part("roll_params", False), dev))
        _flat("roll", to_numpy(res), out)
    jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    ref = [m for m in sys.modules if m == "vision_processor_tpu"
           or m.startswith("vision_processor_tpu.")]
    assert not jax_mods and not ref, (jax_mods[:3], ref[:3])
    np.savez(run_dir / f"out{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    worker(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the parent: the rig, the worlds, the JAX package
# ---------------------------------------------------------------------------


def mini_rig(n_cams: int):
    """``run_handoff_check``'s miniature field and cameras for ``n_cams``
    cameras (JAX-free modules of the JAX package; numpy out)."""
    from vision_processor_tpu.models.camera import (
        CameraModel, visible_field_extent_estimation,
    )
    from vision_processor_tpu.models.perspective import Perspective
    from vision_processor_tpu.net.geometry_io import geometry_from_dict
    from vision_processor_tpu.ops import blob as B

    geometry = geometry_from_dict({"field": {
        "field_length": 1800 * max(n_cams // 2, 1), "field_width": 1400,
        "goal_width": 400, "goal_depth": 100, "penalty_area_depth": 200,
        "penalty_area_width": 400, "boundary_width": 100, "center_circle_radius": 200,
        "line_thickness": 10, "ball_radius": 21.5, "max_robot_radius": 90.0,
    }}).geometry
    models, persps = [], []
    for cam_id in range(n_cams):
        lo, hi = visible_field_extent_estimation(cam_id, n_cams, geometry.field, False)
        center = (lo + hi) / 2
        model = CameraModel(focal_length=1.6 * W, principal_point=np.array([W / 2, H / 2]),
                            distortion_k2=0.0, pos=np.array([center[0], center[1], 2000.0]),
                            size=np.array([W, H]))
        persp = Perspective(cam_id=cam_id)
        geometry.ClearField("calib")
        geometry.calib.append(model.to_proto(cam_id))
        assert persp.update_geometry(geometry, cam_id + 1, W, H, MAXH, 1.0)
        models.append(model)
        persps.append(persp)
    ref = persps[0]
    bm = dict(fmt="RGGB", raw_shape=(2 * H, 2 * W),
              flat_shape=(max(int(p.reprojected_field_size[1]) for p in persps),
                          max(int(p.reprojected_field_size[0]) for p in persps)),
              field_scale=float(ref.field_scale), field_offset=(0.0, 0.0),
              grad_offset=B.gradient_offset(ref.max_blob_radius, ref.field_scale),
              sat_radius=B.sat_radius(ref.min_blob_radius, ref.field_scale),
              disc_radius=B.disc_radius(ref.min_blob_radius, ref.field_scale),
              max_blobs=64)
    det = dict(max_blobs=64, max_anchors=64, max_tracked=16)
    return geometry, models, persps, bm, det


def _scene_frames(geometry, models, persps):
    """Frame-set 0: camera c sees bot c (yellow for even c, blue for odd)
    at its view's centre, even cameras a ball beside it. Frame-set 1: the
    frames shifted by (2, 4) pixels, but the last camera in outage (its
    frame of frame-set 0 again, the MultiCamApp's last-good reuse)."""
    from vision_processor_tpu.io.synthetic import Scene, SceneBall, SceneBot, render_raw

    raws0 = []
    for c, (model, persp) in enumerate(zip(models, persps)):
        e = persp.visible_field_extent
        cx, cy = (e[0] + e[1]) / 2, (e[2] + e[3]) / 2
        scene = Scene(bots=[SceneBot(c, "yellow" if c % 2 == 0 else "blue", cx, cy,
                                     0.4 * c - 1.0)],
                      balls=[SceneBall(cx + 250.0, cy - 150.0)] if c % 2 == 0 else [],
                      noise_sigma=0.5, seed=c)
        raws0.append(render_raw(model, geometry.field, scene, "RGGB"))
    raws0 = np.stack(raws0)
    raws1 = np.stack([np.roll(r, (2, 4), axis=(0, 1)) for r in raws0])
    raws1[-1] = raws0[-1]
    return raws0, raws1


def _handoff_bank(geometry, models, persps):
    """``run_handoff_check``'s frames: yellow 9 starts inside camera 0's
    view, 60 mm short of camera 1's, and walks 12 mm a frame into it."""
    from vision_processor_tpu.io.synthetic import Scene, SceneBot, render_raw

    e0, e1 = persps[0].visible_field_extent, persps[1].visible_field_extent
    y_mid = (max(e0[2], e1[2]) + min(e0[3], e1[3])) / 2
    x_start = e1[0] - 60.0
    assert e0[0] < x_start < e0[1]
    bank = np.zeros((ROLL_FRAMES, len(models), 2 * H, 2 * W), dtype=np.uint8)
    for k in range(ROLL_FRAMES):
        scene = Scene(bots=[SceneBot(ROLL_BOT, "yellow", float(x_start + k * 12.0),
                                     float(y_mid), 0.4)],
                      balls=[], noise_sigma=0.5, seed=k)
        for c, model in enumerate(models):
            bank[k, c] = render_raw(model, geometry.field, scene, "RGGB")
    return bank


def _inputs(n_cams: int, with_bank: bool):
    from vision_processor_tpu.models.colors import ColorState
    from vision_processor_tpu.models.device_finish import pack_field_marks

    geometry, models, persps, bm, det = mini_rig(n_cams)
    raws0, raws1 = _scene_frames(geometry, models, persps)
    f32 = np.float32
    data = {
        "raws0": raws0, "raws1": raws1,
        "packed": np.stack([m.packed() for m in models]).astype(f32),
        "scales": np.array([p.field_scale for p in persps], dtype=f32),
        "offsets": np.array([[p.visible_field_extent[0], p.visible_field_extent[2]]
                             for p in persps], dtype=f32),
        "colors": np.stack([ColorState().packed() for _ in range(n_cams)]),
        "refs": np.stack([ColorState().packed_refs() for _ in range(n_cams)]),
    }
    params = {
        "max_bot_height": f32(MAXH), "max_robot_radius": f32(90.0),
        "min_tracking_radius": f32(60.0), "max_bot_acceleration": f32(6500.0),
        "ball_radius": f32(21.5), "tracked_time_delta": f32(0.01),
        "min_score": f32(0.0), "min_cam_edge_distance": f32(50.0),
        "reference_force": f32(0.1), "history_force": f32(0.7),
        "bot_heights_yb": np.array([145.0, 145.0], dtype=f32),
        # per-camera tunables that differ over the mesh, so that a slice at
        # the wrong camera changes the outputs: a circularity threshold of 30
        # drops candidates of cameras 1 and 5 (the pattern 10, 30, 30, 10
        # differs between neighbouring ranks), and the last camera's
        # confidence gate, above every score, drops its bot
        "min_circularity": np.resize(np.array([10.0, 30.0, 30.0, 10.0], dtype=f32),
                                     n_cams),
        "min_confidence": np.array([0.15] * (n_cams - 1) + [0.99], dtype=f32),
        "clipping_tolerance": np.linspace(8.0, 12.0, n_cams, dtype=f32),
    }
    data.update({f"params.{k}": v for k, v in params.items()})
    marks = pack_field_marks(geometry.field, 10.0)
    data.update({f"marks.{k}": np.asarray(v) for k, v in marks.items()})
    if with_bank:
        data["bank"] = _handoff_bank(geometry, models, persps)
        roll = {k: params[k] for k in ("max_bot_height", "max_robot_radius",
                                       "min_tracking_radius", "max_bot_acceleration",
                                       "ball_radius", "tracked_time_delta")}
        roll.update(min_circularity=f32(10.0), min_confidence=f32(0.15),
                    clipping_tolerance=f32(10.0))
        data.update({f"roll_params.{k}": v for k, v in roll.items()})
    spec = {"bm": {**bm, "raw_shape": list(bm["raw_shape"]),
                   "flat_shape": list(bm["flat_shape"]),
                   "field_offset": list(bm["field_offset"])},
            "det": det, "n_cams": n_cams}
    return data, spec


def _tree(data: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in data.items() if k.startswith(prefix + ".")}


def spawn_world(run_dir: Path, world: int, data: dict, spec: dict,
                kind: str = "cpu") -> list:
    """Runs ``world`` workers on the rig; their outputs, by rank. Fails the
    test when a worker fails or the world is not done within JOIN_S."""
    run_dir.mkdir(parents=True, exist_ok=True)
    np.savez(run_dir / "inputs.npz", **data)
    (run_dir / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, __file__, str(run_dir), str(r), str(world),
                               kind],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_S)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"world of {world} not done within {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n{log}"
    return [dict(np.load(run_dir / f"out{r}.npz")) for r in range(world)]


def _by_camera(outs: list, prefix: str) -> dict:
    """The ranks' local outputs under ``prefix``, concatenated on the camera
    axis in global camera order."""
    trees = [_tree(o, prefix) for o in outs]
    return {k: np.concatenate([t[k] for t in trees]) for k in trees[0]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: (data, spec, outputs by rank)} for worlds 2 (2 cameras, the
    rollout too) and 4 (8 cameras), spawned together."""
    runs = {2: _inputs(2, with_bank=True), 4: _inputs(8, with_bank=False)}
    base = tmp_path_factory.mktemp("sharded")
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(2) as pool:
        futs = {w: pool.submit(spawn_world, base / f"world{w}", w, *runs[w]) for w in runs}
        return {w: (*runs[w], futs[w].result()) for w in runs}


def _configs(spec: dict):
    from vision_processor_tpu.models.detector import DetectorConfig as JDet
    from vision_processor_tpu.ops.pipeline import BlobMachineConfig as JBM
    from vision_processor_tpu.parallel import multicam as JM
    from vision_processor_tpu_torch.models.detector import DetectorConfig
    from vision_processor_tpu_torch.ops.pipeline import BlobMachineConfig
    from vision_processor_tpu_torch.parallel import multicam as M

    bm = {**spec["bm"], "raw_shape": tuple(spec["bm"]["raw_shape"]),
          "flat_shape": tuple(spec["bm"]["flat_shape"]),
          "field_offset": tuple(spec["bm"]["field_offset"])}
    jcfg = JM.MultiCamConfig(bm=JBM(**bm), det=JDet(**spec["det"]), n_cams=spec["n_cams"])
    tcfg = M.MultiCamConfig(bm=BlobMachineConfig(**bm), det=DetectorConfig(**spec["det"]),
                            n_cams=spec["n_cams"])
    return jcfg, tcfg


def _kept(det: dict, c: int) -> dict:
    """Camera c's kept bots by estimated id: (pos, orientation, score,
    tracked id, blob set)."""
    d = {k: np.asarray(v)[c] for k, v in det.items()}
    return {int(d["bot_id_est"][i]): (d["bot_pos"][i], d["bot_orientation"][i],
                                      d["bot_score"][i], int(d["bot_tracked_id"][i]),
                                      frozenset(d["bot_blob_idx"][i]))
            for i in np.flatnonzero(d["bot_valid"])}


def _summary_by_id(g: dict, c: int) -> dict:
    ids, pos = np.asarray(g["id"]).reshape(-1, g["id"].shape[-1]), \
        np.asarray(g["pos"]).reshape(-1, g["id"].shape[-1], 2)
    return {int(i): pos[c, j] for j, i in enumerate(ids[c]) if i >= 0}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_jax(worlds, world):
    """(a) the port's world of ``world`` ranks against the JAX
    ``sharded_step(fused=True)`` on a ``world``-device mesh, two frame-sets
    fed back, per-camera tunables differing, the last camera in outage."""
    import jax
    import jax.numpy as jnp

    from vision_processor_tpu.parallel import multicam as JM
    from vision_processor_tpu_torch.parallel import multicam as M
    from vision_processor_tpu_torch.utils.state import to_torch

    data, spec, outs = worlds[world]
    jcfg, tcfg = _configs(spec)
    n = spec["n_cams"]
    step = JM.sharded_step(jcfg, JM.make_camera_mesh(jax.devices()[:world]), fused=True)
    params = {k: jnp.asarray(v) for k, v in _tree(data, "params").items()}
    marks = {k: jnp.asarray(v) for k, v in _tree(data, "marks").items()}
    prev, colors = JM.empty_summary(jcfg), data["colors"]
    n_bots = 0
    for f in range(STEP_FRAME_SETS):
        jout = jax.device_get(step(data[f"raws{f}"], data["packed"], data["scales"],
                                   data["offsets"], colors, prev, params, data["refs"],
                                   marks))
        jb, jd, jg, jf = jout
        tb, td, tf = (_by_camera(outs, f"fused.{f}.{k}") for k in ("blobs", "det", "fin"))
        tg = _tree(outs[0], f"fused.{f}.gathered")
        np.testing.assert_array_equal(tb["count"], jb["count"])
        np.testing.assert_array_equal(tb["valid"], jb["valid"])
        v = jb["valid"]
        np.testing.assert_allclose(tb["field_pos"][v], jb["field_pos"][v], atol=0.5)
        np.testing.assert_array_equal(td["ball_clipped"], jd["ball_clipped"])
        assert tg["id"].shape == jg["id"].shape == (world, n // world, jcfg.det.max_bots)
        for c in range(n):
            tk, jk = _kept(td, c), _kept(jd, c)
            assert sorted(tk) == sorted(jk), (f, c)
            for bid, (pos, orient, score, tid, blobs) in jk.items():
                np.testing.assert_allclose(tk[bid][0], pos, atol=0.5)
                np.testing.assert_allclose(tk[bid][1], orient, atol=1e-3)
                np.testing.assert_allclose(tk[bid][2], score, rtol=1e-4)
                assert (tk[bid][3], tk[bid][4]) == (tid, blobs)
            n_bots += len(tk)
            ts, js = _summary_by_id(tg, c), _summary_by_id(jg, c)
            assert sorted(ts) == sorted(js)
            for bid in js:
                np.testing.assert_allclose(ts[bid], js[bid], atol=0.5)
        for key in ("bot_valid", "bot_id", "ball_valid", "colors7"):
            np.testing.assert_array_equal(tf[key], jf[key], err_msg=key)
        v = jf["bot_valid"]
        np.testing.assert_allclose(tf["bot_world"][v], jf["bot_world"][v], atol=0.5)
        b = jf["ball_valid"]
        np.testing.assert_allclose(tf["ball_world"][b], jf["ball_world"][b], atol=0.5)
        # every camera found its own bot but the last (its gate), the even
        # ones their ball
        ids = [c + (16 if c % 2 else 0) for c in range(n - 1)]
        found = [sorted(int(i) for i in tf["bot_id"][c][tf["bot_valid"][c]])
                 for c in range(n)]
        assert found == [[i] for i in ids] + [[]], found
        assert tf["ball_valid"].sum(axis=1).tolist() == [1 - c % 2 for c in range(n)]
        # the gathered summary holds the whole fleet: the next frame-set's
        # tracked prior (the same on every rank) has every camera's bot
        prior = M.tracked_from_summaries(tcfg.det, to_torch(tg, "cpu"), 0.01)
        assert sorted(prior["id"][prior["valid"]].tolist()) == sorted(ids)
        prev, colors = jg, jf["colors7"]
    assert n_bots == 2 * (n - 1)


def _batched(data: dict, spec: dict, dev) -> list:
    """The port's ``batched_step`` over all the rig's cameras on ``dev``
    (``rs_grids=None``, fused), its own summaries and colour table fed
    back: (blobs, det, summary, fin) as numpy, a tuple a frame-set."""
    import torch

    from vision_processor_tpu_torch.parallel import multicam as M
    from vision_processor_tpu_torch.utils.state import to_numpy, to_torch

    _, tcfg = _configs(spec)
    n = spec["n_cams"]
    t = to_torch({k: data[k] for k in ("packed", "scales", "offsets", "colors", "refs")},
                 dev)
    params = to_torch(_tree(data, "params"), dev)
    marks = {k: torch.broadcast_to(v, (n, *v.shape))
             for k, v in to_torch(_tree(data, "marks"), dev).items()}
    step = M.batched_step(tcfg)
    prev, colors, wants = M.empty_summary(tcfg, dev), t["colors"], []
    for f in range(STEP_FRAME_SETS):
        res = step(torch.from_numpy(data[f"raws{f}"]).to(dev), t["packed"], t["scales"],
                   t["offsets"], colors, prev, params, None, None, t["refs"], marks)
        wants.append(to_numpy(res))
        prev, colors = res[2], res[3]["colors7"]
    return wants


def _assert_equals_batched(wants: list, outs: list) -> None:
    """The world's outputs equal ``_batched``'s bit for bit; the plain
    step's outputs equal the fused step's first three, and every rank
    gathered the batch's summaries."""
    for f, want in enumerate(wants):
        for i, key in enumerate(("blobs", "det", "fin")):
            got = _by_camera(outs, f"fused.{f}.{key}")
            ref = want[(0, 1, 3)[i]]
            assert sorted(got) == sorted(ref)
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{f} {key}.{k}")
            if key != "fin":
                plain = _by_camera(outs, f"plain.{f}.{key}")
                for k in ref:
                    np.testing.assert_array_equal(plain[k], got[k], err_msg=f"plain {k}")
        for r, out in enumerate(outs):
            for mode in ("fused", "plain"):
                g = _tree(out, f"{mode}.{f}.gathered")
                for k, v in want[2].items():
                    np.testing.assert_array_equal(g[k].reshape(v.shape), v,
                                                  err_msg=f"rank {r} {mode} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_equals_batched_step(worlds, world):
    """(b) the world against the port's ``batched_step`` over all cameras
    in this process, bit for bit."""
    import torch

    data, spec, outs = worlds[world]
    torch.set_num_threads(1)
    _assert_equals_batched(_batched(data, spec, "cpu"), outs)


def check_handoff(data: dict, spec: dict, outs: list, world: int) -> None:
    """The world's ``sharded_rollout`` (yellow 9 walking from camera 0's
    view into camera 1's) against the JAX rollout on a ``world``-device
    mesh: tracked ids, validity and gathered summary ids equal, positions
    within 0.5 mm. Camera 0 identifies the bot from the first frame;
    camera 1 first sees it on a later frame through the tracked search
    (its tracked id 9, seeded by the gathered summaries) and keeps it in
    the summary from then on."""
    import jax
    import jax.numpy as jnp

    from vision_processor_tpu.parallel import multicam as JM

    jcfg, _ = _configs(spec)
    roll = JM.sharded_rollout(jcfg, JM.make_camera_mesh(jax.devices()[:world]), ROLL_FRAMES)
    params = {k: jnp.asarray(v) for k, v in _tree(data, "roll_params").items()}
    j = jax.device_get(roll(data["bank"], data["packed"], data["scales"], data["offsets"],
                            data["colors"], params))
    trees = [_tree(o, "roll") for o in outs]
    t = {k: np.concatenate([tr[k] for tr in trees], axis=1)
         for k in ("bot_tracked_id", "bot_valid", "bot_pos")}
    for k in ("summary_id", "summary_pos"):
        assert all(np.array_equal(tr[k], trees[0][k]) for tr in trees)
        t[k] = trees[0][k]
    for k in ("bot_valid", "bot_tracked_id", "summary_id"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    v = j["bot_valid"]
    np.testing.assert_allclose(t["bot_pos"][v], j["bot_pos"][v], atol=0.5)
    s = j["summary_id"] >= 0
    np.testing.assert_allclose(t["summary_pos"][s], j["summary_pos"][s], atol=0.5)
    valid, tids, sids = t["bot_valid"], t["bot_tracked_id"], t["summary_id"]
    assert valid[0, 0].any() and ROLL_BOT in sids[0, 0][valid[0, 0]]
    seen = [k for k in range(ROLL_FRAMES) if valid[k, 1].any()]
    assert seen and seen[0] > 0, "the bot must enter camera 1's view after frame 0"
    k0 = seen[0]
    assert tids[k0, 1, np.flatnonzero(valid[k0, 1])[0]] == ROLL_BOT
    # the id persists in the gathered summary from camera 1 once it is there
    assert all(ROLL_BOT in sids[k, 1] for k in range(k0, ROLL_FRAMES))


def test_sharded_rollout_hands_off_across_cameras(worlds):
    """(c) the world of 2 through ``sharded_rollout``: ``check_handoff``
    on a 2-device mesh."""
    data, spec, outs = worlds[2]
    check_handoff(data, spec, outs, 2)


@pytest.mark.parametrize("n_cams,world", [(3, 2), (4, 3), (2, 4)])
def test_cameras_must_divide_over_the_world(n_cams, world):
    """(d) ``ValueError`` when n_cams % world != 0, for the step (plain and
    fused) and the rollout, before any collective."""
    import torch

    from vision_processor_tpu_torch.models.detector import DetectorConfig
    from vision_processor_tpu_torch.ops.pipeline import BlobMachineConfig
    from vision_processor_tpu_torch.parallel import multicam as M

    bm = BlobMachineConfig(fmt="RGGB", raw_shape=(8, 8), flat_shape=(4, 4),
                           field_scale=1.0, field_offset=(0.0, 0.0), grad_offset=1,
                           sat_radius=2, disc_radius=1)
    cfg = M.MultiCamConfig(bm=bm, det=DetectorConfig(max_blobs=64), n_cams=n_cams)
    group = M.CameraGroup(group=None, rank=0, world=world, device=torch.device("cpu"))
    for make in (lambda: M.sharded_step(cfg, group),
                 lambda: M.sharded_step(cfg, group, fused=True),
                 lambda: M.sharded_rollout(cfg, group, 3)):
        with pytest.raises(ValueError, match=f"n_cams={n_cams} must divide over {world}"):
            make()


def test_camera_group_of_one_on_the_cpu(tmp_path):
    """A world of one over gloo (``device="cpu"``, a file rendezvous): the
    record's rank, world and device; the default group is reused by a
    second call; the gather of a summary is the (1, n_local, ...) stack."""
    import torch
    import torch.distributed as dist

    from vision_processor_tpu_torch.parallel import multicam as M

    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    group = M.make_camera_group(device="cpu", init_method=f"file://{tmp_path / 'rdzv'}",
                                rank=0, world_size=1)
    try:
        assert (group.rank, group.world, group.device) == (0, 1, torch.device("cpu"))
        assert dist.get_backend() == "gloo"
        assert M.make_camera_group(device="cpu") == group
        summary = {"id": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                   "pos": torch.ones(2, 3, 2)}
        got = M._all_gather(group, summary)
        assert got["id"].dtype == torch.int32 and got["id"].shape == (1, 2, 3)
        assert torch.equal(got["id"][0], summary["id"])
        assert torch.equal(got["pos"][0], summary["pos"])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("device,backend,error", [
    ("cpu", "nccl", ValueError),
    ("cuda:0", "gloo", ValueError),
    ("cuda:0", None, RuntimeError),
    (None, None, RuntimeError),
])
def test_camera_group_refuses_other_pairings(device, backend, error):
    """gloo only for the CPU, NCCL only for a card; asking for a card
    (the default, ``cuda:LOCAL_RANK``) where CUDA is absent raises, with no
    fallback to the host."""
    import torch

    from vision_processor_tpu_torch.parallel import multicam as M

    if error is RuntimeError and torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(error):
        M.make_camera_group(device=device, backend=backend)


@pytest.mark.cuda
def test_nccl_world_equals_batched_step_on_one_card(tmp_path):
    """One NCCL rank per card (2 to 4 cards, 2 cameras a rank): the
    world's outputs equal ``batched_step`` over all cameras on card 0 bit
    for bit (``_assert_equals_batched``). The kernels are built here first,
    by the batched step, so that the ranks load them."""
    import torch

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        pytest.skip("needs 2 or more NVIDIA GPUs: NCCL takes one card a rank")
    world = min(n_cards, 4)
    data, spec = _inputs(2 * world, with_bank=False)
    wants = _batched(data, spec, torch.device("cuda", 0))
    _assert_equals_batched(wants, spawn_world(tmp_path / "nccl", world, data, spec,
                                              kind="cuda"))
