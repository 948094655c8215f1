"""The port's one-card camera batch (parallel/multicam.py) against the JAX
package's, on the same numpy inputs.

A small 2-camera rig (480x270 models over two parts of the Div B field, 2
bots + ball each, max_blobs 256, gather resample): the batched step (device
summary feedback) and the host-tracked step, with and without on-device
finishing, the staggered plan and the rollout, over 2-3 frame-sets with
feedback. Selections, ids, validity and ball sets must be equal; positions
within 0.5 mm and orientations within 1e-3 rad (as tests/test_torch_slice.py
holds the one-camera slice), scores within 1e-4 relative.
"""
from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu.app.processor import TrackedArrays as JTracked
from vision_processor_tpu.io.synthetic import Scene, SceneBall, SceneBot, render_raw
from vision_processor_tpu.models.camera import CameraModel
from vision_processor_tpu.models.colors import ColorState
from vision_processor_tpu.models.detector import DetectorConfig as JDetectorConfig
from vision_processor_tpu.models.device_finish import pack_field_marks
from vision_processor_tpu.models.perspective import Perspective
from vision_processor_tpu.ops import blob as JB
from vision_processor_tpu.ops.pipeline import BlobMachineConfig as JBlobMachineConfig
from vision_processor_tpu.parallel import multicam as JM
from vision_processor_tpu_torch.models.detector import DetectorConfig
from vision_processor_tpu_torch.ops.pipeline import BlobMachineConfig
from vision_processor_tpu_torch.parallel import multicam as M
from vision_processor_tpu_torch.utils.state import to_numpy, to_torch

WIDTH, HEIGHT, MAXH = 480, 270, 150.0
CAMS = ((-2250.0, -1500.0), (1800.0, 1200.0))
SCENES = (
    ([(3, "yellow", -2500.0, -1300.0, 0.7), (9, "blue", -1700.0, -1650.0, -2.0)],
     (-2100.0, -1150.0)),
    ([(5, "blue", 1500.0, 1000.0, 1.0), (12, "yellow", 2100.0, 1400.0, -0.5)],
     (1800.0, 1250.0)),
)
IDS = ({3, 25}, {21, 12})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rig(divb_field):
    geometry = divb_field.geometry
    models, persps, raws = [], [], []
    for cam_id, ((cx, cy), (bots, ball)) in enumerate(zip(CAMS, SCENES)):
        model = CameraModel(focal_length=900.0,
                            principal_point=np.array([WIDTH / 2, HEIGHT / 2]),
                            distortion_k2=0.02, pos=np.array([cx, cy, 4500.0]),
                            size=np.array([WIDTH, HEIGHT]))
        geometry.ClearField("calib")
        geometry.calib.append(model.to_proto(cam_id))
        persp = Perspective(cam_id=cam_id)
        assert persp.update_geometry(geometry, cam_id + 1, WIDTH, HEIGHT, MAXH, 1.25)
        scene = Scene(bots=[SceneBot(*b) for b in bots], balls=[SceneBall(*ball)],
                      noise_sigma=1.5, seed=cam_id)
        models.append(model)
        persps.append(persp)
        raws.append(render_raw(model, geometry.field, scene, "RGGB"))
    raws = np.stack(raws)
    ref = persps[0]
    bm = dict(
        fmt="RGGB", raw_shape=raws.shape[1:],
        flat_shape=(max(int(p.reprojected_field_size[1]) for p in persps),
                    max(int(p.reprojected_field_size[0]) for p in persps)),
        field_scale=float(ref.field_scale), field_offset=(0.0, 0.0),
        grad_offset=JB.gradient_offset(ref.max_blob_radius, ref.field_scale),
        sat_radius=JB.sat_radius(ref.min_blob_radius, ref.field_scale),
        disc_radius=JB.disc_radius(ref.min_blob_radius, ref.field_scale),
        max_blobs=256, resample_mode="gather",
    )
    n = len(CAMS)
    jcfg = JM.MultiCamConfig(bm=JBlobMachineConfig(**bm),
                             det=JDetectorConfig(max_blobs=256, max_tracked=32), n_cams=n)
    tcfg = M.MultiCamConfig(bm=BlobMachineConfig(**bm),
                            det=DetectorConfig(max_blobs=256, max_tracked=32), n_cams=n)
    f32 = np.float32
    inputs = {
        "packed": np.stack([m.packed() for m in models]).astype(f32),
        "scales": np.array([p.field_scale for p in persps], dtype=f32),
        "offsets": np.array([[p.visible_field_extent[0], p.visible_field_extent[2]]
                             for p in persps], dtype=f32),
        "colors": np.stack([ColorState().packed() for _ in range(n)]),
        "refs": np.stack([ColorState().packed_refs() for _ in range(n)]),
        "marks": {k: np.stack([v] * n)
                  for k, v in pack_field_marks(geometry.field, 10.0).items()},
    }
    params = {
        "max_bot_height": f32(MAXH), "min_circularity": f32(15.0),
        "max_robot_radius": f32(90.0), "min_tracking_radius": f32(20.0),
        "max_bot_acceleration": f32(6500.0), "min_confidence": f32(0.2),
        # per camera, as the app's fleet params carry it
        "clipping_tolerance": np.array([10.0, 12.0], dtype=f32),
        "ball_radius": f32(21.5), "tracked_time_delta": f32(0.01),
        "min_score": f32(5.0), "min_cam_edge_distance": f32(170.0),
        "reference_force": f32(0.1), "history_force": f32(0.7),
        "bot_heights_yb": np.array([145.0, 145.0], dtype=f32),
        "color_plausibility_veto": f32(0.0),
    }
    jgrids = JM.make_resample_grids(jcfg, inputs["packed"], MAXH, inputs["scales"],
                                    inputs["offsets"])
    tgrids = M.make_resample_grids(tcfg, inputs["packed"], MAXH, inputs["scales"],
                                   inputs["offsets"], device="cpu")
    return SimpleNamespace(jcfg=jcfg, tcfg=tcfg, raws=raws, inputs=inputs, params=params,
                           jgrids=jgrids, tgrids=tgrids)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ids_from_fin(fin):
    """Per camera, the set of emitted ids of the finisher's output."""
    return [set(int(i) for i in fin["bot_id"][c][fin["bot_valid"][c]])
            for c in range(fin["bot_id"].shape[0])]


def _assert_blobs(t, j):
    np.testing.assert_array_equal(t["count"], np.asarray(j["count"]))
    np.testing.assert_array_equal(t["valid"], np.asarray(j["valid"]))
    v = np.asarray(j["valid"])
    np.testing.assert_allclose(t["field_pos"][v], np.asarray(j["field_pos"])[v], atol=0.5)


def _kept(det, c):
    """Camera c's kept bots by estimated id: (pos, orientation, score, blob set)."""
    det = {k: np.asarray(v)[c] for k, v in det.items()}
    return {int(det["bot_id_est"][i]): (det["bot_pos"][i], det["bot_orientation"][i],
                                        det["bot_score"][i], frozenset(det["bot_blob_idx"][i]))
            for i in np.flatnonzero(det["bot_valid"])}


def _assert_det(t, j):
    """The kept bots, compared by id. A tracked and an untracked hypothesis
    of one bot can score within float rounding of each other (1e-5
    relative: the combo scores differ by that much between the packages on
    the CPU); the two packages may then merge them in another order, and
    the NMS keeps the other one of the pair, so slots are not compared."""
    np.testing.assert_array_equal(t["ball_clipped"], np.asarray(j["ball_clipped"]))
    for c in range(t["bot_valid"].shape[0]):
        tk, jk = _kept(t, c), _kept(j, c)
        assert sorted(tk) == sorted(jk)
        for bid, (pos, orient, score, blobs) in jk.items():
            np.testing.assert_allclose(tk[bid][0], pos, atol=0.5)
            np.testing.assert_allclose(tk[bid][1], orient, atol=1e-3)
            np.testing.assert_allclose(tk[bid][2], score, rtol=1e-4)
            assert tk[bid][3] == blobs


def _assert_fin(t, j):
    for key in ("bot_valid", "bot_id", "ball_valid", "colors7"):
        np.testing.assert_array_equal(t[key], np.asarray(j[key]), err_msg=key)
    v = np.asarray(j["bot_valid"])
    np.testing.assert_allclose(t["bot_world"][v], np.asarray(j["bot_world"])[v], atol=0.5)
    b = np.asarray(j["ball_valid"])
    np.testing.assert_allclose(t["ball_world"][b], np.asarray(j["ball_world"])[b], atol=0.5)


def _tracked_from_fin(fin, now):
    ents = {}
    for c in range(fin["bot_id"].shape[0]):
        ents[c] = [SimpleNamespace(id=int(fin["bot_id"][c, i]), x=float(fin["bot_world"][c, i, 0]),
                                   y=float(fin["bot_world"][c, i, 1]), z=145.0,
                                   w=float(fin["bot_orientation"][c, i]), vx=0.0, vy=0.0,
                                   vw=0.0, timestamp=now)
                   for i in np.flatnonzero(fin["bot_valid"][c])]
    return JTracked.build(ents, now + 0.01, 32).as_dict()


@pytest.mark.parametrize("finish", [True, False])
def test_host_tracked_step_parity(rig, finish):
    """batched_step_host_tracked, two frame-sets, tracked prior and colour
    table fed back from the first."""
    inp = rig.inputs
    jstep = JM.batched_step_host_tracked(rig.jcfg)
    tstep = M.batched_step_host_tracked(rig.tcfg)
    tracked = JTracked.build({}, 0.0, 32).as_dict()
    jcolors = tcolors = inp["colors"]
    fin_args = (inp["refs"], inp["marks"]) if finish else ()
    for frame in range(2):
        jout = jax.device_get(jstep(
            jnp.asarray(rig.raws), *_jax((inp["packed"], inp["scales"], inp["offsets"],
                                          jcolors, tracked, rig.params)),
            rig.jgrids, *_jax(fin_args)))
        targs = to_torch((rig.raws, inp["packed"], inp["scales"], inp["offsets"], tcolors,
                          tracked, rig.params) + fin_args, "cpu")
        tout = to_numpy(tstep(*targs[:7], rig.tgrids, *targs[7:]))
        _assert_blobs(tout[0], jout[0])
        _assert_det(tout[1], jout[1])
        if not finish:
            assert [int(v.sum()) for v in tout[1]["bot_valid"]] == [2, 2]
            continue
        _assert_fin(tout[2], jout[2])
        assert _ids_from_fin(tout[2]) == list(IDS)
        assert [int(v.sum()) for v in tout[2]["ball_valid"]] == [1, 1]
        tracked = _tracked_from_fin(tout[2], frame * 0.01)
        jcolors, tcolors = np.asarray(jout[2]["colors7"]), tout[2]["colors7"]
        if frame == 1:  # the tracked search found kept bots
            assert (tout[1]["bot_tracked_id"][tout[1]["bot_valid"]] >= 0).sum() >= 2


def test_batched_step_parity_with_summary_feedback(rig):
    """batched_step: the device-loop tracked prior from the previous
    frame-set's summaries (and the one before, for velocities)."""
    inp = rig.inputs
    jstep = JM.batched_step(rig.jcfg)
    tstep = M.batched_step(rig.tcfg)
    jprev = jprev2 = JM.empty_summary(rig.jcfg)
    tprev = tprev2 = M.empty_summary(rig.tcfg, "cpu")
    targs = to_torch((rig.raws, inp["packed"], inp["scales"], inp["offsets"],
                      inp["colors"], rig.params, inp["refs"], inp["marks"]), "cpu")
    for frame in range(2):
        jout = jstep(jnp.asarray(rig.raws), *_jax((inp["packed"], inp["scales"],
                                                   inp["offsets"], inp["colors"])),
                     jprev, _jax(rig.params), rig.jgrids, jprev2, *_jax((inp["refs"],
                                                                       inp["marks"])))
        tout = tstep(*targs[:5], tprev, targs[5], rig.tgrids, tprev2, *targs[6:])
        jn, tn = jax.device_get(jout), to_numpy(tout)
        _assert_blobs(tn[0], jn[0])
        _assert_det(tn[1], jn[1])
        for key in ("id", "score"):
            np.testing.assert_allclose(tn[2][key], np.asarray(jn[2][key]), rtol=1e-4)
        _assert_fin(tn[3], jn[3])
        assert [set(int(i) for i in row if i >= 0) for row in tn[2]["id"]] == list(IDS)
        jprev, jprev2 = jout[2], jprev
        tprev, tprev2 = tout[2], tprev
    # the second frame-set's prior held every bot of the first
    prior = M.tracked_from_summaries(rig.tcfg.det, tprev2, 0.01)
    assert set(prior["id"][prior["valid"]].tolist()) == IDS[0] | IDS[1]


def test_staggered_equals_batched(rig):
    """percam_core_step per camera + staggered_tail_step == the batched
    host-tracked step (the JAX package's tests/test_staggered.py contract:
    discrete outputs equal, positions within 1e-3, scores within 1e-4)."""
    inp = rig.inputs
    t = to_torch((rig.raws, inp["packed"], inp["scales"], inp["offsets"], inp["colors"],
                  JTracked.build({}, 0.0, 32).as_dict(), rig.params, inp["refs"],
                  inp["marks"]), "cpu")
    raws, packed, scales, offsets, colors, tracked, params, refs, marks = t
    b_blobs, b_det, b_fin = to_numpy(M.batched_step_host_tracked(rig.tcfg)(
        raws, packed, scales, offsets, colors, tracked, params, rig.tgrids, refs, marks))
    core = M.percam_core_step(rig.tcfg)
    outs = [core(raws[c], packed[c], scales[c], offsets[c], colors[c], tracked,
                 M.params_for_cam(params, c), {k: v[c] for k, v in rig.tgrids.items()})
            for c in range(rig.tcfg.n_cams)]
    s_blobs = {k: torch.stack([o[0][k] for o in outs]) for k in outs[0][0]}
    s_det = {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]}
    s_det, s_fin = M.staggered_tail_step(rig.tcfg)(s_blobs, s_det, colors, packed, params,
                                                   refs, marks)
    s_blobs, s_det, s_fin = to_numpy((s_blobs, s_det, s_fin))
    np.testing.assert_array_equal(b_blobs["count"], s_blobs["count"])
    np.testing.assert_array_equal(b_blobs["field_pos"], s_blobs["field_pos"])
    for key in ("bot_valid", "bot_blob_idx"):
        np.testing.assert_array_equal(b_det[key], s_det[key])
    np.testing.assert_allclose(b_det["bot_pos"], s_det["bot_pos"], atol=1e-3)
    np.testing.assert_allclose(b_det["bot_score"], s_det["bot_score"], atol=1e-4)
    for key in ("bot_id", "ball_valid", "colors7"):
        np.testing.assert_array_equal(b_fin[key], s_fin[key])
    assert (b_det["bot_valid"].sum(axis=1) == 2).all()
    # without markings the tail is the finalize only
    assert M.staggered_tail_step(rig.tcfg)(*to_torch((s_blobs, s_det), "cpu"), colors,
                                           packed, params)[1] is None


def test_rollout_parity(rig):
    """make_rollout over 3 frame-sets from a 2-entry bank, the finisher's
    colour table carried, against the JAX scan."""
    inp = rig.inputs
    bank = np.stack([rig.raws, np.roll(rig.raws, (2, 4), axis=(1, 2))])
    jroll = JM.make_rollout(rig.jcfg, JM.batched_step(rig.jcfg), 3)
    troll = M.make_rollout(rig.tcfg, M.batched_step(rig.tcfg), 3)
    (_, jsum, _, jcolors), jcompact = jax.device_get(jroll(
        jnp.asarray(bank), *_jax((inp["packed"], inp["scales"], inp["offsets"],
                                  inp["colors"], rig.params, inp["refs"], inp["marks"]))))
    (n, tsum, _, tcolors), tcompact = to_numpy(troll(*to_torch(
        (bank, inp["packed"], inp["scales"], inp["offsets"], inp["colors"], rig.params,
         inp["refs"], inp["marks"]), "cpu")))
    assert n == 3
    for key in ("count", "bot_valid", "n_balls"):
        np.testing.assert_array_equal(tcompact[key], np.asarray(jcompact[key]), err_msg=key)
    v = np.asarray(jcompact["bot_valid"])
    np.testing.assert_allclose(tcompact["bot_pos"][v], np.asarray(jcompact["bot_pos"])[v],
                               atol=0.5)
    np.testing.assert_array_equal(tsum["id"], np.asarray(jsum["id"]))
    np.testing.assert_array_equal(tcolors, np.asarray(jcolors))
    assert (tcompact["bot_valid"].sum(axis=-1) == 2).all()


def test_grids_and_field_pos_follow_each_camera(rig):
    """Per-camera field_offset / field_scale reach the grid and field_pos:
    camera 1's grid differs from camera 0's, equals the JAX one, and moving
    camera 1's offset moves its field positions by exactly that offset."""
    w = rig.tcfg.bm.plane_shape[1]

    def uv(g):  # the sampling positions, from the corner index and fractions
        idx = np.asarray(g["idx"])
        return np.stack([idx % w + np.asarray(g["ub"]), idx // w + np.asarray(g["vb"])])

    # the projections agree to float rounding, so a corner index can differ
    # where a position lies on a pixel edge: compare the positions
    np.testing.assert_allclose(uv(rig.tgrids), uv(rig.jgrids), atol=1e-3)
    assert not torch.equal(rig.tgrids["idx"][0], rig.tgrids["idx"][1])

    from vision_processor_tpu_torch.ops.pipeline import blob_machine

    raw = torch.from_numpy(rig.raws[1])
    grid = {k: v[1] for k, v in rig.tgrids.items()}
    scale = float(rig.inputs["scales"][1])
    off = rig.inputs["offsets"][1]
    cam = torch.from_numpy(rig.inputs["packed"][1])
    base = blob_machine(rig.tcfg.bm, raw, cam, MAXH, 15.0, field_scale=scale,
                        field_offset=tuple(off), rs_grid=grid)
    moved = blob_machine(rig.tcfg.bm, raw, cam, MAXH, 15.0, field_scale=scale,
                         field_offset=tuple(off + np.float32(100.0)), rs_grid=grid)
    default = blob_machine(rig.tcfg.bm, raw, cam, MAXH, 15.0,
                           rs_grid=grid)  # the config's (0, 0)
    v = base["valid"]
    assert int(v.sum()) > 5
    np.testing.assert_allclose((moved["field_pos"] - base["field_pos"])[v].numpy(), 100.0,
                               atol=1e-3)
    np.testing.assert_allclose(default["field_pos"][v].numpy(),
                               (base["field_pos"][v] - torch.from_numpy(off)).numpy(),
                               atol=1e-2)


def test_params_for_cam():
    params = {"min_circularity": torch.tensor([15.0, 1e9]), "max_bot_height": torch.tensor(150.0),
              "bot_heights_yb": torch.tensor([145.0, 150.0]),
              "clipping_tolerance": torch.tensor(10.0)}
    p1 = M.params_for_cam(params, 1)
    assert float(p1["min_circularity"]) == 1e9
    assert p1["max_bot_height"] is params["max_bot_height"]
    # a (2,) array of a shared key is not sliced
    assert p1["bot_heights_yb"] is params["bot_heights_yb"]
    assert p1["clipping_tolerance"] is params["clipping_tolerance"]


def test_per_camera_params_in_the_step(rig):
    """Camera 1 gets an impossible min_circularity: it sees no blobs while
    camera 0 detects its bots, as in the JAX package."""
    inp = rig.inputs
    params = dict(rig.params, min_circularity=np.array([15.0, 1e9], np.float32))
    t = to_torch((rig.raws, inp["packed"], inp["scales"], inp["offsets"], inp["colors"],
                  JTracked.build({}, 0.0, 32).as_dict(), params), "cpu")
    blobs, det = to_numpy(M.batched_step_host_tracked(rig.tcfg)(*t, rig.tgrids))
    assert blobs["count"][0] >= 6 and blobs["count"][1] == 0
    assert det["bot_valid"][0].sum() == 2 and det["bot_valid"][1].sum() == 0


def _summary(n_cams, b, entries):
    out = {"pos": np.zeros((n_cams, b, 2), np.float32),
           "orientation": np.zeros((n_cams, b), np.float32),
           "score": np.zeros((n_cams, b), np.float32),
           "id": np.full((n_cams, b), -1, np.int32)}
    for cam, slot, i, x, y, sc, w in entries:
        out["pos"][cam, slot] = (x, y)
        out["orientation"][cam, slot] = w
        out["score"][cam, slot] = sc
        out["id"][cam, slot] = i
    return out


@pytest.mark.parametrize("max_tracked", [2, 8])
def test_tracked_from_summaries_parity(max_tracked):
    """Dedup (one id seen by 3 cameras), GC team heights, linear and angular
    velocities, and tied scores across cameras (ties go to the lower slot,
    as lax.top_k breaks them): every output equal to the JAX function's."""
    det_j = JDetectorConfig(max_blobs=32, max_tracked=max_tracked)
    det_t = DetectorConfig(max_blobs=32, max_tracked=max_tracked)
    b = det_t.max_bots
    cur = _summary(3, b, [
        (0, 0, 5, 100.0, 200.0, 0.9, 0.50),
        (1, 0, 5, 101.0, 201.0, 0.95, 0.51),
        (2, 0, 5, 99.0, 199.0, 0.95, 0.49),   # tie with camera 1: slot order wins
        (2, 1, 21, -500.0, 300.0, 0.4, -1.0),
        (0, 3, 7, 10.0, 20.0, 0.4, 3.1),      # tie with id 21 across cameras
        (1, 5, 9, 50.0, 60.0, 0.4, -3.1),
        (1, 6, 11, 70.0, 80.0, 0.0, 0.0),     # score 0: not tracked
    ])
    prev = _summary(3, b, [(1, 0, 5, 91.0, 191.0, 0.95, 0.31),
                           (2, 2, 7, 0.0, 0.0, 0.5, -3.1)])
    for kwargs in ({}, {"prev": prev, "heights": (147.0, 139.0)}):
        want = JM.tracked_from_summaries(
            det_j, _jax(cur), 0.02,
            prev_summaries=_jax(kwargs["prev"]) if "prev" in kwargs else None,
            bot_heights=kwargs.get("heights"))
        got = M.tracked_from_summaries(
            det_t, to_torch(cur, "cpu"), torch.tensor(0.02),
            prev_summaries=to_torch(kwargs["prev"], "cpu") if "prev" in kwargs else None,
            bot_heights=kwargs.get("heights"))
        assert sorted(got) == sorted(want)
        for key, val in want.items():
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(val), err_msg=key)
    ids = [int(i) for i in got["id"].numpy() if i >= 0]
    assert ids[0] == 5 and len(ids) == min(max_tracked, 4)
    i5 = ids.index(5)
    assert got["x"][i5] == pytest.approx(101.0)  # camera 1's observation, the lower slot
    assert got["vw"][i5] == pytest.approx((0.51 - 0.31) / 0.02)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_batched_step_on_card_matches_cpu(rig, cuda_device):
    """The host-tracked step with on-device finishing on the card (kernels
    E4, B7, B2, B3, B4) and on the CPU (plain versions): the same kept bots
    and ids, positions within 0.5 mm, the same ball sets."""
    from vision_processor_tpu_torch.ops import cuda

    inp = rig.inputs
    host = (rig.raws, inp["packed"], inp["scales"], inp["offsets"], inp["colors"],
            JTracked.build({}, 0.0, 32).as_dict(), rig.params, inp["refs"], inp["marks"])
    outs = {}
    for dev in ("cpu", cuda_device):
        t = to_torch(host, dev)
        grids = {k: v.to(dev) for k, v in rig.tgrids.items()}
        before = dict(cuda.LAUNCHES)
        outs[str(dev)] = to_numpy(M.batched_step_host_tracked(rig.tcfg)(*t[:7], grids,
                                                                         *t[7:]))
        if dev != "cpu":
            assert cuda.LAUNCHES["corner_stack"] - before["corner_stack"] == 2
            assert cuda.LAUNCHES["gather_corners"] - before["gather_corners"] == 2
    c, g = outs["cpu"], outs[str(cuda_device)]
    _assert_blobs(g[0], c[0])
    _assert_det(g[1], c[1])
    _assert_fin(g[2], c[2])
