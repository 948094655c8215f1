"""The port's camera mesh at production scale, on the CPU over gloo: the
counterpart of tests/test_multichip_production.py
(``__graft_entry__.py run_production_parity_check``) and
tests/test_multichip_handoff.py:25.

It reuses tests/test_torch_sharded.py's worker (that file is the worker
script: a rank joins through a file rendezvous, runs ``sharded_step``
plain and fused over its cameras for two frame-sets, the gathered
summaries and colour table fed back, and the rollout when the inputs
hold a bank) and its join timeout.

(a) A world of 4, one camera a rank, on the bench rig
    (``vision_processor_tpu_torch/bench.py build_rig``: 1080p RGGB,
    max_blobs 2000, factor 1.25, 4 robots and a ball a camera), the
    per-camera tunables of ``run_production_parity_check`` (circularity
    12-18, camera 3's confidence gate 0.35, clipping tolerance 8-12) and
    camera 3 in outage on the second frame-set (its first frame again):
    bit-equal to the port's ``batched_step(rs_grids=None)`` over the four
    cameras in one process.
(b) ``batched_step`` against the JAX ``batched_step`` on the same
    inputs, each fed back its own outputs, both with their production
    blob response: selections equal (blob counts and validity, each blob
    in its slot but where two scores tie to 1e-4 relative, each kept
    robot's blob set and tracked id) and detections equal (ids, validity,
    colour tables; positions within 0.5 mm, orientations within 1e-3 rad,
    scores within 1e-4 relative: the tolerances of
    tests/test_torch_sharded.py).
(c) ``sharded_rollout`` on a world of 8 at tests/test_torch_sharded.py's
    192x144, the robot handed off from camera 0 to camera 1 through the
    tracked path, against the JAX rollout on an 8-device mesh.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from test_torch_sharded import (
    _assert_equals_batched, _batched, _by_camera, _configs, _inputs, _kept, _tree,
    check_handoff, spawn_world,
)

PROD_CAMS = 4
OUTAGE_CAM = 3
HANDOFF_WORLD = 8
TIE_REL = 1e-4  # scores this close (relative) may take each other's slots


def production_inputs():
    """The bench rig at 1080p as the worker's inputs and spec."""
    import torch

    from vision_processor_tpu_torch.bench import build_rig
    from vision_processor_tpu_torch.models.colors import ColorState
    from vision_processor_tpu_torch.models.device_finish import pack_field_marks

    rig = build_rig(PROD_CAMS, max_blobs=2000, resampling_factor=1.25, return_scenes=True,
                    device="cpu")
    cfg, raws, packed, scales, offsets, colors, params = rig[:7]
    cams, scenes = rig[8], rig[9]
    raws1 = np.stack([np.roll(r, (2, 4), axis=(0, 1)) for r in raws])
    raws1[OUTAGE_CAM] = raws[OUTAGE_CAM]
    f32 = np.float32
    params = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
              for k, v in params.items()}
    params.update(
        min_circularity=np.linspace(12.0, 18.0, PROD_CAMS, dtype=f32),
        min_confidence=np.asarray([0.2] * (PROD_CAMS - 1) + [0.35], dtype=f32),
        clipping_tolerance=np.linspace(8.0, 12.0, PROD_CAMS, dtype=f32))
    data = {"raws0": np.ascontiguousarray(raws), "raws1": raws1,
            "packed": packed.astype(f32), "scales": scales.astype(f32),
            "offsets": offsets.astype(f32), "colors": colors,
            "refs": np.stack([ColorState().packed_refs() for _ in range(PROD_CAMS)])}
    data.update({f"params.{k}": v for k, v in params.items()})
    marks = pack_field_marks(cams[0][1].field, 10.0)
    data.update({f"marks.{k}": np.asarray(v) for k, v in marks.items()})
    bm = dataclasses.asdict(cfg.bm)
    bm.pop("resample_mode")  # the step resamples in line (rs_grids=None)
    spec = {"bm": bm, "det": dataclasses.asdict(cfg.det), "n_cams": PROD_CAMS}
    return data, spec, scenes


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The production world of 4, then the handoff world of 8 (one after
    the other, so that one world's processes run at a time):
    {"production": (data, spec, outs, scenes), "handoff": (data, spec,
    outs)}."""
    base = tmp_path_factory.mktemp("sharded_production")
    prod_data, prod_spec, scenes = production_inputs()
    prod = spawn_world(base / "world4", PROD_CAMS, prod_data, prod_spec)
    hand_data, hand_spec = _inputs(HANDOFF_WORLD, with_bank=True)
    hand = spawn_world(base / "world8", HANDOFF_WORLD, hand_data, hand_spec)
    return {"production": (prod_data, prod_spec, prod, scenes),
            "handoff": (hand_data, hand_spec, hand)}


@pytest.fixture(scope="module")
def batched(worlds):
    """The port's ``batched_step`` over the four cameras in this process."""
    import torch

    data, spec, _, _ = worlds["production"]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return _batched(data, spec, "cpu")
    finally:
        torch.set_num_threads(n)


def test_production_world_of_4_equals_batched_step(worlds, batched):
    """(a) every output of the world of 4 (both frame-sets, plain and fused,
    every rank's gathered summaries) bit-equal to ``batched_step``."""
    _assert_equals_batched(batched, worlds["production"][2])


def _slot_map(tb: dict, jb: dict, c: int) -> dict:
    """Camera c's JAX blob slots -> the port's: the same slot where the two
    positions agree within 0.5 mm; else the port's slot of that blob, whose
    score must tie with slot j's to TIE_REL in both packages (their scores
    agree to f32 reassociation, so two near-tied blobs may swap slots)."""
    tpos, jpos = tb["field_pos"][c], jb["field_pos"][c]
    tsc, jsc = tb["score"][c], jb["score"][c]
    valid = np.flatnonzero(jb["valid"][c])
    out = {}
    for j in valid:
        if np.abs(tpos[j] - jpos[j]).max() <= 0.5:
            out[int(j)] = int(j)
            continue
        near = [i for i in valid if np.abs(tpos[i] - jpos[j]).max() <= 0.5]
        assert len(near) == 1, (c, j, near)
        i = near[0]
        tie = TIE_REL * abs(jsc[j])
        assert abs(tsc[i] - tsc[j]) <= tie and abs(jsc[i] - jsc[j]) <= tie, (
            c, i, j, tsc[i], tsc[j], jsc[i], jsc[j])
        out[int(j)] = int(i)
    assert sorted(out.values()) == sorted(out), f"camera {c}: not a permutation"
    return out


def test_production_batched_step_equals_the_jax_package(worlds, monkeypatch):
    """(b) the port's ``batched_step`` against the JAX ``batched_step`` on
    the same 1080p inputs, two frame-sets, each package fed back its own
    summaries and colour table, both with the blob response of their
    production path: the JAX package's Pallas kernel (in interpret mode on
    the CPU) and the port's B2 wrapper (its plain version on CPU tensors).
    Their CPU fallback, f32 summed-area tables over the whole map, loses
    too much at 1080p to rank blobs alike (ROADMAP section 3). Blob counts
    and validity equal; every blob in its slot or in a slot whose score
    ties with it to TIE_REL; kept robots by id with their blob sets (through
    that map), tracked ids, positions within 0.5 mm, orientations within
    1e-3 rad, scores within 1e-4 relative; the emitted robots, balls and
    colour tables equal; cameras 0-2 name their four planted robots."""
    import jax
    import jax.numpy as jnp
    import torch

    import vision_processor_tpu.ops.blob_pallas as JBP
    import vision_processor_tpu_torch.ops.pipeline as PL
    from vision_processor_tpu.parallel import multicam as JM
    from vision_processor_tpu_torch.ops.blob_fused import blob_response_fused

    monkeypatch.setattr(JBP, "use_fused_circ", lambda: True)
    monkeypatch.setattr(PL, "blob_response_map", lambda cfg, flat, th: blob_response_fused(
        flat, th, cfg.grad_offset, cfg.sat_radius, cfg.disc_radius))
    data, spec, _, scenes = worlds["production"]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port = _batched(data, spec, "cpu")
    finally:
        torch.set_num_threads(n)
    jcfg, _ = _configs(spec)
    step = JM.batched_step(jcfg)
    params = {k: jnp.asarray(v) for k, v in _tree(data, "params").items()}
    marks = {k: jnp.asarray(np.broadcast_to(v, (PROD_CAMS, *v.shape)))
             for k, v in _tree(data, "marks").items()}
    prev, colors = JM.empty_summary(jcfg), data["colors"]
    for f, (tb, td, tg, tf) in enumerate(port):
        jb, jd, jg, jf = jax.device_get(step(
            data[f"raws{f}"], data["packed"], data["scales"], data["offsets"], colors,
            prev, params, None, None, data["refs"], marks))
        np.testing.assert_array_equal(tb["count"], jb["count"])
        np.testing.assert_array_equal(tb["valid"], jb["valid"])
        np.testing.assert_array_equal(td["ball_clipped"], jd["ball_clipped"])
        for c in range(PROD_CAMS):
            slots = _slot_map(tb, jb, c)
            tk, jk = _kept(td, c), _kept(jd, c)
            assert sorted(tk) == sorted(jk), (f, c)
            for bid, (pos, orient, score, tid, blobs) in jk.items():
                np.testing.assert_allclose(tk[bid][0], pos, atol=0.5)
                np.testing.assert_allclose(tk[bid][1], orient, atol=1e-3)
                np.testing.assert_allclose(tk[bid][2], score, rtol=1e-4)
                assert tk[bid][3] == tid, (f, c, bid)
                assert tk[bid][4] == frozenset(slots.get(b, b) for b in blobs), (f, c, bid)
        for key in ("bot_valid", "ball_valid", "colors7"):
            np.testing.assert_array_equal(tf[key], jf[key], err_msg=f"{f} {key}")
        v = jf["bot_valid"]
        np.testing.assert_array_equal(tf["bot_id"][v], jf["bot_id"][v])
        np.testing.assert_allclose(tf["bot_world"][v], jf["bot_world"][v], atol=0.5)
        b = jf["ball_valid"]
        np.testing.assert_allclose(tf["ball_world"][b], jf["ball_world"][b], atol=0.5)
        for c in range(OUTAGE_CAM):
            planted = sorted(b.bot_id + (16 if b.team == "blue" else 0)
                             for b in scenes[c].bots)
            assert sorted(int(i) for i in tf["bot_id"][c][tf["bot_valid"][c]]) == planted
        prev, colors = jg, jf["colors7"]


def test_handoff_on_a_world_of_8(worlds):
    """(c) the world of 8 at 192x144: ``check_handoff`` against the JAX
    rollout on the 8 virtual devices, and every rank's cameras stepped."""
    data, spec, outs = worlds["handoff"]
    check_handoff(data, spec, outs, HANDOFF_WORLD)
    fin = _by_camera(outs, "fused.0.fin")
    assert fin["bot_valid"].shape[0] == HANDOFF_WORLD
