"""The in-line projection resample through the port's entry points against
the JAX package's, on the same numpy inputs: ``blob_machine`` without a
grid (and against the port's own gather-grid run), ``BlobMachine`` in line
and exact, ``full_step(rs_grid=None)`` and the camera batch with
``rs_grids=None`` (``batched_step`` with summary feedback, the host-tracked
step and the staggered core).

The rig is the 2-camera rig of tests/test_torch_multicam.py (480x270
models, 2 bots + ball each, max_blobs 256), shared from there. Tolerances
as there: blob
counts, validity, ids, ball sets and colour tables equal; field positions
within 0.5 mm, orientations within 1e-3, scores within 1e-4 relative; the
in-line blobs within 0.05 mm of the gather grid's (the JAX package's
``test_grid_cache_through_blob_machine`` bound).
"""
from __future__ import annotations

from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_multicam import IDS, MAXH, _assert_det, _assert_fin, _jax, rig  # noqa: F401

from vision_processor_tpu.app import processor as JP
from vision_processor_tpu.app.processor import TrackedArrays as JTracked
from vision_processor_tpu.ops import pipeline as JPL
from vision_processor_tpu.parallel import multicam as JM
from vision_processor_tpu_torch.app import processor as P
from vision_processor_tpu_torch.ops import cuda
from vision_processor_tpu_torch.ops import pipeline as PL
from vision_processor_tpu_torch.parallel import multicam as M
from vision_processor_tpu_torch.utils.state import to_numpy, to_torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _own(rig, c: int) -> dict:
    """Camera c's own field scale and offset, as its configuration holds them."""
    return dict(field_scale=float(rig.inputs["scales"][c]),
                field_offset=tuple(float(o) for o in rig.inputs["offsets"][c]))


def _assert_blobs(t, j, atol=0.5):
    np.testing.assert_array_equal(t["count"], np.asarray(j["count"]))
    np.testing.assert_array_equal(t["valid"], np.asarray(j["valid"]))
    v = np.asarray(j["valid"])
    np.testing.assert_allclose(t["field_pos"][v], np.asarray(j["field_pos"])[v], atol=atol)


def test_blob_machine_inline_matches_jax_and_the_grid(rig):
    """Camera 1 with its own scale and offset, as a camera batch passes
    them: the in-line blob machine against the JAX package's, and against
    the port's gather-grid run on the same frame."""
    bm = rig.tcfg.bm
    packed, own = rig.inputs["packed"][1], _own(rig, 1)
    scale, off = own["field_scale"], own["field_offset"]
    want = jax.jit(lambda r: JPL.blob_machine(
        rig.jcfg.bm, r, jnp.asarray(packed), jnp.float32(MAXH), jnp.float32(15.0),
        field_scale=scale, field_offset=off))(jnp.asarray(rig.raws[1]))
    raw, cam = torch.from_numpy(rig.raws[1]), torch.from_numpy(packed)
    before = dict(cuda.LAUNCHES)
    got = to_numpy(PL.blob_machine(bm, raw, cam, torch.tensor(MAXH), torch.tensor(15.0),
                                   field_scale=scale, field_offset=off))
    assert cuda.LAUNCHES == before  # CPU tensors: the plain versions
    _assert_blobs(got, jax.device_get(want))
    assert got["valid"].sum() > 5
    grid = bm.make_resample_grid(cam, MAXH, field_scale=scale, field_offset=off)
    cached = to_numpy(PL.blob_machine(bm, raw, cam, MAXH, 15.0, field_scale=scale,
                                      field_offset=off, rs_grid=grid))
    _assert_blobs(got, cached, atol=0.05)


@pytest.mark.parametrize("exact", [False, True])
def test_blob_machine_class_matches_jax(rig, exact):
    """``BlobMachine`` (in line, or exact per-plane) on camera 0's own
    configuration against the JAX package's."""
    own = dict(_own(rig, 0), max_blobs=64, exact_resample=exact)
    raw, packed = rig.raws[0], rig.inputs["packed"][0]
    want = jax.device_get(JPL.BlobMachine(replace(rig.jcfg.bm, **own))(raw, packed, MAXH,
                                                                        15.0))
    machine = PL.BlobMachine(replace(rig.tcfg.bm, **own), device="cpu")
    got = to_numpy(machine(raw, packed, MAXH, 15.0))
    _assert_blobs(got, want)
    assert got["valid"].sum() >= 11  # 2 bots x 5 + the ball
    with pytest.raises(ValueError):
        machine(raw[:-2], packed, MAXH, 15.0)


def test_full_step_inline_matches_jax(rig):
    """``full_step(rs_grid=None)`` with on-device finishing, camera 0."""
    inp, params = rig.inputs, dict(rig.params, clipping_tolerance=np.float32(10.0))
    tracked = JTracked.build({}, 0.0, 32).as_dict()
    host = (rig.raws[0], inp["packed"][0], inp["colors"][0], tracked, params)
    fin_args = (inp["refs"][0], {k: v[0] for k, v in inp["marks"].items()})
    jstep = jax.jit(partial(JP.full_step, replace(rig.jcfg.bm, **_own(rig, 0)),
                            rig.jcfg.det))
    want = jax.device_get(jstep(*_jax(host), None, *_jax(fin_args)))
    t = to_torch(host + fin_args, "cpu")
    got = to_numpy(P.full_step(replace(rig.tcfg.bm, **_own(rig, 0)), rig.tcfg.det, *t[:5],
                               None, *t[5:]))
    _assert_blobs(got[0], want[0])
    cam_axis = lambda tree: {k: np.asarray(v)[None] for k, v in tree.items()}  # noqa: E731
    _assert_det(cam_axis(got[1]), cam_axis(want[1]))
    _assert_fin(cam_axis(got[2]), cam_axis(want[2]))
    assert set(got[2]["bot_id"][got[2]["bot_valid"]].tolist()) == IDS[0]


def test_batched_step_inline_parity(rig):
    """``batched_step`` with ``rs_grids=None`` over 2 frame-sets, summaries
    fed back, against the JAX package's."""
    inp = rig.inputs
    jstep = JM.batched_step(rig.jcfg)
    tstep = M.batched_step(rig.tcfg)
    jprev = jprev2 = JM.empty_summary(rig.jcfg)
    tprev = tprev2 = M.empty_summary(rig.tcfg, "cpu")
    targs = to_torch((rig.raws, inp["packed"], inp["scales"], inp["offsets"],
                      inp["colors"], rig.params, inp["refs"], inp["marks"]), "cpu")
    for _ in range(2):
        jout = jstep(jnp.asarray(rig.raws), *_jax((inp["packed"], inp["scales"],
                                                   inp["offsets"], inp["colors"])),
                     jprev, _jax(rig.params), None, jprev2, *_jax((inp["refs"],
                                                                  inp["marks"])))
        tout = tstep(*targs[:5], tprev, targs[5], None, tprev2, *targs[6:])
        jn, tn = jax.device_get(jout), to_numpy(tout)
        _assert_blobs(tn[0], jn[0])
        _assert_det(tn[1], jn[1])
        for key in ("id", "score"):
            np.testing.assert_allclose(tn[2][key], np.asarray(jn[2][key]), rtol=1e-4)
        _assert_fin(tn[3], jn[3])
        assert [set(int(i) for i in row if i >= 0) for row in tn[2]["id"]] == list(IDS)
        jprev, jprev2 = jout[2], jprev
        tprev, tprev2 = tout[2], tprev


def test_host_tracked_and_staggered_inline(rig):
    """The host-tracked step and the staggered core with no grids: the
    same blobs as the cached-grid step within 0.05 mm, and the staggered
    core equal to the batched step (``_single_cam_step`` no longer needs a
    grid)."""
    inp = rig.inputs
    t = to_torch((rig.raws, inp["packed"], inp["scales"], inp["offsets"], inp["colors"],
                  JTracked.build({}, 0.0, 32).as_dict(), rig.params), "cpu")
    raws, packed, scales, offsets, colors, tracked, params = t
    grids = M.resample_grids(rig.tcfg, packed, MAXH, scales, offsets)
    step = M.batched_step_host_tracked(rig.tcfg)
    b_blobs, b_det = to_numpy(step(*t))
    g_blobs, _ = to_numpy(step(*t, grids))
    _assert_blobs(b_blobs, g_blobs, atol=0.05)
    assert (b_det["bot_valid"].sum(axis=1) == 2).all()
    core = M.percam_core_step(rig.tcfg)
    for c in range(2):
        blobs, _ = to_numpy(core(raws[c], packed[c], scales[c], offsets[c], colors[c],
                                 tracked, M.params_for_cam(params, c)))
        for key in ("count", "valid", "field_pos"):
            np.testing.assert_array_equal(blobs[key], b_blobs[key][c], err_msg=key)
