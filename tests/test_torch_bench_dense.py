"""The port's bench measurements that run the detection step
(vision_processor_tpu_torch/bench.py ``measure_dense_precision``, the
rollout of ``measure_device_sustained``, ``measure_dense_tracked``)
against bench.py's on the CPU, on the same dense rig: 2 cameras of
bench.py's 960x540 models (they see half their planted robots), max_blobs
600, 40 extra blobs a camera, factor 1.25, the gather resample (bit-exact
between the packages). Counts, recall strings and the precision dict must
be equal.
"""
from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench as JB  # noqa: E402

from vision_processor_tpu_torch import bench as PB  # noqa: E402

FULL = dict(n_cams=2, max_blobs=600)  # bench.py's 960x540 models
DENSE = dict(dense=True, dense_blobs=40, return_scenes=True)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_finisher(cams, n_cams):
    from vision_processor_tpu.models.colors import ColorState
    from vision_processor_tpu.models.device_finish import pack_field_marks

    marks_one = pack_field_marks(cams[0][1].field, 10.0)
    marks = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *([marks_one] * n_cams))
    refs = jnp.asarray(np.stack([ColorState().packed_refs()] * n_cams))
    return refs, marks


@pytest.fixture(scope="module")
def dense_full():
    """The dense 960x540 rig in the gather mode, both packages."""
    kw = dict(FULL, **DENSE, resampling_factor=1.25, resample_mode="gather")
    return JB.build_rig(**kw), PB.build_rig(**kw, device=CPU)


# (d) -----------------------------------------------------------------------


def test_dense_precision_equals_bench(dense_full):
    j, p = dense_full
    want = JB.measure_dense_precision(j[0], j[1], *j[2:7], j[9],
                                      *_jax_finisher(j[8], j[0].n_cams))
    got = PB.measure_dense_precision(p[0], p[1], *p[2:7], p[9],
                                     *PB.finisher_inputs(p[8], p[0].n_cams, CPU),
                                     device=CPU)
    assert got == want
    assert want["dense_bots_device_untracked"] > 0


# (e) -----------------------------------------------------------------------


def test_rollout_equals_bench(dense_full):
    from vision_processor_tpu.parallel import multicam as JM

    j, p = dense_full
    refs, marks = _jax_finisher(j[8], j[0].n_cams)
    bank = np.stack([np.roll(j[1], (2 * i, 4 * i), axis=(1, 2)) for i in range(4)])
    _, compact = JM.make_rollout(j[0], JM.batched_step(j[0]), 2)(
        bank, *j[2:7], refs, marks)
    want_bots = int(np.asarray(compact["bot_valid"][-1]).sum())
    want_counts = np.asarray(compact["count"][-1]).tolist()

    rolls = PB.build_rollouts(p[0], 2)
    assert set(rolls) == {2}
    span, bots, counts, aux = PB.measure_device_sustained(
        rolls, *p[:7], *PB.finisher_inputs(p[8], p[0].n_cams, CPU), rounds=1,
        device=CPU)
    assert span is None and aux["ms_band"] is None and aux["busy_share"] is None
    assert (bots, counts) == (want_bots, want_counts)
    assert bots > 0
    assert PB.bot_recall(aux["compact"], p[9]) == JB.bot_recall(
        jax.device_get(compact), j[9])


# (f) -----------------------------------------------------------------------


@pytest.mark.parametrize("veto", [False, True])
def test_dense_tracked_equals_bench(dense_full, veto):
    j, p = dense_full
    suffix = "_veto" if veto else ""
    want = JB.measure_dense_tracked(j[0], j[1], *j[2:7], j[8], j[7], j[9], n_frames=2,
                                    veto=veto, suffix=suffix)
    got = PB.measure_dense_tracked(p[0], p[1], *p[2:7], p[8], p[7], p[9], n_frames=2,
                                   veto=veto, suffix=suffix, device=CPU)
    assert list(got) == list(want)
    for k in ("dense_noise_first_frame", "dense_recall_tracked_t20"):
        assert got[k + suffix] == want[k + suffix]
