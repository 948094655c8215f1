"""The PyTorch port's fused combo chain (kernel B6) against the JAX package.

``combo_chain``'s plain version is held against the JAX package's
``combo_chain`` in the Pallas interpreter (as tests/test_combo_pallas.py
runs it), on the JAX test's random maps, on maps of real pattern rings and
on anchors with no qualifying combo. The detector's fused branch is held
against its unfused chain on the CPU by forcing the switch. The kernel
itself runs only on the card (``-m cuda``).

Tolerance: the JAX package on the CPU computes ``lax.rsqrt`` approximately
and turns its divisions by 5 and 10 into products with the reciprocals;
the port divides exactly and takes a correctly rounded 1 / sqrt, as the
CUDA kernel does. Orientation and position agree to 1e-5 relative and the
winners are equal except between combos whose scores lie within 4 ulp.
Scores agree within 4 ulp on the JAX test's random maps; on real rings the
slot offsets cancel (blob minus predicted position, a few mm out of
metres), which magnifies those ulps to 1e-4 relative of the score.
"""
from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu.ops.combo_pallas import combo_chain as j_combo_chain
from vision_processor_tpu_torch.models import detector as D
from vision_processor_tpu_torch.models.pattern import PATTERN_POS
from vision_processor_tpu_torch.ops import combo_fused as CF
from vision_processor_tpu_torch.ops import cuda

COMBOS, W_COS, W_SIN, COUNT9, ONEHOT, COMBO_MAX = D._detection_onehot_tables(8)
C = COMBOS.shape[0]
CP = -(-C // 128) * 128  # the JAX caller's 128-lane padding
PAT = PATTERN_POS.astype(np.float32)
PBAR = PAT.sum(axis=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread is as fast and leaves the
    cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _random_inputs(a: int, seed: int = 3):
    """The JAX test's maps: normal(0, 50), positions x10, some zero
    orientation accumulators, random ring counts and validity."""
    rng = np.random.default_rng(seed)
    maps = rng.normal(0, 50, (12, a, C)).astype(np.float32)
    maps[2:] *= 10
    maps[0:2, 3] = 0.0
    anchor_pos = rng.normal(0, 1000, (a, 2)).astype(np.float32)
    ring_count = rng.integers(0, 9, a).astype(np.int32)
    anchor_valid = rng.random(a) > 0.2
    return maps, anchor_pos, ring_count, anchor_valid


def _ring_inputs(a: int, seed: int = 5):
    """Maps of real rings: a robot pattern (2 mm noise) around each anchor
    plus 4 clutter blobs, the ring sorted by angle as the detector sorts
    it, through the detector's one-hot tables."""
    rng = np.random.default_rng(seed)
    ring9 = np.zeros((a, 9, 2), np.float32)
    for i in range(a):
        centre = rng.uniform(-4000, 4000, 2)
        th = rng.uniform(-np.pi, np.pi)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        pts = centre + PAT @ rot.T + rng.normal(0, 2, (5, 2))
        ring = np.concatenate([pts[1:], centre + rng.uniform(-90, 90, (4, 2))])
        d = ring - pts[0]
        ring9[i, 0] = pts[0]
        ring9[i, 1:] = ring[np.argsort(np.arctan2(d[:, 1], d[:, 0]))]
    d9 = ring9[:, None] - ring9[:, :, None]
    r2 = d9[..., 0] * d9[..., 0] + d9[..., 1] * d9[..., 1]
    inv = np.where(r2 > 0, 1 / np.sqrt(np.where(r2 > 0, r2, 1)), 0).astype(np.float32)
    u2 = np.concatenate([(d9[..., 0] * inv).reshape(a, 81),
                         (d9[..., 1] * inv).reshape(a, 81)], -1)
    x, y = ring9[..., 0], ring9[..., 1]
    maps = [u2 @ W_COS, u2 @ W_SIN, x @ COUNT9, y @ COUNT9]
    maps += [x @ ONEHOT[s].T for s in range(4)] + [y @ ONEHOT[s].T for s in range(4)]
    ring_count = np.full(a, 8, np.int32)
    ring_count[::7] = 3  # below the 4-blob anchor gate
    anchor_valid = np.ones(a, bool)
    anchor_valid[1::9] = False
    return (np.stack(maps).astype(np.float32), ring9[:, 0].copy(), ring_count,
            anchor_valid)


def _jax(maps, anchor_pos, ring_count, anchor_valid):
    pad = np.zeros((12, maps.shape[1], CP), np.float32)
    pad[:, :, :C] = maps
    m = [jnp.asarray(p) for p in pad]
    out = j_combo_chain(m[0], m[1], m[2], m[3], m[4:8], m[8:12], jnp.asarray(anchor_pos),
                        jnp.asarray(ring_count), jnp.asarray(anchor_valid), COMBO_MAX,
                        C, PAT, PBAR, interpret=True)
    return [np.asarray(o) for o in out]


def _port(maps, anchor_pos, ring_count, anchor_valid, device="cpu"):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return CF.combo_chain(t(maps), t(anchor_pos), t(ring_count), t(anchor_valid),
                          t(COMBO_MAX), PAT, PBAR)


def _ulps(x, y) -> np.ndarray:
    x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
    return np.abs(x.astype(np.float64) - y) / np.spacing(np.maximum(np.abs(x), np.abs(y)))


def _check(got, want, score_tol):
    """The tolerance of the module docstring; ``score_tol`` is ("ulp", 4)
    or ("rel", 1e-4)."""
    got = [g.numpy() for g in got]
    kind, tol = score_tol
    if kind == "ulp":
        assert _ulps(got[0], want[0]).max() <= tol
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=tol, atol=0)
    same = got[5] == want[5]
    # a winner may differ only where two combos tie within 4 ulp
    assert np.all(_ulps(want[0][~same], got[0][~same]) <= 4)
    for g, w in zip(got[1:5], want[1:5]):
        np.testing.assert_allclose(g[same], w[same], rtol=1e-5, atol=1e-6)
    assert same.mean() > 0.9


def test_combo_chain_matches_jax_random_maps():
    inputs = _random_inputs(24)
    before = cuda.LAUNCHES["combo_chain"]
    got = _port(*inputs)
    assert cuda.LAUNCHES["combo_chain"] == before  # CPU: the plain version
    assert [g.shape for g in got] == [(24,)] * 6 and got[5].dtype == torch.int32
    _check(got, _jax(*inputs), ("ulp", 4))


def test_combo_chain_matches_jax_on_rings():
    inputs = _ring_inputs(40)
    got = _port(*inputs)
    want = _jax(*inputs)
    _check(got, want, ("rel", 1e-4))
    ok = (inputs[2] >= 4) & inputs[3]
    assert (want[0][ok] > 0.5).all() and (want[0][~ok] == 0).all()


def test_combo_chain_all_invalid_anchor():
    """Anchors with no qualifying combo: score 0, combo 0 (the argmax tie
    rule) and combo 0's orientation and position."""
    a = 8
    maps = np.zeros((12, a, C), np.float32)
    maps[0] = 1.0
    inputs = (maps, np.zeros((a, 2), np.float32), np.array([8, 3, 0, 8, 8, 2, 1, 8], np.int32),
              np.array([False, True, True, False, False, True, True, False]))
    got = [g.numpy() for g in _port(*inputs)]
    want = _jax(*inputs)
    assert (got[0] == 0).all() and (want[0] == 0).all()
    assert (got[5] == 0).all() and (want[5] == 0).all()
    np.testing.assert_array_equal(got[1], want[1])  # cos 1
    np.testing.assert_array_equal(got[2], want[2])  # sin 0
    for g, w in zip(got[3:5], want[3:5]):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_combo_chain_matches_jax_tail_anchors():
    """A non-round A (72: a 64-anchor TPU block and a tail of 8), exact
    ties between combos 7 and 40 on every fifth anchor, random ring counts
    and invalid anchors, within the random maps' tolerance."""
    maps, anchor_pos, ring_count, anchor_valid = _random_inputs(72, seed=8)
    maps[:, ::5, 40] = maps[:, ::5, 7]
    ring_count[::5] = 8
    anchor_valid[::5] = True
    anchor_valid[1::6] = False
    inputs = (maps, anchor_pos, ring_count, anchor_valid)
    got = _port(*inputs)
    want = _jax(*inputs)
    _check(got, want, ("ulp", 4))
    ok = (ring_count >= 4) & anchor_valid
    assert (~ok).any() and (got[0].numpy()[~ok] == 0).all()
    assert (got[5].numpy()[~ok] == 0).all()
    tied = np.zeros(72, bool)
    tied[::5] = True
    assert (got[5].numpy()[tied] != 40).all()  # a tie goes to the lower combo


# every A the smoke and the card tests launch, a tail A, and C of the
# default ring beside combo counts off the warp grid and above MAX_THREADS
@pytest.mark.parametrize("a", [1, 33, 128, 130, 512])
@pytest.mark.parametrize("c", [C, 1, 31, 33, 513, 1000])
def test_combo_plan_fits_a_block(a, c):
    blocks, threads = CF.combo_plan(a, c)
    assert blocks == a  # one block per anchor
    assert threads % 32 == 0 and 32 <= threads <= CF.MAX_THREADS <= 1024
    # the launch bound holds a thread to 65536 / MAX_THREADS registers
    assert threads * (65536 // CF.MAX_THREADS) <= 65536
    assert threads == min(-(-c // 32) * 32, CF.MAX_THREADS)  # every combo a thread
    if c == C:
        assert threads == 288  # 9 warps, one combo each


def test_combo_plan_matches_the_kernel_bound():
    """MAX_THREADS is the kernel's launch bound, kMaxThreads."""
    src = (Path(CF.__file__).parents[1] / "csrc" / "combo.cu").read_text()
    assert f"constexpr int kMaxThreads = {CF.MAX_THREADS};" in src
    assert "__launch_bounds__(kMaxThreads)" in src
    with pytest.raises(ValueError):
        CF.combo_plan(4, 0)


def test_use_combo_kernel_switch(monkeypatch):
    """Read at call time; only a CUDA tensor ever takes the kernel."""
    cpu = torch.zeros(1)
    monkeypatch.delenv("VPTPU_COMBO_KERNEL", raising=False)
    assert not CF.use_combo_kernel(cpu)
    monkeypatch.setenv("VPTPU_COMBO_KERNEL", "1")
    assert not CF.use_combo_kernel(cpu)


def _blobs(seed: int = 11, k: int = 64):
    """Blob slots with two robot patterns and clutter."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-800, 800, (k, 2)).astype(np.float32)
    for i, (cx, cy, th) in enumerate(((-300.0, 100.0, 0.4), (350.0, -200.0, -2.1))):
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        pos[5 * i: 5 * i + 5] = np.array([cx, cy]) + PAT @ rot.T + rng.normal(0, 1, (5, 2))
    valid = np.ones(k, bool)
    valid[-10:] = False
    return torch.from_numpy(pos), torch.from_numpy(valid)


def test_detector_fused_branch_matches_unfused(monkeypatch):
    """With the switch forced on the CPU, ``_window_hypotheses`` writes the
    twelve matmuls into combo_chain's buffer and takes its winners: the
    same hypotheses as the unfused chain."""
    pos, valid = _blobs()
    cfg = D.DetectorConfig(max_blobs=64, max_anchors=32, max_anchors_tier=0)
    want = D.detection_hypotheses(cfg, pos, valid, 90.0)
    calls = []
    chain = CF.combo_chain

    def recorded(maps, *args):
        calls.append(tuple(maps.shape))
        return chain(maps, *args)

    monkeypatch.setattr(CF, "use_combo_kernel", lambda t: True)
    monkeypatch.setattr(CF, "combo_chain", recorded)
    got = D.detection_hypotheses(cfg, pos, valid, 90.0)
    assert calls == [(12, 32, C)]
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"].numpy())
    assert int(want["valid"].sum()) >= 2
    np.testing.assert_array_equal(got["blob_idx"].numpy(), want["blob_idx"].numpy())
    np.testing.assert_allclose(got["score"].numpy(), want["score"].numpy(), rtol=1e-4)
    np.testing.assert_allclose(got["orientation"].numpy(), want["orientation"].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(got["pos"].numpy(), want["pos"].numpy(), atol=1e-3)


def _card_args(inputs, device):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    maps, anchor_pos, ring_count, anchor_valid = inputs
    return (t(maps), t(anchor_pos), t(ring_count), t(anchor_valid), t(COMBO_MAX), PAT, PBAR)


def _assert_kernel_equals_plain(args):
    before = cuda.LAUNCHES["combo_chain"]
    got = CF.combo_chain(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["combo_chain"] == before + 1
    want = CF._combo_chain_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("a", [1, 33, 128, 512])
def test_combo_chain_kernel_on_card(a, cuda_device):
    """Bit-equal to the plain version on the card, with tied combos and
    anchors with no qualifying combo; A = 1 and 33 are tails of the TPU's
    64-anchor blocks (A = 1 is one gated-off anchor)."""
    maps, anchor_pos, ring_count, anchor_valid = _ring_inputs(a)
    maps[:, ::5, 40] = maps[:, ::5, 7]  # exact ties: combo 7 must win
    _assert_kernel_equals_plain(_card_args((maps, anchor_pos, ring_count, anchor_valid),
                                           cuda_device))


@pytest.mark.cuda
def test_combo_chain_kernel_all_gated_off_on_card(cuda_device):
    """Every anchor fails the gate (ring count below 4 or invalid): score 0,
    combo 0 and combo 0's orientation and position, as in the plain
    version."""
    maps, anchor_pos, ring_count, anchor_valid = _ring_inputs(128)
    ring_count[::2] = 3
    anchor_valid[1::2] = False
    got = _assert_kernel_equals_plain(_card_args((maps, anchor_pos, ring_count,
                                                  anchor_valid), cuda_device))
    assert bool((got[0] == 0).all()) and bool((got[5] == 0).all())
