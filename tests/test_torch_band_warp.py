"""Kernel E1, the banded warp pass with window starts: the port's plain
version against the TPU kernel (``experiments/pallas_band_warp.py``
``band_warp_pallas`` in interpret mode) and against the experiment's 2-tap
``reference`` at a shape whose windows fit, the precondition check, and, on
the card, the CUDA kernel against the plain version, bit for bit.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu_torch.ops import band_warp as BW
from vision_processor_tpu_torch.ops import cuda
from vision_processor_tpu_torch.ops import warp as W

ROOT = Path(__file__).resolve().parents[1]
WIN = 16


@pytest.fixture(scope="module")
def pallas_band_warp():
    """experiments/pallas_band_warp.py, imported by path (its main() does
    not run)."""
    spec = importlib.util.spec_from_file_location(
        "experiments_pallas_band_warp", ROOT / "experiments" / "pallas_band_warp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(ch=4, r=40, c=256, n_out=32, seed=0):
    """The experiment's inputs at a small shape: u8-valued source, a bent
    linear ramp of positions, per-channel quarter-pixel offsets."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (ch, r, c)).astype(np.float32)
    base = np.linspace(1.0, r - 3.0, n_out)
    bend = np.sin(np.linspace(0, np.pi, c)) * 4.0
    pos = np.clip(base[:, None] + bend[None, :] * (base[:, None] / r - 0.5),
                  1.0, r - 3.0).astype(np.float32)
    pos4 = np.stack([pos, pos, pos + 0.25, pos + 0.25])[:ch].astype(np.float32)
    return src, pos, pos4


def test_plain_matches_the_tpu_kernel(pallas_band_warp):
    src, pos, pos4 = _case()
    r0 = pallas_band_warp.block_starts_2d(pos, WIN, src.shape[1])
    want = np.asarray(pallas_band_warp.band_warp_pallas(
        jnp.asarray(src), jnp.asarray(pos4), jnp.asarray(r0), WIN, interpret=True))
    t_r0 = BW.block_starts(torch.from_numpy(pos), WIN, src.shape[1])
    np.testing.assert_array_equal(t_r0.numpy(), r0)
    before = dict(cuda.LAUNCHES)
    got = BW.band_warp(torch.from_numpy(src), torch.from_numpy(pos4), t_r0, WIN)
    assert cuda.LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.shape == want.shape == (4, 32, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    ref = pallas_band_warp.reference(src, pos4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    # B1's function: the two taps at floor(pos)
    b1 = W.band_pass(torch.from_numpy(src), torch.from_numpy(pos4))
    np.testing.assert_allclose(got.numpy(), b1.numpy(), rtol=0, atol=1e-4)


def _edge_case(seed=0, ch=2, r=48, c=256, n_out=16, win=WIN):
    """Inputs at E1's edges: per-block starts, positions on integers, at
    win - 1 and at 0 of their window (and between), u8-valued sources with
    +inf, -inf and NaN placed in window columns outside the two taps of
    every output of that column, plus one column with a NaN at a tap."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (ch, r, c)).astype(np.float32)
    nb, nt = n_out // 8, c // 128
    r0 = rng.integers(0, r - win + 1, (nb, nt)).astype(np.int32)
    rel = rng.uniform(2.0, win - 4.0, (ch, n_out, c)).astype(np.float32)
    rel[:, :, 0::8] = np.floor(rel[:, :, 0::8])  # integer p
    rel[:, :, 1::8] = win - 1  # the last row of the window
    rel[:, :, 2::8] = 0.0
    rel[:, :, 3] = 5.5  # a column whose taps are rows 5 and 6 of its window
    rel[:, :, 4] = 7.0  # taps 7 (weight 1) and 8 (weight 0)
    rel[:, :, 5] = 3.25
    pos = (np.repeat(np.repeat(r0, 8, 0), 128, 1)[None] + rel).astype(np.float32)
    for b in range(nb):
        for t in range(nt):
            base = r0[b, t]
            src[:, base + 12, t * 128 + 3] = np.inf  # rows 5, 6 are the taps
            src[:, base + 0, t * 128 + 4] = np.nan
            src[:, base + win - 1, t * 128 + 5] = -np.inf
            src[:, base + 6, t * 128 + 6] = np.nan  # at a tap of some outputs
    return src, pos, r0, win


def _chain(src, pos, r0, win, fused, taps=False):
    """numpy f32 hat sum over the window in k order from +0: each term
    rounded then added (``fused`` False), or acc + w * s rounded once (a
    fused multiply-add, exact in f64 at these magnitudes). ``taps``: only
    k = floor(p) and floor(p) + 1, the kernel's two-tap sum."""
    rows = np.repeat(np.repeat(r0, 8, 0), 128, 1)[None].astype(np.int64)
    p = (pos - rows.astype(np.float32)).astype(np.float32)
    f = np.floor(p)
    acc = np.zeros_like(pos)
    with np.errstate(invalid="ignore"):
        for k in range(win):
            w = np.maximum(np.float32(1) - np.abs(p - np.float32(k)), np.float32(0))
            s = np.take_along_axis(src, np.broadcast_to(rows + k, pos.shape), 1)
            if fused:
                new = (acc.astype(np.float64) + w.astype(np.float64) * s).astype(np.float32)
            else:
                new = (acc + (w * s).astype(np.float32)).astype(np.float32)
            acc = np.where((k == f) | (k == f + 1), new, acc) if taps else new
    return acc


def test_plain_matches_the_tpu_kernel_at_the_edges(pallas_band_warp):
    """Tolerance 0 on every output, each against the chain its arithmetic
    runs: the port's plain version rounds each product and then each sum,
    as the kernel on the card does with its round-to-nearest intrinsics;
    the TPU kernel in interpret mode runs on XLA's CPU backend, which
    fuses acc + w * s into one multiply-add, so it equals the fused chain
    (the two differ by 1 ulp at some outputs). A non-finite source
    anywhere in a window column reaches every output of that column
    through 0 * inf or 0 * NaN in both, NaN for NaN. Where the column is
    finite, the kernel's two-tap sum equals the win-tap chain bit for bit
    (csrc/band_warp.cu's header comment proves it)."""
    src, pos, r0, win = _edge_case()
    want = np.asarray(pallas_band_warp.band_warp_pallas(
        jnp.asarray(src), jnp.asarray(pos), jnp.asarray(r0), win, interpret=True))
    got = BW.band_warp(torch.from_numpy(src), torch.from_numpy(pos),
                       torch.from_numpy(r0), win).numpy()
    np.testing.assert_array_equal(got, _chain(src, pos, r0, win, fused=False))
    np.testing.assert_array_equal(want, _chain(src, pos, r0, win, fused=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[np.isinf(got)], want[np.isinf(got)])
    bad = ~np.isfinite(got)
    cols = np.flatnonzero(bad.any(axis=(0, 1)))
    assert set(cols % 128) == {3, 4, 5, 6}
    assert bad[:, :, cols].all()
    two = _chain(src, pos, r0, win, fused=False, taps=True)
    np.testing.assert_array_equal(two[~bad], got[~bad])


def test_precondition_is_checked():
    src, pos, pos4 = _case()
    t_src, t_pos = torch.from_numpy(src), torch.from_numpy(pos4)
    r0 = BW.block_starts(torch.from_numpy(pos), WIN, src.shape[1])
    with pytest.raises(ValueError):  # a block's positions span more than the window
        BW.block_starts(torch.from_numpy(pos), 4, src.shape[1])
    with pytest.raises(ValueError):  # positions below their window
        BW.band_warp(t_src, t_pos, r0 + 1, WIN)
    with pytest.raises(ValueError):  # a window past the source's last row
        BW.band_warp(t_src, t_pos, torch.full_like(r0, src.shape[1] - WIN + 1), WIN)
    with pytest.raises(ValueError):  # positions past their window
        BW.band_warp(t_src, t_pos + 20.0, r0, WIN)
    with pytest.raises(ValueError):  # C not a multiple of 128
        BW.band_warp(t_src[..., :200], t_pos[..., :200], r0, WIN)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_edges_on_card(cuda_device):
    """Bit-equal, NaN for NaN, where the two-tap sum stands in for the
    win-tap chain (integer p, p = 0 and win - 1) and where a non-finite
    source makes the kernel run the whole chain; and on E1's contract
    inputs (src (4, 720, 896), pos (4, 432, 896), win 16)."""
    src, pos, r0 = (torch.from_numpy(a).to(cuda_device) for a in _edge_case()[:3])
    win = WIN
    got = BW.band_warp(src, pos, r0, win)
    want = BW._band_warp_plain(src, pos, r0, win)
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    assert torch.equal(got.isnan(), want.isnan())
    assert not torch.isfinite(got).all()
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (4, 720, 896)).astype(np.float32)
    base = np.linspace(1.0, 717.0, 432)
    bend = np.sin(np.linspace(0, np.pi, 896)) * 4.0
    pos = np.clip(base[:, None] + bend[None, :] * (base[:, None] / 720 - 0.5),
                  1.0, 717.0).astype(np.float32)
    pos4 = np.stack([pos, pos, pos + 0.25, pos + 0.25]).astype(np.float32)
    src, pos, pos4 = (torch.from_numpy(a).to(cuda_device) for a in (src, pos, pos4))
    r0 = BW.block_starts(pos, WIN, 720)
    assert torch.equal(BW.band_warp(src, pos4, r0, WIN),
                       BW._band_warp_plain(src, pos4, r0, WIN))


@pytest.mark.cuda
@pytest.mark.parametrize("win", [16, 120])
def test_kernel_matches_plain_on_card(cuda_device, win):
    """Bit-equal; win 120 takes more than 48 KB of shared memory."""
    src, pos, pos4 = _case(r=160, c=384, n_out=128, seed=win)
    src, pos, pos4 = (torch.from_numpy(a).to(cuda_device) for a in (src, pos, pos4))
    r0 = BW.block_starts(pos, win, src.shape[1])
    n = cuda.LAUNCHES["band_warp"]
    got = BW.band_warp(src, pos4, r0, win)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["band_warp"] == n + 1
    assert torch.equal(got, BW._band_warp_plain(src, pos4, r0, win))
