"""Banded 1-D warp pass with window starts (kernel E1): counterpart of
experiments/pallas_band_warp.py (``band_warp_pallas``), the prototype of
the warp's band pass (kernel B1, ops/warp.py ``band_pass``).

``band_warp(src, pos, r0, win)`` resamples ``src`` (ch, R, C) f32 along
axis 1 at ``pos`` (ch, n_out, C) f32: each (8-row, 128-column) output block
reads the ``win`` source rows from its window start ``r0[block, tile]``
((n_out / 8, C / 128) i32) and sums the hat-weighted taps
max(0, 1 - |pos - r0 - k|), k < win, as the TPU kernel does. This is B1's
function (the two taps at floor(pos)) up to rounding, wherever E1's
precondition holds: every window lies in the source and every position in
its block's window (0 <= pos - r0 <= win - 1). The wrapper checks it and
raises ``ValueError`` if not. ``block_starts`` builds such starts, as the
experiment's ``block_starts_2d`` does.

On the card ``band_warp`` launches the CUDA kernel of ``csrc/band_warp.cu``
(a thread per output column of a block: its window column staged, then the
two taps at floor(pos - r0), or all ``win`` where the column holds a
non-finite source); ``_band_warp_plain`` is the plain PyTorch version, used
for CPU tensors and held against the kernel on the card, which is
bit-equal to it (the kernel's header comment proves it). No production path calls it: B1 is the
band pass of the warp; E1 runs at its own contract, measured beside B1 by
``chip_smoke.py``.
"""
from __future__ import annotations

import torch

from . import cuda

BLK = 8     # output rows per block
LAN = 128   # output columns per block
_MAX_WIN = 400  # the window's shared memory: 400 x 128 x 4 bytes = 200 KB


def _rows(r0: torch.Tensor) -> torch.Tensor:
    """(n_out / 8, C / 128) window starts -> (n_out, C), one per output."""
    return r0.repeat_interleave(BLK, 0).repeat_interleave(LAN, 1)


def block_starts(pos: torch.Tensor, win: int, n_src: int) -> torch.Tensor:
    """(n_out / 8, C / 128) i32 window starts covering every 2-tap stencil
    of each (8, 128) block of ``pos`` (n_out, C); raises ``ValueError``
    when a block's positions span more than ``win`` rows."""
    n_out, c = pos.shape
    p = pos.reshape(n_out // BLK, BLK, c // LAN, LAN)
    lo = torch.floor(p.amin(dim=(1, 3)))
    hi = torch.ceil(p.amax(dim=(1, 3))) + 1
    span = int((hi - lo).max())
    if span > win - 1:
        raise ValueError(f"band_warp: window {win} too small for span {span}+1")
    return lo.clamp(0, n_src - win).to(torch.int32)


def check_windows(src: torch.Tensor, pos: torch.Tensor, r0: torch.Tensor, win: int) -> None:
    """E1's precondition (one device->host read on the card): shapes, every
    window inside the source, every position inside its block's window."""
    if src.dim() != 3 or pos.dim() != 3 or r0.dim() != 2:
        raise ValueError(f"band_warp: src {tuple(src.shape)}, pos {tuple(pos.shape)}, "
                         f"r0 {tuple(r0.shape)}")
    ch, r, c = src.shape
    n_out = pos.shape[1]
    if (pos.shape[0] != ch or pos.shape[2] != c or c % LAN or n_out % BLK
            or tuple(r0.shape) != (n_out // BLK, c // LAN) or not 1 <= win <= r):
        raise ValueError(f"band_warp: src {tuple(src.shape)}, pos {tuple(pos.shape)}, "
                         f"r0 {tuple(r0.shape)}, win {win}: C must be a multiple of "
                         f"{LAN}, n_out of {BLK}, r0 one start per block, win <= R")
    rel = pos - _rows(r0).to(pos.dtype)
    ok = ((r0 >= 0).all() & (r0 <= r - win).all() & (rel >= 0).all()
          & (rel <= win - 1).all())
    if not bool(ok):
        raise ValueError("band_warp: a window leaves the source or a position leaves "
                         "its block's window (0 <= pos - r0 <= win - 1)")


def _band_warp_plain(src: torch.Tensor, pos: torch.Tensor, r0: torch.Tensor,
                     win: int) -> torch.Tensor:
    """Plain PyTorch version of kernel E1: the hat-weighted window sum."""
    rows = _rows(r0).to(torch.int64).expand(pos.shape)
    p = pos - rows.to(pos.dtype)
    acc = torch.zeros_like(pos)
    for k in range(win):
        wgt = torch.clamp_min(1.0 - (p - k).abs(), 0.0)
        acc = acc + wgt * torch.gather(src, 1, rows + k)
    return acc


def band_warp(src: torch.Tensor, pos: torch.Tensor, r0: torch.Tensor,
              win: int) -> torch.Tensor:
    """1-D linear resample of ``src`` (ch, R, C) along axis 1 at ``pos``
    (ch, n_out, C) through the per-block windows ``r0`` of ``win`` rows ->
    (ch, n_out, C) f32 (``band_warp_pallas``'s contract)."""
    check_windows(src, pos, r0, win)
    if not src.is_cuda:
        return _band_warp_plain(src, pos, r0, win)
    return _launch(src, pos, r0, win)


def _launch(src: torch.Tensor, pos: torch.Tensor, r0: torch.Tensor,
            win: int) -> torch.Tensor:
    """The kernel launch alone, on inputs ``check_windows`` has passed."""
    cuda.require(src, "src", torch.float32, 3)
    cuda.require(pos, "pos", torch.float32, 3)
    cuda.require(r0, "r0", torch.int32, 2)
    ch, r, c = src.shape
    n_out = pos.shape[1]
    if win > _MAX_WIN or ch > 65535 or n_out // BLK > 65535:
        raise ValueError(f"band_warp: win {win} (at most {_MAX_WIN}), ch {ch} or "
                         f"{n_out // BLK} row blocks out of the launch's range")
    out = torch.empty((ch, n_out, c), dtype=torch.float32, device=src.device)
    rc = cuda.lib().vp_band_warp(src.data_ptr(), pos.data_ptr(), r0.data_ptr(),
                                 out.data_ptr(), ch, r, c, n_out, win, cuda.stream(src))
    cuda.check(rc, "band_warp")
    cuda.LAUNCHES["band_warp"] += 1
    return out
