"""Fused blob response (kernel B2) and fused circularity (kernel B5):
counterpart of vision_processor_tpu/ops/blob_pallas.py
(``blob_response_fused``, ``response_kernel_fits``, ``circularity_fused``).

One pass produces the score-first extraction inputs from the flat (H, W, 3)
map: the masked score, the circularity and the three disc-mean planes. The
circularity uses LOCAL (r-1)x(r-1) box sums of the gradient dot, as the
TPU kernel does, instead of the global summed-area table of the eager chain
(ops/blob.py), so values agree with the eager chain to f32 reassociation in
the interior and follow the fused kernel's edge-replication policy in the
border band. ``circularity_fused`` computes the circularity alone, for
the circularity-first extraction. On the card the CUDA kernels of
``csrc/blob_fused.cu`` run, that source built once per shape (the radii
and the planned tile as constants, ``kernel_defines``) on the shape's
first call, or ahead of it with ``build_kernels``;
``_blob_response_fused_plain`` and ``_circularity_fused_plain`` are their
plain PyTorch versions, used for CPU tensors and held against the kernels
on the card.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cuda
from .blob import (
    circularity, disc_offsets, edge_pad, gradient_dot, summed_area_table,
)

_NEG_INF = float("-inf")
_SRC = "blob_fused.cu"

# output tiles of the CUDA kernels, in the planner's order of preference
_TILES = ((32, 32), (16, 32), (16, 16), (8, 16), (8, 8), (4, 8), (4, 4),
          (2, 4), (2, 2), (1, 2), (1, 1))
_THREADS = 256  # a block; the tiles of at least this many pixels come first
SMEM_DEFAULT = 48 * 1024  # dynamic shared memory a block gets without opting in
SMEM_MAX = 232448  # 227 KB, the most a block can opt in to on Hopper


class TilePlan(NamedTuple):
    tile_h: int
    tile_w: int
    halo: int
    smem_bytes: int


def _smem_bytes(th: int, tw: int, o: int, r: int, dr: Optional[int]) -> int:
    """Shared memory of one block of ``csrc/blob_fused.cu``: the staged
    flat window (3 planes), the region that holds the gradient and the box
    row sums and, for B2, then the disc-span chains, and B2's circularity
    ring. It mirrors ``make_tile`` there, so that the planner and its CPU
    tests need no card: a change to the layout is made in both places (the
    C entry refuses a plan whose bytes differ from its own)."""
    ext = 0 if dr is None else 1
    p = o + r + ext
    wh, ww = th + 2 * p, tw + 2 * p
    gh, gw = wh - 2 * o, ww - 2 * o
    region = gh * gw + gh * (gw - (r - 2))
    floats = 3 * wh * ww
    if dr is not None:
        ng = len({hw for _, hw in disc_spans(dr) if hw > 0})
        region = max(region, 2 * ng * (th + 2 * dr) * tw)
        floats += (th + 2) * (tw + 2)
    return 4 * (floats + region)


@functools.lru_cache(maxsize=None)
def tile_plan(o: int, r: int, dr: Optional[int] = None) -> TilePlan:
    """The output tile of kernel B2 (``dr`` given) or B5 (``dr`` None):
    the first tile of at least 256 pixels that fits the 48 KB a block gets
    by default, else the first tile of any size within the 227 KB a block
    can opt in to (the C entry then opts in). Raises ValueError where even
    a 1 x 1 tile would need more. Every tile's width is a power of two
    and its rows split evenly over the block's row groups (the C entry
    checks both)."""
    halo = o + r + (0 if dr is None else 1)
    for th, tw in _TILES:
        smem = _smem_bytes(th, tw, o, r, dr)
        if th * tw >= _THREADS and smem <= SMEM_DEFAULT:
            return TilePlan(th, tw, halo, smem)
    for th, tw in _TILES:
        smem = _smem_bytes(th, tw, o, r, dr)
        if smem <= SMEM_MAX:
            return TilePlan(th, tw, halo, smem)
    raise ValueError(f"blob kernels: no tile fits 227 KB of shared memory at "
                     f"o={o} r={r} dr={dr}")


def kernel_defines(o: int, r: int, dr: Optional[int] = None) -> dict:
    """The constants ``csrc/blob_fused.cu`` is built with for kernel B2
    (``dr`` given) or B5 at these radii: the radii and ``tile_plan``'s
    tile. Each distinct set is its own library (ops/cuda.py
    ``shaped_lib``)."""
    plan = tile_plan(o, r, dr)
    defines = {"VP_O": o, "VP_R": r, "VP_TILE_H": plan.tile_h, "VP_TILE_W": plan.tile_w}
    if dr is not None:
        defines["VP_DR"] = dr
    return defines


def build_kernels(shapes) -> None:
    """Build B2 for each (o, r, dr) and B5 for each (o, r, None) of
    ``shapes`` ahead of its first call, every nvcc started together with
    those of the other kernels' library (ops/cuda.py ``build``)."""
    cuda.build([(_SRC, kernel_defines(*s)) for s in shapes])


@functools.lru_cache(maxsize=None)
def _kernel_lib(o: int, r: int, dr: Optional[int]):
    return cuda.shaped_lib(_SRC, kernel_defines(o, r, dr))


@functools.lru_cache(maxsize=None)
def _inv_taps(dr: int) -> float:
    return _f32(1.0 / len(disc_offsets(dr)))


def response_kernel_fits(grad_offset: int, sat_radius: int,
                         disc_radius: int) -> bool:
    return sat_radius >= 2 and disc_radius <= grad_offset + sat_radius + 1


def disc_spans(dr: int) -> list[tuple[int, int]]:
    """(dy, half width) of each disc row, in the TPU kernel's summation
    order: groups of equal half width by ascending width, rows ascending
    inside a group."""
    offs = disc_offsets(dr)
    by_hw: dict = {}
    for dy in range(-dr, dr + 1):
        hw = int(np.max(offs[offs[:, 0] == dy, 1]))
        by_hw.setdefault(hw, []).append(dy)
    return [(dy, hw) for hw in sorted(by_hw) for dy in by_hw[hw]]


def _f32(x: float) -> float:
    """A Python float holding an exactly f32-representable value."""
    return float(np.float32(x))


def _circ_plain(chans, p: int, h: int, w: int, o: int, r: int, ext: int):
    """Circularity on rows/cols [-ext, H + ext) from the three channels
    edge-padded by a margin ``p >= o + r + ext``, in the TPU kernels' op
    order (the circ part of kernels B2 and B5)."""

    def sl(t, y0, ny, x0, nx):
        return t[p + y0: p + y0 + ny, p + x0: p + x0 + nx]

    # gradient dot on rows/cols [-(r+ext), H + r + ext)
    gy0, ngy, ngx = -(r + ext), h + 2 * (r + ext), w + 2 * (r + ext)
    g = None
    for c in chans:
        gx = sl(c, gy0, ngy, gy0 + o, ngx) - sl(c, gy0, ngy, gy0 - o, ngx)
        gy = sl(c, gy0 + o, ngy, gy0, ngx) - sl(c, gy0 - o, ngy, gy0, ngx)
        term = gx * gy
        g = term if g is None else g + term

    # local (r-1)x(r-1) box sums: row sums left to right, then rows
    nbx = ngx - (r - 2)
    acc = g[:, 0:nbx]
    for b in range(1, r - 1):
        acc = acc + g[:, b: b + nbx]
    nby = ngy - (r - 2)
    box = acc[0:nby]
    for a in range(1, r - 1):
        box = box + acc[a: a + nby]

    # B(y + dy, x + dx) over the output rows/cols: box index = coordinate + r + ext
    def bx(dy, dx):
        return box[dy + r: dy + r + h + 2 * ext, dx + r: dx + r + w + 2 * ext]

    pp = bx(2, 2)
    nn = bx(1 - r, 1 - r)
    pn = bx(1 - r, 2)
    np_ = bx(2, 1 - r)
    circ = torch.minimum(torch.minimum(pp, nn), torch.minimum(-pn, -np_))
    return circ * _f32(1.0 / (r * r))


def _blob_response_fused_plain(flat: torch.Tensor, circ_threshold, o: int,
                               r: int, dr: int):
    """Plain PyTorch version of kernel B2, in the TPU kernel's op order."""
    h, w = flat.shape[:2]
    p = o + r + 2  # margin of the edge-replicated copy
    fp = edge_pad(flat, p, p, p, p)
    chans = [fp[..., c] for c in range(3)]

    # circularity on rows/cols [-1, H + 1) (the local-max neighbours)
    circ_ext = _circ_plain(chans, p, h, w, o, r, 1)
    circ = circ_ext[1: h + 1, 1: w + 1]
    lmax = (
        (circ_ext[1: h + 1, 0:w] <= circ)
        & (circ_ext[1: h + 1, 2: w + 2] <= circ)
        & (circ_ext[0:h, 1: w + 1] <= circ)
        & (circ_ext[2: h + 2, 1: w + 1] <= circ)
    )

    # disc colour statistics from row spans
    spans = disc_spans(dr)
    n_taps = len(disc_offsets(dr))
    inv_n = _f32(1.0 / n_taps)
    std_sum = None
    means = []
    for c in chans:
        sums = []
        for x in (c, c * c):
            s = None
            for dy, hw in spans:
                rows = x[p + dy: p + dy + h]
                sp = rows[:, p: p + w]
                for b in range(1, hw + 1):
                    sp = sp + rows[:, p + b: p + b + w] + rows[:, p - b: p - b + w]
                s = sp if s is None else s + sp
            sums.append(s)
        mean = sums[0] * inv_n
        var = torch.clamp_min(sums[1] * inv_n - mean * mean, 0.0)
        sd = torch.sqrt(var)
        std_sum = sd if std_sum is None else std_sum + sd
        means.append(mean)

    score = circ / torch.clamp_min(std_sum, 1e-12)
    keep = (circ >= circ_threshold) & lmax
    ms = torch.where(keep, score, _NEG_INF)
    return ms, circ, tuple(means)


def blob_response_fused(flat: torch.Tensor, circ_threshold, grad_offset: int,
                        sat_radius: int, disc_radius: int):
    """flat (H, W, 3) -> (masked_score, circ, (mean0, mean1, mean2), count).

    ``circ_threshold`` is a 0-d tensor on the flat map's device (or a
    float on the CPU). ``count`` is a 0-d int32 tensor: the kept pixels,
    counted by the kernel on the card.
    """
    o, r, dr = int(grad_offset), int(sat_radius), int(disc_radius)
    if not response_kernel_fits(o, r, dr):
        raise ValueError("blob_response_fused: caller gates on response_kernel_fits")
    if not flat.is_cuda:
        ms, circ, means = _blob_response_fused_plain(flat, circ_threshold, o, r, dr)
        return ms, circ, means, (ms > _NEG_INF).sum(dtype=torch.int32)
    flat = flat.contiguous()
    cuda.require(flat, "flat", torch.float32, 3)
    h, w, ch = flat.shape
    if ch != 3:
        raise ValueError(f"blob_response_fused: flat {tuple(flat.shape)}")
    plan = tile_plan(o, r, dr)
    kernel = _kernel_lib(o, r, dr)
    th = torch.as_tensor(circ_threshold, dtype=torch.float32,
                         device=flat.device).reshape(1).contiguous()
    dev = flat.device
    ms, circ, m0, m1, m2 = (
        torch.empty((h, w), dtype=torch.float32, device=dev) for _ in range(5)
    )
    count = torch.empty((), dtype=torch.int32, device=dev)
    rc = kernel.vp_blob_response(
        flat.data_ptr(), h, w, o, r, dr, plan.tile_h, plan.tile_w, plan.smem_bytes,
        _f32(1.0 / (r * r)), _inv_taps(dr), th.data_ptr(),
        ms.data_ptr(), circ.data_ptr(), m0.data_ptr(), m1.data_ptr(), m2.data_ptr(),
        count.data_ptr(), cuda.stream(flat),
    )
    cuda.check(rc, "blob_response_fused")
    cuda.LAUNCHES["blob_response_fused"] += 1
    return ms, circ, (m0, m1, m2), count


def _circularity_fused_plain(flat: torch.Tensor, o: int, r: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B5: the circ part of
    ``_blob_response_fused_plain`` on the unwidened grid."""
    h, w = flat.shape[:2]
    p = o + r
    fp = edge_pad(flat, p, p, p, p)
    return _circ_plain([fp[..., c] for c in range(3)], p, h, w, o, r, 0)


def circularity_fused(flat: torch.Tensor, grad_offset: int,
                      sat_radius: int) -> torch.Tensor:
    """flat (H, W, 3) f32 -> circularity (H, W): local box sums, as the
    TPU kernel computes it (f32-reassociation parity with the eager chain in
    the interior). Below ``sat_radius`` 2 the (r-1)^2 box is empty and the
    eager chain of ops/blob.py runs, as in the JAX package."""
    o, r = int(grad_offset), int(sat_radius)
    if r < 2:
        return circularity(summed_area_table(gradient_dot(flat, o)), r)
    if not flat.is_cuda:
        return _circularity_fused_plain(flat, o, r)
    flat = flat.contiguous()
    cuda.require(flat, "flat", torch.float32, 3)
    h, w, ch = flat.shape
    if ch != 3:
        raise ValueError(f"circularity_fused: flat {tuple(flat.shape)}")
    plan = tile_plan(o, r)
    kernel = _kernel_lib(o, r, None)
    circ = torch.empty((h, w), dtype=torch.float32, device=flat.device)
    rc = kernel.vp_circularity(
        flat.data_ptr(), h, w, o, r, plan.tile_h, plan.tile_w, plan.smem_bytes,
        _f32(1.0 / (r * r)), circ.data_ptr(), cuda.stream(flat),
    )
    cuda.check(rc, "circularity_fused")
    cuda.LAUNCHES["circularity_fused"] += 1
    return circ
