"""Fused combo-score chain and winner argmax (kernel B6): counterpart of
vision_processor_tpu/ops/combo_pallas.py (``use_combo_kernel``,
``combo_chain``).

The detection search scores every (anchor, combo) pair of the static
cyclic-4-subset table: after the one-hot matmuls produce the per-combo
orientation sums and slot positions, an elementwise chain computes the
normalised orientation, the candidate position, the five slot offset
scores and their min, and an argmax keeps one winner per anchor.
``combo_chain`` runs that chain and argmax in one CUDA kernel on the card
(``csrc/combo.cu``: one block per anchor, one thread per combo, launched
as ``combo_plan`` says); ``_combo_chain_plain`` is its plain PyTorch
version, used for CPU tensors and held against the kernel on the card.

Both do the chain op for op in the JAX package's order, with true
divisions and a correctly rounded 1 / sqrt for the inverse norm, so near-
tied combos pick the same rotation on the card as in the plain version.
The JAX caller pads the combo axis to 128 lanes for the TPU's layout; the
port takes the C combos as they are.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import cuda

# the 12 matmul outputs, in the order of ``combo_chain``'s ``maps``
MAPS = ("o_cos", "o_sin", "sum_x", "sum_y", "p5x1", "p5x2", "p5x3", "p5x4",
        "p5y1", "p5y2", "p5y3", "p5y4")
# threads a block at most: csrc/combo.cu kMaxThreads, the kernel's launch
# bound, which holds a thread to 65536 / MAX_THREADS registers
MAX_THREADS = 512


def combo_plan(a: int, c: int) -> tuple[int, int]:
    """(blocks, threads a block) of kernel B6 for A anchors and C combos:
    one block per anchor, one thread per combo, C rounded up to whole warps
    and capped at MAX_THREADS (a thread then takes every threads-th
    combo)."""
    if a < 0 or c < 1:
        raise ValueError(f"combo_plan: A={a}, C={c}")
    return a, min(-(-c // 32) * 32, MAX_THREADS)


def use_combo_kernel(t: torch.Tensor) -> bool:
    """VPTPU_COMBO_KERNEL=1 selects the fused chain, read at call time, and
    only for a CUDA tensor (the JAX package selects it only on a TPU)."""
    return os.environ.get("VPTPU_COMBO_KERNEL", "0") == "1" and t.is_cuda


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true division on every device (a Python-scalar divisor
    becomes a multiply by its reciprocal on the card)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _combo_chain_plain(maps, anchor_pos, ring_count, anchor_valid, combo_max,
                       pat, pbar):
    """Plain PyTorch version of kernel B6."""
    oc, os_, sum_x, sum_y = maps[0], maps[1], maps[2], maps[3]
    norm2 = oc * oc + os_ * os_
    ok_n = norm2 > 0.0
    inv_n = torch.where(ok_n, 1.0 / torch.sqrt(torch.clamp_min(norm2, 1e-30)), 0.0)
    cc = torch.where(ok_n, oc * inv_n, 1.0)
    ss = os_ * inv_n
    pb0, pb1 = float(pbar[0]), float(pbar[1])
    pos_x = _div(sum_x - (cc * pb0 - ss * pb1), 5.0)
    pos_y = _div(sum_y - (ss * pb0 + cc * pb1), 5.0)

    offset_score = None
    for s5 in range(5):
        if s5 == 0:
            p5x, p5y = anchor_pos[:, 0:1], anchor_pos[:, 1:2]
        else:
            p5x, p5y = maps[3 + s5], maps[7 + s5]
        qx, qy = float(pat[s5][0]), float(pat[s5][1])
        dx = _div(p5x - (pos_x + (cc * qx - ss * qy)), 10.0)
        dy = _div(p5y - (pos_y + (ss * qx + cc * qy)), 10.0)
        sc = 1.0 / (1.0 + dx * dx + dy * dy)
        offset_score = sc if offset_score is None else torch.minimum(offset_score, sc)

    rc = ring_count.to(torch.int32)[:, None]
    combo_ok = (combo_max[None, :] < rc) & (rc >= 4) & anchor_valid[:, None]
    score = torch.where(combo_ok, offset_score, 0.0)
    c = score.shape[1]
    iota = torch.arange(c, device=score.device)
    best_v = score.amax(dim=1)
    best = torch.where(score == best_v[:, None], iota, c).amin(dim=1)
    pick = lambda t: torch.gather(t, 1, best[:, None])[:, 0]
    return best_v, pick(cc), pick(ss), pick(pos_x), pick(pos_y), best.to(torch.int32)


def combo_chain(maps: torch.Tensor, anchor_pos: torch.Tensor,
                ring_count: torch.Tensor, anchor_valid: torch.Tensor,
                combo_max: torch.Tensor, pat, pbar):
    """Per-anchor winner over the combo maps.

    maps (12, A, C) f32: the matmul outputs in ``MAPS`` order (o_cos,
    o_sin, sum_x, sum_y, then the slot 1-4 positions x and y); anchor_pos
    (A, 2) f32; ring_count (A,) int; anchor_valid (A,) bool; combo_max (C,)
    i32 table; pat (5, 2) / pbar (2,) pattern constants.

    Returns (best_score, cos, sin, pos_x, pos_y, best_idx i32), each (A,);
    ties go to the lowest combo index.
    """
    if not maps.is_cuda:
        return _combo_chain_plain(maps, anchor_pos, ring_count, anchor_valid,
                                  combo_max, pat, pbar)
    cuda.require(maps, "maps", torch.float32, 3)
    anchor_pos = anchor_pos.contiguous()
    ring_count = ring_count.to(torch.int32).contiguous()
    anchor_valid = anchor_valid.contiguous()
    combo_max = combo_max.to(torch.int32).contiguous()
    cuda.require(anchor_pos, "anchor_pos", torch.float32, 2)
    cuda.require(ring_count, "ring_count", torch.int32, 1)
    cuda.require(anchor_valid, "anchor_valid", torch.bool, 1)
    cuda.require(combo_max, "combo_max", torch.int32, 1)
    n_maps, a, c = maps.shape
    if n_maps != len(MAPS) or tuple(anchor_pos.shape) != (a, 2) \
            or ring_count.shape[0] != a or anchor_valid.shape[0] != a \
            or combo_max.shape[0] != c or c < 1:
        raise ValueError("combo_chain: inconsistent shapes")
    pattern = np.concatenate([np.asarray(pat, np.float32).reshape(10),
                              np.asarray(pbar, np.float32).reshape(2)])
    _, threads = combo_plan(a, c)
    outf = torch.empty((5, a), dtype=torch.float32, device=maps.device)
    outi = torch.empty((a,), dtype=torch.int32, device=maps.device)
    rc = cuda.lib().vp_combo_chain(
        maps.data_ptr(), a, c, anchor_pos.data_ptr(), ring_count.data_ptr(),
        anchor_valid.data_ptr(), combo_max.data_ptr(), pattern.ctypes.data, threads,
        outf.data_ptr(), outi.data_ptr(), cuda.stream(maps),
    )
    cuda.check(rc, "combo_chain")
    cuda.LAUNCHES["combo_chain"] += 1
    return outf[0], outf[1], outf[2], outf[3], outf[4], outi
