"""Masked top-m selections (kernels B3, B4 and E5).

Counterpart of vision_processor_tpu/ops/topk.py. ``row_topk`` (per-row
top-m of a -inf-masked score map, the row stage of blob compaction) and
``query_select_topk`` (per query: the distance test against every blob and
the top-m by rank or by -d^2, never materializing the (Q, K) map) run as
the CUDA kernels of ``csrc/topk.cu`` on the card.

Semantics are those of the JAX package: values descending, ties to the
lower index. On the card the kernels give every slot what m (max, lowest
index) passes give, like the Pallas ``_select_m`` (``select_m`` below), so
exhausted slots repeat index 0 (the lowest -inf index, or the lowest
winner); validity MUST be derived from the values (> -inf), never from the
indices. An m up to 32 runs the register-list kernels (lists of 4, 8, 16
or 32), one warp per row (B3) or 8 warps per query (B4), built into the
one kernel library with the other sources; a larger m runs the block
kernels, one block per row or query. The plain versions used for CPU
tensors are the JAX package's own CPU paths: ``lax.top_k`` semantics (a
stable descending sort) for the rows and the iterative argmax for the
queries. ``row_topk_blk`` (kernel E5, B3 at a swept number of rows per
block, experiments/rowtopk_blk.py) is on no production path: ``blk``
rows a block over the warps ``blk_warps`` gives, a warp a row at a time,
any m in the one kernel; its plain version is the iterative argmax.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda


def _row_topk_plain(x: torch.Tensor, m: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :m].contiguous(), idx[:, :m].to(torch.int32).contiguous()


def row_topk(x: torch.Tensor, m: int):
    """Top-m of each row of ``x`` (R, L) f32: (values, indices), both (R, m)."""
    if not x.is_cuda:
        return _row_topk_plain(x, m)
    cuda.require(x, "x", torch.float32, 2)
    r, l = x.shape
    if l < 1 or m < 1:
        raise ValueError(f"row_topk: empty selection {tuple(x.shape)}, m={m}")
    vals = torch.empty((r, m), dtype=torch.float32, device=x.device)
    idx = torch.empty((r, m), dtype=torch.int32, device=x.device)
    rc = cuda.lib().vp_row_topk(
        x.data_ptr(), r, l, m, vals.data_ptr(), idx.data_ptr(), cuda.stream(x)
    )
    cuda.check(rc, "row_topk")
    cuda.LAUNCHES["row_topk"] += 1
    return vals, idx


def select_m(score: torch.Tensor, m: int):
    """m iterative (max, lowest index) passes over the rows of ``score``
    (the JAX package's iter_top_k); exhausted slots repeat index 0."""
    k = score.shape[-1]
    iota = torch.arange(k, device=score.device)
    cur = score
    vals, idxs = [], []
    for _ in range(m):
        v = cur.amax(dim=-1)
        i = torch.where(cur == v[..., None], iota, k).amin(dim=-1)
        vals.append(v)
        idxs.append(i.to(torch.int32))
        cur = torch.where(iota == i[..., None], float("-inf"), cur)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


# an SM's (and a block's) 32-bit registers, a block's threads (sm_90)
REGS_PER_SM = 65536
MAX_BLOCK_THREADS = 1024


def blk_warps(blk: int, regs: int) -> int:
    """Warps a block of kernel E5 at ``blk`` rows a block, for a kernel of
    ``regs`` registers a thread: one warp a row, up to 32 and no more than
    the SM's 65,536 registers hold, allocated 8 a thread at a time. A warp
    takes every warps-th row of its block."""
    if blk < 1 or not 1 <= regs <= 255:
        raise ValueError(f"blk_warps: blk {blk}, regs {regs}")
    per_warp = 32 * (-(-regs // 8) * 8)
    return min(blk, MAX_BLOCK_THREADS // 32, REGS_PER_SM // per_warp)


@functools.cache
def blk_attrs() -> tuple[int, int]:
    """(registers a thread, most threads a block) of E5's kernel, as the
    card's runtime reports them (the kernels built on first use)."""
    out = (ctypes.c_int * 2)()
    cuda.check(cuda.lib().vp_row_topk_blk_attrs(out), "row_topk_blk attributes")
    return out[0], out[1]


def row_topk_blk(x: torch.Tensor, m: int, blk: int):
    """Top-m of each row of ``x`` (R, L) f32 with ``blk`` rows per block
    (kernel E5, the contract of experiments/rowtopk_blk.py
    ``row_topk_blk``): (values, indices), both (R, m). B3's function with
    ``_select_m``'s exhausted slots, (-inf, 0); ``blk`` sets only how the
    kernel's launch is cut (``blk_warps`` the warps of a block). The plain
    version is ``select_m``."""
    if blk < 1:
        raise ValueError(f"row_topk_blk: blk {blk} must be positive")
    if not x.is_cuda:
        return select_m(x, m)
    cuda.require(x, "x", torch.float32, 2)
    r, l = x.shape
    if l < 1 or m < 1:
        raise ValueError(f"row_topk_blk: empty selection {tuple(x.shape)}, m={m}")
    warps = blk_warps(blk, blk_attrs()[0])
    vals = torch.empty((r, m), dtype=torch.float32, device=x.device)
    idx = torch.empty((r, m), dtype=torch.int32, device=x.device)
    rc = cuda.lib().vp_row_topk_blk(x.data_ptr(), r, l, m, blk, warps, vals.data_ptr(),
                                    idx.data_ptr(), cuda.stream(x))
    cuda.check(rc, "row_topk_blk")
    cuda.LAUNCHES["row_topk_blk"] += 1
    return vals, idx


def _query_scores(query_xy, radius2, blob_xy, rank, by_rank: bool):
    dx = blob_xy[None, :, 0] - query_xy[:, None, 0]
    dy = blob_xy[None, :, 1] - query_xy[:, None, 1]
    d2 = dx * dx + dy * dy
    ok = (d2 <= radius2[:, None]) & (rank[None, :] < float("inf"))
    score = -rank[None, :].expand_as(d2) if by_rank else -d2
    return torch.where(ok, score, float("-inf"))


def _query_select_plain(query_xy, radius2, blob_xy, rank, m: int, by_rank: bool):
    return select_m(_query_scores(query_xy, radius2, blob_xy, rank, by_rank), m)


def query_select_topk(query_xy: torch.Tensor, radius2: torch.Tensor,
                      blob_xy: torch.Tensor, rank: torch.Tensor, m: int,
                      by_rank: bool):
    """Per query: top-m blobs within radius, best-ranked or nearest first.

    query_xy (Q, 2), radius2 (Q,) squared search radii, blob_xy (K, 2),
    rank (K,) — +inf marks an invalid blob; with ``by_rank`` the score is
    -rank (lowest rank wins), otherwise -d2 (nearest wins). Returns
    (scores (Q, m) f32, indices (Q, m) i32); validity is score > -inf.
    """
    if not query_xy.is_cuda:
        return _query_select_plain(query_xy, radius2, blob_xy, rank, m, by_rank)
    query_xy = query_xy.contiguous()
    radius2 = radius2.contiguous()
    blob_xy = blob_xy.contiguous()
    rank = rank.contiguous()
    cuda.require(query_xy, "query_xy", torch.float32, 2)
    cuda.require(radius2, "radius2", torch.float32, 1)
    cuda.require(blob_xy, "blob_xy", torch.float32, 2)
    cuda.require(rank, "rank", torch.float32, 1)
    q, k = query_xy.shape[0], blob_xy.shape[0]
    if query_xy.shape[1] != 2 or blob_xy.shape[1] != 2 or radius2.shape[0] != q \
            or rank.shape[0] != k or k < 1 or m < 1:
        raise ValueError("query_select_topk: inconsistent shapes")
    if blob_xy.data_ptr() % 8:
        blob_xy = blob_xy.clone()  # the kernel reads each blob as one float2
    vals = torch.empty((q, m), dtype=torch.float32, device=query_xy.device)
    idx = torch.empty((q, m), dtype=torch.int32, device=query_xy.device)
    rc = cuda.lib().vp_query_topk(
        query_xy.data_ptr(), radius2.data_ptr(), blob_xy.data_ptr(), rank.data_ptr(),
        q, k, m, int(by_rank), vals.data_ptr(), idx.data_ptr(),
        cuda.stream(query_xy),
    )
    cuda.check(rc, "query_select_topk")
    cuda.LAUNCHES["query_select_topk"] += 1
    return vals, idx
