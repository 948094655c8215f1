"""Blob response chain on the flat field grid (PyTorch port).

Counterpart of vision_processor_tpu/ops/blob.py (reference
kernel/gradientDot.cl, satHorizontal.cl + satVertical.cl,
satBlobCenter.cl, blobList.cl). The eager chain here — gradient dot,
summed-area table, quadrant circularity, local max, span-sum disc
statistics, score — is the reference and the CPU path of the fused
kernels (ops/blob_fused.py, kernels B2 and B5). Compaction
(``_compact_masked``) keeps the JAX package's three exact occupancy tiers;
its row stage is ``ops.topk.row_topk`` (kernel B3 on the card). Two
extractions sit on it: ``extract_blobs_scored`` (score-first, the
default) and ``extract_blobs`` (circularity-first: compaction by
circularity, then disc statistics at the candidates only).

Cumulative sums follow the order XLA uses for ``jnp.cumsum`` on the CPU
(sequential inside chunks of 16, chunk totals scanned recursively), so the
SAT's large-minus-large differences round like the JAX reference's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_NEG_INF = float("-inf")


def _clamped(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices lo..n+hi-1 clamped into [0, n) (edge replication)."""
    return torch.arange(-lo, n + hi, device=device).clamp(0, n - 1)


def edge_pad(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Edge-replicating pad of the first two axes of ``x``."""
    h, w = x.shape[:2]
    rows = _clamped(h, top, bottom, x.device)
    cols = _clamped(w, left, right, x.device)
    return x.index_select(0, rows).index_select(1, cols)


def cumsum(x: torch.Tensor, dim: int, base: int = 16) -> torch.Tensor:
    """Inclusive cumulative sum in XLA's CPU order: a sequential scan inside
    chunks of ``base``, then the chunk totals scanned recursively and added
    to their chunks."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= base:
        parts = [x[..., 0]]
        for k in range(1, n):
            parts.append(parts[-1] + x[..., k])
        out = torch.stack(parts, dim=-1)
        return out.movedim(-1, dim)
    nc = -(-n // base)
    pad = nc * base - n
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(*x.shape[:-1], nc, base)
    s = cumsum(xp, -1, base)
    tot = cumsum(s[..., -1], -1, base)
    excl = torch.nn.functional.pad(tot[..., :-1], (1, 0))
    out = (s + excl[..., None]).reshape(*x.shape[:-1], nc * base)[..., :n]
    return out.movedim(-1, dim)


def _sum3(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] + x[..., 1] + x[..., 2]


def gradient_dot(flat: torch.Tensor, offset: int) -> torch.Tensor:
    """Dot product of central-difference gradients over the dRGB channels
    (H, W, 3) -> (H, W), clamp-to-edge."""
    o = offset
    h, w = flat.shape[:2]
    p = edge_pad(flat, o, o, o, o)

    def sl(dy, dx):
        return p[o + dy: o + dy + h, o + dx: o + dx + w]

    gx = sl(0, o) - sl(0, -o)
    gy = sl(o, 0) - sl(-o, 0)
    return _sum3(gx * gy)


def summed_area_table(img: torch.Tensor) -> torch.Tensor:
    """Inclusive 2D prefix sum (summed-area table), f32."""
    return cumsum(cumsum(img, 1), 0)


def circularity(sat: torch.Tensor, radius: int) -> torch.Tensor:
    """Blob circularity from quadrant box sums of the gradient-dot SAT
    (reference kernel/satBlobCenter.cl:34-45)."""
    r = radius
    h, w = sat.shape
    p = edge_pad(sat, r, r, r, r)

    def read(dx, dy):
        return p[r + dy: r + dy + h, r + dx: r + dx + w]

    pp = read(r, r) - read(r, 1) - read(1, r) + read(1, 1)
    pn = read(r, -r) - read(r, -1) - read(1, -r) + read(1, -1)
    np_ = read(-r, r) - read(-r, 1) - read(-1, r) + read(-1, 1)
    nn = read(-r, -r) - read(-r, -1) - read(-1, -r) + read(-1, -1)
    return torch.minimum(torch.minimum(pp, nn), torch.minimum(pn, np_)) / float(r * r)


def disc_offsets(radius: int) -> np.ndarray:
    """Integer offsets (dy, dx) with dx^2 + dy^2 <= radius^2."""
    out = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx * dx + dy * dy <= radius * radius:
                out.append((dy, dx))
    return np.array(out, dtype=np.int32)


def disc_stats(flat: torch.Tensor, radius: int):
    """Per-pixel disc sums of the flat image and its square as a depthwise
    convolution with a 0/1 disc kernel on the edge-padded image (the JAX
    package's conv form; a reference for the tests). Returns (s1, s2, n)."""
    r = radius
    offs = disc_offsets(r)
    mask = torch.zeros((2 * r + 1, 2 * r + 1), dtype=flat.dtype, device=flat.device)
    mask[offs[:, 0] + r, offs[:, 1] + r] = 1.0
    x = edge_pad(flat, r, r, r, r).permute(2, 0, 1)[None]  # NCHW, C=3
    kern = mask.expand(3, 1, 2 * r + 1, 2 * r + 1)

    def conv(v):
        return torch.nn.functional.conv2d(v, kern, groups=3)[0].permute(1, 2, 0)

    return conv(x), conv(x * x), len(offs)


def disc_stats_sat(flat: torch.Tensor, radius: int):
    """Per-pixel disc sums of the flat image and its square via row prefix
    sums (one shifted difference per disc row). Returns (s1, s2, n)."""
    r = radius
    offs = disc_offsets(r)
    n = len(offs)
    half_w = {
        int(dy): int(np.max(offs[offs[:, 0] == dy, 1])) for dy in range(-r, r + 1)
    }
    padded = edge_pad(flat, r, r, r, r + 1)
    both = torch.cat([padded, padded * padded], dim=-1)
    csum = cumsum(both, 1)
    csum = torch.nn.functional.pad(csum, (0, 0, 1, 0))  # leading zero column

    h, w = flat.shape[:2]
    acc = None
    for dy in range(-r, r + 1):
        hw = half_w[dy]
        rows = csum[r + dy: r + dy + h]
        span = rows[:, r + hw + 1: r + hw + 1 + w] - rows[:, r - hw: r - hw + w]
        acc = span if acc is None else acc + span
    return acc[..., :3], acc[..., 3:], n


def local_max_mask(circ: torch.Tensor) -> torch.Tensor:
    """True where no 4-neighbor (clamp-to-edge) strictly exceeds the value."""
    h, w = circ.shape
    p = edge_pad(circ, 1, 1, 1, 1)

    def sl(dy, dx):
        return p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]

    return (
        (sl(0, -1) <= circ)
        & (sl(0, 1) <= circ)
        & (sl(-1, 0) <= circ)
        & (sl(1, 0) <= circ)
    )


def subpixel_peak(neg: torch.Tensor, center: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """Quadratic interpolation of the peak position from 3 samples."""
    denom = neg - 2 * center + pos
    safe = torch.where(denom != 0, denom, torch.ones_like(denom))
    return torch.where(denom != 0, 0.5 * (neg - pos) / safe, 0.0)


_DISC_TAPS: dict = {}


def _disc_taps(radius: int, device) -> torch.Tensor:
    """(n, 2) i64 disc offsets (dy, dx) on ``device``, cached per device."""
    key = (radius, str(device))
    if key not in _DISC_TAPS:
        _DISC_TAPS[key] = torch.from_numpy(disc_offsets(radius).astype(np.int64)).to(device)
    return _DISC_TAPS[key]


def disc_stats_at(flat: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                  radius: int):
    """Disc sums of value and value^2 at K candidate pixels only: gathers of
    the disc taps per candidate, clamp-to-edge (reference
    kernel/blobList.cl:58-75). Returns (s1 (K, 3), s2 (K, 3), n)."""
    h, w = flat.shape[:2]
    offs = _disc_taps(radius, flat.device)
    yy = (iy[:, None] + offs[None, :, 0]).clamp(0, h - 1)  # (K, n)
    xx = (ix[:, None] + offs[None, :, 1]).clamp(0, w - 1)
    v = flat.reshape(-1, flat.shape[-1])[(yy * w + xx).reshape(-1)]
    v = v.reshape(iy.shape[0], offs.shape[0], flat.shape[-1])
    return v.sum(dim=1), (v * v).sum(dim=1), offs.shape[0]


def blob_response(flat: torch.Tensor, circ: torch.Tensor, circ_threshold,
                  radius: int):
    """Full-map blob response: (masked score with -inf outside the
    threshold + local-max mask, mean color (H, W, 3), count)."""
    s1, s2, n = disc_stats_sat(flat, radius)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    stddev_sum = _sum3(torch.sqrt(var))
    score = circ / torch.clamp_min(stddev_sum, 1e-12)
    keep = (circ >= circ_threshold) & local_max_mask(circ)
    masked = torch.where(keep, score, _NEG_INF)
    return masked, mean, keep.sum(dtype=torch.int32)


def _stage(masked: torch.Tensor, mm: int, max_blobs: int):
    from .topk import row_topk

    h, w = masked.shape
    row_scores, row_idx = row_topk(masked, mm)  # (h, mm)
    rows = torch.arange(h, device=masked.device, dtype=torch.int32) * w
    cand_idx = (row_idx + rows[:, None]).reshape(-1)
    vals, ci = torch.sort(row_scores.reshape(-1), descending=True, stable=True)
    return vals[:max_blobs], cand_idx[ci[:max_blobs]]


def _flat_map(masked: torch.Tensor, max_blobs: int):
    vals, idx = torch.sort(masked.reshape(-1), descending=True, stable=True)
    return vals[:max_blobs], idx[:max_blobs].to(torch.int32)


def compaction_tier(masked: torch.Tensor, max_blobs: int) -> tuple[str, int]:
    """The occupancy tier ``_compact_masked`` takes: ("stage", m) or
    ("flat", 0). Reads the densest row's candidate count (one device->host
    sync on the card)."""
    h, w = masked.shape
    m = min(w, max(16, -(-4 * max_blobs // h)))
    if m == w:  # row stage degenerate: every row fits entirely
        return "stage", m
    max_row = int((masked > _NEG_INF).sum(dim=1).amax())
    m_small = min(m, max(6, -(-max_blobs // h)))
    if m_small < m and h * m_small >= max_blobs and max_row <= m_small:
        return "stage", m_small
    if max_row <= m:
        return "stage", m
    return "flat", 0


def _compact_masked(masked: torch.Tensor, max_blobs: int):
    """Exact top-``max_blobs`` over a (-inf)-masked response map, in the
    JAX package's occupancy tiers (keyed on the densest row's candidate
    count): a small row stage, the m-lane row stage, or the exact flat-map
    selection. Every tier returns the identical exact selection; the tier
    is chosen on the host (the lax.switch of the JAX package). Returns
    (values (max_blobs,), flat indices i32)."""
    kind, mm = compaction_tier(masked, max_blobs)
    if kind == "stage":
        return _stage(masked, mm, max_blobs)
    return _flat_map(masked, max_blobs)


def _neighbour_idx(iy, ix, h: int, w: int, centre: bool) -> torch.Tensor:
    """Flat indices of the (centre,) left, right, up and down neighbours,
    clamp-to-edge: (K, 5) or (K, 4)."""
    cols = [
        iy * w + torch.clamp_min(ix - 1, 0),
        iy * w + torch.clamp_max(ix + 1, w - 1),
        torch.clamp_min(iy - 1, 0) * w + ix,
        torch.clamp_max(iy + 1, h - 1) * w + ix,
    ]
    return torch.stack(([iy * w + ix] if centre else []) + cols, dim=-1)


def extract_blobs(flat, circ, circ_threshold, min_score, radius: int,
                  max_blobs: int):
    """Circularity-first blob extraction (the JAX package's
    ``extract_blobs``): threshold + 4-neighbour local max on the
    circularity, compaction into ``max_blobs`` slots by descending
    circularity, disc colour mean/stddev and score = circ / sum(stddev) at
    those candidates only (reference kernel/blobList.cl:48-75), then the
    slots ordered by descending score (a stable sort: ties keep the lower
    slot, as ``lax.top_k`` does)."""
    h, w = circ.shape
    valid = (circ >= circ_threshold) & local_max_mask(circ)
    count = valid.sum(dtype=torch.int32)

    masked = torch.where(valid, circ, _NEG_INF)
    top_circ, idx = _compact_masked(masked, max_blobs)
    slot_valid = top_circ > _NEG_INF
    idx = idx.long()
    iy = idx // w
    ix = idx % w

    s1, s2, n = disc_stats_at(flat, iy, ix, radius)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    stddev_sum = _sum3(torch.sqrt(var))
    c0 = torch.where(slot_valid, top_circ, 0.0)
    score = c0 / torch.clamp_min(stddev_sum, 1e-12)
    slot_valid = slot_valid & (score >= min_score)

    nv = circ.reshape(-1)[_neighbour_idx(iy, ix, h, w, False).reshape(-1)].reshape(-1, 4)
    px = ix.to(torch.float32) + subpixel_peak(nv[:, 0], c0, nv[:, 1])
    py = iy.to(torch.float32) + subpixel_peak(nv[:, 2], c0, nv[:, 3])

    sort_score, order = torch.sort(torch.where(slot_valid, score, _NEG_INF),
                                   descending=True, stable=True)
    slot_valid = sort_score > _NEG_INF
    return {
        "pos": torch.stack([px, py], dim=-1)[order],
        "color": mean[order],
        "center": flat.reshape(-1, flat.shape[-1])[idx][order],
        "circ": c0[order],
        "score": torch.where(slot_valid, sort_score, 0.0),
        "valid": slot_valid,
        "count": count,
    }


def extract_blobs_scored(flat, circ, masked_score, mean, count, max_blobs: int):
    """Blob compaction from a per-pixel response (see blob_response): slots
    in descending score order with sub-pixel peak positions, disc mean
    color, center pixel color and circularity."""
    h, w = masked_score.shape
    top_score, idx = _compact_masked(masked_score, max_blobs)
    slot_valid = top_score > _NEG_INF
    idx = idx.long()
    iy = idx // w
    ix = idx % w

    nv = circ.reshape(-1)[_neighbour_idx(iy, ix, h, w, True).reshape(-1)].reshape(-1, 5)
    c0 = torch.where(slot_valid, nv[:, 0], 0.0)
    px = ix.to(torch.float32) + subpixel_peak(nv[:, 1], c0, nv[:, 2])
    py = iy.to(torch.float32) + subpixel_peak(nv[:, 3], c0, nv[:, 4])

    if isinstance(mean, (tuple, list)):
        color = torch.stack([p.reshape(-1)[idx] for p in mean], dim=-1)
    else:
        color = mean.reshape(-1, mean.shape[-1])[idx]

    return {
        "pos": torch.stack([px, py], dim=-1),
        "color": color,
        "center": flat.reshape(-1, flat.shape[-1])[idx],
        "circ": c0,
        "score": torch.where(slot_valid, top_score, 0.0),
        "valid": slot_valid,
        "count": count,
    }


def gradient_offset(max_blob_radius: float, field_scale: float) -> int:
    """offset = ceil(max_blob_radius / field_scale) // 3
    (reference src/Resources.cpp:160)."""
    return max(1, int(math.ceil(max_blob_radius / field_scale)) // 3)


def sat_radius(min_blob_radius: float, field_scale: float) -> int:
    """Quadrant radius = ceil(min_blob_radius / field_scale)
    (reference src/Resources.cpp:163)."""
    return max(1, int(math.ceil(min_blob_radius / field_scale)))


def disc_radius(min_blob_radius: float, field_scale: float) -> int:
    """Color-statistics disc radius = floor(min_blob_radius / field_scale)
    (reference src/main.cpp:289)."""
    return max(1, int(math.floor(min_blob_radius / field_scale)))
