"""Vectorized robot/ball hypothesis search (PyTorch port).

Counterpart of vision_processor_tpu/models/detector.py (reference
src/main.cpp:43-141, src/blobs/hypothesis.cpp:97-271): static combo
tables enumerated with masking, scored in parallel, reduced with argmax,
and filtered by a greedy clipping NMS. The ring and tracked-candidate
selections are ``ops.topk.query_select_topk`` (kernel B4 on the card).

Control flow of the JAX package:

* the anchor-window tier (``lax.cond`` on the valid-blob count) is a host
  branch: one device->host read of the count per frame;
* the tracked-window tier always takes the full window, which is exact for
  every valid output (a slot outside the tier yields score 0 either way);
* the greedy NMS ``fori_loop`` over the valid candidates runs to the static
  bound ``max_bots``; its body is a no-op on invalid slots, which sort last;
* the early-exit k-means ``while_loop`` runs its 24 rounds; a finished row
  is never updated again, so the result is the early-exit one.

The combo-scoring products are float32 matmuls (``Precision.HIGHEST`` in
the JAX package): they need full f32, so TF32 must stay off on the card
(``torch.backends.cuda.matmul.allow_tf32 = False``, set by the processor).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from itertools import combinations

import numpy as np
import torch

from .camera import field2image_packed, image2field_packed
from .pattern import (
    MIN_ROBOT_FRONT_DISTANCE,
    MIN_ROBOT_OPENING_ANGLE,
    MIN_ROBOT_RADIUS,
    PATTERNS,
    PATTERN_ANGLES_B2B,
    PATTERN_LUT,
    PATTERN_POS,
)

TWO_PI = 2.0 * math.pi
_INF = float("inf")


@dataclass(frozen=True)
class DetectorConfig:
    """Static shape configuration of the hypothesis search."""

    max_blobs: int  # k blob slots from the blob machine
    max_anchors: int = 512  # anchors tested for detection hypotheses
    max_anchors_tier: int = 128  # small anchor window (0 disables)
    ring_size: int = 8  # neighbour ring per anchor (K)
    max_tracked: int = 32  # tracked-object slots (T); always the full window
    tracked_candidates: int = 3  # blob candidates per pattern slot (M)
    max_bots: int = 64  # bot output slots (B)


# ---------------------------------------------------------------------------
# static combo tables
# ---------------------------------------------------------------------------


def detection_combo_table(ring_size: int) -> np.ndarray:
    """All 4-subsets of the ring in cyclic order, each in its 4 rotations
    (reference src/main.cpp:63-75). Returns (n_combos, 4)."""
    rows = []
    for subset in combinations(range(ring_size), 4):
        for r in range(4):
            rows.append([subset[(j + r) % 4] for j in range(4)])
    return np.array(rows, dtype=np.int32)


_PAIRS = [(a, b) for a in range(5) for b in range(a + 1, 5)]
_PAIR_A = np.array([p[0] for p in _PAIRS], dtype=np.int64)
_PAIR_B = np.array([p[1] for p in _PAIRS], dtype=np.int64)
# expected angle for each ordered pair (a -> b): PATTERN_ANGLES_B2B[b*5 + a]
_PAIR_ANGLE = PATTERN_ANGLES_B2B.reshape(5, 5)[_PAIR_B, _PAIR_A]
_PAIR_COS = np.cos(_PAIR_ANGLE).astype(np.float32)
_PAIR_SIN = np.sin(_PAIR_ANGLE).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _detection_onehot_tables(ring_size: int):
    """Static one-hot matrices turning ring-level quantities into per-combo
    sums by matmul (see the JAX package's detection_hypotheses)."""
    combos = detection_combo_table(ring_size)
    c = combos.shape[0]
    n9 = ring_size + 1
    npair = n9 * n9

    w_cos = np.zeros((c, 2 * npair), dtype=np.float32)
    w_sin = np.zeros((c, 2 * npair), dtype=np.float32)
    count9 = np.zeros((c, n9), dtype=np.float32)
    onehot_slot = np.zeros((4, c, n9), dtype=np.float32)
    for ci in range(c):
        ring_of_slot = [0] + [int(combos[ci, s]) + 1 for s in range(4)]
        for p, (a, b) in enumerate(_PAIRS):
            i, j = ring_of_slot[a], ring_of_slot[b]
            k = i * n9 + j
            ca, sa = float(_PAIR_COS[p]), float(_PAIR_SIN[p])
            w_cos[ci, k] += ca
            w_cos[ci, npair + k] += sa
            w_sin[ci, k] += -sa
            w_sin[ci, npair + k] += ca
        count9[ci, 0] += 1.0
        for s in range(4):
            j = int(combos[ci, s]) + 1
            count9[ci, j] += 1.0
            onehot_slot[s, ci, j] = 1.0
    combo_max = combos.max(axis=-1).astype(np.int32)
    return combos, w_cos.T, w_sin.T, count9.T, onehot_slot, combo_max


_DEVICE_TABLES: dict = {}


def _tables(ring_size: int, device) -> dict:
    """Device copies of the detection tables, cached per device."""
    key = (ring_size, str(device))
    if key not in _DEVICE_TABLES:
        combos, w_cos, w_sin, count9, onehot, combo_max = (
            _detection_onehot_tables(ring_size))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        _DEVICE_TABLES[key] = {
            "combos": t(combos.astype(np.int64)),
            "w_cos": t(w_cos),
            "w_sin": t(w_sin),
            "count9": t(count9),
            "slot_t": [t(onehot[s].T) for s in range(4)],
            "combo_max": t(combo_max),
            "pair_a": t(_PAIR_A),
            "pair_b": t(_PAIR_B),
            "pair_cos": t(_PAIR_COS),
            "pair_sin": t(_PAIR_SIN),
            "pattern_pos": t(PATTERN_POS),
            "patterns": t(PATTERNS),
            "pattern_lut": t(PATTERN_LUT),
        }
        for m in range(1, 9):
            _DEVICE_TABLES[key][f"tracked_combos_{m}"] = t(tracked_combo_table(m + 1))
    return _DEVICE_TABLES[key]


def tracked_combo_table(m_plus_null: int) -> np.ndarray:
    """Cartesian product of per-slot candidate choices, (n, 5); option
    m_plus_null-1 is "no blob on this slot" (reference src/main.cpp:104)."""
    grids = np.meshgrid(*[np.arange(m_plus_null)] * 5, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1).astype(np.int32)


def _remainder_2pi(x):
    """IEEE remainder(x, 2*pi): result in [-pi, pi]."""
    return x - TWO_PI * torch.round(x / TWO_PI)


def _sqnorm(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, left to right."""
    out = d[..., 0] * d[..., 0]
    for i in range(1, d.shape[-1]):
        out = out + d[..., i] * d[..., i]
    return out


def _sqnorm_i(d: torch.Tensor) -> torch.Tensor:
    """Integer sum of squares over the last axis (exact in any order)."""
    return (d * d).sum(dim=-1, dtype=d.dtype)


def _take(arr: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """arr[i, best[i], ...] over the second axis."""
    idx = best.reshape(-1, *([1] * (arr.dim() - 1)))
    idx = idx.expand(-1, 1, *arr.shape[2:])
    return torch.gather(arr, 1, idx).squeeze(1)


def _rotate(c, s, v):
    """Rotate vectors v (..., 2) by the angle whose cos/sin are c, s (...)."""
    x = c * v[..., 0] - s * v[..., 1]
    y = s * v[..., 0] + c * v[..., 1]
    return torch.stack([x, y], dim=-1)


def score_hypotheses(pos5, valid5, tab):
    """Score a batch of 5-blob constellations (reference
    src/blobs/hypothesis.cpp:156-205): unit orientation (c, s), position,
    offset score, blob amount."""
    pa = pos5[..., tab["pair_a"], :]
    pb = pos5[..., tab["pair_b"], :]
    pair_valid = valid5[..., tab["pair_a"]] & valid5[..., tab["pair_b"]]
    diff = pb - pa
    r2 = _sqnorm(diff)
    ok_pair = pair_valid & (r2 > 0.0)
    inv_r = torch.where(ok_pair, torch.rsqrt(torch.where(ok_pair, r2, 1.0)), 0.0)
    dx = diff[..., 0] * inv_r
    dy = diff[..., 1] * inv_r
    o_cos = torch.sum(dx * tab["pair_cos"] + dy * tab["pair_sin"], dim=-1)
    o_sin = torch.sum(dy * tab["pair_cos"] - dx * tab["pair_sin"], dim=-1)

    blob_amount = valid5.sum(dim=-1, dtype=torch.int32)
    norm2 = o_cos * o_cos + o_sin * o_sin
    ok = (blob_amount > 1) & (norm2 > 0.0)
    inv_n = torch.where(ok, torch.rsqrt(torch.clamp_min(norm2, 1e-30)), 0.0)
    c = torch.where(ok, o_cos * inv_n, 1.0)
    s = o_sin * inv_n

    rotated = _rotate(c[..., None], s[..., None], tab["pattern_pos"])
    offsets = pos5 - rotated
    pos = torch.sum(torch.where(valid5[..., None], offsets, 0.0), dim=-2) / (
        torch.clamp_min(blob_amount, 1)[..., None]
    )
    slot_off = (pos5 - (pos[..., None, :] + rotated)) / 10.0
    slot_score = 1.0 / (1.0 + _sqnorm(slot_off))
    offset_score = torch.where(valid5, slot_score, _INF).amin(dim=-1)
    offset_score = torch.where(torch.isfinite(offset_score), offset_score, 1.0)
    return c, s, pos, offset_score, blob_amount


# ---------------------------------------------------------------------------
# detection hypotheses (untracked anchors)
# ---------------------------------------------------------------------------


def detection_hypotheses(cfg: DetectorConfig, blob_pos, blob_valid,
                         max_robot_radius, blob_color=None, colors=None):
    """Best 5-blob constellation per anchor blob: (A,) score/orientation,
    (A, 2) pos and (A, 5) blob indices (slot 0 = the anchor)."""
    k_all = blob_pos.shape[0]
    a = min(cfg.max_anchors, k_all)
    dev = blob_pos.device

    blob_rank = torch.arange(k_all, dtype=torch.float32, device=dev)
    if blob_color is not None and colors is not None:
        d_side = torch.minimum(_sqnorm(blob_color - colors[4]),
                               _sqnorm(blob_color - colors[5]))
        rank = d_side + blob_rank * 1e-6
    else:
        rank = blob_rank

    # the tier choice of the JAX lax.cond, read on the host
    n_valid = int(blob_valid.sum())

    def full_window():
        if a < k_all and blob_color is not None and colors is not None:
            if n_valid <= a:
                anchor_idx = torch.arange(a, dtype=torch.int64, device=dev)
            else:
                d_team = torch.minimum(_sqnorm(blob_color - colors[2]),
                                       _sqnorm(blob_color - colors[3]))
                other = [i for i in range(colors.shape[0]) if i not in (2, 3)]
                d_other = torch.stack(
                    [_sqnorm(blob_color - colors[i]) for i in other]).amin(dim=0)
                a_rank = torch.where(blob_valid, d_team - d_other, _INF)
                anchor_idx = torch.argsort(a_rank, stable=True)[:a]
            anchor_pos = blob_pos[anchor_idx]
            anchor_valid = blob_valid[anchor_idx]
        else:
            anchor_idx = torch.arange(a, dtype=torch.int64, device=dev)
            anchor_pos = blob_pos[:a]
            anchor_valid = blob_valid[:a]
        return _window_hypotheses(cfg, blob_pos, blob_valid, max_robot_radius,
                                  rank, anchor_idx, anchor_pos, anchor_valid)

    tier = cfg.max_anchors_tier
    if not (0 < tier < a) or n_valid > tier:
        return full_window()

    out = _window_hypotheses(
        cfg, blob_pos, blob_valid, max_robot_radius, rank,
        torch.arange(tier, dtype=torch.int64, device=dev),
        blob_pos[:tier], blob_valid[:tier],
    )
    pad = a - tier

    def zpad(t):
        z = torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype, device=dev)
        return torch.cat([t, z])

    return {k: zpad(v) for k, v in out.items()}


def _window_hypotheses(cfg, blob_pos, blob_valid, max_robot_radius, rank,
                       anchor_idx, anchor_pos, anchor_valid):
    """Hypothesis search over one anchor window (see detection_hypotheses).
    With VPTPU_COMBO_KERNEL=1 on the card the combo chain and its argmax
    run fused (``ops.combo_fused.combo_chain``, kernel B6); otherwise, and
    always on the CPU, as the unfused op chain."""
    from ..ops.combo_fused import combo_chain, use_combo_kernel
    from ..ops.topk import query_select_topk

    a = anchor_idx.shape[0]
    k = cfg.ring_size
    dev = blob_pos.device
    tab = _tables(k, dev)

    r2max = max_robot_radius * max_robot_radius
    sel_val, sel_idx = query_select_topk(
        anchor_pos,
        torch.broadcast_to(torch.as_tensor(r2max, device=dev), (a,)).to(torch.float32),
        blob_pos,
        torch.where(blob_valid, rank, _INF),
        m=k,
        by_rank=True,
    )  # (A, K)
    sel_idx = sel_idx.long()
    # validity from the selected VALUES (exhausted slots repeat index 0)
    sel_valid = (sel_val > -_INF) & anchor_valid[:, None]

    sel_diff = blob_pos[sel_idx] - anchor_pos[:, None, :]
    angle = torch.atan2(sel_diff[..., 1], sel_diff[..., 0])
    order = torch.argsort(torch.where(sel_valid, angle, _INF), dim=-1, stable=True)
    ring_idx = torch.gather(sel_idx, 1, order)
    ring_valid = torch.gather(sel_valid, 1, order)
    ring_count = ring_valid.sum(dim=-1, dtype=torch.int32)

    ring_pos = blob_pos[ring_idx]  # (A, K, 2)
    ring9 = torch.cat([anchor_pos[:, None, :], ring_pos], dim=1)
    n9 = k + 1

    d9 = ring9[:, None, :, :] - ring9[:, :, None, :]
    r2 = _sqnorm(d9)
    pos_r2 = r2 > 0.0
    inv = torch.where(pos_r2, torch.rsqrt(torch.where(pos_r2, r2, 1.0)), 0.0)
    u2 = torch.cat(
        [(d9[..., 0] * inv).reshape(a, n9 * n9),
         (d9[..., 1] * inv).reshape(a, n9 * n9)],
        dim=-1,
    )

    pat = PATTERN_POS.astype(np.float32)
    pbar = pat.sum(axis=0)
    if use_combo_kernel(u2):
        # fused chain + argmax (kernel B6); the matmuls stay full-f32
        # matmuls, written into one (12, A, C) buffer in combo_chain's order
        c = tab["combo_max"].shape[0]
        maps = torch.empty((12, a, c), dtype=torch.float32, device=dev)
        torch.matmul(u2, tab["w_cos"], out=maps[0])
        torch.matmul(u2, tab["w_sin"], out=maps[1])
        torch.matmul(ring9[..., 0], tab["count9"], out=maps[2])
        torch.matmul(ring9[..., 1], tab["count9"], out=maps[3])
        for s in range(4):
            torch.matmul(ring9[..., 0], tab["slot_t"][s], out=maps[4 + s])
            torch.matmul(ring9[..., 1], tab["slot_t"][s], out=maps[8 + s])
        best_score, cc_w, ss_w, posx_w, posy_w, best = combo_chain(
            maps, anchor_pos, ring_count, anchor_valid, tab["combo_max"], pat, pbar)
        best = best.long()
        best_orient = torch.atan2(ss_w, cc_w)
        best_pos = torch.stack([posx_w, posy_w], dim=-1)
    else:
        o_cos = u2 @ tab["w_cos"]  # (A, C), full f32
        o_sin = u2 @ tab["w_sin"]
        norm2 = o_cos * o_cos + o_sin * o_sin
        ok_n = norm2 > 0.0
        inv_n = torch.where(ok_n, torch.rsqrt(torch.clamp_min(norm2, 1e-30)), 0.0)
        cc = torch.where(ok_n, o_cos * inv_n, 1.0)
        ss = o_sin * inv_n

        sum_x = ring9[..., 0] @ tab["count9"]
        sum_y = ring9[..., 1] @ tab["count9"]
        pos_x = (sum_x - (cc * float(pbar[0]) - ss * float(pbar[1]))) / 5.0
        pos_y = (sum_y - (ss * float(pbar[0]) + cc * float(pbar[1]))) / 5.0

        offset_score = None
        for s5 in range(5):
            if s5 == 0:
                p5x = anchor_pos[:, 0:1]
                p5y = anchor_pos[:, 1:2]
            else:
                p5x = ring9[..., 0] @ tab["slot_t"][s5 - 1]
                p5y = ring9[..., 1] @ tab["slot_t"][s5 - 1]
            px_, py_ = float(pat[s5, 0]), float(pat[s5, 1])
            dx = (p5x - (pos_x + (cc * px_ - ss * py_))) / 10.0
            dy = (p5y - (pos_y + (ss * px_ + cc * py_))) / 10.0
            sc = 1.0 / (1.0 + dx * dx + dy * dy)
            offset_score = sc if offset_score is None else torch.minimum(offset_score, sc)

        combo_ok = tab["combo_max"][None, :] < ring_count[:, None]
        combo_ok &= (ring_count[:, None] >= 4) & anchor_valid[:, None]
        score = torch.where(combo_ok, offset_score, 0.0)
        best = torch.argmax(score, dim=-1)
        take = lambda arr: torch.gather(arr, 1, best[:, None])[:, 0]
        best_score = take(score)
        best_orient = torch.atan2(take(ss), take(cc))
        best_pos = torch.stack([take(pos_x), take(pos_y)], dim=-1)

    best_combo = tab["combos"][best]  # (A, 4) ring slot indices
    best_sides = torch.gather(ring_idx, 1, best_combo)
    blob_idx5 = torch.cat([anchor_idx[:, None], best_sides], dim=-1).to(torch.int32)
    return {
        "score": best_score,
        "orientation": best_orient,
        "pos": best_pos,
        "blob_idx": blob_idx5,
        "valid": best_score > 0.0,
    }


# ---------------------------------------------------------------------------
# tracked hypotheses
# ---------------------------------------------------------------------------


def tracked_hypotheses(cfg: DetectorConfig, blob_pos, blob_color, blob_valid,
                       tracked, colors, packed_cam, max_bot_height,
                       min_tracking_radius, max_bot_acceleration):
    """Best constellation per tracked object from small per-slot searches
    (reference src/main.cpp:81-141, src/blobs/hypothesis.cpp:230-271).

    Runs the full ``max_tracked`` window: exact for every valid output of
    the JAX package's occupancy tier, with no device->host read."""
    from ..ops.topk import query_select_topk

    dev = blob_pos.device
    tab = _tables(cfg.ring_size, dev)
    t = tracked["id"].shape[0]
    m = cfg.tracked_candidates

    tid = tracked["id"].to(torch.int64)
    tvalid = tracked["valid"]
    dt_raw = tracked["time_delta"]
    dt = dt_raw.clamp(0.0, 0.05)

    world = torch.stack([tracked["x"], tracked["y"], tracked["z"]], dim=-1)
    img = field2image_packed(packed_cam, world)
    reproj = image2field_packed(packed_cam, img, max_bot_height)[..., :2]
    reproj = torch.where(torch.isfinite(reproj), reproj, 0.0)

    pred_xy = reproj + torch.stack([tracked["vx"], tracked["vy"]], dim=-1) * dt_raw[..., None]
    pred_w = tracked["w"]
    search_radius = max_bot_acceleration * dt * dt + min_tracking_radius

    c, s = torch.cos(pred_w), torch.sin(pred_w)
    slot_pos = pred_xy[:, None, :] + _rotate(
        c[:, None], s[:, None], tab["pattern_pos"][None]
    )  # (T, 5, 2)

    cand_val, cand_idx = query_select_topk(
        slot_pos.reshape(t * 5, 2),
        (search_radius * search_radius)[:, None].expand(t, 5).reshape(-1),
        blob_pos,
        torch.where(blob_valid, 0.0, _INF),
        m=m,
        by_rank=False,
    )
    cand_val = cand_val.reshape(t, 5, m)
    cand_idx = cand_idx.reshape(t, 5, m).long()
    cand_valid = cand_val > -_INF

    combos = tab[f"tracked_combos_{m}"]  # (Ct, 5)
    n_combo = combos.shape[0]
    slot_range = torch.arange(5, device=dev)
    cand_pos = blob_pos[cand_idx]  # (T, 5, M, 2)
    pick = [(combos == mi)[None, :, :] for mi in range(m)]

    def expand(tb, null_val):
        """tb (T, 5, M[, D]) -> (T, Ct, 5[, D]); the null choice -> null_val."""
        trailing = tb.dim() == 4
        out = torch.full((t, n_combo, 5) + tuple(tb.shape[3:]), null_val,
                         dtype=tb.dtype, device=dev)
        for mi in range(m):
            p = pick[mi][..., None] if trailing else pick[mi]
            out = torch.where(p, tb[:, None, :, mi], out)
        return out

    gidx = expand(cand_idx, -1)
    gvalid = expand(cand_valid, False)

    # distinctness: no blob used twice (reference skips those combos)
    eq = (gidx[..., :, None] == gidx[..., None, :]) & (
        gvalid[..., :, None] & gvalid[..., None, :]
    )
    eq = eq & ~torch.eye(5, dtype=torch.bool, device=dev)
    distinct = ~eq.any(dim=-1).any(dim=-1)

    pos5 = expand(cand_pos, 0.0)
    oc, os_, pos, offset_score, blob_amount = score_hypotheses(pos5, gvalid, tab)

    cw, sw = torch.cos(pred_w[:, None]), torch.sin(pred_w[:, None])
    rot_off = torch.atan2(os_ * cw - oc * sw, oc * cw + os_ * sw) / math.pi
    delta = (pos - pred_xy[:, None, :]) / 10.0
    offset_score = offset_score / (1.0 + _sqnorm(delta) + rot_off * rot_off)
    offset_score = offset_score * blob_amount / 5.0

    yellow, blue, green, pink = colors[2], colors[3], colors[4], colors[5]
    pat = tab["patterns"][tid % 16]  # (T,)
    is_green = ((pat[:, None] >> (4 - slot_range[None, :])) & 1).bool()
    is_blue_team = (tid >= 16)[:, None]
    exp_side = torch.where(is_green[..., None], green, pink)  # (T, 5, 3)
    opp_side = torch.where(is_green[..., None], pink, green)
    exp_center = torch.where(is_blue_team[..., None], blue, yellow)  # (T, 1, 3)
    opp_center = torch.where(is_blue_team[..., None], yellow, blue)
    center_slot = (slot_range == 0)[None, :, None]
    expected = torch.where(center_slot, exp_center, exp_side)
    opposite = torch.where(center_slot, opp_center, opp_side)

    cand_col = blob_color[cand_idx]  # (T, 5, M, 3)
    d_exp = _sqnorm(cand_col - expected[:, :, None])
    d_opp = _sqnorm(cand_col - opposite[:, :, None])
    veto_bit = cand_valid & (d_opp - d_exp <= 0.0)
    veto = expand(veto_bit, False).any(dim=-1)  # (T, Ct)

    score = torch.where(
        distinct & ~veto & (blob_amount >= 2) & tvalid[:, None] & (tid[:, None] >= 0),
        offset_score,
        0.0,
    )
    best = torch.argmax(score, dim=-1)
    blob_idx = torch.where(_take(gvalid, best), _take(gidx, best), -1).to(torch.int32)
    best_score = _take(score, best)
    return {
        "score": best_score,
        "orientation": torch.atan2(_take(os_, best), _take(oc, best)),
        "pos": _take(pos, best),
        "blob_idx": blob_idx,
        "tracked_id": tid.to(torch.int32),
        "valid": best_score > 0.0,
    }


# ---------------------------------------------------------------------------
# clipping geometry + NMS + ball clip mask
# ---------------------------------------------------------------------------


def _front_distance(angle_to_other, fallback_radius):
    """Distance from the robot center to its hull towards angle_to_other
    (flat front within the opening angle, circle otherwise)."""
    front = angle_to_other.abs() < MIN_ROBOT_OPENING_ANGLE
    return torch.where(
        front, MIN_ROBOT_FRONT_DISTANCE / torch.cos(angle_to_other), fallback_radius
    )


def bot_bot_clipping(pos, orient, clipping_tolerance):
    """Pairwise clipping matrix (B, B) for bot hulls
    (reference src/blobs/hypothesis.cpp:106-124)."""
    diff = pos[None, :, :] - pos[:, None, :]  # diff[i, j] = pos_j - pos_i
    sqd = _sqnorm(diff)
    diff_angle = torch.atan2(diff[..., 1], diff[..., 0])
    self_angle = _remainder_2pi(diff_angle - orient[:, None])
    other_angle = _remainder_2pi(diff_angle - orient[None, :])
    min_dist = (
        _front_distance(self_angle, MIN_ROBOT_RADIUS)
        + _front_distance(other_angle, MIN_ROBOT_RADIUS)
        - clipping_tolerance
    )
    early = sqd >= (2 * MIN_ROBOT_RADIUS) ** 2
    return ~early & (sqd < min_dist * min_dist)


def bot_ball_clipping(bot_pos, bot_orient, ball_pos, ball_radius,
                      clipping_tolerance):
    """(B, k) mask: ball j clips into bot i
    (reference src/blobs/hypothesis.cpp:126-139)."""
    clipped_r = 0.48837 * ball_radius
    diff = ball_pos[None, :, :] - bot_pos[:, None, :]
    sqd = _sqnorm(diff)
    min_dist = MIN_ROBOT_RADIUS + clipped_r
    outside = sqd >= min_dist * min_dist

    angle = _remainder_2pi(
        torch.atan2(diff[..., 1], diff[..., 0]) - bot_orient[:, None]
    )
    side = angle.abs() >= MIN_ROBOT_OPENING_ANGLE
    front_dist = (MIN_ROBOT_FRONT_DISTANCE + clipped_r) / torch.cos(
        angle
    ) - clipping_tolerance
    front_clip = sqd < front_dist * front_dist
    return ~outside & (side | front_clip)


def clipping_nms(pos, orient, score, valid, clipping_tolerance):
    """Greedy clipping suppression by descending score (reference
    src/main.cpp:195-223). The JAX fori_loop runs here to its static bound
    in score order: step i lets the i-th best candidate, if still kept,
    suppress every later candidate it clips; the step is a no-op on
    invalid slots, which sort last. Returns the kept mask."""
    n = pos.shape[0]
    clip = bot_bot_clipping(pos, orient, clipping_tolerance)
    order = torch.argsort(-torch.where(valid, score, -_INF), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=pos.device)
    later = torch.ones((n, n), dtype=torch.bool, device=pos.device).triu(1)
    clip_s = clip[order][:, order] & later  # [i, q]: i-th best clips q-th, q > i
    kept_s = valid[order]
    for i in range(n):
        kept_s = kept_s & ~(clip_s[i] & kept_s[i])
    return kept_s[rank]


def color_implausible(blob_color, blob_center, colors, blob_idx5):
    """(B, 5) constellation blob indices -> (B,) bool: the constellation is
    built from balls (center not team-colored in either color table, and
    at least 3 of 4 sides orange in both)."""
    safe = torch.clamp_min(blob_idx5, 0).long()

    def classify(table):
        c = table[safe]  # (B, 5, 3)
        d = _sqnorm(c[:, :, None, :] - colors[None, None, :, :])  # (B, 5, 6)
        return torch.argmin(d, dim=-1)

    cls_d = classify(blob_color)
    cls_p = classify(blob_center)
    team_d = (cls_d[:, 0] == 2) | (cls_d[:, 0] == 3)
    team_p = (cls_p[:, 0] == 2) | (cls_p[:, 0] == 3)
    ball_side = (cls_d[:, 1:] == 0) & (cls_p[:, 1:] == 0)
    return ~(team_d | team_p) & (ball_side.sum(dim=-1) >= 3)


# ---------------------------------------------------------------------------
# full detector step
# ---------------------------------------------------------------------------


def detect(cfg: DetectorConfig, blobs, tracked, colors, packed_cam, params,
           with_nms: bool = True):
    """Device detection step: blobs -> candidate bots + ball-clip mask."""
    blob_pos = blobs["field_pos"]
    blob_valid = blobs["valid"]
    blob_color = blobs["color"]

    det = detection_hypotheses(
        cfg, blob_pos, blob_valid, params["max_robot_radius"],
        blob_color=blob_color, colors=colors,
    )
    veto_knob = params.get("color_plausibility_veto")
    if veto_knob is not None:
        vetoed = (veto_knob > 0.5) & color_implausible(
            blob_color, blobs["center"], colors, det["blob_idx"]
        )
        det = {
            **det,
            "score": torch.where(vetoed, 0.0, det["score"]),
            "valid": det["valid"] & ~vetoed,
        }
    trk = tracked_hypotheses(
        cfg, blob_pos, blob_color, blob_valid, tracked, colors, packed_cam,
        params["max_bot_height"], params["min_tracking_radius"],
        params["max_bot_acceleration"],
    )

    score = torch.cat([trk["score"], det["score"]])
    pos = torch.cat([trk["pos"], det["pos"]])
    orient = torch.cat([trk["orientation"], det["orientation"]])
    blob_idx = torch.cat([trk["blob_idx"], det["blob_idx"]])
    tracked_id = torch.cat(
        [trk["tracked_id"],
         torch.full(det["score"].shape, -1, dtype=torch.int32, device=score.device)]
    )
    keep = score > params["min_confidence"]
    sorted_score, order = torch.sort(
        torch.where(keep, score, -_INF), descending=True, stable=True)
    top_score = sorted_score[: cfg.max_bots]
    top_i = order[: cfg.max_bots]
    valid = top_score > 0.0
    pos_b = pos[top_i]
    orient_b = orient[top_i]
    score_b = torch.where(valid, top_score, 0.0)

    out = {
        "bot_pos": pos_b,
        "bot_orientation": orient_b,
        "bot_score": score_b,
        "bot_blob_idx": blob_idx[top_i],
        "bot_tracked_id": tracked_id[top_i],
        "bot_valid": valid,
    }
    if not with_nms:
        return out

    kept = clipping_nms(pos_b, orient_b, score_b, valid, params["clipping_tolerance"])
    ball_clip = bot_ball_clipping(pos_b, orient_b, blob_pos, params["ball_radius"],
                                  params["clipping_tolerance"])
    out["bot_valid"] = kept
    out["ball_clipped"] = (ball_clip & kept[:, None]).any(dim=0) & blob_valid
    return out


def finalize_detections_batched(det, blob_pos, blob_valid, clipping_tolerance,
                                ball_radius):
    """Clipping NMS + ball-clip mask over a stacked camera axis: completes
    ``detect(..., with_nms=False)`` outputs carrying a leading (n_cams,)
    axis, one camera at a time."""
    n = det["bot_pos"].shape[0]
    dev = det["bot_pos"].device
    ct = torch.broadcast_to(torch.as_tensor(clipping_tolerance, dtype=torch.float32,
                                            device=dev), (n,))
    br = torch.broadcast_to(torch.as_tensor(ball_radius, dtype=torch.float32,
                                            device=dev), (n,))
    kept, clipped = [], []
    for i in range(n):
        k = clipping_nms(det["bot_pos"][i], det["bot_orientation"][i],
                         det["bot_score"][i], det["bot_valid"][i], ct[i])
        bc = bot_ball_clipping(det["bot_pos"][i], det["bot_orientation"][i],
                               blob_pos[i], br[i], ct[i])
        kept.append(k)
        clipped.append((bc & k[:, None]).any(dim=0) & blob_valid[i])
    det["bot_valid"] = torch.stack(kept)
    det["ball_clipped"] = torch.stack(clipped)
    return det


def _guarded_kmeans2(contrast, vals, c1_init, c2_init, iters: int = 24):
    """Vectorized guarded 2-means over the 4 side-blob colors of each bot
    (reference src/blobs/kmeans.cpp:20-90; host kmeans2 semantics with
    integer floor division). contrast (B, 3), vals (B, 4, 3), c1/c2 (3,)
    or one init per row (B, 3), int32. Runs ``iters`` rounds; a finished
    row is never updated again."""
    b = vals.shape[0]
    dev = vals.device
    rows = torch.arange(b, device=dev)
    c1_init = torch.broadcast_to(c1_init, (b, 3))
    c2_init = torch.broadcast_to(c2_init, (b, 3))
    out_group = _sqnorm_i(vals - contrast[:, None, :]).amin(dim=-1)  # (B,)
    d = vals[:, :, None, :] - vals[:, None, :, :]
    pair = _sqnorm_i(d) + torch.eye(4, dtype=vals.dtype, device=dev) * (2**30)
    in_group = pair.amin(dim=-1).amin(dim=-1)
    may_split = in_group <= out_group

    c1 = vals[rows, torch.argmin(_sqnorm_i(vals - c1_init[:, None]), dim=-1)]
    c2 = vals[rows, torch.argmin(_sqnorm_i(vals - c2_init[:, None]), dim=-1)]
    degenerate = (c1 == c2).all(dim=-1)

    ok = may_split & ~degenerate
    active = ok
    for _ in range(iters):
        d1 = _sqnorm_i(vals - c1[:, None, :])
        d2 = _sqnorm_i(vals - c2[:, None, :])
        assign1 = d1 < d2  # (B, 4)
        n1 = assign1.sum(dim=-1, dtype=vals.dtype)
        n2 = 4 - n1
        empty = (n1 == 0) | (n2 == 0)
        ok = ok & ~(empty & active)
        active = active & ~empty
        s1 = torch.where(assign1[..., None], vals, 0).sum(dim=1, dtype=vals.dtype)
        s2 = torch.where(assign1[..., None], 0, vals).sum(dim=1, dtype=vals.dtype)
        new1 = torch.div(s1, torch.clamp_min(n1, 1)[:, None], rounding_mode="floor")
        new2 = torch.div(s2, torch.clamp_min(n2, 1)[:, None], rounding_mode="floor")
        conv = (new1 == c1).all(dim=-1) | (new2 == c2).all(dim=-1)
        c1 = torch.where(active[:, None], new1, c1)
        c2 = torch.where(active[:, None], new2, c2)
        active = active & ~conv

    split = _sqnorm_i(c1 - c2).to(torch.float32)
    weak = split < out_group.to(torch.float32) / 4.0
    ok = ok & ~weak
    c1 = torch.where(ok[:, None], c1, c1_init)
    c2 = torch.where(ok[:, None], c2, c2_init)
    return c1, c2


def estimate_bot_ids(det, blob_color, colors):
    """In-graph bot id estimate (host_detect.calc_bot_id semantics,
    reference src/blobs/hypothesis.cpp:208-227): guarded per-bot 2-means of
    the side colors, green/pink bits, team by center color. Tracked bots
    keep their known id.

    One camera: ``bot_blob_idx`` (B, 5), blob_color (K, 3), colors (7, 3).
    With a leading camera axis on all three (and on ``bot_tracked_id``) it
    is the JAX package's ``jax.vmap(estimate_bot_ids)``: the camera axis
    folds into the bot axis, each row's 2-means seeded from its own
    camera's table, which is exact since the 2-means is row-wise."""
    tab = _tables(8, blob_color.device)
    idx = det["bot_blob_idx"]
    tid = det["bot_tracked_id"]
    if idx.dim() == 2:
        return estimate_bot_ids(
            {"bot_blob_idx": idx[None], "bot_tracked_id": tid[None]},
            blob_color[None], colors[None])[0]
    n, b = idx.shape[:2]
    yellow, blue, green, pink = colors[:, 2], colors[:, 3], colors[:, 4], colors[:, 5]
    safe = torch.clamp_min(idx, 0).long()  # (N, B, 5)
    c = torch.gather(blob_color, 1, safe.reshape(n, b * 5, 1).expand(-1, -1, 3))
    c = c.reshape(n, b, 5, 3)

    # the host path truncates (np .astype), not rounds
    ci = c.to(torch.int32).reshape(n * b, 5, 3)
    g0 = green.to(torch.int32).repeat_interleave(b, dim=0)
    p0 = pink.to(torch.int32).repeat_interleave(b, dim=0)
    g_ref, p_ref = _guarded_kmeans2(ci[:, 0], ci[:, 1:5], g0, p0)

    d_green = _sqnorm_i(ci[:, 1:5] - g_ref[:, None, :])
    d_pink = _sqnorm_i(ci[:, 1:5] - p_ref[:, None, :])
    bits = (d_green < d_pink).to(torch.int64)
    mask = bits[:, 0] * 8 + bits[:, 1] * 4 + bits[:, 2] * 2 + bits[:, 3]
    base_id = tab["pattern_lut"][mask].reshape(n, b)
    d_blue = _sqnorm(c[:, :, 0] - blue[:, None])
    d_yellow = _sqnorm(c[:, :, 0] - yellow[:, None])
    team16 = torch.where(d_blue < d_yellow, 16, 0).to(torch.int32)
    est = base_id + team16
    return torch.where(tid >= 0, tid, est).to(torch.int32)
