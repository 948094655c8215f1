"""Uncapped host-side oracle of the reference's UNTRACKED bot emission
(the port's copy of python/dense_oracle.py, on the port's pattern tables).

Implements, in plain numpy with no shape caps, exactly what the reference
emits for a blob set on the untracked path:

1. per-anchor best hypothesis over EVERY cyclic 4-subset of ALL in-radius
   blobs (reference src/main.cpp:43-79 generateAngleSortedBotHypotheses —
   every blob is an anchor; rangeSearch returns the anchor itself too),
   scored by BotHypothesis semantics (reference
   src/blobs/hypothesis.cpp:156-205),
2. the score filter (keep score > min_confidence, reference
   src/main.cpp:143-153 filterHypothesesScore),
3. the bot-bot clipping suppression (reference src/main.cpp:195-223
   filterClippingBotBotHypotheses; front-flat hull geometry from
   src/blobs/hypothesis.cpp:106-124).

Color plays no role in the reference's untracked emission decision (it
only assigns ids/teams), so the oracle is geometric-only — which is the
point: it arbitrates whether the device path's emissions on dense scenes
(including pattern-shaped noise constellations) match what the reference's
own enumeration would put on the wire. Used by the port's bench
(vision_processor_tpu_torch/bench.py measure_dense_precision).
"""
from __future__ import annotations

import math
from itertools import combinations

import numpy as np

from .models.pattern import (
    MIN_ROBOT_FRONT_DISTANCE,
    MIN_ROBOT_OPENING_ANGLE,
    MIN_ROBOT_RADIUS,
    PATTERN_ANGLES_B2B,
    PATTERN_POS,
)

_PAIRS = [(a, b) for a in range(5) for b in range(a + 1, 5)]
_PAIR_A = np.array([p[0] for p in _PAIRS])
_PAIR_B = np.array([p[1] for p in _PAIRS])
_PAIR_ANGLE = np.asarray(PATTERN_ANGLES_B2B).reshape(5, 5)[_PAIR_B, _PAIR_A]
_PATTERN_POS = np.asarray(PATTERN_POS, dtype=np.float64)


def score5_batch(pos5: np.ndarray):
    """Reference BotHypothesis scoring for a batch of full 5-blob
    constellations (reference src/blobs/hypothesis.cpp:156-205).

    pos5: (M, 5, 2). Returns (orientation (M,), pos (M, 2), score (M,)).
    """
    pa = pos5[:, _PAIR_A]
    pb = pos5[:, _PAIR_B]
    d = pb - pa
    delta = np.arctan2(d[..., 1], d[..., 0]) - _PAIR_ANGLE
    o_sin = np.sin(delta).sum(axis=-1)
    o_cos = np.cos(delta).sum(axis=-1)
    orientation = np.arctan2(o_sin, o_cos)
    c, s = np.cos(orientation), np.sin(orientation)
    # rotate the pattern by +orientation: p @ [[c, s], [-s, c]]
    rot = np.einsum("kj,mji->mki", _PATTERN_POS,
                    np.stack([np.stack([c, s], -1),
                              np.stack([-s, c], -1)], axis=1))
    offsets = pos5 - rot
    pos = offsets.mean(axis=1)
    slot_off = (pos5 - (pos[:, None] + rot)) / 10.0
    score = (1.0 / (1.0 + np.sum(slot_off**2, axis=-1))).min(axis=1)
    return orientation, pos, score


def best_hypotheses(blob_pos, blob_valid, max_robot_radius):
    """Best 5-blob hypothesis per anchor, uncapped.

    Every valid blob anchors; its candidate ring is ALL valid blobs within
    max_robot_radius (including itself, like the reference's rangeSearch);
    anchors with fewer than 4 ring members are skipped (reference
    src/main.cpp:53-54). Enumerates every 4-subset in every cyclic rotation
    of the angle-sorted ring.

    Returns (anchor_idx (H,), score (H,), orientation (H,), pos (H, 2)).
    """
    pos = np.asarray(blob_pos, dtype=np.float64)
    valid = np.asarray(blob_valid, dtype=bool)
    vidx = np.flatnonzero(valid)
    vpos = pos[vidx]
    r2 = float(max_robot_radius) ** 2

    out_idx, out_score, out_orient, out_pos = [], [], [], []
    # pairwise in-radius adjacency over the valid set only
    d2 = np.sum(
        (vpos[:, None, :] - vpos[None, :, :]) ** 2, axis=-1
    )
    inr_mask = d2 <= r2
    for ai in range(len(vidx)):
        ring_local = np.flatnonzero(inr_mask[ai])
        if len(ring_local) < 4:
            continue
        rpos = vpos[ring_local]
        ang = np.arctan2(rpos[:, 1] - vpos[ai, 1], rpos[:, 0] - vpos[ai, 0])
        order = np.argsort(ang)
        rpos = rpos[order]
        n = len(rpos)
        subs = np.array(list(combinations(range(n), 4)), dtype=np.int64)
        # all 4 cyclic rotations of each angle-ordered subset
        rots = np.concatenate([np.roll(subs, -r, axis=1) for r in range(4)])
        pos5 = np.concatenate(
            [np.broadcast_to(vpos[ai], (len(rots), 1, 2)), rpos[rots]], axis=1
        )
        orient, hpos, score = score5_batch(pos5)
        b = int(np.argmax(score))
        out_idx.append(int(vidx[ai]))
        out_score.append(float(score[b]))
        out_orient.append(float(orient[b]))
        out_pos.append(hpos[b])
    return (
        np.asarray(out_idx, dtype=np.int64),
        np.asarray(out_score, dtype=np.float64),
        np.asarray(out_orient, dtype=np.float64),
        np.asarray(out_pos, dtype=np.float64).reshape(-1, 2),
    )


def _front_distance(angle, fallback):
    return np.where(
        np.abs(angle) < MIN_ROBOT_OPENING_ANGLE,
        MIN_ROBOT_FRONT_DISTANCE / np.cos(angle),
        fallback,
    )


def _rem2pi(x):
    return x - 2.0 * math.pi * np.round(x / (2.0 * math.pi))


def bot_bot_clipping(pos, orient, clipping_tolerance):
    """(H, H) clipping matrix, reference front-flat hull geometry
    (reference src/blobs/hypothesis.cpp:106-124)."""
    diff = pos[None, :, :] - pos[:, None, :]
    sqd = np.sum(diff * diff, axis=-1)
    diff_angle = np.arctan2(diff[..., 1], diff[..., 0])
    self_angle = _rem2pi(diff_angle - orient[:, None])
    other_angle = _rem2pi(diff_angle - orient[None, :])
    min_dist = (
        _front_distance(self_angle, MIN_ROBOT_RADIUS)
        + _front_distance(other_angle, MIN_ROBOT_RADIUS)
        - clipping_tolerance
    )
    early = sqd >= (2 * MIN_ROBOT_RADIUS) ** 2
    return (~early) & (sqd < min_dist * min_dist)


def clipping_nms(pos, orient, score, clipping_tolerance):
    """Greedy descending-score clipping suppression — the stable form of
    the reference's list surgery (reference src/main.cpp:195-223). Ties
    suppress by position in the order. Returns the kept mask."""
    n = len(score)
    kept = np.ones(n, dtype=bool)
    clip = bot_bot_clipping(pos, orient, clipping_tolerance)
    order = np.argsort(-score, kind="stable")
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    for i in order:
        if not kept[i]:
            continue
        kept &= ~(clip[i] & (rank > rank[i]))
    return kept


def emit_bots(blob_pos, blob_valid, max_robot_radius, min_confidence,
              clipping_tolerance):
    """Full untracked emission: enumerate -> score filter -> clipping NMS.

    Returns dict of the emitted (kept) hypotheses: anchor blob index,
    score, orientation, position.
    """
    aidx, score, orient, pos = best_hypotheses(
        blob_pos, blob_valid, max_robot_radius
    )
    keep = score > float(min_confidence)
    aidx, score, orient, pos = aidx[keep], score[keep], orient[keep], pos[keep]
    kept = (
        clipping_nms(pos, orient, score, float(clipping_tolerance))
        if len(score) else np.zeros(0, dtype=bool)
    )
    return {
        "anchor": aidx[kept],
        "score": score[kept],
        "orientation": orient[kept],
        "pos": pos[kept],
        "n_hypotheses": int(len(score)),
        # pre-NMS hypothesis set (above min_confidence): the membership
        # test for "is this emission a reference-scored hypothesis" — a
        # device emission may be NMS-suppressed in the oracle by an extra
        # noise constellation the capped search never anchored, so
        # legitimacy is judged against the hypothesis pool, not the
        # post-NMS survivors
        "all_pos": pos,
        "all_score": score,
    }


def match_sets(pos_a, pos_b, tol_mm: float = 20.0):
    """Greedy mutual-nearest matching between two position sets.

    Returns the number of matched pairs (each element used once)."""
    if len(pos_a) == 0 or len(pos_b) == 0:
        return 0
    d = np.linalg.norm(pos_a[:, None, :] - pos_b[None, :, :], axis=-1)
    matched = 0
    used_a = np.zeros(len(pos_a), dtype=bool)
    used_b = np.zeros(len(pos_b), dtype=bool)
    while True:
        d_masked = np.where(
            used_a[:, None] | used_b[None, :], np.inf, d
        )
        i, j = np.unravel_index(np.argmin(d_masked), d.shape)
        if not np.isfinite(d_masked[i, j]) or d_masked[i, j] > tol_mm:
            break
        used_a[i] = used_b[j] = True
        matched += 1
    return matched
