"""Copy of vision_processor_tpu/models/kmeans.py for the port.

Guarded 2-means over small color sets (host-side, integer vectors).

Reference semantics (reference src/blobs/kmeans.cpp:20-90): refuse to split
when the tightest in-group pair is looser than the contrast distance, seed
centers from the nearest members, restore the previous centers when the
result degenerates or the split is weaker than half the contrast distance.
Integer division semantics are preserved.
"""
from __future__ import annotations

import numpy as np


def kmeans2(
    contrast: np.ndarray, values: list[np.ndarray], c1: np.ndarray, c2: np.ndarray
) -> tuple[bool, np.ndarray, np.ndarray]:
    """Returns (updated, c1, c2); inputs are int vectors, not mutated."""
    c1 = np.asarray(c1, dtype=np.int64)
    c2 = np.asarray(c2, dtype=np.int64)
    if len(values) < 2:
        return False, c1, c2
    vals = np.asarray(values, dtype=np.int64)
    contrast = np.asarray(contrast, dtype=np.int64)

    out_group = np.min(np.sum((vals - contrast) ** 2, axis=-1))
    d = vals[:, None, :] - vals[None, :, :]
    pair = np.sum(d * d, axis=-1)
    np.fill_diagonal(pair, np.iinfo(np.int64).max)  # exclude self-pairs
    in_group = np.min(pair)

    if in_group > out_group:
        return False, c1, c2

    backup1, backup2 = c1.copy(), c2.copy()
    c1 = vals[np.argmin(np.sum((vals - c1) ** 2, axis=-1))].copy()
    c2 = vals[np.argmin(np.sum((vals - c2) ** 2, axis=-1))].copy()
    if np.array_equal(c1, c2):
        return False, backup1, backup2

    old1, old2 = c2.copy(), c1.copy()
    while not (np.array_equal(old1, c1) or np.array_equal(old2, c2)):
        assign1 = np.sum((vals - c1) ** 2, axis=-1) < np.sum(
            (vals - c2) ** 2, axis=-1
        )
        n1 = int(assign1.sum())
        n2 = len(vals) - n1
        if n1 == 0 or n2 == 0:
            return False, backup1, backup2
        old1, old2 = c1, c2
        # integer division like Eigen Vector3i / int
        c1 = vals[assign1].sum(axis=0) // n1
        c2 = vals[~assign1].sum(axis=0) // n2

    if np.linalg.norm(c1 - c2) < np.sqrt(out_group) / 2.0:
        return False, backup1, backup2

    return True, c1, c2


def kmeans2_batch(
    contrast: np.ndarray,
    vals: np.ndarray,
    c1_init: np.ndarray,
    c2_init: np.ndarray,
    max_iters: int = 24,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched ``kmeans2``: same guarded semantics, one numpy pass per
    iteration over all rows instead of a Python call per row (the per-bot
    id assignment was the host-finishing hot spot at ~0.18 ms/call).

    contrast (B, 3), vals (B, N, 3), c1/c2 (3,) ints.
    Returns (updated (B,), c1 (B, 3), c2 (B, 3)).
    """
    vals = np.asarray(vals, dtype=np.int64)
    contrast = np.asarray(contrast, dtype=np.int64)
    c1_init = np.asarray(c1_init, dtype=np.int64)
    c2_init = np.asarray(c2_init, dtype=np.int64)
    b, n = vals.shape[:2]
    if b == 0 or n < 2:
        return (
            np.zeros(b, dtype=bool),
            np.broadcast_to(c1_init, (b, 3)).copy(),
            np.broadcast_to(c2_init, (b, 3)).copy(),
        )

    out_group = np.min(
        np.sum((vals - contrast[:, None, :]) ** 2, axis=-1), axis=-1
    )
    d = vals[:, :, None, :] - vals[:, None, :, :]
    pair = np.sum(d * d, axis=-1)
    pair[:, np.arange(n), np.arange(n)] = np.iinfo(np.int64).max
    in_group = np.min(pair, axis=(-2, -1))
    may_split = in_group <= out_group

    rows = np.arange(b)
    c1 = vals[rows, np.argmin(np.sum((vals - c1_init) ** 2, axis=-1), axis=-1)]
    c2 = vals[rows, np.argmin(np.sum((vals - c2_init) ** 2, axis=-1), axis=-1)]
    degenerate = np.all(c1 == c2, axis=-1)

    ok = may_split & ~degenerate
    active = ok.copy()
    for _ in range(max_iters):
        if not active.any():
            break
        d1 = np.sum((vals - c1[:, None, :]) ** 2, axis=-1)
        d2 = np.sum((vals - c2[:, None, :]) ** 2, axis=-1)
        assign1 = d1 < d2  # (B, N)
        n1 = assign1.sum(axis=-1)
        n2 = n - n1
        empty = (n1 == 0) | (n2 == 0)
        ok &= ~(empty & active)
        active &= ~empty
        s1 = np.sum(np.where(assign1[..., None], vals, 0), axis=1)
        s2 = np.sum(np.where(assign1[..., None], 0, vals), axis=1)
        new1 = s1 // np.maximum(n1, 1)[:, None]
        new2 = s2 // np.maximum(n2, 1)[:, None]
        # scalar loop stops when EITHER center repeats (checked against the
        # pre-update centers)
        conv = np.all(new1 == c1, axis=-1) | np.all(new2 == c2, axis=-1)
        c1 = np.where(active[:, None], new1, c1)
        c2 = np.where(active[:, None], new2, c2)
        active &= ~conv

    split = np.sum((c1 - c2) ** 2, axis=-1).astype(np.float64)
    ok &= split >= out_group.astype(np.float64) / 4.0
    c1 = np.where(ok[:, None], c1, c1_init)
    c2 = np.where(ok[:, None], c2, c2_init)
    return ok, c1, c2
