"""The k-means round counters of the port's recorder (``utils/timing.py``)
on the CPU: both static 24-round loops (``models/device_finish.py
masked_kmeans2``, ``models/detector.py _guarded_kmeans2``) give bit-equal
outputs with device counting on and off, and ``kmeans.live_rounds`` is a
plain Python count of the rounds that start with a row still active.

No input found runs all 24 rounds: over 15 million random rows of four
small integer colours the longest ran 4 (and 5 over 20,000 masked calls
of 4-8 colours). So the row that runs all its rounds is the longest row
in a 3-round call."""
from __future__ import annotations

import pytest
import torch

from vision_processor_tpu_torch.models import detector as D
from vision_processor_tpu_torch.models import device_finish as DF
from vision_processor_tpu_torch.utils import timing as T

FAR = [10_000, 10_000, 10_000]
# _guarded_kmeans2 rows (4 side colours, two inits) and their live rounds
GUARDED = [
    # degenerate: both inits nearest the same colour, never active
    ([[0, 0, 0], [10, 10, 10], [20, 20, 20], [30, 30, 30]], [0, 0, 0], [0, 0, 0]),
    # two tight pairs: active in round 1, converged by its end
    ([[0, 0, 0], [1, 1, 1], [50, 50, 50], [51, 51, 51]], [0, 0, 0], [50, 50, 50]),
    # the longest found: 4 rounds
    ([[0, -2, 0], [0, -2, 1], [2, 2, 0], [0, 2, 1]], [0, -2, 0], [0, -2, 1]),
]
# masked_kmeans2 calls (colours, mask, inits), one row each
MASKED = [
    ([[4, 1, 3], [0, 6, 1], [6, 6, 4], [0, 7, 1]], [True] * 4, [4, 1, 3], [4, 1, 3]),
    ([[17, 4, 11], [19, 15, 20], [18, 2, 19], [0, 15, 8], [17, 7, 6]],
     [False, True, True, True, True], [4, 7, 20], [4, 16, 12]),
    ([[4, 1, 3], [0, 6, 1], [6, 6, 4], [0, 7, 1], [5, 2, 3], [6, 0, 1], [1, 4, 0],
      [5, 4, 7]], [True] * 8, [7, 1, 5], [3, 5, 4]),
]


def _sq(a, b):
    return sum((x - y) ** 2 for x, y in zip(a, b))


def plain_live_rounds(contrast, pts, mask, c1_init, c2_init, iters):
    """The rounds of one row's guarded 2-means (host kmeans2 semantics,
    integer floor means) that start with the row active, in Python ints."""
    idx = [i for i, m in enumerate(mask) if m]
    out_group = min([_sq(pts[i], contrast) for i in idx], default=2**30)
    in_group = min([_sq(pts[i], pts[j]) for i in idx for j in idx if i != j],
                   default=2**30)

    def nearest(c):
        return list(pts[min(idx, key=lambda i: (_sq(pts[i], c), i))])

    c1, c2 = nearest(c1_init), nearest(c2_init)
    active = in_group <= out_group and len(idx) >= 2 and c1 != c2
    live = 0
    for _ in range(iters):
        live += active
        in1 = [m and _sq(p, c1) < _sq(p, c2) for p, m in zip(pts, mask)]
        in2 = [m and not a for m, a in zip(mask, in1)]
        n1, n2 = sum(in1), sum(in2)
        active = active and n1 > 0 and n2 > 0
        new1 = [sum(p[k] for p, a in zip(pts, in1) if a) // max(n1, 1) for k in range(3)]
        new2 = [sum(p[k] for p, a in zip(pts, in2) if a) // max(n2, 1) for k in range(3)]
        converged = new1 == c1 or new2 == c2
        if active:
            c1, c2 = new1, new2
        active = active and not converged
    return live


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder in the loops' modules' place."""
    rec = T.Recorder()
    monkeypatch.setattr(D, "RECORDER", rec)
    monkeypatch.setattr(DF, "RECORDER", rec)
    return rec


def _live(rec, frame_set=0):
    rec.reduce_rounds()
    rec.read_rounds(frame_set)
    counts = {}
    for c in rec.drain()["counts"]:
        assert c.frame_set == frame_set
        counts[c.name] = counts.get(c.name, 0) + c.value
    return counts, counts.get("kmeans.live_rounds", 0)


def _guarded(iters):
    vals = torch.tensor([r[0] for r in GUARDED], dtype=torch.int32)
    contrast = torch.tensor([FAR] * len(GUARDED), dtype=torch.int32)
    c1 = torch.tensor([r[1] for r in GUARDED], dtype=torch.int32)
    c2 = torch.tensor([r[2] for r in GUARDED], dtype=torch.int32)
    return D._guarded_kmeans2(contrast, vals, c1, c2, iters=iters)


def _masked(iters):
    return [DF.masked_kmeans2(torch.tensor(FAR), torch.tensor(v), torch.tensor(m),
                              torch.tensor(a), torch.tensor(b), iters=iters)
            for v, m, a, b in MASKED]


@pytest.mark.parametrize("loop", ["guarded", "masked"])
def test_kmeans_outputs_bit_equal_with_device_counting(recorder, loop):
    run = _guarded if loop == "guarded" else _masked
    off = run(24)
    recorder.enable(device_counting=True)
    on = run(24)
    flat = lambda out: [t for o in (out if loop == "masked" else [out]) for t in o]  # noqa: E731
    for a, b in zip(flat(off), flat(on), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    counts, live = _live(recorder)
    calls = 1 if loop == "guarded" else len(MASKED)
    assert counts["kmeans.rounds"] == 24 * calls and live > 0


@pytest.mark.parametrize("iters", [24, 3])
@pytest.mark.parametrize("loop", ["guarded", "masked"])
def test_live_rounds_count_the_rounds_a_row_starts_active(recorder, loop, iters):
    """A row is never active (degenerate), one freezes after round 1, one
    runs 4 (guarded) or 5 (masked) rounds, all 3 of a 3-round call: a
    call's live rounds are its longest row's, the masked loop's calls (one
    row each) add up."""
    recorder.enable(device_counting=True)
    if loop == "guarded":
        rows = [plain_live_rounds(FAR, v, [True] * 4, a, b, iters) for v, a, b in GUARDED]
        assert rows == [0, 1, min(4, iters)]
        want = max(rows)
        _guarded(iters)
    else:
        rows = [plain_live_rounds(FAR, v, m, a, b, iters) for v, m, a, b in MASKED]
        assert rows == [0, 1, min(5, iters)]
        want = sum(rows)
        _masked(iters)
    counts, live = _live(recorder)
    assert live == want
    assert counts["kmeans.rounds"] == iters * (1 if loop == "guarded" else len(MASKED))
