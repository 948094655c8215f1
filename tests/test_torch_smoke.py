"""chip_smoke.py's loader of another checkout (``--before DIR``), on the CPU.

The smoke times B2-B6 and E5 of another checkout through that checkout's own
package, imported under another name. Here the checkout is this one: its
package, loaded so, must be a second copy (its own modules and launch
counts) whose B2-B6 and E5 give what this package's give, bit for bit.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from vision_processor_tpu_torch.ops import blob_fused as BF
from vision_processor_tpu_torch.ops import combo_fused as CF
from vision_processor_tpu_torch.ops import cuda
from vision_processor_tpu_torch.ops import topk as T

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_before_kernels_are_a_second_copy(smoke):
    before = smoke.before_kernels(ROOT)
    assert before["root"] == str(ROOT)
    assert before["cuda"] is not cuda and before["cuda"].LAUNCHES is not cuda.LAUNCHES
    assert before["B2"] is not BF.blob_response_fused
    assert before["B2"].__module__ == "vptpu_before.ops.blob_fused"

    rng = np.random.default_rng(4)
    flat = torch.from_numpy(rng.uniform(0, 255, (37, 61, 3)).astype(np.float32))
    got = before["B2"](flat, 50.0, 1, 4, 3)
    want = BF.blob_response_fused(flat, 50.0, 1, 4, 3)
    for a, b in zip((got[0], got[1], *got[2], got[3]), (want[0], want[1], *want[2], want[3])):
        assert torch.equal(a, b)
    assert torch.equal(before["B5"](flat, 2, 5), BF.circularity_fused(flat, 2, 5))


def test_before_topk_kernels_are_a_second_copy(smoke):
    before = smoke.before_kernels(ROOT)
    assert before["B3"] is not T.row_topk and before["B4"] is not T.query_select_topk
    assert before["B3"].__module__ == before["B4"].__module__ == "vptpu_before.ops.topk"

    rng = np.random.default_rng(6)
    x = rng.normal(size=(12, 50)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.8] = -np.inf
    x = torch.from_numpy(x)
    for a, b in zip(before["B3"](x, 6), T.row_topk(x, 6)):
        assert torch.equal(a, b)
    qxy = torch.from_numpy(rng.uniform(-100, 100, (7, 2)).astype(np.float32))
    bxy = torch.from_numpy(rng.uniform(-100, 100, (40, 2)).astype(np.float32))
    r2 = torch.full((7,), 2500.0)
    rank = torch.from_numpy(rng.uniform(0, 5, 40).astype(np.float32))
    for by_rank in (True, False):
        got = before["B4"](qxy, r2, bxy, rank, m=4, by_rank=by_rank)
        want = T.query_select_topk(qxy, r2, bxy, rank, m=4, by_rank=by_rank)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_before_b6_e5_are_a_second_copy(smoke):
    before = smoke.before_kernels(ROOT)
    assert before["B6"] is not CF.combo_chain and before["E5"] is not T.row_topk_blk
    assert before["B6"].__module__ == "vptpu_before.ops.combo_fused"
    assert before["E5"].__module__ == "vptpu_before.ops.topk"

    rng = np.random.default_rng(7)
    a, c = 9, 40
    maps = torch.from_numpy(rng.normal(0, 50, (12, a, c)).astype(np.float32))
    pos = torch.from_numpy(rng.normal(0, 500, (a, 2)).astype(np.float32))
    rc = torch.from_numpy(rng.integers(0, 9, a).astype(np.int32))
    valid = torch.from_numpy(rng.random(a) > 0.3)
    cmax = torch.from_numpy(rng.integers(0, 8, c).astype(np.int32))
    pat = rng.normal(0, 50, (5, 2)).astype(np.float32)
    args = (maps, pos, rc, valid, cmax, pat, pat.sum(axis=0))
    assert all(torch.equal(a, b) for a, b in zip(before["B6"](*args), CF.combo_chain(*args)))
    x = rng.normal(size=(12, 50)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.8] = -np.inf
    x = torch.from_numpy(x)
    for a, b in zip(before["E5"](x, 6, 8), T.row_topk_blk(x, 6, 8)):
        assert torch.equal(a, b)


def test_before_e1_is_a_second_copy(smoke):
    """E1 comes as the other checkout's bare launch (no window check), which
    takes CUDA tensors only."""
    from vision_processor_tpu_torch.ops import band_warp as BW

    before = smoke.before_kernels(ROOT)
    assert before["E1"] is not BW._launch
    assert before["E1"].__module__ == "vptpu_before.ops.band_warp"
    assert before["E1"].__name__ == "_launch"
    with pytest.raises(ValueError, match="CUDA"):
        before["E1"](torch.zeros(1, 8, 128), torch.zeros(1, 8, 128),
                     torch.zeros(1, 1, dtype=torch.int32), 2)
