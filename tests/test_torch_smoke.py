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


def test_counting_runner_passes_argv_and_writes_the_counts(smoke, tmp_path):
    """The processes phase's runner runs a launcher as ``__main__`` with the
    arguments after its own two, keeps the launcher's exit code and writes
    the child's launch counts (every kernel's, 0 here) when it exits."""
    import json
    import subprocess
    import sys

    runner, counts = tmp_path / "runner.py", tmp_path / "counts.json"
    runner.write_text(smoke.COUNTING_RUNNER)
    launcher = smoke.LAUNCHER_DIR / "vision_processor.py"
    proc = subprocess.run([sys.executable, str(runner), str(launcher), str(counts), "--help"],
                          capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout
    assert json.loads(counts.read_text()) == {name: 0 for name in cuda.LAUNCHES}
    proc = subprocess.run([sys.executable, str(runner), str(launcher), str(counts), "--bad"],
                          capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 2 and "--bad" in proc.stderr


def test_soak_scenes_loop_with_clutter_in_the_dense_entries(smoke):
    """The soak's bank (``soak_scenes`` over the bench's dense rig, not
    rendered): each camera's robots and ball move by SOAK_RADIUS mm on one
    loop of SOAK_BANK entries; only the SOAK_DENSE entries hold clutter,
    SOAK_CLEAR mm or more from every robot; the ball as well."""
    import math

    from vision_processor_tpu_torch.bench import build_rig

    rig = build_rig(smoke.N_CAMS, dense=True, dense_blobs=1900, resampling_factor=1.25,
                    return_scenes=True, raws=np.zeros((smoke.N_CAMS, 1080, 1920), np.uint8),
                    device="cpu")
    scenes = smoke.soak_scenes(rig[8], rig[9])
    assert len(scenes) == smoke.N_CAMS
    for base, bank in zip(rig[9], scenes):
        assert len(bank) == smoke.SOAK_BANK
        for k, scene in enumerate(bank):
            a = 2 * math.pi * k / smoke.SOAK_BANK
            step = smoke.SOAK_RADIUS * np.array([math.cos(a), math.sin(a)])
            for bot, first in zip(scene.bots, bank[0].bots):
                assert np.allclose([bot.x - first.x, bot.y - first.y],
                                   step - [smoke.SOAK_RADIUS, 0.0], atol=1e-6)
                assert bot.orientation == pytest.approx(first.orientation + a)
            ball = scene.balls[0]
            assert np.allclose([ball.x - base.balls[0].x, ball.y - base.balls[0].y], step)
            clutter = scene.balls[1:]
            assert bool(clutter) == (k in smoke.SOAK_DENSE)
            assert len(clutter) > 1500 or not clutter
            for s in scene.balls:
                assert min(math.hypot(s.x - b.x, s.y - b.y)
                           for b in scene.bots) >= smoke.SOAK_CLEAR


def test_jax_soak_found_reads_the_last_pass_for_every_later_one(smoke):
    found = smoke.JAX_SOAK_FOUND
    assert sorted(found) == list(range(smoke.N_CAMS))
    for c, by in found.items():
        for passes in by.values():
            assert passes and all(len(p) == smoke.SOAK_BANK and set(p) <= {"0", "1"}
                                  for p in passes)
        for number in (1, smoke.SOAK_BANK, smoke.SOAK_BANK + 1, 10_000):
            k, loop = (number - 1) % smoke.SOAK_BANK, (number - 1) // smoke.SOAK_BANK
            got = smoke.jax_soak_found(c, number)
            for key, passes in by.items():
                assert got[key] == (passes[min(loop, len(passes) - 1)][k] == "1")


def test_soak_found_counts_against_the_jax_package(smoke):
    """Camera 0's first pass: the JAX package names every robot but in
    dense entry 5 and finds the ball in entries 0-5, 7 and 9. A port that
    does the same in every frame agrees everywhere; one that misses the
    ball in entry 0 and names every robot in entry 5 falls short once
    and disagrees twice."""
    bank = smoke.SOAK_BANK
    want = smoke.JAX_SOAK_FOUND[0]

    def frame(number, ids, ball):
        k = (number - 1) % bank
        errs = [5.0] * 3 + [5.0 if ids else float("inf")]
        return (number, k, errs, [5.0] * 4, 5.0 if ball else float("inf"), 4, 1)

    same = [frame(n, want["ids"][0][n - 1] == "1", want["ball"][0][n - 1] == "1")
            for n in range(1, bank + 1)]
    got = smoke.soak_found(0, same)
    assert got == {"frames": bank, "robots": bank, "jax_ids": 10, "ids": 10,
                   "ids_agree": bank, "jax_ball": 8, "ball": 8, "ball_agree": bank}
    other = list(same)
    other[0] = frame(1, True, False)
    other[5] = frame(6, True, True)
    got = smoke.soak_found(0, other)
    assert (got["ids"], got["ids_agree"], got["ball"], got["ball_agree"]) == (10, 11, 7, 11)
