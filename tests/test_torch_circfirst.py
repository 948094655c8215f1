"""The PyTorch port's circularity-first extraction (kernel B5) against the
JAX package.

``circularity_fused``'s plain version is held against the JAX package's
``circularity_fused`` (Pallas interpreter) over the whole map and against
the eager chain in the interior; ``extract_blobs`` against the JAX
``extract_blobs`` with every compaction tier reached; the slice end to end
(a camera that ``warp_fits`` rejects, so the gather resample, under
``VPTPU_SCOREFIRST=0``) against the JAX ``Processor``. The kernel itself
runs only on the card (``-m cuda``).
"""
from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu.app.processor import Processor as JProcessor
from vision_processor_tpu.app.processor import TrackedArrays as JTracked
from vision_processor_tpu.io.synthetic import Scene, SceneBall, SceneBot, render_raw
from vision_processor_tpu.models import camera as JC
from vision_processor_tpu.ops import blob as JB
from vision_processor_tpu.ops.blob_pallas import circularity_fused as j_circularity_fused
from vision_processor_tpu.utils.config import VisionConfig
from vision_processor_tpu_torch.app.processor import Processor, TrackedArrays
from vision_processor_tpu_torch.ops import blob as B
from vision_processor_tpu_torch.ops import blob_fused as BF
from vision_processor_tpu_torch.ops import cuda
from vision_processor_tpu_torch.ops import pipeline as P
from vision_processor_tpu_torch.ops.warp import warp_fits

WIDTH, HEIGHT = 480, 270


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread is as fast and leaves the
    cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def _card_kernels():
    """On a card, B5 at every radius this file's card tests use, built
    together before the first of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    BF.build_kernels([(o, r, None) for o, r in CARD_RADII])


@pytest.fixture
def cuda_device(_card_kernels):
    return torch.device("cuda")


def _flat(seed: int, h: int = 40, w: int = 72) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 255, (h, w, 3)).astype(np.float32)


def _eager_circ(flat: torch.Tensor, o: int, r: int) -> torch.Tensor:
    return B.circularity(B.summed_area_table(B.gradient_dot(flat, o)), r)


@pytest.mark.parametrize("o,r", [(1, 4), (2, 5), (3, 5), (1, 1)])
def test_circularity_fused_matches_jax(o, r):
    """Over the whole map, border band included: within 1e-5 of the map's
    scale (f32; the kernels sum in the same order)."""
    flat = _flat(o * 10 + r)
    want = np.asarray(j_circularity_fused(jnp.asarray(flat), o, r))
    before = cuda.LAUNCHES["circularity_fused"]
    got = BF.circularity_fused(torch.from_numpy(flat), o, r).numpy()
    assert cuda.LAUNCHES["circularity_fused"] == before  # CPU: the plain version
    assert got.shape == want.shape == flat.shape[:2]
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1.0)
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("o,r", [(1, 4), (2, 5), (3, 5)])
def test_circularity_fused_interior_matches_eager(o, r):
    """B5's local box sums against the eager summed-area-table chain (the
    JAX package's CPU path): f32 reassociation in the interior."""
    flat = torch.from_numpy(_flat(o + r))
    got = BF._circularity_fused_plain(flat, o, r).numpy()
    ref = _eager_circ(flat, o, r).numpy()
    m = r + 1
    rel = np.abs(got - ref)[m:-m, m:-m].max() / (np.abs(ref[m:-m, m:-m]).max() + 1.0)
    assert rel <= 1e-5, rel


def test_circ_matches_response_kernel_circ():
    """B5's map is B2's circularity output (the two share their code)."""
    flat = torch.from_numpy(_flat(3))
    _, circ, _ = BF._blob_response_fused_plain(flat, 0.0, 1, 4, 3)
    assert torch.equal(BF._circularity_fused_plain(flat, 1, 4), circ)


def test_disc_stats_match_jax():
    rng = np.random.default_rng(4)
    flat = _flat(4)
    iy = rng.integers(0, flat.shape[0], 50).astype(np.int32)
    ix = rng.integers(0, flat.shape[1], 50).astype(np.int32)
    iy[:4], ix[:4] = [0, 0, 39, 39], [0, 71, 0, 71]  # the clamped corners
    j1, j2, jn = JB.disc_stats(jnp.asarray(flat), 3)
    t1, t2, tn = B.disc_stats(torch.from_numpy(flat), 3)
    assert tn == jn == 29
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=1e-6)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=1e-6)
    a1, a2, an = JB.disc_stats_at(jnp.asarray(flat), jnp.asarray(iy), jnp.asarray(ix), 3)
    b1, b2, bn = B.disc_stats_at(torch.from_numpy(flat), torch.from_numpy(iy).long(),
                                 torch.from_numpy(ix).long(), 3)
    assert bn == an == 29
    np.testing.assert_allclose(b1.numpy(), np.asarray(a1), rtol=1e-6)
    np.testing.assert_allclose(b2.numpy(), np.asarray(a2), rtol=1e-6)
    # the candidate-local sums are the full-map sums at the candidates
    np.testing.assert_allclose(b1.numpy(), t1.numpy()[iy, ix], rtol=1e-6)


def _tier_circ(tier: str, h: int = 32, w: int = 64) -> np.ndarray:
    """A circularity map whose densest row holds 5 ("stage" at m_small = 6),
    12 ("stage" at m = 16) or 30 ("flat") candidates at max_blobs 64: peaks
    in (1, 2) on even rows and columns over a background below 0.5."""
    rng = np.random.default_rng({"small": 0, "stage": 1, "flat": 2}[tier])
    circ = rng.uniform(-1.0, 0.3, (h, w)).astype(np.float32)
    per_row = {"small": 5, "stage": 12, "flat": 6}[tier]
    for y in range(0, h, 2):
        xs = rng.choice(np.arange(0, w, 2), per_row, replace=False)
        circ[y, xs] = rng.uniform(1.0, 2.0, per_row)
    if tier == "flat":
        circ[6, 0::2][:30] = rng.uniform(1.0, 2.0, 30)
    return circ


@pytest.mark.parametrize("tier,want_tier", [
    ("small", ("stage", 6)), ("stage", ("stage", 16)), ("flat", ("flat", 0)),
])
def test_extract_blobs_matches_jax(tier, want_tier):
    circ = _tier_circ(tier)
    flat = _flat(5, *circ.shape)
    th, max_blobs = 0.5, 64
    masked = torch.where(torch.from_numpy(circ) >= th, torch.from_numpy(circ),
                         float("-inf"))
    masked = torch.where(B.local_max_mask(torch.from_numpy(circ)), masked, float("-inf"))
    assert B.compaction_tier(masked, max_blobs) == want_tier

    # the slot selection is bit-equal
    jv, ji = JB._compact_masked(jnp.asarray(masked.numpy()), max_blobs)
    tv, ti = B._compact_masked(masked, max_blobs)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    want = JB.extract_blobs(jnp.asarray(flat), jnp.asarray(circ), jnp.float32(th),
                            jnp.float32(0.0), radius=3, max_blobs=max_blobs)
    got = B.extract_blobs(torch.from_numpy(flat), torch.from_numpy(circ),
                          torch.tensor(th), 0.0, radius=3, max_blobs=max_blobs)
    want = {k: np.asarray(v) for k, v in want.items()}
    assert int(got["count"]) == int(want["count"]) > max_blobs
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    assert want["valid"].sum() == max_blobs
    # disc sums reduce in another order: scores to 1e-5, colours to 1e-4
    np.testing.assert_allclose(got["score"].numpy(), want["score"], rtol=1e-5)
    np.testing.assert_allclose(got["color"].numpy(), want["color"], rtol=0, atol=1e-4)
    for key in ("circ", "center"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    np.testing.assert_allclose(got["pos"].numpy(), want["pos"], rtol=0, atol=1e-5)


def test_score_first_switch_read_at_call_time(monkeypatch):
    """VPTPU_SCOREFIRST is read per call: one process runs both orders."""
    calls = []

    def recorder(name):
        fn = getattr(B, name)

        def rec(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return rec

    for name in ("extract_blobs", "extract_blobs_scored"):
        monkeypatch.setattr(B, name, recorder(name))
    cfg = P.BlobMachineConfig(fmt="RGGB", raw_shape=(48, 80), flat_shape=(20, 36),
                              field_scale=10.0, field_offset=(0.0, 0.0), grad_offset=1,
                              sat_radius=4, disc_radius=3, max_blobs=16)
    raw = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (48, 80),
                                                             dtype=np.uint8))
    grid = {"idx": torch.arange(20 * 36, dtype=torch.int32).reshape(20, 36),
            "ub": torch.full((20, 36), 0.25), "vb": torch.full((20, 36), 0.75)}
    for value, want in (("0", "extract_blobs"), ("1", "extract_blobs_scored")):
        monkeypatch.setenv("VPTPU_SCOREFIRST", value)
        out = P.blob_machine(cfg, raw, None, None, torch.tensor(-1e9), rs_grid=grid)
        assert calls[-1] == want and out["field_pos"].shape == (16, 2)


# ---------------------------------------------------------------------------
# the slice end to end: turned camera, gather resample, circularity first
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def turned_rig(divb_field):
    model = JC.CameraModel(
        focal_length=900.0, principal_point=np.array([WIDTH / 2, HEIGHT / 2]),
        distortion_k2=0.02, pos=np.array([-2250.0, -1500.0, 4500.0]),
        size=np.array([WIDTH, HEIGHT]),
    )
    rz = JC.euler_to_matrix(np.array([0.0, 0.0, 0.8]))
    model.quat = JC.matrix_to_quat(model.rotation() @ rz)
    geometry = divb_field.geometry
    geometry.ClearField("calib")
    geometry.calib.append(model.to_proto(0))
    scene = Scene(
        bots=[SceneBot(3, "yellow", -2500.0, -1300.0, 0.7),
              SceneBot(9, "blue", -1900.0, -1600.0, -2.0)],
        balls=[SceneBall(-2100.0, -1250.0)], noise_sigma=1.5, seed=3,
    )
    raw = render_raw(model, geometry.field, scene, "RGGB")
    return geometry, model, raw


def _config() -> VisionConfig:
    cfg = VisionConfig()
    cfg.max_blobs = 256
    cfg.resampling_factor = 1.25
    cfg.resample_mode = "auto"
    cfg.device_finish = True
    return cfg


def _detections(wrapper):
    d = wrapper.detection
    bots = {}
    for team, off in ((d.robots_yellow, 0), (d.robots_blue, 16)):
        for r in team:
            bots[r.robot_id + off] = (r.x, r.y, r.orientation)
    return bots, sorted((b.x, b.y) for b in d.balls)


def _tracked_from(wrapper, now, cls):
    ents = [SimpleNamespace(id=bid, x=x, y=y, z=145.0, w=w, vx=0.0, vy=0.0, vw=0.0,
                            timestamp=now)
            for bid, (x, y, w) in _detections(wrapper)[0].items()]
    return cls.build({0: ents}, now + 0.01, 32)


def _count_host_reads(fn):
    """(result, number of tensor -> Python scalar reads) of fn()."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def test_circfirst_gather_slice_matches_jax(turned_rig, monkeypatch):
    """JAX and port Processors, 2 frames with tracking fed back, under
    VPTPU_SCOREFIRST=0 (set before the JAX Processor traces its graph)."""
    geometry, model, raw = turned_rig
    monkeypatch.setenv("VPTPU_SCOREFIRST", "0")
    jp = JProcessor(_config())
    tp = Processor(_config(), device="cpu")
    for p in (jp, tp):
        p.geometry_check(WIDTH, HEIGHT, geometry, 1)
    j_tr = JTracked.build({}, 0.0, 32)
    t_tr = TrackedArrays.build({}, 0.0, 32)
    for frame in range(2):
        j_wrapper, j_blobs, _ = jp.finish_frame(jp.device_step(raw, "RGGB", j_tr),
                                                frame * 0.01)
        t_out, reads = _count_host_reads(lambda: tp.device_step(raw, "RGGB", t_tr))
        t_wrapper, t_blobs, _ = tp.finish_frame(t_out, frame * 0.01)
        assert reads == 2  # the compaction tier and the anchor-window tier
        assert tp.resample_mode == jp._bm_cfg.resample_mode == "gather"
        bm = tp._bm_cfg
        assert not warp_fits(model, bm.field_scale, bm.field_offset, bm.flat_shape,
                             bm.plane_shape, tp.max_bot_height)

        assert int(t_blobs["count"]) == int(j_blobs["count"])
        n = int(np.asarray(j_blobs["valid"]).sum())
        assert int(t_blobs["valid"].sum()) == n > 5
        np.testing.assert_allclose(t_blobs["field_pos"][:n],
                                   np.asarray(j_blobs["field_pos"])[:n], atol=0.5)

        j_bots, j_balls = _detections(j_wrapper)
        t_bots, t_balls = _detections(t_wrapper)
        assert sorted(t_bots) == sorted(j_bots) == [3, 25]
        for bid, (x, y, w) in j_bots.items():
            tx, ty, tw = t_bots[bid]
            assert abs(tx - x) < 0.5 and abs(ty - y) < 0.5
            assert abs(tw - w) < 1e-3
        assert len(t_balls) == len(j_balls) == 1
        np.testing.assert_allclose(t_balls, j_balls, atol=0.5)

        j_tr = _tracked_from(j_wrapper, frame * 0.01, JTracked)
        t_tr = _tracked_from(t_wrapper, frame * 0.01, TrackedArrays)
        assert t_tr.valid.sum() == 2


@pytest.mark.parametrize("o", range(1, 9))
def test_circularity_tile_plan_fits(o):
    """Every (o, r) with 2 <= r <= 16 gets a B5 tile within 227 KB of
    shared memory, its halo o + r."""
    for r in range(2, 17):
        plan = BF.tile_plan(o, r)
        assert plan.smem_bytes == BF._smem_bytes(plan.tile_h, plan.tile_w, o, r, None)
        assert plan.smem_bytes <= BF.SMEM_MAX
        assert plan.halo == o + r
        assert 1 <= plan.tile_h * plan.tile_w <= 1024


def test_circularity_tile_plan_slice_radii():
    """Factor 1.25 and 1.0 get a 32 x 32 tile within the default 48 KB."""
    assert BF.tile_plan(1, 4) == (32, 32, 5, 33648)
    assert BF.tile_plan(2, 5) == (32, 32, 7, 39000)
    with pytest.raises(ValueError, match="227 KB"):
        BF.tile_plan(8, 200)


def _circ_on_card(flat, o, r):
    before = cuda.LAUNCHES["circularity_fused"]
    got = BF.circularity_fused(flat, o, r)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["circularity_fused"] == before + 1
    assert torch.equal(got, BF._circularity_fused_plain(flat, o, r))


CARD_RADII = [(1, 4), (2, 5), (1, 2), (3, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("o,r", CARD_RADII)
def test_circularity_kernel_on_card(o, r, cuda_device):
    _circ_on_card(torch.from_numpy(_flat(7, 432, 770)).to(cuda_device), o, r)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(1, 1), (3, 200), (200, 3), (37, 61)])
@pytest.mark.parametrize("o,r", [(1, 4), (2, 5), (1, 2)])
def test_circularity_kernel_odd_maps_on_card(h, w, o, r, cuda_device):
    """Maps smaller than a tile or its halo, edges off the tile grid, and a
    constant map."""
    _circ_on_card(torch.from_numpy(_flat(h * w, h, w)).to(cuda_device), o, r)
    _circ_on_card(torch.full((h, w, 3), 7.0, device=cuda_device), o, r)
