"""Parity of the PyTorch port's masked top-m selections (kernels B3, B4) and
the blob compaction tiers with the JAX package.

The JAX side runs as its own tests run it: the Pallas kernels through the
interpreter (``interpret=True``) and the CPU formulations the rest of the
suite uses. On the CPU the port runs the plain versions of its kernels;
``test_kernels_match_plain_on_card`` holds the CUDA kernels against them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu.ops import blob as JB
from vision_processor_tpu.ops import topk as JT
from vision_processor_tpu_torch.ops import blob as B
from vision_processor_tpu_torch.ops import topk as T


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread is as fast and leaves the
    cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rows_case(seed=11, rows=24, width=300):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, width)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.9] = -np.inf
    x[3] = -np.inf                        # exhausted row
    x[5, 7] = x[5, 200] = x[5, 250] = 2.5  # ties -> lower index first
    x[8, :40] = 1.25                       # a run of ties longer than any m
    return x


@pytest.mark.parametrize("m", [3, 6, 8, 19])
def test_row_topk_parity(m):
    x = _rows_case()
    pv, pi = T.row_topk(torch.from_numpy(x), m)
    kv, ki = JT.row_topk(jnp.asarray(x), m, interpret=True)  # Pallas kernel
    lv, li = jax.lax.top_k(jnp.asarray(x), m)                # JAX CPU path
    pv, pi = pv.numpy(), pi.numpy()
    np.testing.assert_array_equal(pv, np.asarray(kv))
    valid = pv > -np.inf
    np.testing.assert_array_equal(pi[valid], np.asarray(ki)[valid])
    # the plain version is lax.top_k exactly, exhausted slots included
    np.testing.assert_array_equal(pv, np.asarray(lv))
    np.testing.assert_array_equal(pi, np.asarray(li))
    assert pi.dtype == np.int32
    assert list(pi[5, :min(m, 3)]) == [7, 200, 250][:min(m, 3)]


def _query_case(seed, q=40, k=300):
    rng = np.random.default_rng(seed)
    qxy = rng.uniform(-1000, 1000, (q, 2)).astype(np.float32)
    bxy = rng.uniform(-1000, 1000, (k, 2)).astype(np.float32)
    r2 = (rng.uniform(100, 400, (q,)) ** 2).astype(np.float32)
    rank = np.round(rng.uniform(0, 10, (k,)), 1).astype(np.float32)  # rank ties
    rank[rng.uniform(size=k) < 0.2] = np.inf                         # invalid blobs
    bxy[10] = bxy[11]                   # coincident blobs: exact d2 ties
    qxy[0] = [5000.0, 5000.0]           # nothing in range: exhausted query
    return qxy, r2, bxy, rank


@pytest.mark.parametrize("m", [3, 8])
@pytest.mark.parametrize("by_rank", [True, False])
def test_query_select_parity(by_rank, m):
    qxy, r2, bxy, rank = _query_case(7 + m)
    pv, pi = T.query_select_topk(
        torch.from_numpy(qxy), torch.from_numpy(r2), torch.from_numpy(bxy),
        torch.from_numpy(rank), m=m, by_rank=by_rank)
    kv, ki = JT.query_select_topk(jnp.asarray(qxy), jnp.asarray(r2), jnp.asarray(bxy),
                                  jnp.asarray(rank), m=m, by_rank=by_rank,
                                  interpret=True)
    pv, pi, kv, ki = pv.numpy(), pi.numpy(), np.asarray(kv), np.asarray(ki)
    valid = kv > -np.inf
    np.testing.assert_array_equal(pv > -np.inf, valid)
    assert not valid[0].any() and (pi[0] == 0).all()  # exhausted: index 0 repeats
    if by_rank:
        np.testing.assert_array_equal(pv, kv)
        np.testing.assert_array_equal(pi[valid], ki[valid])
    else:
        # -d2 within 2 ulp (FMA contraction on either side); indices equal
        # except where two candidates' d2 are within 2 ulp of each other
        spacing = np.abs(np.spacing(kv[valid]))
        assert (np.abs(pv[valid] - kv[valid]) <= 2 * spacing).all()
        d2 = ((bxy[None, :, :] - qxy[:, None, :]) ** 2).sum(-1)
        for qi, j in zip(*np.nonzero(valid & (pi != ki))):
            a, b = d2[qi, pi[qi, j]], d2[qi, ki[qi, j]]
            assert abs(a - b) <= 2 * np.spacing(np.float32(max(a, b)))


def test_query_select_matches_iterative_argmax():
    """The plain version is the JAX package's CPU formulation (iter_top_k
    over the materialized score map), bit for bit."""
    from vision_processor_tpu.models.detector import iter_top_k

    qxy, r2, bxy, rank = _query_case(3)
    for by_rank in (True, False):
        pv, pi = T.query_select_topk(
            torch.from_numpy(qxy), torch.from_numpy(r2), torch.from_numpy(bxy),
            torch.from_numpy(rank), m=4, by_rank=by_rank)
        dx = bxy[None, :, 0] - qxy[:, None, 0]
        dy = bxy[None, :, 1] - qxy[:, None, 1]
        d2 = dx * dx + dy * dy
        ok = (d2 <= r2[:, None]) & (rank[None, :] < np.inf)
        score = np.where(ok, -rank[None, :] if by_rank else -d2, -np.inf)
        rv, ri = iter_top_k(jnp.asarray(score.astype(np.float32)), 4)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


def _tier_map(tier: str, h=40, w=200, max_blobs=64, seed=0):
    """A -inf-masked map whose densest row selects the given tier."""
    rng = np.random.default_rng(seed)
    x = np.full((h, w), -np.inf, np.float32)
    m = min(w, max(16, -(-4 * max_blobs // h)))
    m_small = min(m, max(6, -(-max_blobs // h)))
    per_row = {"small": m_small, "stage": m, "flat": m + 5}[tier]
    for r in range(h):
        n = per_row if r == 7 else rng.integers(0, m_small + 1)
        cols = rng.choice(w, size=n, replace=False)
        x[r, cols] = np.round(rng.uniform(0, 50, n), 1)  # value ties across rows
    return x, m, m_small


@pytest.mark.parametrize("tier", ["small", "stage", "flat"])
def test_compact_masked_tiers(tier):
    max_blobs = 64
    x, m, m_small = _tier_map(tier, max_blobs=max_blobs)
    kind, mm = B.compaction_tier(torch.from_numpy(x), max_blobs)
    assert (kind, mm) == {"small": ("stage", m_small), "stage": ("stage", m),
                          "flat": ("flat", 0)}[tier]
    pv, pi = B._compact_masked(torch.from_numpy(x), max_blobs)
    jv, ji = JB._compact_masked(jnp.asarray(x), max_blobs)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def test_wrappers_use_plain_version_on_cpu_only():
    """A CPU tensor takes the plain version (no build); the kernel path
    checks its arguments before it launches."""
    from vision_processor_tpu_torch.ops import cuda as K

    before = dict(K.LAUNCHES)
    T.row_topk(torch.zeros(2, 5), 2)
    assert K.LAUNCHES == before
    with pytest.raises(ValueError):
        K.require(torch.zeros(3), "x", torch.float32, 1)


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    x = torch.from_numpy(_rows_case(rows=64, width=770)).to(cuda_device)
    for m in (6, 19):
        kv, ki = T.row_topk(x, m)
        pv, pi = T._row_topk_plain(x, m)
        assert torch.equal(kv, pv)
        valid = pv > -np.inf
        assert torch.equal(ki[valid], pi[valid])
    qxy, r2, bxy, rank = (torch.from_numpy(a).to(cuda_device) for a in _query_case(5))
    for by_rank, m in ((True, 8), (False, 3)):
        kv, ki = T.query_select_topk(qxy, r2, bxy, rank, m=m, by_rank=by_rank)
        pv, pi = T._query_select_plain(qxy, r2, bxy, rank, m, by_rank)
        assert torch.equal(kv, pv)
        valid = pv > -np.inf
        assert torch.equal(ki[valid], pi[valid])


@pytest.mark.parametrize("m", [6, 16, 19])
def test_row_topk_blk_parity(m):
    """E5 (experiments/rowtopk_blk.py ``row_topk_blk``: the Pallas
    ``_select_m`` at a swept row block) against the JAX ``row_topk`` in
    interpret mode, which runs the same ``_select_m``: values and indices
    bit-equal, exhausted slots (-inf, 0) included; and ``lax.top_k``'s
    values and valid indices (B3's plain version)."""
    x = _rows_case()
    before = dict(T.cuda.LAUNCHES)
    pv, pi = T.row_topk_blk(torch.from_numpy(x), m, blk=32)
    assert T.cuda.LAUNCHES == before
    kv, ki = JT.row_topk(jnp.asarray(x), m, interpret=True)
    pv, pi = pv.numpy(), pi.numpy()
    np.testing.assert_array_equal(pv, np.asarray(kv))
    np.testing.assert_array_equal(pi, np.asarray(ki))
    assert (pi[3] == 0).all() and (pv[3] == -np.inf).all()  # the exhausted row
    sv, si = T._row_topk_plain(torch.from_numpy(x), m)
    np.testing.assert_array_equal(pv, sv.numpy())
    valid = pv > -np.inf
    np.testing.assert_array_equal(pi[valid], si.numpy()[valid])
    with pytest.raises(ValueError):
        T.row_topk_blk(torch.from_numpy(x), m, blk=0)


def _blk_case(h, w, seed):
    """rowtopk_blk.py's inputs: about 1500 valid entries, |normal| + 1,
    plus a tie row and an exhausted row."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(h, w)).astype(np.float32)
    mask = rng.random((h, w)) < 1500.0 / (h * w)
    x = np.where(mask, np.abs(base) + 1.0, -np.inf).astype(np.float32)
    x[1] = -np.inf
    x[2, ::7] = 2.0
    return x


# registers a thread: the range of the kernels of csrc/topk.cu (B3's lists
# take 80 to 206 on sm_90a), the 64 of E5's launch bound, and the extremes
@pytest.mark.parametrize("blk", [1, 5, 8, 32, 64, 100])
@pytest.mark.parametrize("regs", [1, 32, 40, 64, 72, 80, 127, 206, 255])
def test_blk_warps_fit_a_block(blk, regs):
    """E5's warps a block: one a row up to 32, as many as 65,536 registers
    hold (allocated 8 a thread at a time), never more than 1,024 threads."""
    w = T.blk_warps(blk, regs)
    alloc = -(-regs // 8) * 8
    assert 1 <= w <= min(blk, 32)
    assert 32 * w <= T.MAX_BLOCK_THREADS == 1024
    assert 32 * w * alloc <= T.REGS_PER_SM == 65536
    assert w == min(blk, 32) or 32 * (w + 1) * alloc > 65536  # no warp left out
    if regs <= 64:
        assert w == min(blk, 32)


def test_blk_warps_refuses():
    for blk, regs in ((0, 64), (8, 0), (8, 256)):
        with pytest.raises(ValueError):
            T.blk_warps(blk, regs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(432, 770), (540, 962), (40, 5)])
def test_row_topk_blk_matches_plain_on_card(cuda_device, shape):
    """Every slot equal to select_m's at every blk of the sweep, at the
    contract's m, at m = 1 and 32 and above 32, on the contract's shapes
    (a tie row and an exhausted row included) and on rows of width 5."""
    x = torch.from_numpy(_blk_case(*shape, seed=shape[0])).to(cuda_device)
    for m in (1, 6, 16, 19, 32, 40):
        pv, pi = T.select_m(x, m)
        for blk in (8, 32, 64):
            kv, ki = T.row_topk_blk(x, m, blk)
            assert torch.equal(kv, pv) and torch.equal(ki, pi), (m, blk)


@pytest.mark.cuda
def test_row_topk_blk_plan_on_card(cuda_device):
    """The runtime's registers and thread limit of E5's kernel admit the
    warps blk_warps gives at every blk of the sweep."""
    regs, most = T.blk_attrs()
    assert regs <= 64  # the kernel's launch bound: 32 warps fit
    for blk in (8, 32, 64):
        assert 32 * T.blk_warps(blk, regs) <= most


# every list bucket of csrc/topk.cu, the m between them, and m above the
# largest (the block kernels)
CARD_MS = (1, 3, 4, 6, 8, 16, 19, 32, 40)


def _card_rows(width=770):
    """B3's card cases: _rows_case plus a row of equal values (every lane's
    list full of ties), a row with +inf, rows with fewer valid values than
    any bucket, and a row valid from index 0; the first ``width`` columns."""
    x = _rows_case(rows=64, width=max(width, 770))
    x[9] = 1.0
    x[10, 17] = np.inf
    x[11] = -np.inf
    x[11, [5, 300, 301]] = [0.5, 7.0, 7.0]
    x[12, :2] = 3.0
    return np.ascontiguousarray(x[:, :width])


def _assert_select_m(kv, ki, score, m):
    """Every slot, exhausted ones included, equals select_m's: m (max,
    lowest index) passes with the winners masked."""
    pv, pi = T.select_m(score, m)
    assert torch.equal(kv, pv), m
    assert torch.equal(ki, pi), m


@pytest.mark.cuda
@pytest.mark.parametrize("width", [770, 962, 5])
def test_row_topk_every_slot_on_card(cuda_device, width):
    """B3 at every bucket and above it, on the path's widths and on rows
    shorter than m: every slot equals select_m's, and values and valid
    indices equal the plain version's (a stable sort)."""
    x = torch.from_numpy(_card_rows(width)).to(cuda_device)
    for m in CARD_MS:
        kv, ki = T.row_topk(x, m)
        _assert_select_m(kv, ki, x, m)
        sv, si = T._row_topk_plain(x, m) if m <= width else (None, None)
        if sv is not None:
            valid = sv > -np.inf
            assert torch.equal(kv, sv) and torch.equal(ki[valid], si[valid]), m
        exhausted = kv == -np.inf
        assert (ki[exhausted] == 0).all(), m


def _card_queries(seed, q, k=2000):
    """B4's card cases: _query_case at the path's sizes, radii wide enough
    that some queries hold more than 40 blobs, an exhausted query, exact
    d2 and rank ties."""
    qxy, r2, bxy, rank = _query_case(seed, q=q, k=k)
    r2[1::7] = np.float32(600.0 ** 2)
    return qxy, r2, bxy, rank


@pytest.mark.cuda
@pytest.mark.parametrize("q", [128, 160, 512])
@pytest.mark.parametrize("by_rank", [True, False])
def test_query_select_every_slot_on_card(cuda_device, q, by_rank):
    """B4 at every bucket and above it: every slot equals the plain
    version's (select_m over the materialized scores)."""
    qxy, r2, bxy, rank = (torch.from_numpy(a).to(cuda_device)
                          for a in _card_queries(q, q))
    for m in CARD_MS:
        want = T._query_select_plain(qxy, r2, bxy, rank, m, by_rank)
        kv, ki = T.query_select_topk(qxy, r2, bxy, rank, m=m, by_rank=by_rank)
        assert torch.equal(kv, want[0]) and torch.equal(ki, want[1]), m
        assert (want[1][want[0] == -np.inf] == 0).all()
        assert bool((want[0][0] == -np.inf).all())  # the exhausted query


@pytest.mark.cuda
def test_query_select_small_and_unaligned_on_card(cuda_device):
    """Fewer blobs than m, and a blob table at an odd float offset (the
    wrapper copies it to the float2 alignment the kernel reads)."""
    qxy, r2, bxy, rank = _query_case(2, q=40, k=300)
    qxy, r2, bxy, rank = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
                          for a in (qxy, np.full_like(r2, 1e8), bxy[:5], rank[:5]))
    buf = torch.zeros(2 * 300 + 1, device=cuda_device)
    qxy2, r22, bxy2, rank2 = (torch.from_numpy(a).to(cuda_device)
                              for a in _query_case(4, q=40, k=300))
    buf[1:].copy_(bxy2.reshape(-1))
    odd = buf[1:].view(300, 2)
    assert odd.data_ptr() % 8 == 4
    for m in (3, 8, 40):
        for by_rank in (True, False):
            kv, ki = T.query_select_topk(qxy, r2, bxy, rank, m=m, by_rank=by_rank)
            _assert_select_m(kv, ki, T._query_scores(qxy, r2, bxy, rank, by_rank), m)
            kv, ki = T.query_select_topk(qxy2, r22, odd, rank2, m=m, by_rank=by_rank)
            _assert_select_m(kv, ki, T._query_scores(qxy2, r22, bxy2, rank2, by_rank), m)
