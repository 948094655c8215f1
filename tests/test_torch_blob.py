"""Parity of the PyTorch port's blob response (fused kernel B2 and the eager
chain) and blob extraction with the JAX package.

The JAX fused response runs through the Pallas interpreter, as the JAX
package's tests run it on the CPU; on the CPU the port runs the plain
version of its kernel. Tolerances: 1e-5 relative (to the map's scale) over
the whole cropped map against the fused JAX kernel, 1e-5 against the eager
chain in the interior, masks equal except within 1e-5 relative of the
threshold or of a neighbour, disc means within 1e-3.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu.ops import blob as JB
from vision_processor_tpu.ops import blob_pallas as JBP
from vision_processor_tpu_torch.ops import blob as B
from vision_processor_tpu_torch.ops import blob_fused as BF

RADII = [(1, 4, 3), (2, 5, 4), (3, 5, 2)]


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
    """On a card, B2 and B5 at every radius this file's card tests use,
    built together before the first of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    BF.build_kernels([*CARD_RADII, *((o, r, None) for o, r, _ in CARD_RADII)])


@pytest.fixture
def cuda_device(_card_kernels):
    return torch.device("cuda")


def _flat(seed=0, h=40, w=150):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (h, w, 3)).astype(np.float32)


def _rel(a, b):
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1.0)


def _check_masks(got_ms, want_ms, circ, th):
    """Masks agree except where circ is within 1e-5 relative of the
    threshold or of one of its 4 neighbours."""
    tol = 1e-5 * (float(np.abs(circ).max()) + 1.0)
    diff = np.isfinite(got_ms) != np.isfinite(want_ms)
    if not diff.any():
        return
    p = np.pad(circ, 1, mode="edge")
    near = np.abs(circ - th) <= tol
    for dy, dx in ((0, 1), (2, 1), (1, 0), (1, 2)):
        nb = p[dy: dy + circ.shape[0], dx: dx + circ.shape[1]]
        near |= np.abs(circ - nb) <= tol
    assert near[diff].all(), f"{int((diff & ~near).sum())} mask differences"


@pytest.mark.parametrize("o,r,dr", RADII)
def test_fused_response_parity(o, r, dr):
    flat = _flat(o + r)
    jc = np.asarray(JB.circularity(JB.summed_area_table(
        JB.gradient_dot(jnp.asarray(flat), o)), r))
    th = float(np.quantile(jc, 0.8))
    j_ms, j_circ, j_means, j_count = JBP.blob_response_fused(
        jnp.asarray(flat), th, o, r, dr)
    j_ms, j_circ = np.asarray(j_ms), np.asarray(j_circ)
    t_ms, t_circ, t_means, t_count = BF.blob_response_fused(
        torch.from_numpy(flat), th, o, r, dr)
    t_ms, t_circ = t_ms.numpy(), t_circ.numpy()

    assert t_ms.shape == t_circ.shape == flat.shape[:2]
    assert _rel(t_circ, j_circ) < 1e-5
    _check_masks(t_ms, j_ms, j_circ, th)
    both = np.isfinite(t_ms) & np.isfinite(j_ms)
    assert both.sum() > 20
    assert _rel(t_ms[both], j_ms[both]) < 1e-5
    for tm, jm in zip(t_means, j_means):
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-3)
    assert abs(int(t_count) - int(j_count)) <= int((np.isfinite(t_ms) != np.isfinite(j_ms)).sum())

    # against the eager chain (summed-area table) in the interior
    m = o + r + 1
    assert _rel(t_circ[m:-m, m:-m], jc[m:-m, m:-m]) < 1e-5


@pytest.mark.parametrize("o,r,dr", RADII)
def test_eager_chain_parity(o, r, dr):
    flat = _flat(10 + r, h=36, w=140)
    jf = jnp.asarray(flat)
    tf = torch.from_numpy(flat)
    np.testing.assert_allclose(B.gradient_dot(tf, o).numpy(),
                               np.asarray(JB.gradient_dot(jf, o)), rtol=1e-5, atol=1e-2)
    jc = np.array(JB.circularity(JB.summed_area_table(JB.gradient_dot(jf, o)), r))
    tc = B.circularity(B.summed_area_table(B.gradient_dot(tf, o)), r).numpy()
    assert _rel(tc, jc) < 1e-5
    th = float(np.quantile(jc, 0.8))
    j_ms, j_mean, j_count = JB.blob_response(jf, jnp.asarray(jc), th, dr)
    t_ms, t_mean, t_count = B.blob_response(tf, torch.from_numpy(jc), th, dr)
    _check_masks(t_ms.numpy(), np.asarray(j_ms), jc, th)
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(j_mean), atol=1e-3)
    assert int(t_count) == int(j_count)
    np.testing.assert_array_equal(B.local_max_mask(torch.from_numpy(jc)).numpy(),
                                  np.asarray(JB.local_max_mask(jnp.asarray(jc))))


@pytest.mark.parametrize("n", [5, 16, 17, 300, 777])
def test_cumsum_matches_xla_order(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(6, n)) * 1000).astype(np.float32)
    got = B.cumsum(torch.from_numpy(x), 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))
    got0 = B.cumsum(torch.from_numpy(x.T.copy()), 0).numpy()
    np.testing.assert_array_equal(got0, np.asarray(jnp.cumsum(jnp.asarray(x.T), axis=0)))


def test_disc_spans_cover_the_disc():
    for dr in (1, 2, 3, 4, 5):
        spans = BF.disc_spans(dr)
        assert sum(2 * hw + 1 for _, hw in spans) == len(B.disc_offsets(dr))
        np.testing.assert_array_equal(B.disc_offsets(dr), JB.disc_offsets(dr))


@pytest.mark.parametrize("planes", [False, True])
def test_extract_blobs_scored_parity(planes):
    flat = _flat(3, h=48, w=160)
    jf = jnp.asarray(flat)
    jc = JB.circularity(JB.summed_area_table(JB.gradient_dot(jf, 1)), 4)
    th = float(np.quantile(np.asarray(jc), 0.85))
    if planes:
        ms, circ, mean, count = JBP.blob_response_fused(jf, th, 1, 4, 3)
        t_mean = tuple(torch.from_numpy(np.array(p)) for p in mean)
    else:
        circ = jc
        ms, mean, count = JB.blob_response(jf, jc, th, 3)
        t_mean = torch.from_numpy(np.array(mean))
    want = JB.extract_blobs_scored(jf, circ, ms, mean, count, max_blobs=96)
    got = B.extract_blobs_scored(
        torch.from_numpy(flat), torch.from_numpy(np.array(circ)),
        torch.from_numpy(np.array(ms)), t_mean, torch.tensor(int(count)), max_blobs=96)
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert valid.sum() > 10
    for key in ("color", "center", "circ", "score"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["pos"].numpy(), np.asarray(want["pos"]), atol=1e-4)


def test_radius_helpers_match():
    for scale in (3.7, 4.85, 6.06, 9.7):
        assert B.gradient_offset(25.0, scale) == JB.gradient_offset(25.0, scale)
        assert B.sat_radius(20.0, scale) == JB.sat_radius(20.0, scale)
        assert B.disc_radius(20.0, scale) == JB.disc_radius(20.0, scale)
    for o, r, dr in RADII + [(1, 1, 1), (1, 3, 6)]:
        assert BF.response_kernel_fits(o, r, dr) == JBP.response_kernel_fits(o, r, dr)


@pytest.mark.parametrize("o", range(1, 9))
def test_tile_plan_fits_every_admitted_radius(o):
    """Every (o, r, dr) with 2 <= r <= 16 and dr <= r that the gate admits
    gets a B2 tile within 227 KB of shared memory, and the tile covers its
    halo's reads: a window of tile + 2 (o + r + 1)."""
    for r in range(2, 17):
        for dr in range(1, r + 1):
            assert BF.response_kernel_fits(o, r, dr)
            plan = BF.tile_plan(o, r, dr)
            assert plan.smem_bytes <= BF.SMEM_MAX
            assert plan.smem_bytes == BF._smem_bytes(plan.tile_h, plan.tile_w, o, r, dr)
            assert plan.halo == o + r + 1 >= dr
            assert 1 <= plan.tile_h * plan.tile_w <= 1024
            # the C entry's conditions: a power-of-two width, whole row groups
            per = -(-plan.tile_h * plan.tile_w // 256)
            assert plan.tile_w & (plan.tile_w - 1) == 0 and plan.tile_h % per == 0
            if plan.smem_bytes > BF.SMEM_DEFAULT:
                # opting in only where no tile of 256 pixels fits 48 KB
                assert all(BF._smem_bytes(th, tw, o, r, dr) > BF.SMEM_DEFAULT
                           for th, tw in BF._TILES if th * tw >= 256)


def test_tile_plan_slice_radii_need_no_opt_in():
    """The slices' radii, factor 1.25 and 1.0, fit the default 48 KB."""
    assert BF.tile_plan(1, 4, 3) == (32, 32, 6, 47312)
    assert BF.tile_plan(2, 5, 4) == (16, 32, 8, 39312)
    for o, r, dr in RADII:
        assert BF.tile_plan(o, r, dr).smem_bytes <= BF.SMEM_DEFAULT


def test_tile_plan_refuses_past_227kb():
    with pytest.raises(ValueError, match="227 KB"):
        BF.tile_plan(8, 120, 100)
    # the smallest tile past the limit, the largest within it
    plan = BF.tile_plan(8, 40, 30)
    assert plan.smem_bytes <= BF.SMEM_MAX < BF._smem_bytes(
        *BF._TILES[BF._TILES.index((plan.tile_h, plan.tile_w)) - 1], 8, 40, 30)


def test_each_shape_builds_its_own_kernel():
    """B2 and B5 are built once per shape, the radii and the planned tile
    as constants: each (o, r, dr) of B2 and (o, r) of B5 its own library,
    the same shape always the same one, and the source left out of the
    other kernels' library."""
    from vision_processor_tpu_torch.ops import cuda

    assert BF.kernel_defines(1, 4, 3) == {
        "VP_O": 1, "VP_R": 4, "VP_DR": 3, "VP_TILE_H": 32, "VP_TILE_W": 32}
    assert BF.kernel_defines(2, 5) == {"VP_O": 2, "VP_R": 5, "VP_TILE_H": 32, "VP_TILE_W": 32}
    shapes = [(o, r, d) for o, r, dr in CARD_RADII for d in (dr, None)]
    paths = [cuda.shaped_target("blob_fused.cu", BF.kernel_defines(*s))[0] for s in shapes]
    assert len(set(paths)) == len(set(shapes))
    assert paths == [cuda.shaped_target("blob_fused.cu", BF.kernel_defines(*s))[0]
                     for s in shapes]
    assert "blob_fused.cu" not in [p.name for p in cuda.sources()]
    with pytest.raises(ValueError, match="227 KB"):
        BF.kernel_defines(8, 120, 100)


def test_build_links_a_repeated_shape_once(tmp_path, monkeypatch):
    """A shape named twice in one build (B5's (o, r) from two B2 radii)
    is compiled and linked once, with a stand-in nvcc that refuses a link
    given the same object twice, as the linker does."""
    import stat
    import sys

    from vision_processor_tpu_torch.ops import cuda

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "out = args.index('-o') + 1\n"
        "objs = [] if '-c' in args else args[out + 1:]\n"
        "if len(objs) != len(set(objs)):\n"
        "    sys.exit('multiple definition')\n"
        "open(args[out], 'w').close()\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda, "BUILD_INFO", {})
    shapes = [(1, 4, 3), (1, 4, None), (1, 4, 6), (1, 4, None)]
    BF.build_kernels(shapes)
    for shape in shapes:
        assert cuda.shaped_target("blob_fused.cu", BF.kernel_defines(*shape))[0].exists()
    assert len(list((tmp_path / "build").glob("libblob_fused_*.so"))) == 3


def test_count_is_the_kept_pixels_on_the_cpu():
    flat = torch.from_numpy(_flat(2))
    ms, _, _, count = BF.blob_response_fused(flat, 0.0, 1, 4, 3)
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(torch.isfinite(ms).sum()) > 0


# the card: B2 bit-equal to its plain version, count included
CARD_RADII = RADII + [(1, 2, 1), (1, 4, 6), (2, 5, 8)]  # r = 2; dr = o + r + 1


def _check_on_card(flat, th, o, r, dr):
    from vision_processor_tpu_torch.ops import cuda

    before = cuda.LAUNCHES["blob_response_fused"]
    ms, circ, means, count = BF.blob_response_fused(flat, th, o, r, dr)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["blob_response_fused"] == before + 1
    p_ms, p_circ, p_means = BF._blob_response_fused_plain(flat, th, o, r, dr)
    assert torch.equal(circ, p_circ)
    assert torch.equal(torch.isfinite(ms), torch.isfinite(p_ms))
    assert torch.equal(ms, p_ms)
    for a, b in zip(means, p_means):
        assert torch.equal(a, b)
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int((p_ms > float("-inf")).sum())
    return int(count)


@pytest.mark.cuda
@pytest.mark.parametrize("o,r,dr", CARD_RADII)
def test_fused_kernel_on_card(o, r, dr, cuda_device):
    flat = torch.from_numpy(_flat(o + r, h=432, w=770)).to(cuda_device)
    th = torch.tensor(300.0, device=cuda_device)
    assert _check_on_card(flat, th, o, r, dr) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(1, 1), (3, 200), (200, 3), (37, 61)])
@pytest.mark.parametrize("o,r,dr", [(1, 4, 3), (2, 5, 4), (1, 2, 1), (1, 4, 6)])
def test_fused_kernel_odd_maps_on_card(h, w, o, r, dr, cuda_device):
    """Maps smaller than a tile or its halo, edges off the tile grid."""
    flat = torch.from_numpy(_flat(h + w, h=h, w=w)).to(cuda_device)
    _check_on_card(flat, torch.tensor(50.0, device=cuda_device), o, r, dr)


@pytest.mark.cuda
@pytest.mark.parametrize("o,r,dr", [(1, 4, 3), (2, 5, 4), (3, 5, 2)])
def test_fused_kernels_unaligned_map_on_card(o, r, dr, cuda_device):
    """A map whose first element is not 16-byte aligned (a view one float
    into its storage), as a caller's slice of a larger buffer gives."""
    h, w = 70, 300
    buf = torch.from_numpy(_flat(5, h=1, w=h * w + 1).reshape(-1)).to(cuda_device)
    flat = buf[1: 1 + h * w * 3].view(h, w, 3)
    assert flat.data_ptr() % 16 != 0
    _check_on_card(flat, torch.tensor(50.0, device=cuda_device), o, r, dr)
    assert torch.equal(BF.circularity_fused(flat, o, r),
                       BF._circularity_fused_plain(flat, o, r))


@pytest.mark.cuda
@pytest.mark.parametrize("o,r,dr", [(1, 4, 3), (2, 5, 4)])
def test_fused_kernel_ties_and_empty_on_card(o, r, dr, cuda_device):
    """A constant map ties every local-max test: all kept at threshold 0,
    none at 1; a threshold above every value keeps none."""
    flat = torch.full((45, 70, 3), 100.0, device=cuda_device)
    assert _check_on_card(flat, torch.tensor(0.0, device=cuda_device), o, r, dr) == 45 * 70
    assert _check_on_card(flat, torch.tensor(1.0, device=cuda_device), o, r, dr) == 0
    flat = torch.from_numpy(_flat(9, h=432, w=770)).to(cuda_device)
    assert _check_on_card(flat, torch.tensor(3e38, device=cuda_device), o, r, dr) == 0
