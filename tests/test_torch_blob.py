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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
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


@pytest.mark.cuda
@pytest.mark.parametrize("o,r,dr", RADII)
def test_fused_kernel_on_card(o, r, dr, cuda_device):
    flat = torch.from_numpy(_flat(o + r, h=432, w=770)).to(cuda_device)
    th = torch.tensor(300.0, device=cuda_device)
    ms, circ, means, _ = BF.blob_response_fused(flat, th, o, r, dr)
    p_ms, p_circ, p_means = BF._blob_response_fused_plain(flat, th, o, r, dr)
    assert torch.equal(circ, p_circ)
    assert torch.equal(ms, p_ms)
    for a, b in zip(means, p_means):
        assert torch.equal(a, b)
