"""The kernels' yardstick: bytes and operations from a call's shapes, the
least time at the H100's peaks, and the device names of the twelve."""
import pytest

from roofline import FP32_OPS_PER_S, HBM_BYTES_PER_S, kernel_function, least_seconds, work


def test_band_pass_counts_source_positions_and_output():
    # src (4, 540, 960) read once; pos and out (4, 432, 960) once each
    b, o = work("band_pass", ((4, 540, 960), (4, 432, 960)), {})
    assert b == 4.0 * (4 * 540 * 960 + 2 * 4 * 432 * 960)
    assert o == 5.0 * 4 * 432 * 960


def test_blob_response_by_radii():
    b, o = work("blob_response_fused", ((432, 770, 3), (), 1, 4, 3), {})
    px = 432 * 770
    assert b == 4.0 * px * 8 + 4
    assert o == (11 + 2 * 2 + 6 + 4 + 6 * 13 + 3 + 15 + 5) * px


def test_query_select_m_by_keyword_or_position():
    shapes = ((128, 2), (128,), (2000, 2), (2000,))
    assert work("query_select_topk", shapes, {"m": 8, "by_rank": True}) == \
        work("query_select_topk", shapes + (8, True), {})
    b, o = work("query_select_topk", shapes, {"m": 8})
    assert (b, o) == (12.0 * 128 + 12.0 * 2000 + 8.0 * 128 * 8, 6.0 * 128 * 2000)


@pytest.mark.parametrize("name,args,kw", [
    ("row_topk", ((432, 770), 6), {}),
    ("row_topk_blk", ((540, 962), 19, 64), {}),
    ("circularity_fused", ((432, 770, 3), 1, 4), {}),
    ("corner_stack", ((1080, 1920), "RGGB"), {}),
    ("resample_packed", ((1080, 1920), (432, 770), (432, 770), "RGGB"), {}),
    ("gather_corners", ((518400, 16), (432, 770)), {"distinct_rows": 300000}),
    ("combo_chain", ((12, 128, 280), (128, 2), (128,), (128,), (), None, None), {}),
    ("band_warp", ((4, 540, 960), (4, 432, 960), (4, 54), 16), {}),
])
def test_every_wrapper_has_a_count(name, args, kw):
    b, o = work(name, args, kw)
    assert b > 0 and o >= 0


def test_least_time_is_the_larger_bound():
    assert least_seconds(HBM_BYTES_PER_S, 0.0) == pytest.approx(1.0)
    assert least_seconds(1.0, 2 * FP32_OPS_PER_S) == pytest.approx(2.0)


@pytest.mark.parametrize("name,want", [
    ("(anonymous namespace)::band_pass_kernel(float const*, float const*, float*, int)",
     "band_pass_kernel"),
    ("(anonymous namespace)::blob_tile_kernel(float const*, int, int, float)", "blob_tile_kernel"),
    ("void (anonymous namespace)::row_topk_warps<8>(float const*, int)", "row_topk_warps"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>(Params)", None),
    ("band_pass_kernel(float const*, float const*, float*, int, int, int, long long)",
     "band_pass_kernel"),
    ("void row_topk_warps<8>(float const*, int, int, int, float*, int*)", "row_topk_warps"),
    ("void query_topk_blocks<8>(float const*)", "query_topk_blocks"),
    ("void at::native::reduce_kernel<512, 1>(int)", None),
    ("Memcpy HtoD (Pageable -> Device)", None),
])
def test_kernel_function(name, want):
    assert kernel_function(name) == want
