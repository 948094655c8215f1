// Fused combo-score chain and winner argmax of the detection search.
//
// Replaces vision_processor_tpu/ops/combo_pallas.py:_combo_chain_kernel
// (combo_chain). For every (anchor, combo) pair the TPU kernel reads the 12
// matmul outputs of a 64-anchor block once, keeps the ~30-op elementwise
// chain (normalised orientation, candidate position, five slot offset
// scores and their min, the combo_ok gate) in VMEM and writes only each
// anchor's winner; the argmax is a max then a min over the tying indices.
//
// Bound: memory, barely. The 12 (A, C) f32 maps are 1.7 MB at A = 128 and
// 6.9 MB at A = 512 (C = 280); the chain is about 110 flops per pair, some
// 4 MFLOP at A = 128, which the card does in under 0.1 us. At these sizes
// the launch itself dominates. Design: one warp per anchor; lane l takes
// combos l, l + 32, ... (9 per lane at C = 280, coalesced reads of each
// map row), runs the chain in registers, keeps its best (score, index,
// cos, sin, x, y) with a strict > so that its lowest index wins a tie, and
// a warp-shuffle reduction ordered by (score descending, index ascending)
// gives the anchor's winner. Every product, sum and quotient is a
// round-to-nearest intrinsic (no FMA contraction) and the inverse norm is
// 1 / sqrt, correctly rounded, so the result is bit-equal to the plain
// PyTorch version (ops/combo_fused.py _combo_chain_plain), which does the
// same ops one by one.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

struct Pattern {
  float pat[10];  // (5, 2) slot offsets of the pattern
  float pbar[2];  // their sum
};

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__global__ void combo_chain_kernel(const float* __restrict__ maps, int A, int C,
                                   const float* __restrict__ anchor_pos,
                                   const int* __restrict__ ring_count,
                                   const unsigned char* __restrict__ anchor_valid,
                                   const int* __restrict__ combo_max, Pattern P,
                                   float* __restrict__ outf,
                                   int* __restrict__ outi) {
  int a = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  int lane = threadIdx.x & 31;
  if (a >= A) return;  // a is uniform over the warp
  size_t plane = (size_t)A * C;
  const float* row = maps + (size_t)a * C;
  float ax = anchor_pos[2 * a];
  float ay = anchor_pos[2 * a + 1];
  int rc = ring_count[a];
  bool gate = rc >= 4 && anchor_valid[a] != 0;

  float bv = -CUDART_INF_F, bc = 1.0f, bs = 0.0f, bx = 0.0f, by = 0.0f;
  int bi = 0x7fffffff;
  for (int c = lane; c < C; c += 32) {
    float oc = row[c];
    float os = row[plane + c];
    float norm2 = __fadd_rn(__fmul_rn(oc, oc), __fmul_rn(os, os));
    bool ok_n = norm2 > 0.0f;
    float inv_n =
        ok_n ? __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(norm2, 1e-30f))) : 0.0f;
    float cc = ok_n ? __fmul_rn(oc, inv_n) : 1.0f;
    float ss = __fmul_rn(os, inv_n);
    float px = __fdiv_rn(
        __fsub_rn(row[2 * plane + c], __fsub_rn(__fmul_rn(cc, P.pbar[0]),
                                                __fmul_rn(ss, P.pbar[1]))),
        5.0f);
    float py = __fdiv_rn(
        __fsub_rn(row[3 * plane + c], __fadd_rn(__fmul_rn(ss, P.pbar[0]),
                                                __fmul_rn(cc, P.pbar[1]))),
        5.0f);
    float off = 0.0f;
    for (int s5 = 0; s5 < 5; ++s5) {
      float p5x = s5 == 0 ? ax : row[(size_t)(3 + s5) * plane + c];
      float p5y = s5 == 0 ? ay : row[(size_t)(7 + s5) * plane + c];
      float qx = P.pat[2 * s5];
      float qy = P.pat[2 * s5 + 1];
      float dx = __fdiv_rn(
          __fsub_rn(p5x, __fadd_rn(px, __fsub_rn(__fmul_rn(cc, qx),
                                                 __fmul_rn(ss, qy)))),
          10.0f);
      float dy = __fdiv_rn(
          __fsub_rn(p5y, __fadd_rn(py, __fadd_rn(__fmul_rn(ss, qx),
                                                 __fmul_rn(cc, qy)))),
          10.0f);
      float sc = __fdiv_rn(
          1.0f, __fadd_rn(__fadd_rn(1.0f, __fmul_rn(dx, dx)), __fmul_rn(dy, dy)));
      off = s5 == 0 ? sc : fminf(off, sc);
    }
    float score = (gate && combo_max[c] < rc) ? off : 0.0f;
    if (score > bv) {  // c ascends: a tie keeps the lane's lowest index
      bv = score;
      bi = c;
      bc = cc;
      bs = ss;
      bx = px;
      by = py;
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, bv, d);
    int oi = __shfl_down_sync(0xffffffffu, bi, d);
    float oc = __shfl_down_sync(0xffffffffu, bc, d);
    float os = __shfl_down_sync(0xffffffffu, bs, d);
    float ox = __shfl_down_sync(0xffffffffu, bx, d);
    float oy = __shfl_down_sync(0xffffffffu, by, d);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
      bc = oc;
      bs = os;
      bx = ox;
      by = oy;
    }
  }
  if (lane == 0) {
    outf[a] = bv;
    outf[A + a] = bc;
    outf[2 * A + a] = bs;
    outf[3 * A + a] = bx;
    outf[4 * A + a] = by;
    outi[a] = bi;
  }
}

}  // namespace

// maps (12, A, C) f32; anchor_pos (A, 2) f32; ring_count (A,) i32;
// anchor_valid (A,) u8; combo_max (C,) i32; pattern: 12 host floats (the
// (5, 2) slot offsets, then their sum); outf (5, A) f32 = score, cos, sin,
// x, y of each anchor's winner; outi (A,) i32 = the winning combo.
extern "C" int vp_combo_chain(const float* maps, int A, int C,
                              const float* anchor_pos, const int* ring_count,
                              const unsigned char* anchor_valid,
                              const int* combo_max, const float* pattern,
                              float* outf, int* outi, void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  Pattern P;
  for (int k = 0; k < 10; ++k) P.pat[k] = pattern[k];
  P.pbar[0] = pattern[10];
  P.pbar[1] = pattern[11];
  if (A > 0) {
    long long threads = (long long)A * 32;
    combo_chain_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                         kThreads, 0, (cudaStream_t)stream>>>(
        maps, A, C, anchor_pos, ring_count, anchor_valid, combo_max, P, outf,
        outi);
  }
  return (int)cudaGetLastError();
}
