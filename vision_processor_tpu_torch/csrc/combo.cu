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
// 4 MFLOP at A = 128, which the card does in under 0.1 us. What costs is
// latency: each pair's chain is about 19 dependent correctly rounded
// divisions and square roots (on an H100 one anchor's block alone takes as
// long as 128 of them). Design: one block per anchor, one thread
// per combo (C rounded up to whole warps, at most kMaxThreads; a thread
// takes combos t, t + blockDim.x, ... beyond that), so that A = 128 is 128
// blocks of 288 threads, one wave on the card's 132 SMs, and every chain
// runs at once. Each thread loads its 12 map values (coalesced along C),
// runs the chain and keeps its best (score, index) with a strict >, so
// that its lowest index wins a tie; a warp-shuffle reduction ordered by
// (score descending, index ascending), one value a warp in shared memory
// and warp 0's reduction of those give the anchor's winner, which is
// broadcast through shared memory: the thread that holds it writes its
// own score, cos, sin, x and y, as the plain version's gather does. An
// anchor that fails the gate (ring count < 4 or invalid) scores 0 on every
// combo, so combo 0 wins: one thread runs combo 0's chain alone. Every
// product, sum and quotient is a round-to-nearest intrinsic (no FMA
// contraction) and the inverse norm is 1 / sqrt, correctly rounded, so
// the result is bit-equal to the plain PyTorch version
// (ops/combo_fused.py _combo_chain_plain), which does the same ops one by
// one.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// threads a block at most (ops/combo_fused.py MAX_THREADS): the launch
// bound keeps a thread at 65536 / kMaxThreads = 128 registers or fewer
constexpr int kMaxThreads = 512;
constexpr int kNoIndex = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

struct Pattern {
  float pat[10];  // (5, 2) slot offsets of the pattern
  float pbar[2];  // their sum
};

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// One combo's chain: its normalised orientation (cc, ss), candidate
// position (px, py) and the min of its five slot offset scores.
struct Combo {
  float cc, ss, px, py, off;
};

__device__ __forceinline__ Combo chain(const float* row, size_t plane, int c, float ax,
                                       float ay, const Pattern& P) {
  float oc = row[c];
  float os = row[plane + c];
  float norm2 = __fadd_rn(__fmul_rn(oc, oc), __fmul_rn(os, os));
  bool ok_n = norm2 > 0.0f;
  float inv_n = ok_n ? __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(norm2, 1e-30f))) : 0.0f;
  Combo r;
  r.cc = ok_n ? __fmul_rn(oc, inv_n) : 1.0f;
  r.ss = __fmul_rn(os, inv_n);
  r.px = __fdiv_rn(__fsub_rn(row[2 * plane + c], __fsub_rn(__fmul_rn(r.cc, P.pbar[0]),
                                                           __fmul_rn(r.ss, P.pbar[1]))),
                   5.0f);
  r.py = __fdiv_rn(__fsub_rn(row[3 * plane + c], __fadd_rn(__fmul_rn(r.ss, P.pbar[0]),
                                                           __fmul_rn(r.cc, P.pbar[1]))),
                   5.0f);
  r.off = 0.0f;
#pragma unroll
  for (int s5 = 0; s5 < 5; ++s5) {
    float p5x = s5 == 0 ? ax : row[(size_t)(3 + s5) * plane + c];
    float p5y = s5 == 0 ? ay : row[(size_t)(7 + s5) * plane + c];
    float qx = P.pat[2 * s5];
    float qy = P.pat[2 * s5 + 1];
    float dx = __fdiv_rn(
        __fsub_rn(p5x, __fadd_rn(r.px, __fsub_rn(__fmul_rn(r.cc, qx), __fmul_rn(r.ss, qy)))),
        10.0f);
    float dy = __fdiv_rn(
        __fsub_rn(p5y, __fadd_rn(r.py, __fadd_rn(__fmul_rn(r.ss, qx), __fmul_rn(r.cc, qy)))),
        10.0f);
    float sc = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(1.0f, __fmul_rn(dx, dx)), __fmul_rn(dy, dy)));
    r.off = s5 == 0 ? sc : fminf(r.off, sc);
  }
  return r;
}

__device__ __forceinline__ void put_winner(float* outf, int* outi, int A, int a,
                                           float score, const Combo& w, int c) {
  outf[a] = score;
  outf[A + a] = w.cc;
  outf[2 * A + a] = w.ss;
  outf[3 * A + a] = w.px;
  outf[4 * A + a] = w.py;
  outi[a] = c;
}

// The (score descending, index ascending) best of the warp, in every lane.
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    float ov = __shfl_xor_sync(kFull, v, d);
    int oi = __shfl_xor_sync(kFull, i, d);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    combo_chain_kernel(const float* __restrict__ maps, int A, int C,
                       const float* __restrict__ anchor_pos,
                       const int* __restrict__ ring_count,
                       const unsigned char* __restrict__ anchor_valid,
                       const int* __restrict__ combo_max, Pattern P,
                       float* __restrict__ outf, int* __restrict__ outi) {
  __shared__ float s_v[kMaxThreads / 32];
  __shared__ int s_i[kMaxThreads / 32];
  __shared__ int s_win;
  int a = blockIdx.x;
  int t = threadIdx.x;
  size_t plane = (size_t)A * C;
  const float* row = maps + (size_t)a * C;
  float ax = anchor_pos[2 * a];
  float ay = anchor_pos[2 * a + 1];
  int rc = ring_count[a];
  if (!(rc >= 4 && anchor_valid[a] != 0)) {
    // every combo scores 0: the lowest index, combo 0, wins
    if (t == 0) put_winner(outf, outi, A, a, 0.0f, chain(row, plane, 0, ax, ay, P), 0);
    return;
  }
  float bv = -CUDART_INF_F;
  int bi = kNoIndex;
  Combo best = {1.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = t; c < C; c += blockDim.x) {
    Combo r = chain(row, plane, c, ax, ay, P);
    float score = combo_max[c] < rc ? r.off : 0.0f;
    if (score > bv) {  // c ascends: a tie keeps the thread's lowest index
      bv = score;
      bi = c;
      best = r;
    }
  }
  float v = bv;
  int i = bi;
  warp_best(v, i);
  int warp = t >> 5;
  int lane = t & 31;
  if (lane == 0) {
    s_v[warp] = v;
    s_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    int nw = blockDim.x >> 5;
    v = lane < nw ? s_v[lane] : -CUDART_INF_F;
    i = lane < nw ? s_i[lane] : kNoIndex;
    warp_best(v, i);
    if (lane == 0) s_win = i;
  }
  __syncthreads();
  // one thread holds the winner; where no combo has a number for a score
  // (NaN maps), every thread holds the same empty one and writes it
  if (bi == s_win) put_winner(outf, outi, A, a, bv, best, bi);
}

}  // namespace

// maps (12, A, C) f32; anchor_pos (A, 2) f32; ring_count (A,) i32;
// anchor_valid (A,) u8; combo_max (C,) i32; pattern: 12 host floats (the
// (5, 2) slot offsets, then their sum); threads: the block size of
// ops/combo_fused.py combo_plan, a whole number of warps up to
// kMaxThreads (one block per anchor); outf (5, A) f32 = score, cos, sin,
// x, y of each anchor's winner; outi (A,) i32 = the winning combo.
extern "C" int vp_combo_chain(const float* maps, int A, int C,
                              const float* anchor_pos, const int* ring_count,
                              const unsigned char* anchor_valid,
                              const int* combo_max, const float* pattern,
                              int threads, float* outf, int* outi, void* stream) {
  if (C < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  Pattern P;
  for (int k = 0; k < 10; ++k) P.pat[k] = pattern[k];
  P.pbar[0] = pattern[10];
  P.pbar[1] = pattern[11];
  if (A > 0) {
    combo_chain_kernel<<<(unsigned)A, threads, 0, (cudaStream_t)stream>>>(
        maps, A, C, anchor_pos, ring_count, anchor_valid, combo_max, P, outf, outi);
  }
  return (int)cudaGetLastError();
}
