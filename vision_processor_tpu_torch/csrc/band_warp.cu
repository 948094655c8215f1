// Banded 1-D warp pass with per-block window starts: a linear resample along
// axis 1 of src (ch, R, C) at per-output positions pos (ch, n_out, C), each
// (8-row, 128-column) output block reading only the win source rows that
// start at its own r0[block, tile].
//
// Replaces experiments/pallas_band_warp.py:_band_kernel (band_warp_pallas),
// the prototype of B1 (csrc/warp.cu). The TPU kernel keeps the (R, 128)
// column strip in VMEM, slices the (win, 128) window at the scalar-
// prefetched r0 and accumulates win hat-weighted rows, max(0, 1 - |p - k|),
// into the (8, 128) block, so that it needs no gather.
//
// Bound: memory. The function's own bytes are src, pos, r0 and out once
// each (at E1's shape, src (4, 720, 896), pos (4, 432, 896): 22.7 MB,
// 6.8 us at 3.35 TB/s). On Hopper a block is one (8, 128) output tile of
// 128 threads, a thread one column of it: it issues its 8 position loads
// and its column of the window (win loads, 8 in flight at a time) before
// it uses any, keeps the column in shared memory that only it reads (so no
// barrier), and writes its 8 outputs. Small blocks without a barrier keep
// many tiles' loads in flight on every SM (8 blocks an SM at 64 registers
// a thread, most of E1's 1512 tiles at once), where 1024-thread blocks,
// 2 an SM, each staged, waited at a barrier, then computed. Batches of 8
// loads, not 16, keep the thread under 64 registers.
//
// Two taps, bit-equal to the win-tap chain. The plain version
// (ops/band_warp.py _band_warp_plain) sums, for k = 0 .. win-1 in order,
// acc = acc + w_k * s_k from acc = +0, with w_k = max(0, 1 - |p - k|),
// every operation f32 round to nearest; this kernel adds only k = f and
// k = f + 1 (f = floor(p), the second when f + 1 < win), with the same
// operations, wherever the window column is finite. Proof that the sums
// are equal, for finite s and 0 <= p <= win - 1 (the wrapper checks it):
// p = pos - r0 is exact (r0 is an integer and |p| <= pos < 2^24, so p is a
// multiple of ulp(pos)). For k <= f - 1 the true p - k is >= 1, and for
// k >= f + 2 it is < -1; rounding is monotone and +-1 are representable,
// so |fl(p - k)| >= 1, fl(1 - |fl(p - k)|) <= 0 (never -0: 1 - 1 = +0 in
// round to nearest), and w_k = +0. Then w_k * s_k = +-0, and adding +-0
// leaves a nonzero sum unchanged and turns +0 into +0. The sum is never
// -0: it starts at +0, and a round-to-nearest sum is -0 only when both
// addends are -0. So every zero-weight term leaves acc as it was, and the
// win-tap chain reduces to the two terms at f and f + 1, computed here by
// the same expressions in the same order. A non-finite source anywhere in
// the window column breaks the proof (0 * inf and 0 * NaN are NaN, and the
// plain version and the TPU kernel carry them into the output): the thread
// keeps a flag while it stages its column and runs the whole win-tap chain
// where the flag is clear.
#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 8;    // output rows per block
constexpr int kLan = 128;  // output columns per block = threads per block
constexpr int kBatch = 8;  // window loads a thread has in flight

__device__ __forceinline__ float tap(float acc, float p, int k, float s) {
  float wgt = __fsub_rn(1.0f, fabsf(__fsub_rn(p, (float)k)));
  wgt = wgt < 0.0f ? 0.0f : wgt;  // torch.clamp_min(., 0): NaN passes
  return __fadd_rn(acc, __fmul_rn(wgt, s));
}

// kStaging: the loads and the finite flags alone (one output a thread
// written from them), for measuring what the staging costs.
template <bool kStaging>
__global__ void __launch_bounds__(kLan)
band_warp_kernel(const float* __restrict__ src, const float* __restrict__ pos,
                 const int* __restrict__ r0, float* __restrict__ out, int R, int C,
                 int n_out, int win) {
  extern __shared__ float window[];  // (win, kLan); column t is thread t's own
  const int t = threadIdx.x;
  const int rb = blockIdx.y;
  const int c = blockIdx.z;
  const size_t col = (size_t)blockIdx.x * kLan + t;
  const size_t o0 = ((size_t)c * n_out + (size_t)rb * kBlk) * C + col;
  float pr[kBlk];
#pragma unroll
  for (int j = 0; j < kBlk; ++j) pr[j] = __ldg(pos + o0 + (size_t)j * C);
  const int start = __ldg(r0 + (size_t)rb * (C / kLan) + blockIdx.x);
  const float* s = src + ((size_t)c * R + start) * C + col;
  bool finite = true;
  for (int k0 = 0; k0 < win; k0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      v[j] = k0 + j < win ? __ldg(s + (size_t)(k0 + j) * C) : 0.0f;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (k0 + j < win) {
        window[(k0 + j) * kLan + t] = v[j];
        finite = finite && isfinite(v[j]);
      }
    }
  }
  if (kStaging) {
    out[o0] = finite ? pr[0] : 0.0f;
    return;
  }
#pragma unroll
  for (int j = 0; j < kBlk; ++j) {
    const float p = __fsub_rn(pr[j], (float)start);
    float acc = 0.0f;
    if (finite) {
      const int f = min(max((int)floorf(p), 0), win - 1);
      acc = tap(acc, p, f, window[f * kLan + t]);
      if (f + 1 < win) acc = tap(acc, p, f + 1, window[(f + 1) * kLan + t]);
    } else {
      for (int k = 0; k < win; ++k) acc = tap(acc, p, k, window[k * kLan + t]);
    }
    out[o0 + (size_t)j * C] = acc;
  }
}

template <bool kStaging>
int launch(const float* src, const float* pos, const int* r0, float* out, int ch, int R,
           int C, int n_out, int win, void* stream) {
  if (C % kLan || n_out % kBlk || win < 1) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)win * kLan * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute((const void*)band_warp_kernel<kStaging>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (ch > 0 && C > 0 && n_out > 0) {
    dim3 grid((unsigned)(C / kLan), (unsigned)(n_out / kBlk), (unsigned)ch);
    band_warp_kernel<kStaging><<<grid, kLan, smem, (cudaStream_t)stream>>>(
        src, pos, r0, out, R, C, n_out, win);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// src (ch, R, C) f32, pos and out (ch, n_out, C) f32, r0 (n_out / 8, C / 128)
// i32 on the card; C a multiple of 128, n_out of 8, n_out / 8 <= 65535,
// ch <= 65535, 0 <= r0 <= R - win, 0 <= pos - r0 <= win - 1.
extern "C" int vp_band_warp(const float* src, const float* pos, const int* r0,
                            float* out, int ch, int R, int C, int n_out, int win,
                            void* stream) {
  return launch<false>(src, pos, r0, out, ch, R, C, n_out, win, stream);
}

// The same loads and finite flags, without the sums: out[c, 8 * rb, col] only
// (the rest of out is left as it was). For timing the staging alone.
extern "C" int vp_band_warp_staging(const float* src, const float* pos, const int* r0,
                                    float* out, int ch, int R, int C, int n_out, int win,
                                    void* stream) {
  return launch<true>(src, pos, r0, out, ch, R, C, n_out, win, stream);
}
