// Banded 1-D warp pass with per-block window starts: a linear resample along
// axis 1 of src (ch, R, C) at per-output positions pos (ch, n_out, C), each
// (8-row, 128-column) output block reading only the win source rows that
// start at its own r0[block, tile].
//
// Replaces experiments/pallas_band_warp.py:_band_kernel (band_warp_pallas),
// the prototype of B1 (csrc/warp.cu). The TPU kernel keeps the (R, 128)
// column strip in VMEM, slices the (win, 128) window at the scalar-
// prefetched r0 and accumulates win hat-weighted rows, max(0, 1 - |p - k|),
// into the (8, 128) block, so that it needs no gather. B1 on Hopper reads
// the two taps at floor(p) from L1/L2 instead. This kernel keeps E1's
// design where it carries over: one block per (8, 128) output tile and
// channel loads its own r0, stages the (win, 128) window in shared memory
// with coalesced row reads, and each of its 1024 threads (one per output)
// sums the win hat-weighted taps from shared memory in E1's order.
//
// Bound: memory. Each source element of the windows is read once per
// output block that covers it; the function's own bytes are src, pos, r0
// and out once each (at E1's shape, src (4, 720, 896), pos (4, 432, 896):
// 22.7 MB, 6.8 us at 3.35 TB/s); the hat sum is 5 operations per tap, win
// taps per output. Every operation is a round-to-nearest intrinsic in the
// plain PyTorch version's order (ops/band_warp.py _band_warp_plain), so
// the kernel is bit-equal to it. The wrapper checks E1's precondition:
// every window lies in the source and every position in its block's
// window (0 <= pos - r0 <= win - 1).
#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 8;    // output rows per block
constexpr int kLan = 128;  // output columns per block

__global__ void band_warp_kernel(const float* __restrict__ src,
                                 const float* __restrict__ pos,
                                 const int* __restrict__ r0,
                                 float* __restrict__ out, int R, int C, int n_out,
                                 int win) {
  extern __shared__ float window[];  // (win, kLan)
  int tile = blockIdx.x;
  int rb = blockIdx.y;
  int c = blockIdx.z;
  int start = __ldg(r0 + (size_t)rb * (C / kLan) + tile);
  const float* s = src + ((size_t)c * R + start) * C + (size_t)tile * kLan;
  int tid = threadIdx.y * kLan + threadIdx.x;
  for (int i = tid; i < win * kLan; i += kBlk * kLan) {
    window[i] = __ldg(s + (size_t)(i / kLan) * C + (i % kLan));
  }
  __syncthreads();
  size_t o = ((size_t)c * n_out + (size_t)rb * kBlk + threadIdx.y) * C +
             (size_t)tile * kLan + threadIdx.x;
  float p = __fsub_rn(__ldg(pos + o), (float)start);
  float acc = 0.0f;
  for (int k = 0; k < win; ++k) {
    float wgt = __fsub_rn(1.0f, fabsf(__fsub_rn(p, (float)k)));
    wgt = wgt < 0.0f ? 0.0f : wgt;  // torch.clamp_min(., 0): NaN passes
    acc = __fadd_rn(acc, __fmul_rn(wgt, window[k * kLan + threadIdx.x]));
  }
  out[o] = acc;
}

}  // namespace

// src (ch, R, C) f32, pos and out (ch, n_out, C) f32, r0 (n_out / 8, C / 128)
// i32 on the card; C a multiple of 128, n_out of 8, n_out / 8 <= 65535,
// ch <= 65535, 0 <= r0 <= R - win.
extern "C" int vp_band_warp(const float* src, const float* pos, const int* r0,
                            float* out, int ch, int R, int C, int n_out, int win,
                            void* stream) {
  if (C % kLan || n_out % kBlk || win < 1) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)win * kLan * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)band_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (ch > 0 && C > 0 && n_out > 0) {
    dim3 grid((unsigned)(C / kLan), (unsigned)(n_out / kBlk), (unsigned)ch);
    dim3 block(kLan, kBlk);
    band_warp_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(src, pos, r0, out,
                                                                  R, C, n_out, win);
  }
  return (int)cudaGetLastError();
}
