// Corner-stack gather of the cached-grid resample:
// out[p, :] = float(stack[idx[p], :]) over 16 u8 lanes per row.
//
// Replaces vision_processor_tpu/ops/pallas_resample.py:_kernel
// (gather_corners_pallas). A TPU cannot gather from HBM, so that kernel
// DMAs a (16, 192) band of the stack per (8, 128) output tile, with band
// starts scalar-prefetched from the index maps, and gathers inside VMEM as a
// one-hot bf16 matmul on the MXU (exact for 8-bit data). It never lowered on
// Mosaic; this is the function's first compiled form.
//
// Bound: memory. Per output pixel it reads one i32 index and one 16-byte
// stack row and writes 64 bytes of f32: at the slice's shapes (432 x 770
// outputs from a 540 x 960 x 16 stack, 8.3 MB, which fits the 50 MB L2)
// the 21.3 MB of output dominate. Design: one thread per (output pixel,
// 4-byte word of the row). Four neighbouring threads read one 16-byte row
// and write one 64-byte run of the output, so the stores coalesce across
// the warp; the row reads are as scattered as the grid is, and the L2
// absorbs them. The u8 -> f32 widening is exact, as is the one-hot product
// of the TPU kernel, so the result is bit-equal to the plain PyTorch
// version (ops/gather_corners.py _gather_corners_plain).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_corners_kernel(const uint32_t* __restrict__ stack,
                                      const int* __restrict__ idx,
                                      long long n_words,
                                      float4* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_words) return;
  long long p = t >> 2;
  uint32_t v = stack[(size_t)idx[p] * 4 + (t & 3)];
  // little-endian: byte k of the word is lane 4 * (t & 3) + k
  out[t] = make_float4((float)(v & 0xffu), (float)((v >> 8) & 0xffu),
                       (float)((v >> 16) & 0xffu), (float)(v >> 24));
}

}  // namespace

extern "C" int vp_gather_corners(const void* stack, const int* idx,
                                 long long n_out, void* out, void* stream) {
  long long n_words = n_out * 4;
  if (n_words > 0) {
    long long blocks = (n_words + kThreads - 1) / kThreads;
    gather_corners_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const uint32_t*)stack, idx, n_words, (float4*)out);
  }
  return (int)cudaGetLastError();
}
