// Corner stack of the cached-grid resample: for each cell (y, x) of the
// (H, W) half-resolution plane grid, 16 bytes = the cell's 4 planes, then
// those of its right, down and down-right neighbours, replicated at the
// last row and column (lanes [cell, right, down, down-right] x 4 planes).
//
// Replaces experiments/pallas_stack.py:_kernel_rows (corner_stack_pallas).
// The TPU kernel takes the packed planes (H, 4W) in 64-row VMEM blocks and
// reads the first row of the next block as its halo, masking the padding
// rows of a partial last block; its byte shuffles are lane concats and a
// 4 -> 16 relayout. Blocks on Hopper run in no order and share nothing, so
// there is no halo to carry: each thread computes one cell and reads the
// (at most) four cells it needs, clamped at the edges, from device memory.
// The neighbours' reads hit the L1/L2 that the neighbouring threads' own
// reads just filled.
//
// Bound: memory. The function reads 4 bytes per cell (the raw frame, or the
// packed planes) and writes 16: at (H, W) = (540, 960), 10.4 MB, about
// 3.1 us at 3.35 TB/s. Design: one thread per cell; the four source words
// are built straight from the raw frame as the JAX package's
// corner_stack_u32 builds them (a Bayer cell is two u16 loads, the top and
// bottom rows, one u32 word little-endian), and the 16 output bytes go out
// as one aligned 16-byte store, so a warp writes 512 contiguous bytes.
// Three sources share the kernel: Bayer raw (2H, 2W) u8, packed planes
// (H, 4W) u8 (the experiment's contract), BGR (H, W, 3) u8 with a zero 4th
// plane. Pure byte moves: bit-equal to the plain PyTorch version
// (ops/corner_stack.py _corner_stack_plain).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBayer = 0;
constexpr int kPacked = 1;
constexpr int kBgr = 2;

// the 4 planes of cell (y, x) as one little-endian word: byte k = plane k
template <int MODE>
__device__ __forceinline__ uint32_t cell_word(const uint8_t* __restrict__ src,
                                              int y, int x, int w) {
  if (MODE == kBayer) {
    // raw row 2y holds planes 0, 1 of the cell; row 2y + 1 planes 2, 3
    const uint16_t* top =
        reinterpret_cast<const uint16_t*>(src + (size_t)(2 * y) * (2 * w));
    const uint16_t* bot = top + w;
    return (uint32_t)__ldg(top + x) | ((uint32_t)__ldg(bot + x) << 16);
  } else if (MODE == kPacked) {
    return __ldg(reinterpret_cast<const uint32_t*>(src) + (size_t)y * w + x);
  } else {
    const uint8_t* p = src + ((size_t)y * w + x) * 3;
    return (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 8) |
           ((uint32_t)__ldg(p + 2) << 16);
  }
}

template <int MODE>
__global__ void corner_stack_kernel(const uint8_t* __restrict__ src, int h,
                                    int w, uint4* __restrict__ out) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  if (x >= w) return;
  int x1 = min(x + 1, w - 1);
  int y1 = min(y + 1, h - 1);
  uint4 v;
  v.x = cell_word<MODE>(src, y, x, w);
  v.y = cell_word<MODE>(src, y, x1, w);
  v.z = cell_word<MODE>(src, y1, x, w);
  v.w = cell_word<MODE>(src, y1, x1, w);
  out[(size_t)y * w + x] = v;
}

}  // namespace

// src: Bayer (2H, 2W) u8 (mode 0, 2-byte aligned), packed planes (H, 4W) u8
// (mode 1, 4-byte aligned) or BGR (H, W, 3) u8 (mode 2); out: (H, W, 16) u8,
// 16-byte aligned; H <= 65535 (the grid's y extent).
extern "C" int vp_corner_stack(const void* src, int mode, int h, int w,
                               void* out, void* stream) {
  if (h > 0 && w > 0) {
    dim3 grid((unsigned)((w + kThreads - 1) / kThreads), (unsigned)h);
    cudaStream_t s = (cudaStream_t)stream;
    const uint8_t* in = (const uint8_t*)src;
    uint4* o = (uint4*)out;
    switch (mode) {
      case kBayer:
        corner_stack_kernel<kBayer><<<grid, kThreads, 0, s>>>(in, h, w, o);
        break;
      case kPacked:
        corner_stack_kernel<kPacked><<<grid, kThreads, 0, s>>>(in, h, w, o);
        break;
      case kBgr:
        corner_stack_kernel<kBgr><<<grid, kThreads, 0, s>>>(in, h, w, o);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
