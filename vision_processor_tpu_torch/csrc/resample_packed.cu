// In-line projection resample: the packed single-cell sampler of the flat
// field grid. For each flat pixel, its projected image position (px, py) in
// the half-resolution plane space, the 2x2 cell neighbourhood of the four
// planes, per-plane fractions clipped to that shared cell (each plane at its
// quarter-pixel Bayer offset), three lerps per plane, the Bayer green
// combine and dRGB -> (Hf, Wf, 3) f32.
//
// Replaces experiments/k2_proto.py:_kernel and experiments/k2_stages.py:
// _kernel (resample_k2, E2 and E3: one function, E3 with fewer transposes).
// The TPU kernels keep the whole image in VMEM as bf16, copy a scalar-
// prefetched (BH, BW)-block window per (8, 128) output tile and select the
// four corners with one-hot bf16 matmuls, because a TPU cannot gather; they
// emulate the clamp-to-edge with a cell in [0, W-2] and fraction 1 at the
// edge, hard-code H=540, W=960 and RGGB, and have no check that a tile's
// positions fit the window. On Hopper a gather from L1/L2 is cheap, so
// there is no window: one thread per flat pixel reads its px/py (coalesced;
// they may be interleaved, as the projection writes them), clamps the cell
// as the production sampler does (ops/frame.py sample_planes_packed) and
// loads the four cells straight from the source. From the raw Bayer frame a
// cell is two u16 loads, as csrc/corner_stack.cu reads it, so neither the
// f32 packed planes nor the corner stack is built.
//
// Bound: memory. Per flat pixel it reads px and py (8 bytes) and writes
// three floats (12); the raw frame is read once across the grid (2 MB at
// 1080p): at the flat grid (432, 770) about 8.7 MB, 2.6 us at 3.35 TB/s;
// at (540, 962) 12.5 MB, 3.7 us. About 106 float32 operations per pixel,
// well under the byte bound. The sources: a Bayer frame (2H, 2W) u8 (RGGB
// or GRBG), BGR (H, W, 3) u8 with a zero 4th plane, or packed planes
// (H, W, 4) u8 or f32 (E2/E3's own contract; f32 values are 8-bit camera
// data, cast as torch casts f32 to u8). Every operation is a round-to-
// nearest intrinsic in the plain PyTorch version's order (ops/frame.py
// sample_planes_packed -> combine_planes -> rgb_to_drgb), so nvcc cannot
// contract a lerp into an FMA and the kernel is bit-equal to that chain.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// source modes
constexpr int kBayer = 0;
constexpr int kBgr = 1;
constexpr int kPackedU8 = 2;
constexpr int kPackedF32 = 3;
// raw formats (the combine of the planes)
constexpr int kRggb = 0;
constexpr int kGrbg = 1;
constexpr int kFmtBgr = 2;

__device__ __forceinline__ uint32_t to_u8(float v) {
  // torch's f32 -> u8 cast: through int64, then the low byte
  return (uint32_t)(uint8_t)(long long)v;
}

// the 4 planes of cell (y, x) as one word: byte k = plane k
template <int MODE>
__device__ __forceinline__ uint32_t cell_word(const void* __restrict__ src, int y,
                                              int x, int w) {
  if (MODE == kBayer) {
    // raw row 2y holds planes 0, 1 of the cell; row 2y + 1 planes 2, 3
    const uint16_t* top =
        reinterpret_cast<const uint16_t*>(src) + (size_t)(2 * y) * w;
    const uint16_t* bot = top + w;
    return (uint32_t)__ldg(top + x) | ((uint32_t)__ldg(bot + x) << 16);
  } else if (MODE == kBgr) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(src) + ((size_t)y * w + x) * 3;
    return (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 8) |
           ((uint32_t)__ldg(p + 2) << 16);
  } else if (MODE == kPackedU8) {
    return __ldg(reinterpret_cast<const uint32_t*>(src) + (size_t)y * w + x);
  } else {
    float4 f = __ldg(reinterpret_cast<const float4*>(src) + (size_t)y * w + x);
    return to_u8(f.x) | (to_u8(f.y) << 8) | (to_u8(f.z) << 16) | (to_u8(f.w) << 24);
  }
}

// torch.clamp(x, 0, 1): NaN passes through
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

__device__ __forceinline__ float plane(uint32_t word, int p) {
  return (float)((word >> (8 * p)) & 0xFFu);
}

// (2a - b - c + 510) * 0.25, left to right
__device__ __forceinline__ float drgb(float a, float b, float c) {
  return __fmul_rn(
      __fadd_rn(__fsub_rn(__fsub_rn(__fmul_rn(2.0f, a), b), c), 510.0f), 0.25f);
}

template <int MODE, int FMT>
__global__ void resample_packed_kernel(const void* __restrict__ src, int h, int w,
                                       const float* __restrict__ px,
                                       const float* __restrict__ py, int pstride,
                                       long long n, float* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float u = __fsub_rn(__ldg(px + t * pstride), 0.5f);
  float v = __fsub_rn(__ldg(py + t * pstride), 0.5f);
  int x0 = min(max((int)floorf(u), 0), w - 1);
  int y0 = min(max((int)floorf(v), 0), h - 1);
  int x1 = min(x0 + 1, w - 1);
  int y1 = min(y0 + 1, h - 1);
  uint32_t c00 = cell_word<MODE>(src, y0, x0, w);
  uint32_t c01 = cell_word<MODE>(src, y0, x1, w);
  uint32_t c10 = cell_word<MODE>(src, y1, x0, w);
  uint32_t c11 = cell_word<MODE>(src, y1, x1, w);
  float x0f = (float)x0;
  float y0f = (float)y0;
  float s[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    // quarter-pixel plane offsets (ops/frame.py _PLANE_OFFSETS)
    float offx = FMT == kFmtBgr ? 0.0f : ((p & 1) ? -0.25f : 0.25f);
    float offy = FMT == kFmtBgr ? 0.0f : ((p & 2) ? -0.25f : 0.25f);
    float fx = clamp01(__fsub_rn(__fadd_rn(u, offx), x0f));
    float fy = clamp01(__fsub_rn(__fadd_rn(v, offy), y0f));
    float gx = __fsub_rn(1.0f, fx);
    float top = __fadd_rn(__fmul_rn(plane(c00, p), gx), __fmul_rn(plane(c01, p), fx));
    float bot = __fadd_rn(__fmul_rn(plane(c10, p), gx), __fmul_rn(plane(c11, p), fx));
    s[p] = __fadd_rn(__fmul_rn(top, __fsub_rn(1.0f, fy)), __fmul_rn(bot, fy));
  }
  float r, g, b;
  if (FMT == kRggb) {
    r = s[0];
    g = __fadd_rn(__fmul_rn(0.5f, s[1]), __fmul_rn(0.5f, s[2]));
    b = s[3];
  } else if (FMT == kGrbg) {
    r = s[1];
    g = __fadd_rn(__fmul_rn(0.5f, s[0]), __fmul_rn(0.5f, s[3]));
    b = s[2];
  } else {
    r = s[2];
    g = s[1];
    b = s[0];
  }
  float* o = out + 3 * t;
  o[0] = drgb(r, g, b);
  o[1] = drgb(g, b, r);
  o[2] = drgb(b, r, g);
}

template <int MODE, int FMT>
void launch(const void* src, int h, int w, const float* px, const float* py,
            int pstride, long long n, float* out, cudaStream_t s) {
  long long blocks = (n + kThreads - 1) / kThreads;
  resample_packed_kernel<MODE, FMT><<<(unsigned)blocks, kThreads, 0, s>>>(
      src, h, w, px, py, pstride, n, out);
}

}  // namespace

// src: by mode, Bayer (2H, 2W) u8 (mode 0, 2-byte aligned; fmt RGGB or
// GRBG), BGR (H, W, 3) u8 (mode 1; fmt BGR), packed planes (H, W, 4) u8
// (mode 2, 4-byte aligned) or f32 (mode 3, 16-byte aligned); (h, w) the
// plane grid. px/py: n flat pixels, element t at px[t * pstride]. out:
// (n, 3) f32.
extern "C" int vp_resample_packed(const void* src, int mode, int fmt, int h, int w,
                                  const float* px, const float* py, int pstride,
                                  long long n, float* out, void* stream) {
  if (n > 0) {
    if (h < 1 || w < 1 || pstride < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (mode * 3 + fmt) {
      case kBayer * 3 + kRggb:
        launch<kBayer, kRggb>(src, h, w, px, py, pstride, n, out, s);
        break;
      case kBayer * 3 + kGrbg:
        launch<kBayer, kGrbg>(src, h, w, px, py, pstride, n, out, s);
        break;
      case kBgr * 3 + kFmtBgr:
        launch<kBgr, kFmtBgr>(src, h, w, px, py, pstride, n, out, s);
        break;
      case kPackedU8 * 3 + kRggb:
        launch<kPackedU8, kRggb>(src, h, w, px, py, pstride, n, out, s);
        break;
      case kPackedU8 * 3 + kGrbg:
        launch<kPackedU8, kGrbg>(src, h, w, px, py, pstride, n, out, s);
        break;
      case kPackedU8 * 3 + kFmtBgr:
        launch<kPackedU8, kFmtBgr>(src, h, w, px, py, pstride, n, out, s);
        break;
      case kPackedF32 * 3 + kRggb:
        launch<kPackedF32, kRggb>(src, h, w, px, py, pstride, n, out, s);
        break;
      case kPackedF32 * 3 + kGrbg:
        launch<kPackedF32, kGrbg>(src, h, w, px, py, pstride, n, out, s);
        break;
      case kPackedF32 * 3 + kFmtBgr:
        launch<kPackedF32, kFmtBgr>(src, h, w, px, py, pstride, n, out, s);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
