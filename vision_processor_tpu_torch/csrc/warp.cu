// Banded 1-D linear resample: one pass of the two-pass separable warp.
//
// Replaces vision_processor_tpu/ops/warp.py:_band_kernel (band_pass).
// The TPU kernel loads a WIN-row window per (8, 128) output block, starting
// at a scalar-prefetched row r0, and accumulates WIN hat-weighted taps so
// that no gather is needed. On Hopper a gather from L1/L2 is cheap, so each
// thread computes its output directly from the two taps at floor(p):
// out = (1 - f) * src[i0] + f * src[i0 + 1]. warp_fits guarantees that the
// TPU window holds both taps, so r0 is a precondition here, not an input.
//
// Bound: memory. Per output element it reads one position and two source
// values (neighbouring threads read neighbouring columns, so both the
// position and the source reads coalesce) and writes one value; at the
// slice's shapes (pass 1 (4, 776, 640), pass 2 (4, 432, 896)) that is a
// few MB per pass, well inside L2. Design: one thread per output element,
// column index fastest; explicit round-to-nearest intrinsics keep nvcc from
// contracting the lerp into an FMA, so the result is bit-equal to the
// plain PyTorch version (ops/warp.py _band_pass_plain).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void band_pass_kernel(const float* __restrict__ src,
                                 const float* __restrict__ pos,
                                 float* __restrict__ out, int R, int C,
                                 int n_out, long long total) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  int col = (int)(t % C);
  long long rest = t / C;
  long long c = rest / n_out;
  float p = pos[t];
  int i0 = (int)floorf(p);
  i0 = min(max(i0, 0), R - 2);
  float f = __fsub_rn(p, (float)i0);
  const float* s = src + (size_t)c * R * C + col;
  float a = s[(size_t)i0 * C];
  float b = s[(size_t)(i0 + 1) * C];
  out[t] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), a), __fmul_rn(f, b));
}

}  // namespace

extern "C" int vp_band_pass(const float* src, const float* pos, float* out,
                            int ch, int R, int C, int n_out, void* stream) {
  long long total = (long long)ch * n_out * C;
  if (total > 0) {
    long long blocks = (total + kThreads - 1) / kThreads;
    band_pass_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        src, pos, out, R, C, n_out, total);
  }
  return (int)cudaGetLastError();
}
