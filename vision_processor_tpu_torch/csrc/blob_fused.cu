// Fused blob response: gradient dot, local box sums, quadrant circularity,
// 4-neighbour local maximum, disc colour mean/stddev and the masked score;
// and the circularity alone.
//
// Replaces vision_processor_tpu/ops/blob_pallas.py:_response_kernel
// (blob_response_fused, kernel B2) and :_kernel (circularity_fused, kernel
// B5, the circularity-first extraction). Both TPU kernels keep the three
// edge-padded flat channels resident in VMEM and walk 16-row bands,
// forming every intermediate with lane rolls so that none of them reaches
// HBM.
//
// Bound: arithmetic on L1-resident data. Every output pixel needs the
// circularity of itself (B5) or of itself and its four neighbours (B2):
// 4 boxes of (r-1)^2 gradient values, each 3 channels x 4 reads; B2 adds
// 2 x 3 disc sums over 29 taps (r = 4, dr = 3 at the slice). All of it is
// read from a (432, 770, 3) f32 map that stays in L2 (4 MB). The bytes
// that must move (the map once, the outputs once) take 1.6 us (B5) and
// 3.2 us (B2) at HBM rate, far below the recompute. Design, simple first:
// circ_kernel computes the circularity on the output grid widened by `ext`
// pixels on each side, each thread recomputing its gradient values with
// clamped reads. B5 is one launch of it at ext = 0. B2 launches it at
// ext = 1 into a scratch map (the local-max neighbours), then
// response_kernel reads the five circularity values it needs from the
// scratch map and computes the disc statistics, score and mask. Clamped
// reads of the unpadded map equal the TPU wrappers' edge-replicated
// padding, and the lane-roll wrap of the TPU kernels lies outside their
// crop, so results agree over the whole cropped map. Every sum is taken in
// the TPU kernels' order with round-to-nearest intrinsics (no FMA
// contraction), so both kernels are bit-equal to their plain PyTorch
// versions (ops/blob_fused.py _blob_response_fused_plain,
// _circularity_fused_plain).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSpans = 64;

struct Spans {
  int n;
  int dy[kMaxSpans];
  int hw[kMaxSpans];
};

__device__ __forceinline__ float ld(const float* __restrict__ flat, int H,
                                    int W, int y, int x, int c) {
  y = min(max(y, 0), H - 1);
  x = min(max(x, 0), W - 1);
  return flat[((size_t)y * W + x) * 3 + c];
}

// sum over the 3 channels of (c[y, x+o] - c[y, x-o]) * (c[y+o, x] - c[y-o, x])
__device__ float grad_at(const float* __restrict__ flat, int H, int W, int y,
                         int x, int o) {
  float acc = 0.0f;
  for (int c = 0; c < 3; ++c) {
    float gx = __fsub_rn(ld(flat, H, W, y, x + o, c),
                         ld(flat, H, W, y, x - o, c));
    float gy = __fsub_rn(ld(flat, H, W, y + o, x, c),
                         ld(flat, H, W, y - o, x, c));
    float p = __fmul_rn(gx, gy);
    acc = c == 0 ? p : __fadd_rn(acc, p);
  }
  return acc;
}

// (r-1) x (r-1) box of gradient values with top-left corner (y, x):
// row sums left to right, then rows top to bottom (the TPU kernel's order)
__device__ float box_at(const float* __restrict__ flat, int H, int W, int y,
                        int x, int o, int r) {
  float box = 0.0f;
  for (int a = 0; a < r - 1; ++a) {
    float row = grad_at(flat, H, W, y + a, x, o);
    for (int b = 1; b < r - 1; ++b)
      row = __fadd_rn(row, grad_at(flat, H, W, y + a, x + b, o));
    box = a == 0 ? row : __fadd_rn(box, row);
  }
  return box;
}

// circularity on the (H + 2 ext, W + 2 ext) grid:
// circ_ext[ye, xe] = circ(ye - ext, xe - ext)
__global__ void circ_kernel(const float* __restrict__ flat, int H, int W,
                            int o, int r, int ext, float inv_rr,
                            float* __restrict__ circ_ext) {
  int We = W + 2 * ext;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)(H + 2 * ext) * We) return;
  int y = (int)(t / We) - ext;
  int x = (int)(t % We) - ext;
  float pp = box_at(flat, H, W, y + 2, x + 2, o, r);
  float nn = box_at(flat, H, W, y - r + 1, x - r + 1, o, r);
  float pn = box_at(flat, H, W, y - r + 1, x + 2, o, r);
  float np_ = box_at(flat, H, W, y + 2, x - r + 1, o, r);
  float c = fminf(fminf(pp, nn), fminf(-pn, -np_));
  circ_ext[t] = __fmul_rn(c, inv_rr);
}

__global__ void response_kernel(const float* __restrict__ flat, int H, int W,
                                Spans spans, float inv_n,
                                const float* __restrict__ th_ptr,
                                const float* __restrict__ circ_ext,
                                float* __restrict__ ms,
                                float* __restrict__ circ_out,
                                float* __restrict__ m0,
                                float* __restrict__ m1,
                                float* __restrict__ m2) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)H * W) return;
  int y = (int)(t / W);
  int x = (int)(t % W);
  int We = W + 2;
  const float* ce = circ_ext + (size_t)(y + 1) * We + (x + 1);
  float cc = ce[0];
  bool lmax = (ce[-1] <= cc) && (ce[1] <= cc) && (ce[-We] <= cc) &&
              (ce[We] <= cc);

  float std_sum = 0.0f;
  float means[3];
  for (int c = 0; c < 3; ++c) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = 0; k < spans.n; ++k) {
      int yy = y + spans.dy[k];
      float v = ld(flat, H, W, yy, x, c);
      float sp1 = v;
      float sp2 = __fmul_rn(v, v);
      for (int b = 1; b <= spans.hw[k]; ++b) {
        float vp = ld(flat, H, W, yy, x + b, c);
        float vm = ld(flat, H, W, yy, x - b, c);
        sp1 = __fadd_rn(__fadd_rn(sp1, vp), vm);
        sp2 = __fadd_rn(__fadd_rn(sp2, __fmul_rn(vp, vp)), __fmul_rn(vm, vm));
      }
      s1 = k == 0 ? sp1 : __fadd_rn(s1, sp1);
      s2 = k == 0 ? sp2 : __fadd_rn(s2, sp2);
    }
    float mean = __fmul_rn(s1, inv_n);
    float var = fmaxf(__fsub_rn(__fmul_rn(s2, inv_n), __fmul_rn(mean, mean)),
                      0.0f);
    float sd = __fsqrt_rn(var);
    std_sum = c == 0 ? sd : __fadd_rn(std_sum, sd);
    means[c] = mean;
  }
  float score = __fdiv_rn(cc, fmaxf(std_sum, 1e-12f));
  bool keep = (cc >= th_ptr[0]) && lmax;
  ms[t] = keep ? score : -CUDART_INF_F;
  circ_out[t] = cc;
  m0[t] = means[0];
  m1[t] = means[1];
  m2[t] = means[2];
}

}  // namespace

extern "C" int vp_blob_response(const float* flat, int H, int W, int o,
                                int r, float inv_rr, int n_spans,
                                const int* dys, const int* hws, float inv_n,
                                const float* th, float* circ_ext, float* ms,
                                float* circ, float* m0, float* m1, float* m2,
                                void* stream) {
  if (n_spans < 1 || n_spans > kMaxSpans) return (int)cudaErrorInvalidValue;
  Spans spans;
  spans.n = n_spans;
  for (int k = 0; k < n_spans; ++k) {
    spans.dy[k] = dys[k];
    spans.hw[k] = hws[k];
  }
  cudaStream_t s = (cudaStream_t)stream;
  long long n_ext = (long long)(H + 2) * (W + 2);
  long long n_out = (long long)H * W;
  if (n_out > 0) {
    circ_kernel<<<(unsigned)((n_ext + kThreads - 1) / kThreads), kThreads, 0,
                  s>>>(flat, H, W, o, r, 1, inv_rr, circ_ext);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    response_kernel<<<(unsigned)((n_out + kThreads - 1) / kThreads), kThreads,
                      0, s>>>(flat, H, W, spans, inv_n, th, circ_ext, ms,
                              circ, m0, m1, m2);
  }
  return (int)cudaGetLastError();
}

extern "C" int vp_circularity(const float* flat, int H, int W, int o, int r,
                              float inv_rr, float* circ, void* stream) {
  if (r < 2) return (int)cudaErrorInvalidValue;
  long long n_out = (long long)H * W;
  if (n_out > 0) {
    circ_kernel<<<(unsigned)((n_out + kThreads - 1) / kThreads), kThreads, 0,
                  (cudaStream_t)stream>>>(flat, H, W, o, r, 0, inv_rr, circ);
  }
  return (int)cudaGetLastError();
}
