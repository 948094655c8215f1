// Fused blob response: gradient dot, local box sums, quadrant circularity,
// 4-neighbour local maximum, disc colour mean/stddev, the masked score and
// the count of kept pixels; and the circularity alone.
//
// Replaces vision_processor_tpu/ops/blob_pallas.py:_response_kernel
// (blob_response_fused, kernel B2) and :_kernel (circularity_fused, kernel
// B5, the circularity-first extraction). Both TPU kernels keep the three
// edge-padded flat channels resident in VMEM and walk 16-row bands,
// forming every intermediate once with lane rolls so that none of them
// reaches HBM.
//
// Bound: the bytes that must move (the (H, W, 3) f32 map read once, the
// outputs written once) take 1.6 us (B5) and 3.2 us (B2) at HBM rate at
// the slice's (432, 770); the map (4 MB) stays in L2. What costs is the
// arithmetic and the shared-memory traffic of the stencils.
//
// Built once per shape: ops/blob_fused.py kernel_defines gives the radii
// and the planned tile as constants (VP_O, VP_R, VP_TILE_H, VP_TILE_W, and
// VP_DR for B2; without VP_DR the library holds B5), and ops/cuda.py
// compiles one library per shape, on the shape's first call or ahead of it.
// So every loop unrolls, every offset and disc span is a constant, whatever
// the camera's radii.
//
// Design: one block of 256 threads per output tile (tile_h x tile_w,
// planned by ops/blob_fused.py tile_plan). The block stages the tile's
// window, widened by a halo p (o + r + 1 for B2, o + r for B5), once, with
// asynchronous 4-byte copies all in flight together: every global
// coordinate is clamped at load time, which equals the TPU wrappers' edge
// padding, and the three channels go to separate planes. From there each
// intermediate is formed once per staged position, in shared memory: the
// gradient dot, the (r-1)-wide box row sums, the (r-1)-tall box sums and
// the circularity (on the tile widened by 1 for
// B2, the local-max ring, whose positions outside the map come from
// clamped flat reads like every other). B2 then builds, per channel, one
// disc-span chain per (staged row, output column) for the value and its
// square, keeps the chain at each span width that disc_spans(dr) needs
// (a narrower span is a prefix of the wider one's chain) and adds 2dr+1 of
// them per output pixel; the width-0 rows (dy = +-dr) read the staged
// value itself. The same launch writes the five planes and counts the kept
// pixels (__syncthreads_count, one atomicAdd a block into the int32 that
// the entry zeroes on the same stream): one B2 call is one memset and one
// launch, one B5 call one launch. Every sum is taken in the TPU kernels'
// order with round-to-nearest intrinsics (no FMA contraction), so both
// kernels are bit-equal to their plain PyTorch versions (ops/blob_fused.py
// _blob_response_fused_plain, _circularity_fused_plain).
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>
#include <utility>

#if !defined(VP_O) || !defined(VP_R) || !defined(VP_TILE_H) || !defined(VP_TILE_W)
#error "built once per shape: -DVP_O -DVP_R -DVP_TILE_H -DVP_TILE_W [-DVP_DR] (ops/blob_fused.py kernel_defines)"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPer = 4;  // output pixels per thread: tile_h * tile_w <= 1024
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 232448;  // 227 KB, the most a block can opt in to

constexpr int kO = VP_O, kR = VP_R;
#ifdef VP_DR
// B2: circularity ring, disc statistics, score, mask, count
constexpr bool kResponse = true;
constexpr int kDR = VP_DR;
#else
// B5: the circularity on the tile itself
constexpr bool kResponse = false;
constexpr int kDR = 0;
#endif

// disc_spans(dr) of ops/blob_fused.py at compile time: the half width of
// row dy, the s-th row's dy (span widths ascending, rows ascending inside a
// width), and a width's index among the widths above 0 (-1 where no row
// has it)
__host__ __device__ constexpr int disc_hw(int dr, int dy) {
  int hw = 0;
  while ((hw + 1) * (hw + 1) + dy * dy <= dr * dr) ++hw;
  return hw;
}

__host__ __device__ constexpr int span_dy(int dr, int s) {
  for (int hw = 0; hw <= dr; ++hw)
    for (int dy = -dr; dy <= dr; ++dy)
      if (disc_hw(dr, dy) == hw && s-- == 0) return dy;
  return 0;
}

__host__ __device__ constexpr int width_group(int dr, int w) {
  int g = 0;
  for (int v = 1; v <= dr; ++v) {
    bool used = false;
    for (int dy = -dr; dy <= dr; ++dy) used = used || disc_hw(dr, dy) == v;
    if (v == w) return used ? g : -1;
    g += used ? 1 : 0;
  }
  return -1;
}

__host__ __device__ constexpr int n_groups(int dr) {
  int n = 0;
  for (int v = 1; v <= dr; ++v) n += width_group(dr, v) >= 0 ? 1 : 0;
  return n;
}

// The tile's shared-memory arrays, each row-major with its own width. Row
// and column 0 of each sit at the window's corner (ty0 - p, tx0 - p) plus
// the offset noted; ops/blob_fused.py _smem_bytes mirrors the sizes, and
// the entry refuses a call whose bytes differ.
struct Tile {
  int th, tw;    // output pixels
  int ext;       // circularity ring: 1 for B2 (the local-max neighbours), 0 for B5
  int p;         // halo of the staged window
  int dr;        // disc radius (B2)
  int wh, ww;    // staged flat window, 3 planes
  int gh, gw;    // gradient values, offset o
  int aw;        // box row sums: gh rows, offset o
  int bh;        // box sums (top-left corners): aw columns, offset o
  int cw;        // circularity: th + 2 ext rows, at (ty0 - ext, tx0 - ext)
  int sh;        // disc spans: 2 ng planes of sh x tw, at (ty0 - dr, tx0)
  int region;    // floats of the region that holds gradient + row sums, then spans
  int floats;    // all of it
  int tw_shift;  // log2(tw): B2's last stages give each thread a column and
  int per;       // `per` consecutive output rows of it
};

__host__ __device__ constexpr Tile make_tile(int th, int tw, int o, int r, int dr,
                                             int ng, bool response) {
  Tile t{};
  t.th = th;
  t.tw = tw;
  t.ext = response ? 1 : 0;
  t.p = o + r + t.ext;
  t.dr = dr;
  t.wh = th + 2 * t.p;
  t.ww = tw + 2 * t.p;
  t.gh = t.wh - 2 * o;
  t.gw = t.ww - 2 * o;
  t.aw = t.gw - (r - 2);
  t.bh = t.gh - (r - 2);
  t.cw = tw + 2 * t.ext;
  t.sh = th + 2 * dr;
  t.region = t.gh * t.gw + t.gh * t.aw;
  int floats = 3 * t.wh * t.ww;
  if (response) {
    int spans = 2 * ng * t.sh * tw;
    if (spans > t.region) t.region = spans;
    floats += t.region + (th + 2) * t.cw;
  } else {
    floats += t.region;
  }
  t.floats = floats;
  while ((1 << t.tw_shift) < tw) ++t.tw_shift;
  t.per = (th * tw + kThreads - 1) / kThreads;
  return t;
}

// this library's tile
__host__ __device__ constexpr Tile tile() {
  return make_tile(VP_TILE_H, VP_TILE_W, kO, kR, kDR, n_groups(kDR), kResponse);
}

static_assert(kR >= 2, "the (r-1)^2 box needs r >= 2 (response_kernel_fits)");
static_assert(kDR <= kO + kR + 1, "the disc must lie inside the halo (response_kernel_fits)");
// a tile of whole row groups of at most kMaxPer rows per thread, its width
// a power of two that divides the block
static_assert(tile().th >= 1 && (1 << tile().tw_shift) == tile().tw &&
                  tile().tw <= kThreads && tile().per <= kMaxPer &&
                  tile().th % tile().per == 0 &&
                  tile().per * (kThreads / tile().tw) >= tile().th,
              "tile shape");
static_assert(4 * tile().floats <= kSmemMax, "the tile's shared memory exceeds 227 KB");

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// f(integral_constant<int, 0>) ... f(integral_constant<int, N - 1>)
template <class F, int... I>
__device__ __forceinline__ void unroll_seq(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void unroll(F&& f) {
  unroll_seq(f, std::make_integer_sequence<int, N>{});
}

__global__ void __launch_bounds__(kThreads)
    blob_tile_kernel(const float* __restrict__ flat, int H, int W, float inv_rr,
                     float inv_n, const float* __restrict__ th_ptr,
                     float* __restrict__ ms, float* __restrict__ circ_out,
                     float* __restrict__ m0, float* __restrict__ m1,
                     float* __restrict__ m2, int* __restrict__ count) {
  constexpr Tile T = tile();
  constexpr int o = kO, r = kR, p = T.p;  // p: the halo
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int ty0 = blockIdx.y * T.th, tx0 = blockIdx.x * T.tw;
  constexpr int plane = T.wh * T.ww;
  float* F = smem;                // [3][wh][ww] the clamped flat window
  float* G = smem + 3 * plane;    // [gh][gw] gradient, then [bh][aw] box sums
  float* A = G + T.gh * T.gw;     // [gh][aw] box row sums
  float* S = G;                   // [2 ng][sh][tw] disc spans (B2), after circ
  float* C = G + T.region;        // [th + 2][cw] circularity ring (B2)

  // 1. stage the window with asynchronous copies (every load in flight at
  //    once). A row of the interleaved map is contiguous: thread e copies
  //    element e of every window row.
  for (int e = tid; e < 3 * T.ww; e += kThreads) {
    int j = e / 3, c = e - 3 * j;
    const float* src = flat + (size_t)clampi(tx0 - p + j, W - 1) * 3 + c;
    float* dst = F + c * plane + j;
#pragma unroll 4
    for (int k = 0; k < T.wh; ++k) {
      int y = clampi(ty0 - p + k, H - 1);
      __pipeline_memcpy_async(dst + k * T.ww, src + (size_t)y * W * 3,
                              sizeof(float));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2. gradient dot: sum over channels of (c[y, x+o] - c[y, x-o]) *
  //    (c[y+o, x] - c[y-o, x]), channels added in order
  for (int i = tid; i < T.gh * T.gw; i += kThreads) {
    int k = i / T.gw, j = i - k * T.gw;
    const float* f = F + (k + o) * T.ww + (j + o);
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* fc = f + c * plane;
      float gx = __fsub_rn(fc[o], fc[-o]);
      float gy = __fsub_rn(fc[o * T.ww], fc[-o * T.ww]);
      float prod = __fmul_rn(gx, gy);
      acc = c == 0 ? prod : __fadd_rn(acc, prod);
    }
    G[i] = acc;
  }
  __syncthreads();

  // 3. box row sums, left to right
  for (int i = tid; i < T.gh * T.aw; i += kThreads) {
    int k = i / T.aw, j = i - k * T.aw;
    const float* g = G + k * T.gw + j;
    float s = g[0];
#pragma unroll
    for (int b = 1; b < r - 1; ++b) s = __fadd_rn(s, g[b]);
    A[i] = s;
  }
  __syncthreads();

  // 4. box sums, rows top to bottom (over the gradient, no longer needed)
  for (int i = tid; i < T.bh * T.aw; i += kThreads) {
    const float* a = A + i;
    float s = a[0];
#pragma unroll
    for (int b = 1; b < r - 1; ++b) s = __fadd_rn(s, a[b * T.aw]);
    G[i] = s;
  }
  __syncthreads();

  // 5. circularity at (y, x) = (ty0 - ext + k, tx0 - ext + j): the box with
  //    top-left corner (Y, X) sits at box index (Y - ty0 + q, X - tx0 + q)
  constexpr int q = p - o;
  constexpr int ch = T.th + 2 * T.ext;
  for (int i = tid; i < ch * T.cw; i += kThreads) {
    int k = i / T.cw, j = i - k * T.cw;
    int k2 = k - T.ext + q + 2, j2 = j - T.ext + q + 2;
    int k1 = k - T.ext + q - r + 1, j1 = j - T.ext + q - r + 1;
    float pp = G[k2 * T.aw + j2], nn = G[k1 * T.aw + j1];
    float pn = G[k1 * T.aw + j2], np_ = G[k2 * T.aw + j1];
    float c = __fmul_rn(fminf(fminf(pp, nn), fminf(-pn, -np_)), inv_rr);
    if constexpr (kResponse) {
      C[i] = c;
    } else {
      int y = ty0 + k, x = tx0 + j;
      if (y < H && x < W) circ_out[(size_t)y * W + x] = c;
    }
  }
  if constexpr (!kResponse) return;
  __syncthreads();

  // 6. disc statistics, one channel after another. Each thread owns output
  //    column jc and rows k0 .. k0 + per - 1, so that a span's offsets are
  //    worked out once for all of them.
  const int jc = tid & (T.tw - 1), rg = tid >> T.tw_shift;
  const int k0 = rg * T.per;
  constexpr int row_step = kThreads >> T.tw_shift;
  const bool active = k0 < T.th;
  constexpr int splane = T.sh * T.tw;
  constexpr int dr = kDR;  // also the widest span's half width
  float sd_sum[kMaxPer];
  for (int c = 0; c < 3; ++c) {
    const float* fc = F + c * plane;
    float* mean_out = c == 0 ? m0 : (c == 1 ? m1 : m2);
    // the span chains of the value and its square, kept at each width
    for (int k = rg; k < T.sh; k += row_step) {
      const float* f = fc + (k + p - dr) * T.ww + (jc + p);
      float v = f[0];
      float a1 = v, a2 = __fmul_rn(v, v);
      float* out = S + k * T.tw + jc;
      // widen by b on both sides, then keep the chain if group g is b wide
      unroll<dr>([&](auto b_) {
        constexpr int b = decltype(b_)::value + 1;
        constexpr int g = width_group(dr, b);
        float vp = f[b], vm = f[-b];
        a1 = __fadd_rn(__fadd_rn(a1, vp), vm);
        a2 = __fadd_rn(__fadd_rn(a2, __fmul_rn(vp, vp)), __fmul_rn(vm, vm));
        if constexpr (g >= 0) {
          out[(2 * g) * splane] = a1;
          out[(2 * g + 1) * splane] = a2;
        }
      });
    }
    __syncthreads();
    if (active) {
      float s1[kMaxPer], s2[kMaxPer];
      // add span s (row dy, width group g) to each of the thread's pixels
      unroll<2 * dr + 1>([&](auto s_) {
        constexpr int s = decltype(s_)::value;
        constexpr int dy = span_dy(dr, s);
        constexpr int g = width_group(dr, disc_hw(dr, dy));
        const float* src;
        int pitch;
        if constexpr (g < 0) {  // width 0: the staged value itself
          src = fc + (k0 + p + dy) * T.ww + (jc + p);
          pitch = T.ww;
        } else {
          src = S + (2 * g) * splane + (k0 + dr + dy) * T.tw + jc;
          pitch = T.tw;
        }
#pragma unroll
        for (int u = 0; u < T.per; ++u) {
          float v1 = src[u * pitch];
          float v2 = g < 0 ? __fmul_rn(v1, v1) : src[u * pitch + splane];
          s1[u] = s == 0 ? v1 : __fadd_rn(s1[u], v1);
          s2[u] = s == 0 ? v2 : __fadd_rn(s2[u], v2);
        }
      });
#pragma unroll
      for (int u = 0; u < T.per; ++u) {
        float mean = __fmul_rn(s1[u], inv_n);
        float var = fmaxf(
            __fsub_rn(__fmul_rn(s2[u], inv_n), __fmul_rn(mean, mean)), 0.0f);
        float sd = __fsqrt_rn(var);
        sd_sum[u] = c == 0 ? sd : __fadd_rn(sd_sum[u], sd);
        int y = ty0 + k0 + u, x = tx0 + jc;
        if (y < H && x < W) mean_out[(size_t)y * W + x] = mean;
      }
    }
    __syncthreads();  // the next channel's chains overwrite S
  }

  // 7. score, threshold + 4-neighbour local maximum, and the count
  const float th = th_ptr[0];
  int kept = 0;
#pragma unroll
  for (int u = 0; u < T.per; ++u) {  // every thread reaches each barrier
    bool keep = false;
    int k = k0 + u, y = ty0 + k, x = tx0 + jc;
    if (active && y < H && x < W) {
      const float* cc = C + (k + 1) * T.cw + (jc + 1);
      float c0 = cc[0];
      bool lmax = (cc[-1] <= c0) && (cc[1] <= c0) && (cc[-T.cw] <= c0) &&
                  (cc[T.cw] <= c0);
      float score = __fdiv_rn(c0, fmaxf(sd_sum[u], 1e-12f));
      keep = (c0 >= th) && lmax;
      size_t at = (size_t)y * W + x;
      ms[at] = keep ? score : -CUDART_INF_F;
      circ_out[at] = c0;
    }
    kept += __syncthreads_count(keep);
  }
  if (tid == 0 && kept > 0) atomicAdd(count, kept);
}

// refuses a call whose radii, tile or shared memory are not the ones this
// library was built for, and opts in to more than 48 KB where the tile
// needs it
cudaError_t prepare(int o, int r, int dr, int tile_h, int tile_w, int smem) {
  constexpr Tile t = tile();
  if (o != kO || r != kR || dr != kDR || tile_h != t.th || tile_w != t.tw ||
      smem != 4 * t.floats)
    return cudaErrorInvalidValue;
  if (smem > kSmemDefault)
    return cudaFuncSetAttribute((const void*)blob_tile_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  return cudaSuccess;
}

}  // namespace

#ifdef VP_DR
extern "C" int vp_blob_response(const float* flat, int H, int W, int o, int r,
                                int dr, int tile_h, int tile_w, int smem,
                                float inv_rr, float inv_n, const float* th,
                                float* ms, float* circ, float* m0, float* m1,
                                float* m2, int* count, void* stream) {
  cudaError_t e = prepare(o, r, dr, tile_h, tile_w, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if ((long long)H * W > 0) {
    dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h);
    blob_tile_kernel<<<grid, kThreads, smem, s>>>(flat, H, W, inv_rr, inv_n, th,
                                                  ms, circ, m0, m1, m2, count);
  }
  return (int)cudaGetLastError();
}
#else
extern "C" int vp_circularity(const float* flat, int H, int W, int o, int r,
                              int tile_h, int tile_w, int smem, float inv_rr,
                              float* circ, void* stream) {
  cudaError_t e = prepare(o, r, 0, tile_h, tile_w, smem);
  if (e != cudaSuccess) return (int)e;
  if ((long long)H * W > 0) {
    dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h);
    blob_tile_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        flat, H, W, inv_rr, 0.0f, nullptr, nullptr, circ, nullptr, nullptr,
        nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}
#endif
