// Masked top-m selections: per-row top-m of a score map (one block per row,
// B3; or blk rows per block, E5), and the fused query -> blob distance
// test + top-m.
//
// Replaces vision_processor_tpu/ops/topk.py:_row_topk_kernel (row_topk)
// and :_query_topk_kernel (query_select_topk). Both TPU kernels keep a
// block of rows in VMEM and run m iterative (max, lowest index) passes
// (_select_m); the query kernel also forms d^2 in VMEM so the (Q, K) score
// map never reaches HBM.
//
// Bound: latency, not bytes or FLOPs. A row is 770 floats (row stage) or
// 2000 blobs (query stage) and m is 3 to 19, so each block reads a few KB
// once and then spends m block-wide reductions on it. Design: one block per
// row or query; the row (or the row's scores, computed in place from the
// blob table) lives in shared memory; each pass is a strided scan per
// thread, a warp shuffle reduction and one cross-warp step, ordered by
// (value descending, index ascending), after which the winner is masked to
// -inf. Exhausted slots therefore repeat the lowest -inf index, exactly as
// _select_m does. There is no 128-lane cap on m. d^2 is formed with
// round-to-nearest intrinsics so that FMA contraction cannot reorder
// near-ties against the plain PyTorch version.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Block-wide (max value, lowest index) over cur[0, n). Every thread returns
// the same winner.
__device__ void block_argmax(const float* cur, int n, float* s_v, int* s_i,
                             float* out_v, int* out_i) {
  float bv = -CUDART_INF_F;
  int bi = kNoIndex;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float v = cur[k];
    if (better(v, k, bv, bi)) {
      bv = v;
      bi = k;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, bv, off);
    int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  if (lane == 0) {
    s_v[warp] = bv;
    s_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    int nw = (blockDim.x + 31) >> 5;
    bv = lane < nw ? s_v[lane] : -CUDART_INF_F;
    bi = lane < nw ? s_i[lane] : kNoIndex;
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, bv, off);
      int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_v[32] = bv;
      s_i[32] = bi;
    }
  }
  __syncthreads();
  *out_v = s_v[32];
  *out_i = s_i[32];
  __syncthreads();
}

// m passes of block_argmax over cur (shared memory); winners masked to -inf.
__device__ void select_m(float* cur, int n, int m, float* vals, int* idx) {
  __shared__ float s_v[33];
  __shared__ int s_i[33];
  for (int j = 0; j < m; ++j) {
    float v;
    int i;
    block_argmax(cur, n, s_v, s_i, &v, &i);
    if (threadIdx.x == 0) {
      vals[j] = v;
      idx[j] = i;
      if (i < n) cur[i] = -CUDART_INF_F;
    }
    __syncthreads();
  }
}

__global__ void row_topk_kernel(const float* __restrict__ x, int L, int m,
                                float* __restrict__ vals,
                                int* __restrict__ idx) {
  extern __shared__ float cur[];
  const float* xr = x + (size_t)blockIdx.x * L;
  for (int k = threadIdx.x; k < L; k += blockDim.x) cur[k] = xr[k];
  __syncthreads();
  select_m(cur, L, m, vals + (size_t)blockIdx.x * m,
           idx + (size_t)blockIdx.x * m);
}

__global__ void query_topk_kernel(const float* __restrict__ q,
                                  const float* __restrict__ r2,
                                  const float* __restrict__ b,
                                  const float* __restrict__ rank, int K,
                                  int m, int by_rank,
                                  float* __restrict__ vals,
                                  int* __restrict__ idx) {
  extern __shared__ float cur[];
  int qi = blockIdx.x;
  float qx = q[2 * qi];
  float qy = q[2 * qi + 1];
  float rr = r2[qi];
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float dx = __fsub_rn(b[2 * k], qx);
    float dy = __fsub_rn(b[2 * k + 1], qy);
    float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    float rk = rank[k];
    bool ok = (d2 <= rr) && (rk < CUDART_INF_F);
    cur[k] = ok ? (by_rank ? -rk : -d2) : -CUDART_INF_F;
  }
  __syncthreads();
  select_m(cur, K, m, vals + (size_t)qi * m, idx + (size_t)qi * m);
}

// Replaces experiments/rowtopk_blk.py:row_topk_blk (E5): B3's function
// with blk rows per block, one warp per row (min(blk, 32) warps a block,
// each taking every nw-th row of the block's blk). The TPU experiment
// swept the rows per block to amortise the per-block dispatch; here the
// same sweep sets how many rows share one block's launch and residency.
// A warp keeps no copy of its row: pass j scans the row (from L1/L2) for
// the best element strictly after pass j-1's winner in the (value
// descending, index ascending) order, which is the element _select_m's
// masking leaves as the maximum. Once a pass finds only -inf, the row is
// exhausted and every later slot is (-inf, 0), as _select_m's are (all
// lanes -inf, the lowest index wins). Bound: latency, as B3's.
__global__ void row_topk_blk_kernel(const float* __restrict__ x, int R, int L,
                                    int m, int blk, float* __restrict__ vals,
                                    int* __restrict__ idx) {
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int nw = blockDim.x >> 5;
  for (int rr = warp; rr < blk; rr += nw) {
    long long row = (long long)blockIdx.x * blk + rr;
    if (row >= R) return;
    const float* xr = x + row * L;
    float pv = CUDART_INF_F;  // the previous winner; +inf, -1: none yet
    int pi = -1;
    bool exhausted = false;
    for (int j = 0; j < m; ++j) {
      float bv = -CUDART_INF_F;
      int bi = kNoIndex;
      if (!exhausted) {
        for (int k = lane; k < L; k += 32) {
          float v = __ldg(xr + k);
          bool after = v < pv || (v == pv && k > pi);
          if (after && better(v, k, bv, bi)) {
            bv = v;
            bi = k;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          float ov = __shfl_down_sync(0xffffffffu, bv, off);
          int oi = __shfl_down_sync(0xffffffffu, bi, off);
          if (better(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        bv = __shfl_sync(0xffffffffu, bv, 0);
        bi = __shfl_sync(0xffffffffu, bi, 0);
        exhausted = bv == -CUDART_INF_F;
      }
      if (lane == 0) {
        vals[row * m + j] = exhausted ? -CUDART_INF_F : bv;
        idx[row * m + j] = exhausted ? 0 : bi;
      }
      pv = bv;
      pi = bi;
    }
  }
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int vp_row_topk(const float* x, int R, int L, int m, float* vals,
                           int* idx, void* stream) {
  size_t smem = (size_t)L * sizeof(float);
  cudaError_t e = allow_smem((const void*)row_topk_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (R > 0 && m > 0) {
    row_topk_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(x, L, m, vals,
                                                                 idx);
  }
  return (int)cudaGetLastError();
}

extern "C" int vp_query_topk(const float* q, const float* r2, const float* b,
                             const float* rank, int Q, int K, int m,
                             int by_rank, float* vals, int* idx,
                             void* stream) {
  size_t smem = (size_t)K * sizeof(float);
  cudaError_t e = allow_smem((const void*)query_topk_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (Q > 0 && m > 0) {
    query_topk_kernel<<<Q, kThreads, smem, (cudaStream_t)stream>>>(
        q, r2, b, rank, K, m, by_rank, vals, idx);
  }
  return (int)cudaGetLastError();
}

extern "C" int vp_row_topk_blk(const float* x, int R, int L, int m, int blk,
                               float* vals, int* idx, void* stream) {
  if (blk < 1) return (int)cudaErrorInvalidValue;
  if (R > 0 && m > 0) {
    int warps = blk < 32 ? blk : 32;
    long long blocks = ((long long)R + blk - 1) / blk;
    row_topk_blk_kernel<<<(unsigned)blocks, 32 * warps, 0, (cudaStream_t)stream>>>(
        x, R, L, m, blk, vals, idx);
  }
  return (int)cudaGetLastError();
}
