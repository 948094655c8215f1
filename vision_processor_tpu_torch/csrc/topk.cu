// Masked top-m selections: per-row top-m of a score map (B3; E5 at a swept
// number of rows per block), and the fused query -> blob distance test +
// top-m (B4).
//
// Replaces vision_processor_tpu/ops/topk.py:_row_topk_kernel (row_topk)
// and :_query_topk_kernel (query_select_topk). Both TPU kernels keep a
// block of rows in VMEM and run m iterative (max, lowest index) passes
// (_select_m); the query kernel also forms d^2 in VMEM so the (Q, K) score
// map never reaches HBM.
//
// Bound: latency. B3's (432, 770) map is 1.3 MB, 0.4 us of HBM bytes, and
// B4's ring call 2000 blobs x 128 queries of d^2, 0.05 us of float32
// operations: both less than one launch. What costs is the chain of
// dependent steps inside a row or query. The first design (kept below as
// the route for m above the largest bucket) stages the row in shared
// memory and runs m block-wide (max, lowest index) passes, each a strided
// scan, two shuffle trees and three __syncthreads.
//
// Design: the row or query is read once, into registers. Each lane scans
// its strided elements in index order and keeps a sorted list of its best
// M (value descending; an equal value goes after, since its index is the
// larger), M a compile-time bucket (4, 8, 16, 32) at or above m; -inf is
// never inserted. Then min(m, entries in the lists) rounds of a warp
// (value descending, index ascending) argmax over the lanes' list heads,
// two redux.sync each (the max of an order-preserving key, then the min
// index among the lanes that hold it), the winning lane popping its head.
// The top m of each lane's top M hold the top m of the row, because the
// order is total. B3 gives a row to one warp, 4 rows a block, a lane's
// elements loaded at once, with no shared memory and no barrier. B4 gives
// a query to a block of 8 warps, thread t scanning blobs t, t + 256, ...:
// each warp merges its lanes to its top m in shared memory, then, after
// one barrier, each thread ranks one of those candidates by counting the
// ones that beat it and writes it to that slot, in place of m more serial
// rounds. (One warp per query, and 4 warps, took 1.2-2.5x the 8 warps'
// time at Q = 128, 160 and 512 on an H100: PERF.md section 6.)
//
// Exhausted slots hold -inf and the index _select_m's masking gives them:
// the lowest i with score(i) == -inf once the winners are masked, the
// lower of the first -inf on input and the lowest winner. One warp finds
// it after the selection, scanning from index 0 and stopping at the lowest
// winner (one 32-wide step unless the row starts with NaNs). So every slot
// equals the block kernels', which the large-m route still runs. d^2 is
// formed with round-to-nearest intrinsics so that FMA contraction cannot
// reorder near-ties against the plain PyTorch version.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;  // the block kernels of the large-m route
constexpr int kNoIndex = 0x7fffffff;
constexpr int kWarps = 4;      // rows a block in B3's warp kernel
constexpr int kQueryWarps = 8;  // warps a query in B4's block kernel
constexpr unsigned kFull = 0xffffffffu;

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
    float ov = __shfl_down_sync(kFull, bv, off);
    int oi = __shfl_down_sync(kFull, bi, off);
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
      float ov = __shfl_down_sync(kFull, bv, off);
      int oi = __shfl_down_sync(kFull, bi, off);
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

// The large-m route (m above the largest bucket): one block per row.
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

// One query's score of blob k: -rank or -d^2 within the radius, else -inf.
struct QueryScore {
  const float2* __restrict__ b;
  const float* __restrict__ rank;
  float qx, qy, rr;
  int by_rank;

  __device__ __forceinline__ float operator()(int k) const {
    float2 p = __ldg(b + k);
    float dx = __fsub_rn(p.x, qx);
    float dy = __fsub_rn(p.y, qy);
    float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    float rk = __ldg(rank + k);
    bool ok = (d2 <= rr) && (rk < CUDART_INF_F);
    return ok ? (by_rank ? -rk : -d2) : -CUDART_INF_F;
  }
};

__device__ __forceinline__ QueryScore query_score(const float* q, const float* r2,
                                                  const float* b, const float* rank,
                                                  int by_rank, int qi) {
  return QueryScore{reinterpret_cast<const float2*>(b), rank, __ldg(q + 2 * qi),
                    __ldg(q + 2 * qi + 1), __ldg(r2 + qi), by_rank};
}

// The large-m route: one block per query.
__global__ void query_topk_kernel(const float* __restrict__ q,
                                  const float* __restrict__ r2,
                                  const float* __restrict__ b,
                                  const float* __restrict__ rank, int K,
                                  int m, int by_rank,
                                  float* __restrict__ vals,
                                  int* __restrict__ idx) {
  extern __shared__ float cur[];
  int qi = blockIdx.x;
  QueryScore score = query_score(q, r2, b, rank, by_rank, qi);
  for (int k = threadIdx.x; k < K; k += blockDim.x) cur[k] = score(k);
  __syncthreads();
  select_m(cur, K, m, vals + (size_t)qi * m, idx + (size_t)qi * m);
}

struct RowScore {
  const float* __restrict__ x;

  __device__ __forceinline__ float operator()(int k) const { return __ldg(x + k); }
};

// An unsigned key in the order of the float values (no NaN ever reaches
// it); -0 and +0 share one key, as they tie in better().
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = v == 0.0f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A lane's best M (value descending, index ascending) in registers; every
// loop is unrolled so that the list never leaves them.
template <int M>
struct LaneList {
  float v[M];
  int i[M];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      v[j] = -CUDART_INF_F;
      i[j] = kNoIndex;
    }
  }

  // k is above every index in the list (a lane scans in index order), so
  // x goes after an equal value; -inf and NaN never go in.
  __device__ __forceinline__ void insert(float x, int k) {
    if (!(x > v[M - 1])) return;
#pragma unroll
    for (int j = M - 1; j > 0; --j) {
      bool up = x > v[j - 1];
      bool here = x > v[j];
      v[j] = up ? v[j - 1] : (here ? x : v[j]);
      i[j] = up ? i[j - 1] : (here ? k : i[j]);
    }
    if (x > v[0]) {
      v[0] = x;
      i[0] = k;
    }
  }

  __device__ __forceinline__ int size() const {
    int n = 0;
#pragma unroll
    for (int j = 0; j < M; ++j) n += v[j] > -CUDART_INF_F;
    return n;
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j < M - 1; ++j) {
      v[j] = v[j + 1];
      i[j] = i[j + 1];
    }
    v[M - 1] = -CUDART_INF_F;
    i[M - 1] = kNoIndex;
  }
};

// Each lane scans score(first), score(first + stride), ... below n into
// its list, U loads at a time.
template <int U, class Score, class List>
__device__ __forceinline__ void scan(const Score& score, int n, int first, int stride,
                                     List& list) {
  for (int k0 = first; k0 < n; k0 += U * stride) {
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int k = k0 + u * stride;
      x[u] = k < n ? score(k) : CUDART_NAN_F;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) list.insert(x[u], k0 + u * stride);
  }
}

// The warp's top min(m, entries in its lists): as many rounds of its
// (value desc, index asc) argmax over the lanes' list heads, the winning
// lane popping its head and calling emit(j, v, i). Returns the number of
// winners and lowers min_win to the lowest winning index. Warp-uniform.
template <int M, class Emit>
__device__ __forceinline__ int warp_merge(LaneList<M>& list, int m, int& min_win,
                                          Emit emit) {
  int rounds = min(m, (int)__reduce_add_sync(kFull, (unsigned)list.size()));
  for (int j = 0; j < rounds; ++j) {
    unsigned key = order_key(list.v[0]);
    unsigned top = __reduce_max_sync(kFull, key);
    unsigned win = __reduce_min_sync(kFull, key == top ? (unsigned)list.i[0] : kFull);
    if ((unsigned)list.i[0] == win) {
      emit(j, list.v[0], list.i[0]);
      list.pop();
    }
    min_win = min(min_win, (int)win);
  }
  return rounds;
}

// The index of an exhausted slot: the lowest k < n with score(k) == -inf
// below min_win, else min_win. One warp, 32 indices a step.
template <class Score>
__device__ __forceinline__ int exhausted_index(const Score& score, int n, int min_win) {
  int lane = threadIdx.x & 31;
  int lim = min(n, min_win);
  for (int c = 0; c < lim; c += 32) {
    int k = c + lane;
    unsigned hit = __ballot_sync(kFull, k < lim && score(k) == -CUDART_INF_F);
    if (hit) return c + __ffs(hit) - 1;
  }
  return min_win;
}

// Slots n_win..m-1 of an exhausted selection, by one warp.
template <class Score>
__device__ __forceinline__ void fill_exhausted(const Score& score, int n, int n_win,
                                               int m, int min_win, float* vr, int* ir) {
  if (n_win >= m) return;
  int e = exhausted_index(score, n, min_win);
  for (int j = n_win + (threadIdx.x & 31); j < m; j += 32) {
    vr[j] = -CUDART_INF_F;
    ir[j] = e;
  }
}

// B3: one warp per row, kWarps rows a block; a lane's 24 to 31 elements
// (L = 770 to 962) are loaded at once.
template <int M>
__global__ void row_topk_warps(const float* __restrict__ x, int R, int L, int m,
                               float* __restrict__ vals, int* __restrict__ idx) {
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  RowScore score{x + (size_t)row * L};
  float* vr = vals + (size_t)row * m;
  int* ir = idx + (size_t)row * m;
  LaneList<M> list;
  list.init();
  scan<32>(score, L, threadIdx.x & 31, 32, list);
  int min_win = kNoIndex;
  int n_win = warp_merge(list, m, min_win, [&](int j, float v, int i) {
    vr[j] = v;
    ir[j] = i;
  });
  fill_exhausted(score, L, n_win, m, min_win, vr, ir);
}

// B4: one block of kQueryWarps warps per query. Each warp merges its
// lanes' lists to its top m in shared memory; after one barrier, thread t
// takes the t-th of those candidates (at most kQueryWarps * m <= 256) and
// writes it to the slot of its rank, the number of candidates that beat
// it: the order is total, so the ranks are the slots.
template <int M>
__global__ void query_topk_blocks(const float* __restrict__ q, const float* __restrict__ r2,
                                  const float* __restrict__ b,
                                  const float* __restrict__ rank, int K, int m,
                                  int by_rank, float* __restrict__ vals,
                                  int* __restrict__ idx) {
  __shared__ float s_v[kQueryWarps][M];
  __shared__ int s_i[kQueryWarps][M];
  __shared__ int s_n[kQueryWarps];
  int qi = blockIdx.x;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  QueryScore score = query_score(q, r2, b, rank, by_rank, qi);
  LaneList<M> list;
  list.init();
  scan<8>(score, K, threadIdx.x, kQueryWarps * 32, list);
  int unused = kNoIndex;
  int n = warp_merge(list, m, unused, [&](int j, float v, int i) {
    s_v[warp][j] = v;
    s_i[warp][j] = i;
  });
  if (lane == 0) s_n[warp] = n;
  __syncthreads();
  float* vr = vals + (size_t)qi * m;
  int* ir = idx + (size_t)qi * m;
  int total = 0, cw = 0, cj = 0;
#pragma unroll
  for (int w = 0; w < kQueryWarps; ++w) {
    if (threadIdx.x >= total && threadIdx.x < total + s_n[w]) {
      cw = w;
      cj = threadIdx.x - total;
    }
    total += s_n[w];
  }
  if (threadIdx.x < total) {
    float v = s_v[cw][cj];
    int i = s_i[cw][cj];
    int slot = 0;
#pragma unroll
    for (int w = 0; w < kQueryWarps; ++w)
      for (int j = 0; j < s_n[w]; ++j) slot += better(s_v[w][j], s_i[w][j], v, i);
    if (slot < m) {
      vr[slot] = v;
      ir[slot] = i;
    }
  }
  if (total < m && warp == 0) {
    // every candidate won: the lowest winner is their lowest index
    int min_win = kNoIndex;
#pragma unroll
    for (int w = 0; w < kQueryWarps; ++w)
      for (int j = lane; j < s_n[w]; j += 32) min_win = min(min_win, s_i[w][j]);
    min_win = __reduce_min_sync(kFull, min_win);
    fill_exhausted(score, K, total, m, min_win, vr, ir);
  }
}

// The list bucket of m: the least of 4, 8, 16, 32 at or above it; 0 above
// 32 (the large-m route).
int bucket(int m) {
  return m <= 4 ? 4 : m <= 8 ? 8 : m <= 16 ? 16 : m <= 32 ? 32 : 0;
}

template <int M>
void launch_rows(const float* x, int R, int L, int m, float* vals, int* idx,
                 cudaStream_t s) {
  row_topk_warps<M><<<(R + kWarps - 1) / kWarps, 32 * kWarps, 0, s>>>(x, R, L, m, vals,
                                                                         idx);
}

template <int M>
void launch_queries(const float* q, const float* r2, const float* b, const float* rank,
                    int Q, int K, int m, int by_rank, float* vals, int* idx,
                    cudaStream_t s) {
  query_topk_blocks<M><<<Q, 32 * kQueryWarps, 0, s>>>(q, r2, b, rank, K, m, by_rank,
                                                      vals, idx);
}

// Replaces experiments/rowtopk_blk.py:row_topk_blk (E5): B3's function
// with blk rows a block. The TPU experiment swept the rows per block to
// amortise the per-block dispatch; here the same sweep sets how many rows
// share one block's launch and residency, so at blk = 64 the (540, 962)
// map runs on 9 blocks, 9 of the card's 132 SMs, each of which must read
// its 64 rows (246 KB) through its own load path: on an H100 such a block
// takes as long when no entry is above -inf as on the contract's map, so
// those reads, not the selection, bound it. B3's register lists would add
// O(M) instructions for every element a lane inserts and about 200
// registers a thread at M = 32 (9 warps a block).
// Design: a block of nw warps (ops/topk.py blk_warps: one a row, up to 32)
// takes rows blockIdx.x * blk .. + blk - 1, warp w the rows w, w + nw, ...
// of them, asking L1 for its next row before it ranks this one. A warp
// reads its row once, a lane's kBlkLoads elements at a time, and compacts
// the entries above -inf into a 32-slot buffer in shared memory by
// ballots (a ballot that finds none costs three instructions);
// if the row has at most 32 such entries, as the contract's rows (about
// 1500 valid entries a map) have, lane j ranks candidate j by counting the
// candidates that beat it in the (value descending, index ascending)
// order and writes it to the slot of its rank: the order is total, so the
// ranks are the slots. A denser row takes m passes instead, each the best
// element strictly after the last winner in that order (a lane's elements
// from L1). The exhausted slots are B3's (fill_exhausted). Any m takes the
// same kernel, which holds a thread to 64 registers, so 32 warps fit.
constexpr int kBlkMaxWarps = 32;
constexpr int kBlkLoads = 16;  // a lane's loads a round: 512 elements a round

// Asks L1 for the lines of a row that the warp takes next, one line a lane
// (the last lane's holds the row's last element).
__device__ __forceinline__ void prefetch_row(const float* xr, int n) {
  for (int e = (threadIdx.x & 31) * 32; e < n + 31; e += 32 * 32)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(xr + min(e, n - 1)));
}

// Compacts score(0 .. n-1)'s entries above -inf (never NaN) into the first
// 32 slots of s_v / s_i, in index order; returns how many there are.
template <class Score>
__device__ __forceinline__ int compact(const Score& score, int n, float* s_v, int* s_i) {
  int lane = threadIdx.x & 31;
  unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int k0 = 0; k0 < n; k0 += 32 * kBlkLoads) {
    float v[kBlkLoads];
#pragma unroll
    for (int u = 0; u < kBlkLoads; ++u) {
      int k = k0 + 32 * u + lane;
      v[u] = k < n ? score(k) : -CUDART_INF_F;
    }
#pragma unroll
    for (int u = 0; u < kBlkLoads; ++u) {
      bool ok = v[u] > -CUDART_INF_F;
      unsigned bal = __ballot_sync(kFull, ok);
      if (bal) {
        int slot = count + __popc(bal & below);
        if (ok && slot < 32) {
          s_v[slot] = v[u];
          s_i[slot] = k0 + 32 * u + lane;
        }
        count += __popc(bal);
      }
    }
  }
  __syncwarp();
  return count;
}

// The top min(count, m) of count <= 32 candidates, lane j ranking the j-th.
// Returns the number of winners; min_win is the lowest candidate index.
__device__ __forceinline__ int rank_candidates(const float* s_v, const int* s_i, int count,
                                               int m, float* vr, int* ir, int& min_win) {
  int lane = threadIdx.x & 31;
  float v = lane < count ? s_v[lane] : -CUDART_INF_F;
  int i = lane < count ? s_i[lane] : kNoIndex;
  int rank = 0;
  for (int c = 0; c < count; ++c) rank += better(s_v[c], s_i[c], v, i);
  if (lane < count && rank < m) {
    vr[rank] = v;
    ir[rank] = i;
  }
  min_win = (int)__reduce_min_sync(kFull, (unsigned)i);
  return min(count, m);
}

// A dense row: m passes, each the warp's best element strictly after the
// last winner. Returns the number of winners; lowers min_win to the lowest.
template <class Score>
__device__ __forceinline__ int rescan(const Score& score, int n, int m, float* vr, int* ir,
                                      int& min_win) {
  int lane = threadIdx.x & 31;
  float pv = CUDART_INF_F;  // the last winner; (+inf, -1): none yet
  int pi = -1;
  for (int j = 0; j < m; ++j) {
    float bv = -CUDART_INF_F;
    int bi = kNoIndex;
    for (int k = lane; k < n; k += 32) {
      float v = score(k);
      bool after = v < pv || (v == pv && k > pi);
      if (after && better(v, k, bv, bi)) {
        bv = v;
        bi = k;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      float ov = __shfl_xor_sync(kFull, bv, d);
      int oi = __shfl_xor_sync(kFull, bi, d);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (!(bv > -CUDART_INF_F)) return j;  // warp-uniform: every lane holds the best
    if (lane == 0) {
      vr[j] = bv;
      ir[j] = bi;
    }
    min_win = min(min_win, bi);
    pv = bv;
    pi = bi;
  }
  return m;
}

__global__ void __launch_bounds__(32 * kBlkMaxWarps)
    row_topk_blk_warps(const float* __restrict__ x, int R, int L, int m, int blk,
                       float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ float s_v[kBlkMaxWarps][32];
  __shared__ int s_i[kBlkMaxWarps][32];
  int warp = threadIdx.x >> 5;
  int nw = blockDim.x >> 5;
  int first = blockIdx.x * blk;
  int end = min(R, first + blk);
  for (int row = first + warp; row < end; row += nw) {
    if (row + nw < end) prefetch_row(x + (size_t)(row + nw) * L, L);
    RowScore score{x + (size_t)row * L};
    float* vr = vals + (size_t)row * m;
    int* ir = idx + (size_t)row * m;
    int count = compact(score, L, s_v[warp], s_i[warp]);
    int min_win = kNoIndex;
    int n_win = count <= 32 ? rank_candidates(s_v[warp], s_i[warp], count, m, vr, ir, min_win)
                            : rescan(score, L, m, vr, ir, min_win);
    fill_exhausted(score, L, n_win, m, min_win, vr, ir);
    __syncwarp();  // the buffer is the warp's next row's
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
  cudaStream_t s = (cudaStream_t)stream;
  if (R <= 0 || m <= 0) return (int)cudaGetLastError();
  switch (bucket(m)) {
    case 4: launch_rows<4>(x, R, L, m, vals, idx, s); break;
    case 8: launch_rows<8>(x, R, L, m, vals, idx, s); break;
    case 16: launch_rows<16>(x, R, L, m, vals, idx, s); break;
    case 32: launch_rows<32>(x, R, L, m, vals, idx, s); break;
    default: {
      size_t smem = (size_t)L * sizeof(float);
      cudaError_t e = allow_smem((const void*)row_topk_kernel, smem);
      if (e != cudaSuccess) return (int)e;
      row_topk_kernel<<<R, kThreads, smem, s>>>(x, L, m, vals, idx);
    }
  }
  return (int)cudaGetLastError();
}

// b must be 8-byte aligned: each blob is read as one float2.
extern "C" int vp_query_topk(const float* q, const float* r2, const float* b,
                             const float* rank, int Q, int K, int m,
                             int by_rank, float* vals, int* idx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (((size_t)b & 7u) != 0) return (int)cudaErrorInvalidValue;
  if (Q <= 0 || m <= 0) return (int)cudaGetLastError();
  switch (bucket(m)) {
    case 4: launch_queries<4>(q, r2, b, rank, Q, K, m, by_rank, vals, idx, s); break;
    case 8: launch_queries<8>(q, r2, b, rank, Q, K, m, by_rank, vals, idx, s); break;
    case 16: launch_queries<16>(q, r2, b, rank, Q, K, m, by_rank, vals, idx, s); break;
    case 32: launch_queries<32>(q, r2, b, rank, Q, K, m, by_rank, vals, idx, s); break;
    default: {
      size_t smem = (size_t)K * sizeof(float);
      cudaError_t e = allow_smem((const void*)query_topk_kernel, smem);
      if (e != cudaSuccess) return (int)e;
      query_topk_kernel<<<Q, kThreads, smem, s>>>(q, r2, b, rank, K, m, by_rank, vals,
                                                   idx);
    }
  }
  return (int)cudaGetLastError();
}

// E5 at blk rows a block over warps a block (ops/topk.py blk_warps: 1 to
// min(blk, 32)), any m; a launch the SM cannot hold returns its error.
extern "C" int vp_row_topk_blk(const float* x, int R, int L, int m, int blk, int warps,
                               float* vals, int* idx, void* stream) {
  if (blk < 1 || warps < 1 || warps > blk || warps > kBlkMaxWarps)
    return (int)cudaErrorInvalidValue;
  if (R > 0 && m > 0) {
    int blocks = R / blk + (R % blk != 0);
    row_topk_blk_warps<<<blocks, 32 * warps, 0, (cudaStream_t)stream>>>(
        x, R, L, m, blk, vals, idx);
  }
  return (int)cudaGetLastError();
}

// E5's kernel: out[0] its registers a thread, out[1] the most threads a
// block it can launch with, as the runtime reports them.
extern "C" int vp_row_topk_blk_attrs(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, row_topk_blk_warps);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = attr.maxThreadsPerBlock;
  return 0;
}
