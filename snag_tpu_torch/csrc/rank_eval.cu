// Streaming full-rank evaluation for Hopper, f32: two sweeps over the
// virtual (N, N) squared-L2 distance matrix, neither of which writes it.
//
// Replaces snag_tpu/ops/pallas/rank_eval.py::_run_topk_mean (sweep A,
// kernel _topk_mean_kernel) and ::_run_ranks (sweep B, kernel _rank_kernel).
//
//   sweep A, per query row i: a running top-k (k <= MAX_LONG_K) of
//     s = 1 - max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) over j < n, its mean
//     (the CSLS neighbourhood term), and the raw diagonal distance d_ii;
//   sweep B, per query row i: recompute every distance, optionally apply
//     CSLS as 1 - ((2s - r_row) - r_col), and count
//     #{dist < d_true, j != i} and #{dist == d_true, j < i} (stable-sort
//     rank semantics), plus an optional running top-3 of column ids with
//     ties going to the lowest id.
//
// What bounds it on the H100: fp32 arithmetic, 2 N^2 d flops a sweep
// (2.6e11 at N = 10,500, d = 1,200; 3.9 ms at 67 TFLOP/s).  Both sweeps
// run the pipelined tile product of rank_tile.cuh (96 x 256 block tiles,
// a 4 x 16 register tile a thread, a 4-slot cp.async ring); this file
// holds their epilogues, the per-row state and the merges.  A block owns
// 96 rows and one column split (a run of whole column tiles); each thread
// keeps the state of its 4 rows over its 16 columns of every tile, merges
// it across the row's 16 threads with warp shuffles at the end, and
// writes the block's partial to scratch, one slot per (split, row): no
// atomics.  A second kernel merges the splits' partials in split order.
// The diagonal is written by the one block whose split holds it.  Sweep
// A's list is sized to k (K = 1, 3 or MAX_K).
//
// Sweep A for MAX_K < k <= MAX_LONG_K (CSLS k above 10; the JAX kernel
// keeps its running list in a (rows, 128) scratch, so it takes k up to
// 128) runs both directions from one pass too, with lists of K = 32 or 128
// that would spill from registers.  long_topk_mean_kernel keeps each of its
// 96 rows' lists in shared memory (sorted, descending), with K slots of
// candidates beside it and, in the registers of the row's half-warp, the
// list's last entry (the threshold) and the candidates' count.  A tile's
// similarities above the threshold are appended to the candidates (a scan
// of the 16 lanes' counts places them; no vote a value), and a full buffer
// is merged into the list by one bitonic network over the half-warp
// (merge_candidates), which raises the threshold; so after the first
// tiles a row's tile costs its 16 compares and one vote.  The column
// direction writes each column's 96 similarities of the block's rows, as
// they are, to col_part[(row tile * n + col) * BM + row]: row tiles x n x
// 96 floats (0.44 GB at n = 10,500, 2.5 GB at 25,000), straight from the
// registers, with no tile in shared memory and no barrier.  One merge
// kernel, a warp a row or column (long_topk_merge_kernel), keeps the same
// kind of list over the splits' lists or over a column's row tiles.  The
// mean adds the top k in descending order from 0, as for k <= MAX_K.
//
// Both directions in one launch: the distance of y_j to x_i is the
// distance of x_i to y_j to the bit (fmaf and the norms' sum commute), so
// one pass over x y^T also yields the reverse direction's sweep, its
// per-column state reduced over the block's rows in shared memory and
// written per (row tile, column), then merged in row-tile order.  The
// evaluation does its four sweeps' work in two launches; a caller that
// wants one direction reads the row outputs.

// Rank exactness: both sweeps compute every distance through the same
// tile product and sq_dist, one fmaf per k in ascending k (rank_tile.cuh),
// and sweep B derives d_true in-kernel from sweep A's diagonal with the
// same csls_dist.  The gold column's distance in sweep B is therefore
// bit-identical to d_true, so the gold cannot beat or tie itself.  The
// epilogue uses __f*_rn intrinsics so no contraction reorders it.  A top-k
// of values, integer counts, and a top-3 under the total order (value,
// then lower id) do not depend on the order of the merge, so every output
// is the same bits for any tiling or number of splits.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#include "rank_tile.cuh"

namespace {

using rank::BM;
using rank::BN;
using rank::TM;
using rank::TN;
using rank::TX;
using rank::THREADS;
using rank::SMEM_BYTES;
using rank::tile_col;

constexpr int MAX_K = 10;        // the longest list kept in registers
constexpr int MAX_LONG_K = 128;  // the longest list of long_topk_mean_kernel
constexpr int PART_B = 8;  // ints of one sweep-B partial: 2 counts, 3 + 3 top-3

// max(|x|^2 + |y|^2 - 2 x.y, 0) in the op order of
// snag_tpu/eval/ranking.py::pairwise_distances.
__device__ __forceinline__ float sq_dist(float xn, float yn, float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(xn, yn), __fmul_rn(2.0f, dot)), 0.0f);
}

// CSLS distance 1 - ((2s - r_row) - r_col) with s = 1 - dist, in the exact
// op order of snag_tpu/eval/ranking.py::csls_sim.
__device__ __forceinline__ float csls_dist(float dist, float r_row, float r_col) {
  const float s = __fsub_rn(1.0f, dist);
  return __fsub_rn(1.0f, __fsub_rn(__fsub_rn(__fmul_rn(2.0f, s), r_row), r_col));
}

// Keep v[] as the K largest values seen, descending.
template <int K>
__device__ __forceinline__ void insert_topk(float (&v)[K], float x) {
  if (!(x > v[K - 1])) return;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (x > v[q]) {
      const float t = v[q];
      v[q] = x;
      x = t;
    }
  }
}

// Larger value first; among equal values the lower column id.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void insert_top3(float (&v)[3], int (&id)[3],
                                            float x, int xi) {
  if (!better(x, xi, v[2], id[2])) return;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (better(x, xi, v[q], id[q])) {
      const float t = v[q];
      const int ti = id[q];
      v[q] = x;
      id[q] = xi;
      x = t;
      xi = ti;
    }
  }
}

// Block b of the grid: row tile b / S, split b % S (the splits of a row
// tile run side by side, so they share its x rows in L2).
struct Place {
  int row_tile, row0, split, t0, t1;
};

__device__ __forceinline__ Place place(int n, int splits) {
  Place p;
  p.row_tile = blockIdx.x / splits;
  p.row0 = p.row_tile * BM;
  p.split = blockIdx.x % splits;
  rank::split_tiles(p.split, splits, (n + BN - 1) / BN, p.t0, p.t1);
  return p;
}

// Sweep A over one split: part[(split * n + row) * K + q], the split's
// top-K similarities of each row, descending; diag[row] where the split
// holds column row.  Also the other direction from the same products
// (y_j . x_i is x_i . y_j to the bit, and so is its distance):
// col_part[(row tile * n + col) * K + q], the top-K similarities of each
// column over the block's rows, through a (BM x BN) tile of them in
// shared memory.
template <int K>
__global__ void __launch_bounds__(THREADS, 1)
topk_mean_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                 const float* __restrict__ xn, const float* __restrict__ yn,
                 float* __restrict__ part, float* __restrict__ diag,
                 float* __restrict__ col_part, int n, int d, int ld,
                 int splits) {
  extern __shared__ __align__(16) float smem[];
  float* sims = smem + SMEM_BYTES / 4;  // BM x BN similarities
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const Place p = place(n, splits);

  float xr[TM];
  float top[TM][K];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gr = p.row0 + ty * TM + r;
    xr[r] = gr < n ? xn[gr] : 0.f;
#pragma unroll
    for (int q = 0; q < K; ++q) top[r][q] = -INFINITY;
  }

  rank::sweep_tiles<1>(
      xt, yt, n, d, ld, p.row0, p.t0, p.t1, smem,
      [&](int gc, float (&v)[1]) { v[0] = yn[gc]; },
      [&](const float (&acc)[TM][TN], int col0, const float* cv) {
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int tc = tile_col(tx, c);
      const int gc = col0 + tc;
      if (gc >= n) continue;
      const float yc = cv[tc];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int gr = p.row0 + ty * TM + r;
        const float dist = sq_dist(xr[r], yc, acc[r][c]);
        const float sim = __fsub_rn(1.0f, dist);
        insert_topk<K>(top[r], sim);
        if (gr == gc) diag[gr] = dist;
        sims[(ty * TM + r) * BN + tc] = sim;
      }
    }
    __syncthreads();
    const int gc = col0 + threadIdx.x;
    if (threadIdx.x < BN && gc < n) {
      float ctop[K];
#pragma unroll
      for (int q = 0; q < K; ++q) ctop[q] = -INFINITY;
      const int rows = min(BM, n - p.row0);
      for (int r = 0; r < rows; ++r)
        insert_topk<K>(ctop, sims[r * BN + threadIdx.x]);
      float* out = col_part + ((size_t)p.row_tile * n + gc) * K;
#pragma unroll
      for (int q = 0; q < K; ++q) out[q] = ctop[q];
    }
  });

  // merge the row's TX partial lists (lanes of one half-warp)
#pragma unroll
  for (int off = TX / 2; off >= 1; off >>= 1) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float theirs[K];
#pragma unroll
      for (int q = 0; q < K; ++q)
        theirs[q] = __shfl_xor_sync(0xffffffffu, top[r][q], off);
#pragma unroll
      for (int q = 0; q < K; ++q) insert_topk<K>(top[r], theirs[q]);
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int gr = p.row0 + ty * TM + r;
      if (gr >= n) continue;
      float* out = part + ((size_t)p.split * n + gr) * K;
#pragma unroll
      for (int q = 0; q < K; ++q) out[q] = top[r][q];
    }
  }
}

// Merge sweep A's partials in order: mean[row] = the mean of the row's
// top-k, summed in descending order from 0, over the `parts` partials
// part[(s * n + row) * K + q].
template <int K>
__global__ void topk_merge_kernel(const float* __restrict__ part,
                                  float* __restrict__ mean, int n, int k,
                                  int parts) {
  const int gr = blockIdx.x * blockDim.x + threadIdx.x;
  if (gr >= n) return;
  float top[K];
#pragma unroll
  for (int q = 0; q < K; ++q) top[q] = -INFINITY;
  for (int s = 0; s < parts; ++s) {
    const float* in = part + ((size_t)s * n + gr) * K;
#pragma unroll
    for (int q = 0; q < K; ++q) insert_topk<K>(top, in[q]);
  }
  float sum = 0.f;
#pragma unroll
  for (int q = 0; q < K; ++q)
    if (q < k) sum = __fadd_rn(sum, top[q]);
  mean[gr] = __fdiv_rn(sum, (float)k);
}

// ---- sweep A's long lists

// One compare-exchange step of a bitonic network over the N values that L
// lanes hold, E = N / L a lane: value i = lane * E + e sits in v[e] of lane
// i / E (shuffle width L, all 32 lanes calling).  Value i meets value
// i ^ s; the pair ends ascending where (i & up) == 0, else descending (up =
// 0: every pair descending).  No value is NaN, so fminf and fmaxf select.
template <int E, int L>
__device__ __forceinline__ void bitonic_step(float (&v)[E], int lane, int s,
                                             int up) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    const bool asc = up != 0 && (i & up) == 0;
    if (s < E) {  // the partner in this lane's registers
      if ((e & s) == 0) {
        const float a = v[e], b = v[e ^ s];
        v[e] = asc ? fminf(a, b) : fmaxf(a, b);
        v[e ^ s] = asc ? fmaxf(a, b) : fminf(a, b);
      }
    } else {
      const float o = __shfl_xor_sync(0xffffffffu, v[e], s / E, L);
      const bool low = (i & s) == 0;
      v[e] = low == asc ? fminf(v[e], o) : fmaxf(v[e], o);
    }
  }
}

// Merge the `count` candidates buf[0 .. count) into the top-K list
// (descending) that L lanes keep in shared memory, and return its new last
// entry.  The candidates, padded with -inf, are sorted ascending; then the
// larger of list[i] and buf[i] are the K largest of both, a bitonic
// sequence, which K / 2 .. 1 steps sort descending.  Not inlined: its
// registers stay out of the sweep's allocation (inlined, the sweep at K =
// 128 took 168 registers with 48 B of spills, and 14 % longer on an H100).
template <int K, int L>
__device__ __noinline__ float merge_candidates(float* list,
                                                  const float* buf, int count,
                                                  int lane) {
  constexpr int E = K / L;
  static_assert(E >= 1 && K % L == 0 && (K & (K - 1)) == 0, "K / L a lane");
  __syncwarp();
  float v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    v[e] = i < count ? buf[i] : -INFINITY;
  }
#pragma unroll
  for (int up = 2; up <= K; up *= 2)
#pragma unroll
    for (int s = up / 2; s >= 1; s /= 2) bitonic_step<E, L>(v, lane, s, up);
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = fmaxf(list[lane * E + e], v[e]);
#pragma unroll
  for (int s = K / 2; s >= 1; s /= 2) bitonic_step<E, L>(v, lane, s, 0);
  __syncwarp();  // every lane has read buf and list
#pragma unroll
  for (int e = 0; e < E; ++e) list[lane * E + e] = v[e];
  __syncwarp();
  return __shfl_sync(0xffffffffu, v[E - 1], L - 1, L);
}

// Offer each lane's N values v[] (-inf or NaN for none) to the top-K list
// that L lanes keep (list and buf, K floats each, in shared memory; count
// and thr, the list's last entry, the same in the L lanes).  The values
// above thr are appended to buf in lane order, placed by a scan of the
// lanes' counts; a full buffer is merged, and what no longer beats the new
// thr is dropped.  With L = 16 both halves of a warp call this together,
// each for its own list, and merge together when either is full.
template <int K, int L, int N>
__device__ __forceinline__ void offer(float* list, float* buf, int& count,
                                      float& thr, const float (&v)[N],
                                      int lane) {
  static_assert(N <= 32, "a bit of pend a value");
  unsigned pend = 0;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (v[c] > thr) pend |= 1u << c;
  while (__any_sync(0xffffffffu, pend != 0)) {
    const int mine = __popc(pend);
    int incl = mine;
#pragma unroll
    for (int o = 1; o < L; o *= 2) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o, L);
      if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(0xffffffffu, incl, L - 1, L);
    int at = count + incl - mine;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (pend & (1u << c)) {
        if (at < K) {
          buf[at] = v[c];
          pend &= ~(1u << c);
        }
        ++at;
      }
    }
    count = min(count + total, K);
    if (__any_sync(0xffffffffu, count == K)) {
      thr = merge_candidates<K, L>(list, buf, count, lane);
      count = 0;
#pragma unroll
      for (int c = 0; c < N; ++c)
        if (!(v[c] > thr)) pend &= ~(1u << c);
    }
  }
}

// Sweep A over one split for MAX_K < K, both directions:
// part[(split * n + row) * K + q], the split's top-K similarities of each
// row, descending; diag[row] where the split holds column row; and
// col_part[(row tile * n + col) * BM + r], the similarity of row r of the
// block to column col (-inf past n), for long_topk_merge_kernel to take
// each column's top K from.  Each row's list and candidates live in shared
// memory after the product's (offer).
template <int K>
__global__ void __launch_bounds__(THREADS, 1)
long_topk_mean_kernel(const float* __restrict__ xt,
                      const float* __restrict__ yt,
                      const float* __restrict__ xn,
                      const float* __restrict__ yn, float* __restrict__ part,
                      float* __restrict__ diag, float* __restrict__ col_part,
                      int n, int d, int ld, int splits) {
  extern __shared__ __align__(16) float smem[];
  float* lists = smem + SMEM_BYTES / 4;  // BM x 2K: a row's list, then buf
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const Place p = place(n, splits);

  float xr[TM], thr[TM];
  int count[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gr = p.row0 + ty * TM + r;
    xr[r] = gr < n ? xn[gr] : 0.f;
    thr[r] = -INFINITY;
    count[r] = 0;
#pragma unroll
    for (int j = 0; j < K / 16; ++j)
      lists[(ty * TM + r) * 2 * K + tx + 16 * j] = -INFINITY;
  }
  __syncwarp();

  rank::sweep_tiles<1>(
      xt, yt, n, d, ld, p.row0, p.t0, p.t1, smem,
      [&](int gc, float (&v)[1]) { v[0] = yn[gc]; },
      [&](const float (&acc)[TM][TN], int col0, const float* cv) {
    float sim[TM][TN];
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int tc = tile_col(tx, c);
      const int gc = col0 + tc;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int gr = p.row0 + ty * TM + r;
        const float dist = sq_dist(xr[r], cv[tc], acc[r][c]);
        sim[r][c] = gc < n && gr < n ? __fsub_rn(1.0f, dist) : -INFINITY;
        if (gr == gc && gc < n) diag[gr] = dist;
      }
    }
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gc = col0 + tile_col(tx, c);
      if (gc < n)
        __stcs(reinterpret_cast<float4*>(
                   col_part + ((size_t)p.row_tile * n + gc) * BM + ty * TM),
               make_float4(sim[0][c], sim[1][c], sim[2][c], sim[3][c]));
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float* list = lists + (ty * TM + r) * 2 * K;
      offer<K, 16>(list, list + K, count[r], thr[r], sim[r], tx);
    }
  });

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    float* list = lists + (ty * TM + r) * 2 * K;
    if (__any_sync(0xffffffffu, count[r] > 0))
      merge_candidates<K, 16>(list, list + K, count[r], tx);
    const int gr = p.row0 + ty * TM + r;
    if (gr >= n) continue;
    float* out = part + ((size_t)p.split * n + gr) * K;
#pragma unroll
    for (int j = 0; j < K / 16; ++j) out[tx + 16 * j] = list[tx + 16 * j];
  }
}

constexpr int LONG_MERGE_THREADS = 256;  // 8 warps, a row or column each

// mean[i] = the mean of the top k of the `parts` x CHUNK values
// part[(s * n + i) * CHUNK + q] (-inf or NaN for none), summed in
// descending order from 0: the splits' lists of a row (CHUNK = K) or a
// column's similarities by row tile (CHUNK = BM).  A warp keeps row or
// column i's list (offer), reading the next part while it takes one.
template <int K, int CHUNK>
__global__ void __launch_bounds__(LONG_MERGE_THREADS)
long_topk_merge_kernel(const float* __restrict__ part,
                       float* __restrict__ mean, int n, int k, int parts) {
  constexpr int V = CHUNK / 32;
  static_assert(CHUNK % 32 == 0, "CHUNK / 32 values a lane");
  __shared__ float lists[LONG_MERGE_THREADS / 32][2 * K];
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int i = blockIdx.x * (LONG_MERGE_THREADS / 32) + w;
  if (i >= n) return;  // the whole warp
  float* list = lists[w];
#pragma unroll
  for (int j = 0; j < K / 32; ++j) list[lane + 32 * j] = -INFINITY;
  __syncwarp();
  const float* in = part + (size_t)i * CHUNK + lane;
  const size_t stride = (size_t)n * CHUNK;
  float v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = in[32 * j];
  int count = 0;
  float thr = -INFINITY;
  for (int s = 0; s < parts; ++s) {
    float next[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      next[j] = s + 1 < parts ? in[(s + 1) * stride + 32 * j] : -INFINITY;
    offer<K, 32>(list, list + K, count, thr, v, lane);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = next[j];
  }
  if (count > 0) merge_candidates<K, 32>(list, list + K, count, lane);
  if (lane == 0) {
    float sum = 0.f;
    for (int q = 0; q < k; ++q) sum = __fadd_rn(sum, list[q]);
    mean[i] = __fdiv_rn(sum, (float)k);
  }
}

// Sweep B over one split: part[(split * n + row) * PART_B + ...] = the
// split's two counts, then (with TOP3) its top-3 values (as bits) and ids.
// Also the other direction's counts from the same products:
// column j as the query, CSLS 1 - ((2s - rr[j]) - rl[i]) against its own
// gold distance, col_part[(row tile * n + j) * 2 + ...] over the block's
// rows, added in shared memory with integer atomics (order-free).
template <bool CSLS, bool TOP3>
__global__ void __launch_bounds__(THREADS, 1)
ranks_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
             const float* __restrict__ xn, const float* __restrict__ yn,
             const float* __restrict__ rl, const float* __restrict__ rr,
             const float* __restrict__ diag, int* __restrict__ part,
             int* __restrict__ col_part, int n, int d, int ld, int splits) {
  extern __shared__ __align__(16) float smem[];
  int* col_counts = reinterpret_cast<int*>(smem + SMEM_BYTES / 4);  // 2 x BN
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const Place p = place(n, splits);
  // read first after the sweep's first barrier
  for (int i = threadIdx.x; i < 2 * BN; i += THREADS) col_counts[i] = 0;

  float xr[TM], rrow[TM], dtrue[TM];
  int smaller[TM], tied[TM];
  float tv[TM][3];
  int ti[TM][3];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gr = p.row0 + ty * TM + r;
    const bool ok = gr < n;
    xr[r] = ok ? xn[gr] : 0.f;
    rrow[r] = (CSLS && ok) ? rl[gr] : 0.f;
    dtrue[r] = ok ? (CSLS ? csls_dist(diag[gr], rl[gr], rr[gr]) : diag[gr]) : 0.f;
    smaller[r] = 0;
    tied[r] = 0;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      tv[r][q] = -INFINITY;
      ti[r][q] = INT_MAX;
    }
  }

  // per column: yn, rr, and the column's own gold distance
  rank::sweep_tiles<3>(
      xt, yt, n, d, ld, p.row0, p.t0, p.t1, smem,
      [&](int gc, float (&v)[3]) {
        v[0] = yn[gc];
        if (CSLS) v[1] = rr[gc];
        v[2] = CSLS ? csls_dist(diag[gc], rr[gc], rl[gc]) : diag[gc];
      },
      [&](const float (&acc)[TM][TN], int col0, const float* cv) {
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int tc = tile_col(tx, c);
      const int gc = col0 + tc;
      const bool col_ok = gc < n;
      const float yc = cv[tc];
      const float rcol = CSLS ? cv[BN + tc] : 0.f;
      const float dt_col = cv[2 * BN + tc];
      int c_smaller = 0, c_tied = 0;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int gr = p.row0 + ty * TM + r;
        const float dm = sq_dist(xr[r], yc, acc[r][c]);
        if (col_ok) {
          const float dist = CSLS ? csls_dist(dm, rrow[r], rcol) : dm;
          smaller[r] += (gc != gr && dist < dtrue[r]) ? 1 : 0;
          tied[r] += (gc < gr && dist == dtrue[r]) ? 1 : 0;
          if (TOP3) insert_top3(tv[r], ti[r], -dist, gc);
        }
        const float dc = CSLS ? csls_dist(dm, rcol, rrow[r]) : dm;
        c_smaller += (gr < n && gr != gc && dc < dt_col) ? 1 : 0;
        c_tied += (gr < gc && dc == dt_col) ? 1 : 0;
      }
      // the warp's two row groups share these columns
      c_smaller += __shfl_xor_sync(0xffffffffu, c_smaller, TX);
      c_tied += __shfl_xor_sync(0xffffffffu, c_tied, TX);
      if (ty % 2 == 0 && col_ok) {
        atomicAdd(&col_counts[tc], c_smaller);
        atomicAdd(&col_counts[BN + tc], c_tied);
      }
    }
    __syncthreads();
    if (threadIdx.x < BN) {
      const int gc = col0 + threadIdx.x;
      if (gc < n) {
        int* out = col_part + ((size_t)p.row_tile * n + gc) * 2;
        out[0] = col_counts[threadIdx.x];
        out[1] = col_counts[BN + threadIdx.x];
      }
      // the next tile's atomics come after the next slice's barrier
      col_counts[threadIdx.x] = 0;
      col_counts[BN + threadIdx.x] = 0;
    }
  });

#pragma unroll
  for (int off = TX / 2; off >= 1; off >>= 1) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      smaller[r] += __shfl_xor_sync(0xffffffffu, smaller[r], off);
      tied[r] += __shfl_xor_sync(0xffffffffu, tied[r], off);
      if (TOP3) {
        float ov[3];
        int oi[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          ov[q] = __shfl_xor_sync(0xffffffffu, tv[r][q], off);
          oi[q] = __shfl_xor_sync(0xffffffffu, ti[r][q], off);
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) insert_top3(tv[r], ti[r], ov[q], oi[q]);
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int gr = p.row0 + ty * TM + r;
      if (gr >= n) continue;
      int* out = part + ((size_t)p.split * n + gr) * PART_B;
      out[0] = smaller[r];
      out[1] = tied[r];
      if (TOP3) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          out[2 + q] = __float_as_int(tv[r][q]);
          out[5 + q] = ti[r][q];
        }
      }
    }
  }
}

// Merge sweep B's partials in order: counts (n, 2) and (with TOP3) top3
// (n, 3) over the `parts` partials part[(s * n + row) * STRIDE + ...].
template <bool TOP3, int STRIDE>
__global__ void ranks_merge_kernel(const int* __restrict__ part,
                                   int* __restrict__ counts,
                                   int* __restrict__ top3, int n, int parts) {
  const int gr = blockIdx.x * blockDim.x + threadIdx.x;
  if (gr >= n) return;
  int smaller = 0, tied = 0;
  float tv[3] = {-INFINITY, -INFINITY, -INFINITY};
  int ti[3] = {INT_MAX, INT_MAX, INT_MAX};
  for (int s = 0; s < parts; ++s) {
    const int* in = part + ((size_t)s * n + gr) * STRIDE;
    smaller += in[0];
    tied += in[1];
    if (TOP3) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        insert_top3(tv, ti, __int_as_float(in[2 + q]), in[5 + q]);
    }
  }
  counts[(size_t)gr * 2] = smaller;
  counts[(size_t)gr * 2 + 1] = tied;
  if (TOP3) {
#pragma unroll
    for (int q = 0; q < 3; ++q) top3[(size_t)gr * 3 + q] = ti[q];
  }
}

constexpr int MERGE_THREADS = 256;

int merge_blocks(int n) { return (n + MERGE_THREADS - 1) / MERGE_THREADS; }

int row_tiles(int n) { return (n + BM - 1) / BM; }

// Dynamic shared memory of a block of sweep A / B: the product's, then
// the other direction's room.
constexpr int SMEM_A = SMEM_BYTES + BM * BN * 4;
constexpr int SMEM_B = SMEM_BYTES + 2 * BN * 4;
// ... and of long_topk_mean_kernel<K>: the product's, then each row's list
// and candidates
constexpr int smem_long(int k) { return SMEM_BYTES + BM * 2 * k * 4; }

// The wrapper's contract: xt, yt (d, ld) with 4 | ld, ld >= n, zeros in
// columns n .. ld-1, 16-byte aligned; 1 <= splits <= the column tiles.
bool bad_shape(const float* xt, const float* yt, int n, int d, int ld,
               int splits) {
  return n <= 0 || d <= 0 || ld < n || ld % 4 != 0 || splits < 1 ||
         splits > (n + BN - 1) / BN ||
         reinterpret_cast<uintptr_t>(xt) % 16 != 0 ||
         reinterpret_cast<uintptr_t>(yt) % 16 != 0;
}

// Lets a sweep kernel take `bytes` (> 48 KB) of dynamic shared memory on
// the current device.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Resident blocks per SM of a sweep kernel, or minus a CUDA error.
template <class Kernel>
int occupancy(Kernel kernel, int bytes) {
  cudaError_t err = allow_smem(kernel, bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        THREADS, bytes);
  return err != cudaSuccess ? -static_cast<int>(err) : blocks;
}

// Sweep A's list length for k: 1, 3 or MAX_K in registers, 32 or
// MAX_LONG_K in shared memory.
int list_len(int k) {
  return k == 1 ? 1 : k <= 3 ? 3 : k <= MAX_K ? MAX_K : k <= 32 ? 32
                                                               : MAX_LONG_K;
}

template <int K>
int launch_topk(const float* xt, const float* yt, const float* xn,
                const float* yn, float* part, float* mean, float* diag,
                float* col_part, float* mean_cols, int n, int d, int ld,
                int k, int splits, cudaStream_t s) {
  cudaError_t err = allow_smem(topk_mean_kernel<K>, SMEM_A);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_mean_kernel<K><<<row_tiles(n) * splits, THREADS, SMEM_A, s>>>(
      xt, yt, xn, yn, part, diag, col_part, n, d, ld, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<K><<<merge_blocks(n), MERGE_THREADS, 0, s>>>(
      part, mean, n, k, splits);
  topk_merge_kernel<K><<<merge_blocks(n), MERGE_THREADS, 0, s>>>(
      col_part, mean_cols, n, k, row_tiles(n));
  return static_cast<int>(cudaGetLastError());
}

// Both directions of sweep A at K > MAX_K from one pass: the sweep, then
// the rows' merge over the splits' lists and the columns' over the row
// tiles' similarities.
template <int K>
int launch_topk_long(const float* xt, const float* yt, const float* xn,
                     const float* yn, float* part, float* mean, float* diag,
                     float* col_part, float* mean_cols, int n, int d, int ld,
                     int k, int splits, cudaStream_t s) {
  cudaError_t err = allow_smem(long_topk_mean_kernel<K>, smem_long(K));
  if (err != cudaSuccess) return static_cast<int>(err);
  long_topk_mean_kernel<K><<<row_tiles(n) * splits, THREADS, smem_long(K), s>>>(
      xt, yt, xn, yn, part, diag, col_part, n, d, ld, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + LONG_MERGE_THREADS / 32 - 1) / (LONG_MERGE_THREADS / 32);
  long_topk_merge_kernel<K, K><<<blocks, LONG_MERGE_THREADS, 0, s>>>(
      part, mean, n, k, splits);
  long_topk_merge_kernel<K, BM><<<blocks, LONG_MERGE_THREADS, 0, s>>>(
      col_part, mean_cols, n, k, row_tiles(n));
  return static_cast<int>(cudaGetLastError());
}

template <bool CSLS, bool TOP3>
int launch_ranks(const float* xt, const float* yt, const float* xn,
                 const float* yn, const float* rl, const float* rr,
                 const float* diag, int* part, int* counts, int* top3,
                 int* col_part, int* counts_cols, int n, int d, int ld,
                 int splits, cudaStream_t s) {
  cudaError_t err = allow_smem(ranks_kernel<CSLS, TOP3>, SMEM_B);
  if (err != cudaSuccess) return static_cast<int>(err);
  ranks_kernel<CSLS, TOP3><<<row_tiles(n) * splits, THREADS, SMEM_B, s>>>(
      xt, yt, xn, yn, rl, rr, diag, part, col_part, n, d, ld, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ranks_merge_kernel<TOP3, PART_B><<<merge_blocks(n), MERGE_THREADS, 0, s>>>(
      part, counts, top3, n, splits);
  ranks_merge_kernel<false, 2><<<merge_blocks(n), MERGE_THREADS, 0, s>>>(
      col_part, counts_cols, nullptr, n, row_tiles(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Resident blocks per SM of a sweep's kernel on the current device:
// sweep 0 is A with list length list_len(key = k), sweep 1 is B with
// flags (use_csls, with_top3) = (key & 1, key & 2).  A negative value is
// a CUDA error.
int rank_blocks_per_sm(int sweep, int key) {
  if (sweep == 0) {
    switch (list_len(key)) {
      case 1: return occupancy(topk_mean_kernel<1>, SMEM_A);
      case 3: return occupancy(topk_mean_kernel<3>, SMEM_A);
      case MAX_K: return occupancy(topk_mean_kernel<MAX_K>, SMEM_A);
      case 32: return occupancy(long_topk_mean_kernel<32>, smem_long(32));
      default:
        return occupancy(long_topk_mean_kernel<MAX_LONG_K>,
                         smem_long(MAX_LONG_K));
    }
  }
  switch (key & 3) {
    case 0: return occupancy(ranks_kernel<false, false>, SMEM_B);
    case 1: return occupancy(ranks_kernel<true, false>, SMEM_B);
    case 2: return occupancy(ranks_kernel<false, true>, SMEM_B);
    default: return occupancy(ranks_kernel<true, true>, SMEM_B);
  }
}

// Dynamic shared memory of a block of sweep A (0) at k = key, or of B (1).
int rank_smem_bytes(int sweep, int key) {
  if (sweep != 0) return SMEM_B;
  const int len = list_len(key);
  return len > MAX_K ? smem_long(len) : SMEM_A;
}

// Sweep A in both directions, 1 <= k <= MAX_LONG_K.  xt, yt (d, ld): x
// and y transposed (the wrapper's contract, bad_shape); xn, yn (n,)
// squared row norms; part (splits, n, list_len(k)) and col_part (row
// tiles, n, list_len(k)) scratch, or (row tiles, n, BM) for list_len(k) >
// MAX_K; writes mean (n,) and diag (n,), and mean_cols (n,), the means of
// sweep A on (y, x).
int rank_topk_mean(const float* xt, const float* yt, const float* xn,
                   const float* yn, float* part, float* mean, float* diag,
                   float* col_part, float* mean_cols, int n, int d, int ld,
                   int k, int splits, void* stream) {
  if (bad_shape(xt, yt, n, d, ld, splits) || k < 1 || k > MAX_LONG_K ||
      k > n || !col_part || !mean_cols)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (list_len(k)) {
    case 1: return launch_topk<1>(xt, yt, xn, yn, part, mean, diag, col_part, mean_cols, n, d, ld, k, splits, s);
    case 3: return launch_topk<3>(xt, yt, xn, yn, part, mean, diag, col_part, mean_cols, n, d, ld, k, splits, s);
    case MAX_K: return launch_topk<MAX_K>(xt, yt, xn, yn, part, mean, diag, col_part, mean_cols, n, d, ld, k, splits, s);
    case 32: return launch_topk_long<32>(xt, yt, xn, yn, part, mean, diag, col_part, mean_cols, n, d, ld, k, splits, s);
    default: return launch_topk_long<MAX_LONG_K>(xt, yt, xn, yn, part, mean, diag, col_part, mean_cols, n, d, ld, k, splits, s);
  }
}

// Sweep B in both directions.  rl, rr (n,) CSLS terms (read only when
// use_csls); diag (n,) from sweep A; part (splits, n, PART_B) and col_part
// (row tiles, n, 2) scratch; writes counts (n, 2) and, when with_top3,
// top3 (n, 3), and counts_cols (n, 2), the counts of sweep B on (y, x)
// with rr and rl swapped.
int rank_counts(const float* xt, const float* yt, const float* xn,
                const float* yn, const float* rl, const float* rr,
                const float* diag, int* part, int* counts, int* top3,
                int* col_part, int* counts_cols, int n, int d, int ld,
                int use_csls, int with_top3, int splits, void* stream) {
  if (bad_shape(xt, yt, n, d, ld, splits) || (with_top3 && n < 3) ||
      !col_part || !counts_cols)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_csls) {
    if (with_top3) return launch_ranks<true, true>(xt, yt, xn, yn, rl, rr, diag, part, counts, top3, col_part, counts_cols, n, d, ld, splits, s);
    return launch_ranks<true, false>(xt, yt, xn, yn, rl, rr, diag, part, counts, top3, col_part, counts_cols, n, d, ld, splits, s);
  }
  if (with_top3) return launch_ranks<false, true>(xt, yt, xn, yn, rl, rr, diag, part, counts, top3, col_part, counts_cols, n, d, ld, splits, s);
  return launch_ranks<false, false>(xt, yt, xn, yn, rl, rr, diag, part, counts, top3, col_part, counts_cols, n, d, ld, splits, s);
}

}  // extern "C"
