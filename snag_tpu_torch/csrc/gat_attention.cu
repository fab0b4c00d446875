// Sparse-GAT layer forward (diag mode) for Hopper, f32 or bf16 x.
//
// Replaces snag_tpu/ops/pallas/gat_attention.py::fused_gat_attention.
// For every destination row i, head h and edge i <- j in row_ptr[i]..row_ptr[i+1]:
//     e_h        = exp(-leakyrelu_0.2(s_src[i,h] + s_dst[j,h]))
//     agg[i,h,:] = sum_j e_h * x[j,:]
//     rowsum[i,h] = sum_j e_h
//
// What bounds it on the H100: the gathered bytes.  Each edge reads one
// x row, so a layer moves E*C*4 bytes (E = 329,862 edges, C = 300 at the
// slice geometry: 0.40 GB) against ~2*H*C flops per edge; the N*C*4-byte x
// table (N = 30,000: 36 MB) fits in the 50 MB L2, so most of those reads
// hit L2.
//
// What the design does about it: the TPU kernel materialises the
// (E, c_pad) gather [x | s_dst | 1][col] and reduces it with one-hot MXU
// dots.  Here nothing is materialised, and a row costs no block barrier, no
// shared memory and no serial thread: one warp owns one destination row.
// The column ids and attention weights of up to 32 of its edges are
// computed one edge a lane, while the first x rows are in flight, and
// broadcast by shuffle; lane l owns the float4 slices l, l + 32, ... (G of
// them, a template parameter) of H register accumulators, and loads the x
// row of one edge at a time, so that registers stay few and an SM holds
// more warps.  x is read once per edge for all heads; agg is written
// once and streamed past L2.  There are no
// atomics and the edge order within a row is fixed, so the result is
// deterministic: agg is an fmaf chain over the edges in order from 0 and
// rowsum a sum in edge order from 0, the bits of the block-per-row kernel
// this one replaced.  A row of any length is walked by its one warp, 32 edges
// at a time.
//
// gat_attention_fwd_bf16: the same kernel on bf16 x (T = __nv_bfloat16),
// with the rounding points of the Pallas kernel on the JAX package's bf16
// path: s_src[i] and s_dst[j] are rounded to bf16 (gat_attention.py:135,
// gat_attn_primitive.py:85), and so is e, before both the aggregate and
// the rowsum (gat_attention.py:74); the sums run in fp32 (a bf16 e times a
// bf16 x is exact there) and agg and rowsum are fp32.  A lane's slice is 4
// bf16, one 8-byte load (C = 300 is not a multiple of 8), so the gathered
// bytes halve.
//
// Any head count and width (gat_fwd_wide_tile, f32 and bf16): the kernels
// above hold MAX_HEADS heads and MAX_GROUPS slices a lane in registers,
// which covers H <= 4 and C <= 1,280 (C % 4 == 0) or 320, the main path's
// shapes.  Past them gat_fwd_wide_tile walks each row's edges once for
// every head (up to WIDE_HEADS; more heads take groups on grid.y, each
// walking the row again), so each x[j] reaches the SM once an edge.  A row
// wider than one warp's groups takes a group of up to WIDE_WARPS warps
// that split its columns (warp w the slices from 32 GW w on, GW from
// wide_big: 96 accumulator floats a lane at 8 heads, 48 at fewer); a
// narrower row takes one warp, WIDE_ROWS row groups a block; columns past
// WIDE_WARPS warps' take more blocks on grid.z.  A block takes a tile of
// consecutive rows, WIDE_RUN a row group, whose edges are contiguous in
// CSR: all its threads first stage a chunk of them (column ids and every
// head's weight, WIDE_STAGE edges a thread, their loads in flight
// together) into shared memory; then each group streams its rows' edges
// with D x rows in flight, copied by cp.async into each warp's ring in
// shared memory (wide_depth: as many slots as WIDE_RING bytes hold), and
// writes a row's sums where the stream passes its end.  So neither a row's
// weights nor its first x rows wait on a chain of loads of its own, and
// rows in flight cost no registers beside the accumulators.  f32 rows of
// even C not a multiple of 4 take 8-byte slices (VEC = 2), bf16 rows two
// bf16 a lane.  Bits: agg is the fmaf chain over the row's edges in order
// from 0, rowsum their sum in edge order from 0 (warp 0 of a group, in the
// first column block, a lane a head), e from the same s_src + s_dst, so
// every element has the kernels' above.  The body this replaced (PERF.md
// section 6) ran a block per (row block, column chunk of 160 slices, head
// group of 4), each walking the row's edges with one x row in flight; it
// spent 0.54-0.79 of its cycles waiting for x rows; a walk per row with
// its own staging spent 0.35-0.52 on the staging's chain of loads
// (scripts/torch_gat_fwd_phases.py).
// tests/test_torch_gat_fwd_wide_schedule.py emulates the walk's sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_HEADS = 4;
constexpr int MAX_GROUPS = 10;   // c / vec <= 320
constexpr int WARPS = 4;         // rows a block
constexpr unsigned FULL = 0xffffffffu;
// the wide path (ops/cuda/gat_attention.py mirrors these in wide_plan)
constexpr int WIDE_HEADS = 8;    // heads a wide warp holds, at most
constexpr int WIDE_WARPS = 8;    // warps of a row, at most
constexpr int WIDE_ROWS = 4;     // row groups a block when a row takes one warp
constexpr int WIDE_RUN = 4;      // rows a row group walks in turn
constexpr int WIDE_STAGE = 2;    // edges a thread stages a chunk
constexpr int WIDE_RING = 9216;  // bytes of a wide warp's ring of x rows
constexpr int WIDE_DEPTH = 8;    // x rows a wide warp keeps in flight, at most

__device__ __forceinline__ float edge_weight(float score) {
  const float lr = score > 0.f ? score : 0.2f * score;
  return expf(-lr);
}

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static void fma(float& acc, float e, float v) { acc = fmaf(e, v, acc); }
};
template <> struct Vec<2> {
  using T = float2;
  __device__ static void fma(float2& acc, float e, float2 v) {
    acc.x = fmaf(e, v.x, acc.x);
    acc.y = fmaf(e, v.y, acc.y);
  }
};
template <> struct Vec<4> {
  using T = float4;
  __device__ static void fma(float4& acc, float e, float4 v) {
    acc.x = fmaf(e, v.x, acc.x);
    acc.y = fmaf(e, v.y, acc.y);
    acc.z = fmaf(e, v.z, acc.z);
    acc.w = fmaf(e, v.w, acc.w);
  }
};

// x rounded to bf16 and back: the JAX package's astype(bfloat16)
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Slice s of a row of x as fp32: VEC floats, or VEC bf16 (their bits
// shifted into fp32's high half, which is exact).
template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T load_slice(const float* row,
                                                           int s) {
  return reinterpret_cast<const typename Vec<VEC>::T*>(row)[s];
}

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T load_slice(
    const __nv_bfloat16* row, int s) {
  if constexpr (VEC == 4) {
    const uint2 u = reinterpret_cast<const uint2*>(row)[s];
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  } else {
    return __bfloat162float(row[s]);
  }
}

// The body of both kernels; X is x's type.
template <typename X, int H, int VEC, int G>
__device__ __forceinline__ void gat_attention_rows(
    const X* __restrict__ x, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, const int* __restrict__ row_ptr,
    const int* __restrict__ col, float* __restrict__ agg,
    float* __restrict__ rowsum, int n, int c) {
  constexpr bool BF16 = !std::is_same<X, float>::value;
  using V = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;  // a tail warp; nothing below waits on a barrier
  const int nv = c / VEC;

  float src[H], rs[H];
  V acc[H][G];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    src[h] = s_src[(size_t)i * H + h];
    if constexpr (BF16) src[h] = round_bf16(src[h]);
    rs[h] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) acc[h][g] = V{};
  }
  const int beg = row_ptr[i];
  const int end = row_ptr[i + 1];

  for (int base = beg; base < end; base += 32) {
    const int m = min(32, end - base);
    // edge base + lane: its column and weights
    int j_l = 0;
    float e_l[H];
#pragma unroll
    for (int h = 0; h < H; ++h) e_l[h] = 0.f;
    if (lane < m) {
      j_l = col[base + lane];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        e_l[h] = s_dst[(size_t)j_l * H + h];
        if constexpr (BF16) e_l[h] = round_bf16(e_l[h]);
      }
    }

    for (int q = 0; q < m; ++q) {  // the same q for every lane
      const int j = __shfl_sync(FULL, j_l, q);
      const X* row = x + (size_t)j * c;
      V v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = lane + 32 * g;
        v[g] = s < nv ? load_slice<VEC>(row, s) : V{};
      }
      if (q == 0) {  // with the first x row in flight: the edge weights
#pragma unroll
        for (int h = 0; h < H; ++h) {
          e_l[h] = edge_weight(src[h] + e_l[h]);
          if constexpr (BF16) e_l[h] = round_bf16(e_l[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float e = __shfl_sync(FULL, e_l[h], q);
#pragma unroll
        for (int g = 0; g < G; ++g) Vec<VEC>::fma(acc[h][g], e, v[g]);
        rs[h] += e;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int s = lane + 32 * g;
      if (s < nv) __stcs(reinterpret_cast<V*>(agg + ((size_t)i * H + h) * c) + s, acc[h][g]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) rowsum[(size_t)i * H + h] = rs[h];
  }
}

template <int H, int VEC, int G>
__global__ void __launch_bounds__(32 * WARPS)
gat_attention_fwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ s_src,
                         const float* __restrict__ s_dst,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ col,
                         float* __restrict__ agg,
                         float* __restrict__ rowsum, int n, int c) {
  gat_attention_rows<float, H, VEC, G>(x, s_src, s_dst, row_ptr, col, agg,
                                       rowsum, n, c);
}

// named apart so that a profile tells the two apart
template <int H, int VEC, int G>
__global__ void __launch_bounds__(32 * WARPS)
gat_attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                              const float* __restrict__ s_src,
                              const float* __restrict__ s_dst,
                              const int* __restrict__ row_ptr,
                              const int* __restrict__ col,
                              float* __restrict__ agg,
                              float* __restrict__ rowsum, int n, int c) {
  gat_attention_rows<__nv_bfloat16, H, VEC, G>(x, s_src, s_dst, row_ptr, col,
                                               agg, rowsum, n, c);
}

// ---- the wide path: any head count and width

// cp.async of N bytes from global src to shared dst, and its groups.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src),
               "n"(N)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A wide warp's slice s of an x row as it lands in the warp's ring in
// shared memory, and widened to fp32 where an edge's fmaf reads it: f32
// VEC floats; bf16 VEC values in 32-bit words (VEC = 1: one in a word's
// low half), whose bits shifted into fp32's high half are exact.  A slice
// of 4, 8 or 16 bytes is copied by cp.async, so that rows are in flight
// without registers; a single bf16 (odd C) is loaded and stored.
template <typename X, int VEC> struct Raw {
  using T = typename Vec<VEC>::T;
  __device__ static void copy(T* dst, const float* row, int s) {
    cp_async<sizeof(T)>(dst, reinterpret_cast<const T*>(row) + s);
  }
  __device__ static T widen(T v) { return v; }
};
template <int VEC> struct Raw<__nv_bfloat16, VEC> {
  using T = typename std::conditional<VEC == 4, uint2, uint32_t>::type;
  __device__ static void copy(T* dst, const __nv_bfloat16* row, int s) {
    if constexpr (VEC == 1)
      *dst = reinterpret_cast<const unsigned short*>(row)[s];
    else
      cp_async<sizeof(T)>(dst, reinterpret_cast<const T*>(row) + s);
  }
  __device__ static float lo(uint32_t w) { return __uint_as_float(w << 16); }
  __device__ static float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
  __device__ static typename Vec<VEC>::T widen(T u) {
    if constexpr (VEC == 4) return make_float4(lo(u.x), hi(u.x), lo(u.y), hi(u.y));
    else if constexpr (VEC == 2) return make_float2(lo(u), hi(u));
    else return lo(u);
  }
};

// An edge's weights of the block's heads to and from shared memory (HB
// floats, 8- or 16-byte aligned).
template <int HB>
__device__ __forceinline__ void load_weights(const float* p, float (&e)[HB]) {
  if constexpr (HB == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    e[0] = a.x;
    e[1] = a.y;
  } else {
#pragma unroll
    for (int k = 0; k < HB / 4; ++k) {
      const float4 a = reinterpret_cast<const float4*>(p)[k];
      e[4 * k] = a.x;
      e[4 * k + 1] = a.y;
      e[4 * k + 2] = a.z;
      e[4 * k + 3] = a.w;
    }
  }
}

template <int HB>
__device__ __forceinline__ void store_weights(float* p, const float (&e)[HB]) {
  if constexpr (HB == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(e[0], e[1]);
  } else {
#pragma unroll
    for (int k = 0; k < HB / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(e[4 * k], e[4 * k + 1], e[4 * k + 2], e[4 * k + 3]);
  }
}

// The most groups a lane of a wide warp of hb heads holds at slice width
// vec: 96 accumulator floats at WIDE_HEADS heads, 48 at fewer, at most 12
// groups.
__host__ __device__ constexpr int wide_big(int hb, int vec) {
  return (hb == WIDE_HEADS ? 96 : 48) / (hb * vec) < 12
             ? (hb == WIDE_HEADS ? 96 : 48) / (hb * vec)
             : 12;
}

// Slots of a wide warp's ring of x rows, each gw slices of `bytes` a
// lane: as many as WIDE_RING bytes hold, 2 to WIDE_DEPTH.
__host__ __device__ constexpr int wide_depth(int gw, int bytes) {
  return WIDE_RING / (32 * gw * bytes) < 2 ? 2
         : WIDE_RING / (32 * gw * bytes) > WIDE_DEPTH
             ? WIDE_DEPTH
             : WIDE_RING / (32 * gw * bytes);
}

// A row's barrier: its warp's, or its block's when the row has several.
__device__ __forceinline__ void wide_sync(int warps) {
  if (warps == 1) __syncwarp();
  else __syncthreads();
}

// Dynamic shared memory of a wide block of `threads` threads (wide_plan
// mirrors it): the warps' rings, then a chunk's weights (WIDE_STAGE
// edges a thread, HB heads each) and column ids, then the tile's row
// offsets.
__host__ __device__ constexpr size_t wide_smem(int hb, int gw, int bytes,
                                               int threads, int tile) {
  return (size_t)(threads / 32) * wide_depth(gw, bytes) * 32 * gw * bytes +
         (size_t)WIDE_STAGE * threads * 4 * (hb + 1) + 4 * ((size_t)tile + 1);
}

// The wide body (file comment).  A block takes a tile of `rows` x WIDE_RUN
// rows from blockIdx.x: its `rows` row groups of `warps` warps each walk
// WIDE_RUN consecutive rows in turn (warp w of a group on the rows' slices
// from s_lo = (blockIdx.z warps + w) 32 GW, its lane l on slices s_lo +
// 32 g + l), heads h0 = blockIdx.y hn .. of h (hl <= hn <= HB of them
// live).  The tile's edges, contiguous in CSR, go in chunks of WIDE_STAGE
// edges a thread: every thread stages its edges' column ids and every
// head's weights into shared memory; then each warp streams its rows'
// edges of the chunk, edge q + D - 1's x slices copied by cp.async into
// the warp's ring before edge q's slot feeds the fmaf of every head, and
// a row's sums written when the stream passes its last edge.  Warp 0 of
// a group, in pass 0, adds rowsum in edge order.
template <typename X, int HB, int VEC, int GW>
__device__ __forceinline__ void gat_fwd_wide_tile(
    const X* __restrict__ x, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, const int* __restrict__ row_ptr,
    const int* __restrict__ col, float* __restrict__ agg,
    float* __restrict__ rowsum, int n, int c, int h, int hn, int warps) {
  constexpr bool BF16 = !std::is_same<X, float>::value;
  using R = Raw<X, VEC>;
  using P = typename R::T;
  using V = typename Vec<VEC>::T;
  constexpr int D = wide_depth(GW, sizeof(P));
  extern __shared__ __align__(16) unsigned char wide_smem_buf[];
  const int threads = blockDim.x;
  const int nw = threads >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = nw / warps;                  // row groups
  const int rg = warp / warps;                  // this warp's row group
  const int w = warp % warps;                   // its warp in the group
  const int t0 = blockIdx.x * rows * WIDE_RUN;  // the tile's first row
  const int tn = min(rows * WIDE_RUN, n - t0);  // the tile's rows
  const int eb = WIDE_STAGE * threads;          // edges a chunk
  P* ring = reinterpret_cast<P*>(wide_smem_buf) + (size_t)warp * D * GW * 32;
  float* es = reinterpret_cast<float*>(wide_smem_buf +
                                       (size_t)nw * D * GW * 32 * sizeof(P));
  int* ks = reinterpret_cast<int*>(es + (size_t)eb * HB);
  int* rp = ks + eb;
  const int h0 = blockIdx.y * hn;
  const int hl = min(hn, h - h0);               // live heads
  const int s_lo = (blockIdx.z * warps + w) * 32 * GW;
  const int nv = c / VEC - s_lo;                // this warp's slices from s_lo
  const bool sums = blockIdx.z == 0 && w == 0;  // rowsum's warps

  for (int t = threadIdx.x; t <= tn; t += threads) rp[t] = row_ptr[t0 + t];
  __syncthreads();
  // this group's rows [ra, rb) of the tile, r the one being summed
  const int ra = min(tn, rg * WIDE_RUN);
  const int rb = min(tn, ra + WIDE_RUN);
  int r = ra;
  V acc[HB][GW];
#pragma unroll
  for (int hh = 0; hh < HB; ++hh)
#pragma unroll
    for (int g = 0; g < GW; ++g) acc[hh][g] = V{};
  float rs = 0.f;   // lane hh < hl of a rowsum warp: head h0 + hh

  // row rr's sums out, and a fresh start
  auto flush = [&](int rr) {
    const size_t i = (size_t)t0 + rr;
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      if (hh < hl) {
        V* out = reinterpret_cast<V*>(agg + (i * h + h0 + hh) * c) + s_lo;
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          if (lane + 32 * g < nv) __stcs(out + lane + 32 * g, acc[hh][g]);
          acc[hh][g] = V{};
        }
      }
    }
    if (sums && lane < hl) rowsum[i * h + h0 + lane] = rs;
    rs = 0.f;
  };
  // chunk edge q's x slices of this warp into ring slot q % D, as one
  // group of copies (empty past qb)
  auto issue = [&](int q, int qb) {
    if (q < qb) {
      const X* row = x + (size_t)ks[q] * c;
      P* slot = ring + (q % D) * GW * 32 + lane;
#pragma unroll
      for (int g = 0; g < GW; ++g)
        if (lane + 32 * g < nv) R::copy(slot + 32 * g, row, s_lo + lane + 32 * g);
    }
    cp_async_commit();
  };

  const int e_lo = rp[ra], e_hi = rp[rb];       // this group's edges
  for (int c0 = rp[0]; c0 < rp[tn]; c0 += eb) {
    const int c1 = min(rp[tn], c0 + eb);
    if (c0 > rp[0]) __syncthreads();   // every warp is done with the last chunk
    // the chunk: WIDE_STAGE edges a thread, each edge's row (the last
    // with rp <= p), column id and weight for every head
    int p[WIDE_STAGE], j[WIDE_STAGE], ri[WIDE_STAGE];
#pragma unroll
    for (int k = 0; k < WIDE_STAGE; ++k) {
      p[k] = c0 + threadIdx.x + k * threads;
      j[k] = p[k] < c1 ? col[p[k]] : 0;
      int lo = 0, hi = tn;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (rp[mid] <= p[k]) lo = mid;
        else hi = mid;
      }
      ri[k] = t0 + lo;
    }
#pragma unroll
    for (int k = 0; k < WIDE_STAGE; ++k) {
      if (p[k] < c1) {
        float e[HB];
#pragma unroll
        for (int hh = 0; hh < HB; ++hh) {
          float src = hh < hl ? s_src[(size_t)ri[k] * h + h0 + hh] : 0.f;
          float dst = hh < hl ? s_dst[(size_t)j[k] * h + h0 + hh] : 0.f;
          if constexpr (BF16) {
            src = round_bf16(src);
            dst = round_bf16(dst);
          }
          e[hh] = edge_weight(src + dst);
          if constexpr (BF16) e[hh] = round_bf16(e[hh]);
        }
        store_weights<HB>(es + (size_t)(p[k] - c0) * HB, e);
        ks[p[k] - c0] = j[k];
      }
    }
    __syncthreads();

    // this group's edges of the chunk, streamed through the ring
    const int qa = max(e_lo, c0) - c0, qb = min(e_hi, c1) - c0;
#pragma unroll
    for (int u = 0; u < D - 1; ++u) issue(qa + u, qb);
    for (int q = qa; q < qb; ++q) {
      issue(q + D - 1, qb);
      while (c0 + q >= rp[r + 1]) flush(r++);   // rows that ended before q
      cp_async_wait<D - 1>();
      const P* slot = ring + (q % D) * GW * 32 + lane;
      float e[HB];
      load_weights<HB>(es + q * HB, e);
      V xv[GW];
#pragma unroll
      for (int g = 0; g < GW; ++g)
        xv[g] = lane + 32 * g < nv ? R::widen(slot[32 * g]) : V{};
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        if (hh < hl) {
#pragma unroll
          for (int g = 0; g < GW; ++g) Vec<VEC>::fma(acc[hh][g], e[hh], xv[g]);
        }
      }
      if (sums && lane < hl) rs += es[q * HB + lane];
    }
  }
  while (r < rb) flush(r++);
}

template <int HB, int VEC, int GW>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
gat_attention_fwd_wide_kernel(const float* __restrict__ x,
                              const float* __restrict__ s_src,
                              const float* __restrict__ s_dst,
                              const int* __restrict__ row_ptr,
                              const int* __restrict__ col,
                              float* __restrict__ agg,
                              float* __restrict__ rowsum, int n, int c, int h,
                              int hn, int warps) {
  gat_fwd_wide_tile<float, HB, VEC, GW>(x, s_src, s_dst, row_ptr, col, agg,
                                        rowsum, n, c, h, hn, warps);
}

template <int HB, int VEC, int GW>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
gat_attention_fwd_bf16_wide_kernel(const __nv_bfloat16* __restrict__ x,
                                   const float* __restrict__ s_src,
                                   const float* __restrict__ s_dst,
                                   const int* __restrict__ row_ptr,
                                   const int* __restrict__ col,
                                   float* __restrict__ agg,
                                   float* __restrict__ rowsum, int n, int c,
                                   int h, int hn, int warps) {
  gat_fwd_wide_tile<__nv_bfloat16, HB, VEC, GW>(
      x, s_src, s_dst, row_ptr, col, agg, rowsum, n, c, h, hn, warps);
}

template <typename X>
struct Args {
  const X* x;
  const float *s_src, *s_dst;
  const int *row_ptr, *col;
  float *agg, *rowsum;
  int n, c;
};

template <typename X, int H, int VEC, int G>
void launch_rows(const Args<X>& a, cudaStream_t stream) {
  const int blocks = (a.n + WARPS - 1) / WARPS;
  if constexpr (std::is_same<X, float>::value)
    gat_attention_fwd_kernel<H, VEC, G><<<blocks, 32 * WARPS, 0, stream>>>(
        a.x, a.s_src, a.s_dst, a.row_ptr, a.col, a.agg, a.rowsum, a.n, a.c);
  else
    gat_attention_fwd_bf16_kernel<H, VEC, G><<<blocks, 32 * WARPS, 0, stream>>>(
        a.x, a.s_src, a.s_dst, a.row_ptr, a.col, a.agg, a.rowsum, a.n, a.c);
}

template <typename X, int H, int VEC>
void launch_groups(const Args<X>& a, int groups, cudaStream_t stream) {
  if (groups <= 1) launch_rows<X, H, VEC, 1>(a, stream);
  else if (groups <= 2) launch_rows<X, H, VEC, 2>(a, stream);
  else if (groups <= 3) launch_rows<X, H, VEC, 3>(a, stream);
  else if (groups <= 5) launch_rows<X, H, VEC, 5>(a, stream);
  else launch_rows<X, H, VEC, MAX_GROUPS>(a, stream);
}

template <typename X, int H>
void launch(const Args<X>& a, int vec, int groups, cudaStream_t stream) {
  if (vec == 4) launch_groups<X, H, 4>(a, groups, stream);
  else launch_groups<X, H, 1>(a, groups, stream);
}

// The wide kernels' launch (ops/cuda/gat_attention.py, wide_plan): tiles
// of rows (grid.x), heads in groups of hn (grid.y), a row on `warps` warps
// (WIDE_ROWS row groups a block when warps == 1), and passes over the
// columns (grid.z) past WIDE_WARPS warps' slices.
template <typename X, int HB, int VEC, int GW>
int launch_wide(const Args<X>& a, int h, int hn, int warps,
                cudaStream_t stream) {
  using P = typename Raw<X, VEC>::T;
  const int rows = warps == 1 ? WIDE_ROWS : 1;
  const int tile = rows * WIDE_RUN;
  const int groups = (a.c / VEC + 31) / 32;
  const int passes = ((groups + GW - 1) / GW + warps - 1) / warps;
  const dim3 grid((a.n + tile - 1) / tile, (h + hn - 1) / hn, passes);
  const size_t smem = wide_smem(HB, GW, sizeof(P), 32 * warps * rows, tile);
  const void* kernel =
      std::is_same<X, float>::value
          ? reinterpret_cast<const void*>(gat_attention_fwd_wide_kernel<HB, VEC, GW>)
          : reinterpret_cast<const void*>(gat_attention_fwd_bf16_wide_kernel<HB, VEC, GW>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same<X, float>::value)
    gat_attention_fwd_wide_kernel<HB, VEC, GW><<<grid, 32 * warps * rows,
                                                 smem, stream>>>(
        a.x, a.s_src, a.s_dst, a.row_ptr, a.col, a.agg, a.rowsum, a.n, a.c,
        h, hn, warps);
  else
    gat_attention_fwd_bf16_wide_kernel<HB, VEC, GW><<<grid,
                                                      32 * warps * rows, smem,
                                                      stream>>>(
        a.x, a.s_src, a.s_dst, a.row_ptr, a.col, a.agg, a.rowsum, a.n, a.c,
        h, hn, warps);
  return static_cast<int>(cudaGetLastError());
}

// The groups a lane that a wide launch takes (wide_plan mirrors them):
// wide_big's, and fewer where a row of that many heads is narrow: 1, 3 or
// 6 at WIDE_HEADS heads (H > 4 at a narrow C), 6 for a pair row of two
// heads (C <= 384).
template <typename X, int HB, int VEC>
int launch_wide_gw(const Args<X>& a, int h, int hn, int gw, int warps,
                   cudaStream_t s) {
  constexpr int BIG = wide_big(HB, VEC);
  if (gw == BIG) return launch_wide<X, HB, VEC, BIG>(a, h, hn, warps, s);
  if constexpr (HB == WIDE_HEADS) {
    if (gw == 1) return launch_wide<X, HB, VEC, 1>(a, h, hn, warps, s);
    if constexpr (BIG > 3) {
      if (gw == 3) return launch_wide<X, HB, VEC, 3>(a, h, hn, warps, s);
    }
    if constexpr (BIG > 6) {
      if (gw == 6) return launch_wide<X, HB, VEC, 6>(a, h, hn, warps, s);
    }
  } else if constexpr (VEC == 2 && BIG > 6) {
    if (gw == 6) return launch_wide<X, HB, VEC, 6>(a, h, hn, warps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename X, int VEC>
int launch_wide_heads(const Args<X>& a, int h, int hn, int gw, int warps,
                      cudaStream_t s) {
  if (hn <= 2) return launch_wide_gw<X, 2, VEC>(a, h, hn, gw, warps, s);
  if (hn <= 4) return launch_wide_gw<X, 4, VEC>(a, h, hn, gw, warps, s);
  return launch_wide_gw<X, WIDE_HEADS, VEC>(a, h, hn, gw, warps, s);
}

template <typename X>
int forward(const X* x, const float* s_src, const float* s_dst,
            const int* row_ptr, const int* col, float* agg, float* rowsum,
            int n, int c, int h, int vec, int hn, int gw, int warps,
            void* stream) {
  if (n <= 0 || c <= 0 || h < 1 || (vec != 1 && vec != 2 && vec != 4) ||
      c % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<X> a{x, s_src, s_dst, row_ptr, col, agg, rowsum, n, c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hn != 0) {
    if (hn < 1 || hn > WIDE_HEADS || hn > h || warps < 1 ||
        warps > WIDE_WARPS)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (vec) {
      case 4: return launch_wide_heads<X, 4>(a, h, hn, gw, warps, s);
      case 2: return launch_wide_heads<X, 2>(a, h, hn, gw, warps, s);
      default: return launch_wide_heads<X, 1>(a, h, hn, gw, warps, s);
    }
  }
  if (h > MAX_HEADS || c / vec > 32 * MAX_GROUPS || vec == 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (c / vec + 31) / 32;
  switch (h) {
    case 1: launch<X, 1>(a, vec, groups, s); break;
    case 2: launch<X, 2>(a, vec, groups, s); break;
    case 3: launch<X, 3>(a, vec, groups, s); break;
    default: launch<X, 4>(a, vec, groups, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n, c), s_src/s_dst (n, h), row_ptr (n+1), col (row_ptr[n]) on the
// device; agg (n, h, c) and rowsum (n, h) are written in full.  hn = 0:
// gat_attention_rows, for h <= 4 with c / vec <= 320, vec 4 when
// c % 4 == 0 and x and agg are 16-byte aligned, else 1.  hn > 0: the wide
// kernels at any h and c, heads in groups of hn, gw groups of 32 slices a
// lane and `warps` warps a row (ops/cuda/gat_attention.py, wide_plan),
// vec 4, 2 (c even, x and agg 8-byte aligned) or 1.
int gat_attention_fwd(const float* x, const float* s_src, const float* s_dst,
                      const int* row_ptr, const int* col, float* agg,
                      float* rowsum, int n, int c, int h, int vec, int hn,
                      int gw, int warps, void* stream) {
  return forward(x, s_src, s_dst, row_ptr, col, agg, rowsum, n, c, h, vec,
                 hn, gw, warps, stream);
}

// The same on bf16 x (s_src, s_dst, agg and rowsum fp32); vec is 4 when
// c % 4 == 0, x is 8-byte and agg 16-byte aligned, (wide) 2 when c is
// even, x is 4-byte and agg 8-byte aligned, else 1.
int gat_attention_fwd_bf16(const __nv_bfloat16* x, const float* s_src,
                           const float* s_dst, const int* row_ptr,
                           const int* col, float* agg, float* rowsum, int n,
                           int c, int h, int vec, int hn, int gw, int warps,
                           void* stream) {
  return forward(x, s_src, s_dst, row_ptr, col, agg, rowsum, n, c, h, vec,
                 hn, gw, warps, stream);
}

}  // extern "C"
