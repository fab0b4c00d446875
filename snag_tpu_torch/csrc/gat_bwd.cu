// Sparse-GAT layer backward (diag mode) for Hopper, f32 or bf16 x and G.
//
// Replaces snag_tpu/ops/pallas/gat_bwd.py::fused_gat_backward_row (per-edge
// math edgewise_bwd).  Given the cotangents G (n, h, c) of agg and r (n, h)
// of rowsum from gat_attention.cu, every edge i <- j contributes
//     e        = exp(-leakyrelu_0.2(s_src[i] + s_dst[j]))
//     d_e      = <x[j], G[i, h]> + r[i, h]
//     d_score  = -d_e * e * leaky'(s_src[i] + s_dst[j])
//     d_x[j]     += sum_h e_h * G[i, h]
//     d_s_dst[j] += d_score
//     d_s_src[i] += d_score
//
// The edge multiset is symmetric (an undirected graph with self-loops; the
// wrapper refuses a graph without that flag), so node j's in-edges are its
// CSR row (j, k) read backwards, and rev[p] is the position of the reverse
// of edge p (a self-loop is its own reverse).  Two launches, no atomics:
//   pass 1, one warp per CSR row j: each edge p = (j, k) of the row is read
//       as the edge (k, j) = rev[p].  The warp gathers G[k] (and s_src[k],
//       r[k]), adds e * G[k] into d_x[j] in registers, reduces <x[j], G[k, h]>
//       across its lanes, and forms that edge's d_score: it goes into
//       d_s_dst[j] in edge order and to scratch[rev[p]].
//   pass 2, one thread per row i: d_s_src[i] = sum of scratch over row i in
//       CSR order.
// e is recomputed, never stored.
//
// What bounds it on the H100: the gathered bytes.  G (n h c floats, 72 MB at
// the slice geometry: n = 30,000, c = 300, h = 2) and x (36 MB) together do
// not fit in the 50 MB L2, and the columns of a row are scattered, so most G
// rows come from HBM.  Each edge needs its G row, h c floats: 0.79 GB per
// layer at E = 329,862.  Every d_score is computed once, by the row of its
// column, so nothing else is gathered per edge: no x[k] row (the earlier
// kernel, one block per row, gathered x[k] as well to compute each d_score a
// second time, for d_s_src: (h + 1) c floats an edge).  The scratch is E h
// floats (2.6 MB), written once at scattered positions and read once in
// order from L2.
//
// What the design does about it: a warp owns a row, so a row costs no block
// barrier, no shared memory and no serial thread.  Lane l owns the float4
// slices l, l + 32, ..., (G of them, a template parameter): x[j] and d_x[j]
// stay in registers, and both are streamed past L2 (read or written once) so
// that L2 keeps G rows.  The column ids and scalars of up to 32 edges are
// loaded one edge a lane and broadcast by shuffle; the edge weights are
// computed while the first G rows are in flight.  What sets the rate is the
// number of rows in flight on an SM, so a lane loads the G rows of one edge
// at a time and registers stay few (more edges in flight ran slower at C =
// 300 on an H100: PERF.md, PR 10).  A row of any length is walked by
// its one warp, 32 edges at a time: a hub row of 10^4 edges runs serially on
// one warp, slower than the rest of the grid but with the same sums.
//
// Bit-identity with the block-per-row kernel it replaced: there thread s owned
// slice s, so warp w held slices 32w + l, and a dot product was
// ((0 + P_0) + P_1) + ... with P_w warp w's xor-butterfly sum (offsets
// 16..1) of its lanes' Vec::dot.  Here lane l's group g is slice 32g + l, so
// butterflying each group separately and adding the group sums in order from
// 0 gives the same bits; every lane of an xor butterfly ends with the same
// value.  The d_score of edge (i, k) there was computed twice, once in row i
// as Vec::dot(x[k], G[i]) and once in row k; here row k computes it once with
// those operands, and d_s_src adds it in row i's CSR order as before.  d_x is
// the same fmaf chain (edges in order, heads in order, from 0).
//
// gat_bwd_bf16: the same two launches on bf16 x and G, with the rounding
// points of the Pallas kernel on the JAX package's bf16 path
// (gat_attn_primitive.py:137-192, gat_bwd.py:95-125, edgewise_bwd): the
// node block [G | r | s_src] and [x | s_dst] are bf16, so s_src, s_dst
// and r are rounded to bf16 here; e stays fp32; d_e sums the exact fp32
// products of x[j] and G[k]; each edge's d_score is rounded to bf16 (the
// kernel packs it beside d_x in the bf16 block it reduces), and so is its
// d_x term, a bf16 sum over heads of bf16(bf16(e_h) G[k, h]); the scratch
// and both row sums stay fp32, and d_x is written as bf16, as the
// primitive casts it to x's dtype.
//
// Its first pass has a body of its own, gat_bwd_bf16_rows.  Half the bytes
// of a G row do not make it gather-bound: on the H100 the same body as f32,
// with G widened to fp32 on arrival and the term's roundings in fp32, spent
// 0.30 of its warps' cycles on the term, 0.20 on the butterflies and 0.22
// waiting for G rows, and ran slower than the f32 kernel at 90 registers
// (scripts/torch_gat_bwd_phases.py; PERF.md section 6).  So:
// * G and the term stay bf16 pairs, two to a 32-bit word: the term is one
//   mul.rn.bf16x2 a pair and head and one add.rn.bf16x2 a pair for each
//   head after the first, each rounded once, which gives the fp32-then-
//   round_bf16 bits (mul_bf16x2); G is widened only inside the dot (the
//   same fmaf chain on the same fp32 values) and the term only where it is
//   added to d_x in fp32.
// * An edge's H x G lane partials of its dots are summed by one
//   reduce-scatter, warp_sums, with the butterflies' bits: 15 shuffles at
//   C = 300, H = 2 where a butterfly a value took 30.
// * One edge's G rows at a time, as the f32 body: at most 72 registers up
//   to C = 384, seven blocks an SM.  Two edges' rows in flight, or a
//   software prefetch of later edges' rows (92 registers), ran slower: the
//   warps in flight set the rate, and the wait for G rows is again the
//   largest phase.
// tests/test_torch_gat_bwd_bf16_schedule.py emulates the pass bit for bit.
//
// Any head count and width (gat_bwd_wide, f32 and bf16): the bodies above
// hold MAX_HEADS heads' G rows and MAX_GROUPS slices a lane in registers,
// which covers H <= 4 and C <= 1,280 (C % 4 == 0) or 320, the main path's
// shapes.  Past them gat_bwd_wide_rows walks each row's edges once, at any
// width.  A row wider than one warp's WIDE_GROUPS slices a lane takes a
// block of up to WIDE_WARPS warps that split its columns (warp w the
// slices from 32 WIDE_GROUPS w on), each keeping its share of x[j] and of
// the d_x[j] sums in registers; a narrower row takes one warp, WIDE_ROWS
// rows a block.  An edge's heads go in groups of WIDE_HEADS whose G rows
// are in flight together, and a group's lane partials (heads x groups) are
// summed by one reduce-scatter whose holder lanes write each (head, group)
// sum to shared memory.  A row of at most two heads of pairs (VEC = 2) and
// up to twice WIDE_GROUPS groups takes one warp, two heads a group: at H =
// 2, C = 330 on an H100 that ran 0.21 ms where two warps a row ran 0.32
// (scripts/torch_gat_bwd_phases.py; PERF.md section 6).  A batch of up to 32 edges shares one load of its
// columns, slots, weights, leaky' and r.  After a barrier a thread an
// (edge, head) adds the batch's group sums in order from 0 and writes the
// d_score to scratch[rev[p] h + head], once.  (The body this replaced
// walked a row's column chunks one after the other in one warp, each chunk
// a walk over the row's edges, and an edge's heads one at a time: load
// one head's G row, butterfly every group, and carry the partial dot
// through a read-modify-write of the edge's scratch slot before the next
// head; PERF.md section 6.)  Bits: the dot is the sum over groups in order
// from 0 of each group's butterfly sum, as in that body and in the main
// path's; d_x is the same fmaf chain (edges in order, heads in order, from
// 0), in bf16 the same term rounded at the same points.  Columns past
// WIDE_WARPS warps' take more launches, "passes", each carrying the
// partial dot in the edge's slot to the next.  f32 rows of even C take
// 8-byte slices (VEC = 2), bf16 rows two bf16 a lane.  The second launch
// then adds both d_s_src (row i's slots) and d_s_dst (the slots rev[p] of
// row j's edges, in edge order from 0: the bodies' running sum), a thread
// a (row, head): no atomics anywhere.
// tests/test_torch_gat_bwd_wide_schedule.py emulates the pass's sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_HEADS = 4;
constexpr int MAX_GROUPS = 10;   // c / vec <= 320
constexpr int WIDE_GROUPS = 3;   // groups a lane on the wide path, at most
constexpr int WIDE_HEADS = 4;    // heads whose G rows a wide warp holds
constexpr int WIDE_WARPS = 16;   // warps of a row on the wide path, at most
constexpr int WIDE_ROWS = 4;     // rows a block when a row takes one warp
constexpr int WIDE_SMEM = 48 * 1024;   // a wide block's shared memory
constexpr int WARPS = 4;         // rows a block in pass 1
constexpr int SUM_THREADS = 256; // rows a block in pass 2
// gat_bwd_bf16's first pass at G <= 3: blocks an SM it is built for (at
// most 72 registers a thread); so bounded it ran 4 % faster on an H100
// than unbounded at the same 72 registers (PERF.md section 6)
constexpr int BF16_MIN_BLOCKS = 7;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float edge_weight(float score) {
  const float lr = score > 0.f ? score : 0.2f * score;
  return expf(-lr);
}

__device__ __forceinline__ float leaky_grad(float score) {
  return score > 0.f ? 1.f : 0.2f;
}

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static void fma(float& acc, float e, float v) { acc = fmaf(e, v, acc); }
  __device__ static float dot(float a, float b) { return a * b; }
};
template <> struct Vec<2> {
  using T = float2;
  __device__ static void fma(float2& acc, float e, float2 v) {
    acc.x = fmaf(e, v.x, acc.x);
    acc.y = fmaf(e, v.y, acc.y);
  }
  __device__ static float dot(float2 a, float2 b) {
    return fmaf(a.y, b.y, a.x * b.x);
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
  __device__ static float dot(float4 a, float4 b) {
    return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
  }
};

// x rounded to bf16 and back: the JAX package's astype(bfloat16)
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Pass 1 of gat_bwd (f32).
template <int H, int VEC, int G>
__device__ __forceinline__ void gat_bwd_rows(
    const float* __restrict__ x, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, const float* __restrict__ g_agg,
    const float* __restrict__ g_rs, const int* __restrict__ row_ptr,
    const int* __restrict__ col, const long long* __restrict__ rev,
    float* __restrict__ d_x, float* __restrict__ d_s_dst,
    float* __restrict__ scratch, int n, int c) {
  using V = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (j >= n) return;  // a tail warp; nothing below waits on a barrier
  const int nv = c / VEC;

  V xj[G], acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int s = lane + 32 * g;
    // read once: streamed past L2, which keeps the G rows
    xj[g] = s < nv ? __ldcs(reinterpret_cast<const V*>(x + (size_t)j * c) + s)
                   : V{};
    acc[g] = V{};
  }
  float dst_j[H], sum_dst[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    dst_j[h] = s_dst[(size_t)j * H + h];
    sum_dst[h] = 0.f;
  }
  const int beg = row_ptr[j];
  const int end = row_ptr[j + 1];

  for (int base = beg; base < end; base += 32) {
    const int m = min(32, end - base);
    // edge base + lane: column k, the position of its reverse, its scalars
    int k_l = 0;
    long long at_l = 0;
    float score_l[H], e_l[H], r_l[H], dot_l[H];
#pragma unroll
    for (int h = 0; h < H; ++h) score_l[h] = r_l[h] = dot_l[h] = 0.f;
    if (lane < m) {
      k_l = col[base + lane];
      at_l = rev[base + lane];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        score_l[h] = s_src[(size_t)k_l * H + h];
        r_l[h] = g_rs[(size_t)k_l * H + h];
      }
    }

    for (int q = 0; q < m; ++q) {  // the same q for every lane
      const int k = __shfl_sync(FULL, k_l, q);
      V gk[H][G];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const V* row = reinterpret_cast<const V*>(g_agg + ((size_t)k * H + h) * c);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int s = lane + 32 * g;
          gk[h][g] = s < nv ? row[s] : V{};
        }
      }
      if (q == 0) {  // with the first G rows in flight: the edge weights
#pragma unroll
        for (int h = 0; h < H; ++h) {
          score_l[h] += dst_j[h];
          e_l[h] = edge_weight(score_l[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float e = __shfl_sync(FULL, e_l[h], q);
        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          Vec<VEC>::fma(acc[g], e, gk[h][g]);
          part[g] = lane + 32 * g < nv ? Vec<VEC>::dot(xj[g], gk[h][g]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part[g] += __shfl_xor_sync(FULL, part[g], off);
        }
        float dot = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (32 * g < nv) dot += part[g];
        // with VEC = 1 the compiler may fuse a lane's product into the
        // butterfly's first add, and then lanes may differ: lane 0's sum
        // is the one the block-per-row kernel kept
        if (VEC == 1) dot = __shfl_sync(FULL, dot, 0);
        if (lane == q) dot_l[h] = dot;
      }
    }

    // the chunk's d_scores, one edge a lane: to scratch, and into d_s_dst[j]
    // in edge order
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float d_score =
          -(dot_l[h] + r_l[h]) * e_l[h] * leaky_grad(score_l[h]);
      if (lane < m) scratch[at_l * H + h] = d_score;
      for (int q = 0; q < m; ++q) sum_dst[h] += __shfl_sync(FULL, d_score, q);
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int s = lane + 32 * g;
    if (s < nv) __stcs(reinterpret_cast<V*>(d_x + (size_t)j * c) + s, acc[g]);
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) d_s_dst[(size_t)j * H + h] = sum_dst[h];
  }
}

// ---- gat_bwd_bf16's first pass: x, G and the d_x term kept as bf16 pairs

// A slice of a bf16 row, packed: VEC = 4, two 32-bit words of two bf16
// each (the lower address in the low half); VEC = 1, one bf16 in the low
// half of a word.
template <int VEC> struct Packed;
template <> struct Packed<4> { using T = uint2; };
// VEC = 2 (the wide path's 4-byte slices): one word of two bf16, named
// apart from VEC = 1's word, which holds one
struct Pair { uint32_t w; };
template <> struct Packed<2> { using T = Pair; };
template <> struct Packed<1> { using T = uint32_t; };

template <int VEC>
__device__ __forceinline__ typename Packed<VEC>::T load_packed(
    const __nv_bfloat16* row, int s, bool stream) {
  if constexpr (VEC == 4) {
    const uint2* p = reinterpret_cast<const uint2*>(row) + s;
    return stream ? __ldcs(p) : *p;
  } else if constexpr (VEC == 2) {
    const unsigned int* p = reinterpret_cast<const unsigned int*>(row) + s;
    return Pair{stream ? __ldcs(p) : *p};
  } else {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(row) + s;
    return stream ? __ldcs(p) : *p;
  }
}

// The bf16 of a word's low or high half as fp32 (exact).
__device__ __forceinline__ float lo_f32(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(lo_f32(v.x), hi_f32(v.x), lo_f32(v.y), hi_f32(v.y));
}
__device__ __forceinline__ float2 widen(Pair v) {
  return make_float2(lo_f32(v.w), hi_f32(v.w));
}
__device__ __forceinline__ float widen(uint32_t v) { return lo_f32(v); }

// Vec<VEC>::dot(x, widen(g)): the same fmaf chain on the same fp32 values.
__device__ __forceinline__ float dot_packed(float4 x, uint2 g) {
  return fmaf(x.w, hi_f32(g.y),
              fmaf(x.z, lo_f32(g.y), fmaf(x.y, hi_f32(g.x), x.x * lo_f32(g.x))));
}
__device__ __forceinline__ float dot_packed(float2 x, Pair g) {
  return fmaf(x.y, hi_f32(g.w), x.x * lo_f32(g.w));
}
__device__ __forceinline__ float dot_packed(float x, uint32_t g) {
  return x * lo_f32(g);
}

// Both bf16 of a word times (or plus) the other word's, each result rounded
// once to nearest even: sm_90's bf16 arithmetic.  round_bf16(a * b) of two
// bf16 is the same value (their product is exact in fp32, and where it is
// too small for fp32's normal range its one fp32 rounding cannot land on a
// bf16 midpoint), and so is round_bf16(a + b) (the fp32 sum is exact unless
// the exponents differ by 16 or more, and then both round to the larger):
// the parent's bits, two elements an instruction.  tests/
// test_torch_gat_bwd_bf16_schedule.py holds both claims against f64.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint2 mul_bf16x2(uint32_t a, uint2 b) {
  return make_uint2(mul_bf16x2(a, b.x), mul_bf16x2(a, b.y));
}
__device__ __forceinline__ uint2 add_bf16x2(uint2 a, uint2 b) {
  return make_uint2(add_bf16x2(a.x, b.x), add_bf16x2(a.y, b.y));
}
__device__ __forceinline__ Pair mul_bf16x2(uint32_t a, Pair b) {
  return Pair{mul_bf16x2(a, b.w)};
}
__device__ __forceinline__ Pair add_bf16x2(Pair a, Pair b) {
  return Pair{add_bf16x2(a.w, b.w)};
}

// e rounded to bf16, in both halves of a word.
__device__ __forceinline__ uint32_t bf16_pair(float e) {
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(e));
  return b | (b << 16);
}

__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float2& a, float2 b) {
  a.x += b.x;
  a.y += b.y;
}
__device__ __forceinline__ void add(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}
__host__ __device__ constexpr int log2_of(int p) {
  return p <= 1 ? 0 : 1 + log2_of(p / 2);
}

// One step of warp_sums: the lane keeps half of its P values (the upper
// half where its bit OFF is set) and adds its partner's copy of each.
template <int M, int P, int OFF>
__device__ __forceinline__ void halve(float (&w)[M], int lane) {
  if constexpr (OFF > 0) {
    if constexpr (P > 1) {
      constexpr int HALF = P / 2;
      const bool up = lane & OFF;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float send = up ? w[i] : w[i + HALF];
        const float keep = up ? w[i + HALF] : w[i];
        w[i] = keep + __shfl_xor_sync(FULL, send, OFF);
      }
      halve<M, HALF, OFF / 2>(w, lane);
    } else {
      w[0] += __shfl_xor_sync(FULL, w[0], OFF);
      halve<M, 1, OFF / 2>(w, lane);
    }
  }
}

// v[i] <- the xor butterfly of v[i] over the warp (offsets 16, 8, ..., 1),
// on every lane, for N values at once, with the butterfly's bits: a
// reduce-scatter.  At offset OFF the butterfly adds, in each lane, its own
// value and its partner's; here a lane does that add only for the half of
// its values that it keeps, and sends its partner the other half, so each
// kept value is the butterfly's value at that lane (fp32 addition is
// commutative).  After the steps each lane holds R = P / 32 values (P, N
// rounded up to a power of two; R = 1 for P <= 32): value i on the lanes
// whose bits 16, 8, ... spell i's upper bits.  One shuffle a value brings
// each sum back to every lane.  N = 6: 15 shuffles where the butterflies
// take 30.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N], int lane) {
  constexpr int P = pow2_at_least(N);
  constexpr int LP = log2_of(P);
  constexpr int STEPS = LP < 5 ? LP : 5;   // halvings
  constexpr int R = P >> STEPS;            // values a lane keeps
  float w[P];
#pragma unroll
  for (int i = 0; i < P; ++i) w[i] = i < N ? v[i] : 0.f;
  halve<P, P, 16>(w, lane);
  if constexpr (P == 1) {
    v[0] = w[0];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      int holder = 0;
#pragma unroll
      for (int k = 0; k < STEPS; ++k)
        holder += ((i >> (LP - 1 - k)) & 1) * (16 >> k);
      v[i] = __shfl_sync(FULL, w[i & (R - 1)], holder);
    }
  }
}

// Slice s of a bf16 row of d_x from fp32: VEC values rounded to bf16.
template <int VEC>
__device__ __forceinline__ void store_slice(__nv_bfloat16* row, int s,
                                            typename Vec<VEC>::T v) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    __stcs(reinterpret_cast<uint2*>(row) + s, u);
  } else if constexpr (VEC == 2) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
    __stcs(reinterpret_cast<unsigned int*>(row) + s,
           *reinterpret_cast<const unsigned int*>(&b));
  } else {
    row[s] = __float2bfloat16_rn(v);
  }
}

// Pass 1 of gat_bwd_bf16, with the Pallas kernel's rounding points (file
// comment): the f32 body's walk, with lane l's slices l, l + 32, ... of G
// and the d_x term kept packed.
template <int H, int VEC, int G>
__device__ __forceinline__ void gat_bwd_bf16_rows(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, const __nv_bfloat16* __restrict__ g_agg,
    const float* __restrict__ g_rs, const int* __restrict__ row_ptr,
    const int* __restrict__ col, const long long* __restrict__ rev,
    __nv_bfloat16* __restrict__ d_x, float* __restrict__ d_s_dst,
    float* __restrict__ scratch, int n, int c) {
  using V = typename Vec<VEC>::T;
  using P = typename Packed<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (j >= n) return;  // a tail warp; nothing below waits on a barrier
  const int nv = c / VEC;

  V xj[G], acc[G];     // x[j] widened once; d_x[j] summed in fp32
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int s = lane + 32 * g;
    // read once: streamed past L2, which keeps the G rows
    xj[g] = s < nv ? widen(load_packed<VEC>(x + (size_t)j * c, s, true)) : V{};
    acc[g] = V{};
  }
  float dst_j[H], sum_dst[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    dst_j[h] = round_bf16(s_dst[(size_t)j * H + h]);
    sum_dst[h] = 0.f;
  }
  const int beg = row_ptr[j];
  const int end = row_ptr[j + 1];

  for (int base = beg; base < end; base += 32) {
    const int m = min(32, end - base);
    // edge base + lane: column k, the position of its reverse, its scalars
    int k_l = 0;
    long long at_l = 0;
    float score_l[H], e_l[H], r_l[H], dot_l[H];
#pragma unroll
    for (int h = 0; h < H; ++h) score_l[h] = r_l[h] = dot_l[h] = 0.f;
    if (lane < m) {
      k_l = col[base + lane];
      at_l = rev[base + lane];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        score_l[h] = round_bf16(s_src[(size_t)k_l * H + h]);
        r_l[h] = round_bf16(g_rs[(size_t)k_l * H + h]);
      }
    }

    for (int q = 0; q < m; ++q) {  // the same q for every lane
      const int k = __shfl_sync(FULL, k_l, q);
      P gk[H][G];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const __nv_bfloat16* row = g_agg + ((size_t)k * H + h) * c;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int s = lane + 32 * g;
          gk[h][g] = s < nv ? load_packed<VEC>(row, s, false) : P{};
        }
      }
      if (q == 0) {  // with the first G rows in flight: the edge weights
#pragma unroll
        for (int h = 0; h < H; ++h) {
          score_l[h] += dst_j[h];
          e_l[h] = edge_weight(score_l[h]);
        }
      }
      // the edge's d_x term, bf16(bf16(e_h) G[k, h]) summed over heads in
      // bf16, and its lanes' dot partials, head h's group g at h G + g
      P term[G];
      float part[H * G];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const uint32_t e2 = bf16_pair(__shfl_sync(FULL, e_l[h], q));
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const P p = mul_bf16x2(e2, gk[h][g]);
          term[g] = h == 0 ? p : add_bf16x2(term[g], p);
          part[h * G + g] =
              lane + 32 * g < nv ? dot_packed(xj[g], gk[h][g]) : 0.f;
        }
      }
      warp_sums<H * G>(part, lane);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float dot = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (32 * g < nv) dot += part[h * G + g];
        if (lane == q) dot_l[h] = dot;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) add(acc[g], widen(term[g]));
    }

    // the chunk's d_scores, one edge a lane, rounded to bf16: to scratch,
    // and into d_s_dst[j] in edge order
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float d_score =
          round_bf16(-(dot_l[h] + r_l[h]) * e_l[h] * leaky_grad(score_l[h]));
      if (lane < m) scratch[at_l * H + h] = d_score;
      for (int q = 0; q < m; ++q) sum_dst[h] += __shfl_sync(FULL, d_score, q);
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int s = lane + 32 * g;
    if (s < nv) store_slice<VEC>(d_x + (size_t)j * c, s, acc[g]);
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) d_s_dst[(size_t)j * H + h] = sum_dst[h];
  }
}

// ---- the wide path: any head count and width

// The halving steps of warp_sums alone (a reduce-scatter of N values):
// after them value i sits in w[i % R] of the SPAN lanes l with l / SPAN ==
// i / R, with the butterfly's bits.
template <int N> struct Held {
  static constexpr int P = pow2_at_least(N);
  static constexpr int LP = log2_of(P);
  static constexpr int STEPS = LP < 5 ? LP : 5;
  static constexpr int R = P >> STEPS;       // values a lane holds
  static constexpr int SPAN = 32 >> STEPS;   // lanes that hold the same ones
};

template <int N>
__device__ __forceinline__ void warp_reduce_scatter(const float (&v)[N],
                                                    float (&held)[Held<N>::R],
                                                    int lane) {
  constexpr int P = Held<N>::P;
  float w[P];
#pragma unroll
  for (int i = 0; i < P; ++i) w[i] = i < N ? v[i] : 0.f;
  halve<P, P, 16>(w, lane);
#pragma unroll
  for (int r = 0; r < Held<N>::R; ++r) held[r] = w[r];
}

// Shared memory of one row of the wide pass: the batch's slots (int64)
// and columns, each edge's weight, leaky' and r per head, and the (head,
// group) sums, `batch + 1` floats apart; 16-byte aligned.
__host__ __device__ constexpr size_t wide_row_bytes(int batch, int h, int ng) {
  return ((size_t)12 * batch + (size_t)12 * h * batch +
          (size_t)4 * h * ng * (batch + 1) + 15) / 16 * 16;
}

// A row's barrier: its warp's, or its block's when the row has several.
__device__ __forceinline__ void wide_sync(int warps) {
  if (warps == 1) __syncwarp();
  else __syncthreads();
}

// Slice s of a G row as the body keeps it: f32 Vec<VEC>::T, bf16 packed;
// and its dot with x[j]'s slice (f32: Vec<VEC>::dot; bf16: dot_packed).
template <typename X, int VEC> struct RowSlice {
  using T = typename Vec<VEC>::T;
  __device__ static T load(const float* row, int s) {
    return reinterpret_cast<const T*>(row)[s];
  }
  __device__ static float dot(T x, T g) { return Vec<VEC>::dot(x, g); }
};
template <int VEC> struct RowSlice<__nv_bfloat16, VEC> {
  using T = typename Packed<VEC>::T;
  __device__ static T load(const __nv_bfloat16* row, int s) {
    return load_packed<VEC>(row, s, false);
  }
  __device__ static float dot(typename Vec<VEC>::T x, T g) {
    return dot_packed(x, g);
  }
};

// Pass 1 at any head count h and width c (file comment): a row on its
// block's `warps` warps (or a warp a row, WIDE_ROWS rows a block), warp w
// on the row's slices from s_lo = (pass warps + w) 32 GW, its lane l on
// slices s_lo + 32 g + l.  The row's edges are walked once, `batch` at a
// time: the batch's scalars into shared memory, then every edge's heads
// in groups of HG with their G rows in flight together, the
// group's lane partials summed by one reduce-scatter and each (head,
// group) sum written to shared memory by its holder lane; after a
// barrier, a thread an (edge, head) adds the row's group sums in order
// from 0 (after the partial dot that the pass before left in the edge's
// slot) and writes the d_score, or the partial dot, to scratch[rev[p] h +
// head].  d_s_dst is left to the second launch.
template <typename X, int VEC, int HG, int GW>
__device__ __forceinline__ void gat_bwd_wide_rows(
    const X* __restrict__ x, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, const X* __restrict__ g_agg,
    const float* __restrict__ g_rs, const int* __restrict__ row_ptr,
    const int* __restrict__ col, const long long* __restrict__ rev,
    X* __restrict__ d_x, float* __restrict__ scratch, int n, int c, int h,
    int warps, int batch, int pass) {
  constexpr bool BF16 = !std::is_same<X, float>::value;
  constexpr int N = HG * GW;   // values an edge's head group sums
  using V = typename Vec<VEC>::T;
  using S = RowSlice<X, VEC>;
  using P = typename S::T;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = blockDim.x / (32 * warps);   // 1 unless warps == 1
  const int r_in = warp / warps;                // the block's row
  const int w = warp % warps;                   // the row's warp
  const int t_row = threadIdx.x - r_in * 32 * warps;
  const int row_threads = 32 * warps;
  const int j = blockIdx.x * rows + r_in;
  if (j >= n) return;  // a tail row: one warp, whose barriers are its own
  const int ng = GW * warps;                    // a pass's groups
  const int nv_all = c / VEC;
  const int s_lo = (pass * warps + w) * 32 * GW;
  const int nv = nv_all - s_lo;                 // this warp's slices from s_lo
  // the pass's groups that hold slices, and whether it is the last pass
  const int live = min(ng, (nv_all - pass * ng * 32 + 31) / 32);
  const bool last = (pass + 1) * ng * 32 >= nv_all;
  const int stride = batch + 1;                 // odd: no bank conflicts
  unsigned char* base_ptr =
      wide_smem + (size_t)r_in * wide_row_bytes(batch, h, ng);
  long long* at_s = reinterpret_cast<long long*>(base_ptr);
  int* k_s = reinterpret_cast<int*>(at_s + batch);
  float* e_s = reinterpret_cast<float*>(k_s + batch);   // [h][batch]
  float* lk_s = e_s + h * batch;                          // leaky'
  float* r_s = lk_s + h * batch;
  float* sum_s = r_s + h * batch;                         // [h][ng][stride]

  V xj[GW], acc[GW];
#pragma unroll
  for (int g = 0; g < GW; ++g) {
    const int s = lane + 32 * g;
    if constexpr (BF16)
      xj[g] = s < nv ? widen(load_packed<VEC>(x + (size_t)j * c, s_lo + s, true))
                     : V{};
    else
      xj[g] = s < nv
                  ? __ldcs(reinterpret_cast<const V*>(x + (size_t)j * c) + s_lo + s)
                  : V{};
    acc[g] = V{};
  }
  const int beg = row_ptr[j];
  const int end = row_ptr[j + 1];

  for (int b0 = beg; b0 < end; b0 += batch) {
    const int m = min(batch, end - b0);
    // the batch: each edge's column and slot, and per head its weight,
    // leaky' and r (a thread an (edge, head), heads adjacent)
    for (int t = t_row; t < m; t += row_threads) {
      k_s[t] = col[b0 + t];
      at_s[t] = rev[b0 + t];
    }
    for (int t = t_row; t < m * h; t += row_threads) {
      const int q = t / h, hh = t - q * h;
      const int k = col[b0 + q];
      float src = s_src[(size_t)k * h + hh];
      float dst = s_dst[(size_t)j * h + hh];
      float r = g_rs[(size_t)k * h + hh];
      if constexpr (BF16) {
        src = round_bf16(src);
        dst = round_bf16(dst);
        r = round_bf16(r);
      }
      const float score = src + dst;
      e_s[hh * batch + q] = edge_weight(score);
      lk_s[hh * batch + q] = leaky_grad(score);
      r_s[hh * batch + q] = r;
    }
    wide_sync(warps);

    for (int q = 0; q < m; ++q) {
      const int k = k_s[q];
      P term[GW];
      for (int hb = 0; hb < h; hb += HG) {
        // the head group's G rows, in flight together
        P gk[HG][GW];
#pragma unroll
        for (int i = 0; i < HG; ++i) {
          const X* row = g_agg + ((size_t)k * h + hb + i) * c;
#pragma unroll
          for (int g = 0; g < GW; ++g) {
            const int s = lane + 32 * g;
            gk[i][g] = hb + i < h && s < nv ? S::load(row, s_lo + s) : P{};
          }
        }
        float part[N];
#pragma unroll
        for (int i = 0; i < HG; ++i) {
          const float e = hb + i < h ? e_s[(hb + i) * batch + q] : 0.f;
#pragma unroll
          for (int g = 0; g < GW; ++g) {
            if (hb + i < h) {
              if constexpr (BF16) {
                const P p = mul_bf16x2(bf16_pair(e), gk[i][g]);
                term[g] = hb + i == 0 ? p : add_bf16x2(term[g], p);
              } else {
                Vec<VEC>::fma(acc[g], e, gk[i][g]);
              }
            }
            part[i * GW + g] =
                lane + 32 * g < nv ? S::dot(xj[g], gk[i][g]) : 0.f;
          }
        }
        // each (head, group) sum to shared memory, by one of its holders
        float held[Held<N>::R];
        warp_reduce_scatter<N>(part, held, lane);
        if ((lane & (Held<N>::SPAN - 1)) == 0) {
#pragma unroll
          for (int v = 0; v < Held<N>::R; ++v) {
            const int i = (lane / Held<N>::SPAN) * Held<N>::R + v;
            const int hh = hb + i / GW;
            if (i < N && hh < h)
              sum_s[(hh * ng + w * GW + i % GW) * stride + q] = held[v];
          }
        }
      }
      if constexpr (BF16) {
#pragma unroll
        for (int g = 0; g < GW; ++g) add(acc[g], widen(term[g]));
      }
    }
    wide_sync(warps);

    // the batch's d_scores (or partial dots), a thread an (edge, head):
    // the group sums added in order from 0, as one warp's groups are
    for (int t = t_row; t < m * h; t += row_threads) {
      const int hh = t / m, q = t - hh * m;
      const long long at = at_s[q];
      float dot = pass == 0 ? 0.f : scratch[at * h + hh];
      const float* sums = sum_s + (size_t)hh * ng * stride + q;
      for (int g = 0; g < live; ++g) dot += sums[g * stride];
      if (last) {
        const int o = hh * batch + q;
        float d_score = -(dot + r_s[o]) * e_s[o] * lk_s[o];
        if constexpr (BF16) d_score = round_bf16(d_score);
        dot = d_score;
      }
      scratch[at * h + hh] = dot;
    }
    wide_sync(warps);
  }

#pragma unroll
  for (int g = 0; g < GW; ++g) {
    const int s = lane + 32 * g;
    if (s >= nv) continue;
    if constexpr (BF16)
      store_slice<VEC>(d_x + (size_t)j * c, s_lo + s, acc[g]);
    else
      __stcs(reinterpret_cast<V*>(d_x + (size_t)j * c) + s_lo + s, acc[g]);
  }
}

template <int VEC, int HG, int GW>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
gat_bwd_wide_rows_kernel(const float* __restrict__ x,
                         const float* __restrict__ s_src,
                         const float* __restrict__ s_dst,
                         const float* __restrict__ g_agg,
                         const float* __restrict__ g_rs,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ col,
                         const long long* __restrict__ rev,
                         float* __restrict__ d_x, float* __restrict__ scratch,
                         int n, int c, int h, int warps, int batch, int pass) {
  gat_bwd_wide_rows<float, VEC, HG, GW>(x, s_src, s_dst, g_agg, g_rs,
                                        row_ptr, col, rev, d_x, scratch, n,
                                        c, h, warps, batch, pass);
}

template <int VEC, int HG, int GW>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
gat_bwd_bf16_wide_rows_kernel(const __nv_bfloat16* __restrict__ x,
                              const float* __restrict__ s_src,
                              const float* __restrict__ s_dst,
                              const __nv_bfloat16* __restrict__ g_agg,
                              const float* __restrict__ g_rs,
                              const int* __restrict__ row_ptr,
                              const int* __restrict__ col,
                              const long long* __restrict__ rev,
                              __nv_bfloat16* __restrict__ d_x,
                              float* __restrict__ scratch, int n, int c,
                              int h, int warps, int batch, int pass) {
  gat_bwd_wide_rows<__nv_bfloat16, VEC, HG, GW>(x, s_src, s_dst, g_agg,
                                                g_rs, row_ptr, col, rev, d_x,
                                                scratch, n, c, h, warps, batch,
                                                pass);
}

// The wide second launch, a thread a (row i, head): d_s_src[i] = row i's
// slots, d_s_dst[i] = the slots rev[p] of row i's edges, each added in CSR
// order from 0.
__device__ __forceinline__ void gat_bwd_wide_sums(
    const float* __restrict__ scratch, const int* __restrict__ row_ptr,
    const long long* __restrict__ rev, float* __restrict__ d_s_src,
    float* __restrict__ d_s_dst, int n, int h) {
  const long long t = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (t >= (long long)n * h) return;
  const int i = static_cast<int>(t / h);
  const int hh = static_cast<int>(t % h);
  float src = 0.f, dst = 0.f;
  const int end = row_ptr[i + 1];
  for (int p = row_ptr[i]; p < end; ++p) {
    src += scratch[(size_t)p * h + hh];
    dst += scratch[rev[p] * h + hh];
  }
  d_s_src[t] = src;
  d_s_dst[t] = dst;
}

// Two kernels around the same body: only their names differ, so that a
// profiler's kernel names tell the f32 backward's launches from the bf16's.
__global__ void __launch_bounds__(SUM_THREADS)
gat_bwd_wide_sums_kernel(const float* __restrict__ scratch,
                         const int* __restrict__ row_ptr,
                         const long long* __restrict__ rev,
                         float* __restrict__ d_s_src,
                         float* __restrict__ d_s_dst, int n, int h) {
  gat_bwd_wide_sums(scratch, row_ptr, rev, d_s_src, d_s_dst, n, h);
}

__global__ void __launch_bounds__(SUM_THREADS)
gat_bwd_bf16_wide_sums_kernel(const float* __restrict__ scratch,
                              const int* __restrict__ row_ptr,
                              const long long* __restrict__ rev,
                              float* __restrict__ d_s_src,
                              float* __restrict__ d_s_dst, int n, int h) {
  gat_bwd_wide_sums(scratch, row_ptr, rev, d_s_src, d_s_dst, n, h);
}

template <int H, int VEC, int G>
__global__ void __launch_bounds__(32 * WARPS)
gat_bwd_rows_kernel(const float* __restrict__ x,
                    const float* __restrict__ s_src,
                    const float* __restrict__ s_dst,
                    const float* __restrict__ g_agg,
                    const float* __restrict__ g_rs,
                    const int* __restrict__ row_ptr,
                    const int* __restrict__ col,
                    const long long* __restrict__ rev,
                    float* __restrict__ d_x,
                    float* __restrict__ d_s_dst,
                    float* __restrict__ scratch, int n, int c) {
  gat_bwd_rows<H, VEC, G>(x, s_src, s_dst, g_agg, g_rs, row_ptr, col, rev,
                          d_x, d_s_dst, scratch, n, c);
}

// named apart so that a profile tells the two apart; up to C = 384 (the
// GAT's 300) at most 72 registers, seven blocks an SM
template <int H, int VEC, int G>
__global__ void __launch_bounds__(32 * WARPS, G <= 3 ? BF16_MIN_BLOCKS : 1)
gat_bwd_bf16_rows_kernel(const __nv_bfloat16* __restrict__ x,
                         const float* __restrict__ s_src,
                         const float* __restrict__ s_dst,
                         const __nv_bfloat16* __restrict__ g_agg,
                         const float* __restrict__ g_rs,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ col,
                         const long long* __restrict__ rev,
                         __nv_bfloat16* __restrict__ d_x,
                         float* __restrict__ d_s_dst,
                         float* __restrict__ scratch, int n, int c) {
  gat_bwd_bf16_rows<H, VEC, G>(x, s_src, s_dst, g_agg, g_rs, row_ptr, col,
                               rev, d_x, d_s_dst, scratch, n, c);
}

// d_s_src[i] = the d_scores of row i's edges, added in CSR order from 0.
template <int H>
__device__ __forceinline__ void gat_bwd_src(const float* __restrict__ scratch,
                                            const int* __restrict__ row_ptr,
                                            float* __restrict__ d_s_src, int n) {
  const int i = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= n) return;
  float sum[H];
#pragma unroll
  for (int h = 0; h < H; ++h) sum[h] = 0.f;
  const int end = row_ptr[i + 1];
  for (int p = row_ptr[i]; p < end; ++p) {
#pragma unroll
    for (int h = 0; h < H; ++h) sum[h] += scratch[(size_t)p * H + h];
  }
#pragma unroll
  for (int h = 0; h < H; ++h) d_s_src[(size_t)i * H + h] = sum[h];
}

template <int H>
__global__ void __launch_bounds__(SUM_THREADS)
gat_bwd_src_kernel(const float* __restrict__ scratch,
                   const int* __restrict__ row_ptr,
                   float* __restrict__ d_s_src, int n) {
  gat_bwd_src<H>(scratch, row_ptr, d_s_src, n);
}

template <int H>
__global__ void __launch_bounds__(SUM_THREADS)
gat_bwd_bf16_src_kernel(const float* __restrict__ scratch,
                        const int* __restrict__ row_ptr,
                        float* __restrict__ d_s_src, int n) {
  gat_bwd_src<H>(scratch, row_ptr, d_s_src, n);
}

template <typename X>
struct Args {
  const X* x;
  const float *s_src, *s_dst;
  const X* g_agg;
  const float* g_rs;
  const int *row_ptr, *col;
  const long long* rev;
  X* d_x;
  float *d_s_src, *d_s_dst, *scratch;
  int n, c;
};

template <typename X, int H, int VEC, int G>
void launch_rows(const Args<X>& a, cudaStream_t stream) {
  const int blocks = (a.n + WARPS - 1) / WARPS;
  if constexpr (std::is_same<X, float>::value)
    gat_bwd_rows_kernel<H, VEC, G><<<blocks, 32 * WARPS, 0, stream>>>(
        a.x, a.s_src, a.s_dst, a.g_agg, a.g_rs, a.row_ptr, a.col, a.rev, a.d_x,
        a.d_s_dst, a.scratch, a.n, a.c);
  else
    gat_bwd_bf16_rows_kernel<H, VEC, G><<<blocks, 32 * WARPS, 0, stream>>>(
        a.x, a.s_src, a.s_dst, a.g_agg, a.g_rs, a.row_ptr, a.col, a.rev, a.d_x,
        a.d_s_dst, a.scratch, a.n, a.c);
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
int launch(const Args<X>& a, int vec, int groups, cudaStream_t stream) {
  if (vec == 4) launch_groups<X, H, 4>(a, groups, stream);
  else launch_groups<X, H, 1>(a, groups, stream);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.n + SUM_THREADS - 1) / SUM_THREADS;
  if constexpr (std::is_same<X, float>::value)
    gat_bwd_src_kernel<H><<<blocks, SUM_THREADS, 0, stream>>>(
        a.scratch, a.row_ptr, a.d_s_src, a.n);
  else
    gat_bwd_bf16_src_kernel<H><<<blocks, SUM_THREADS, 0, stream>>>(
        a.scratch, a.row_ptr, a.d_s_src, a.n);
  return static_cast<int>(cudaGetLastError());
}

// The wide first pass, one launch a pass over a share of the columns, then
// the row sums.  A row takes `warps` warps (a block), or one warp,
// WIDE_ROWS rows a block.
template <typename X, int VEC, int HG, int GW>
int launch_wide(const Args<X>& a, int h, int warps, int batch,
                cudaStream_t stream) {
  const int ng = GW * warps;
  const int rows = warps == 1 ? WIDE_ROWS : 1;
  const size_t smem = rows * wide_row_bytes(batch, h, ng);
  if (smem > WIDE_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (a.n + rows - 1) / rows;
  const int passes = (a.c / VEC + 32 * ng - 1) / (32 * ng);
  for (int pass = 0; pass < passes; ++pass) {
    if constexpr (std::is_same<X, float>::value)
      gat_bwd_wide_rows_kernel<VEC, HG, GW><<<blocks, 32 * warps * rows,
                                              smem, stream>>>(
          a.x, a.s_src, a.s_dst, a.g_agg, a.g_rs, a.row_ptr, a.col, a.rev,
          a.d_x, a.scratch, a.n, a.c, h, warps, batch, pass);
    else
      gat_bwd_bf16_wide_rows_kernel<VEC, HG, GW><<<blocks,
                                                   32 * warps * rows, smem,
                                                   stream>>>(
          a.x, a.s_src, a.s_dst, a.g_agg, a.g_rs, a.row_ptr, a.col, a.rev,
          a.d_x, a.scratch, a.n, a.c, h, warps, batch, pass);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long threads = (long long)a.n * h;
  const int sums = static_cast<int>((threads + SUM_THREADS - 1) / SUM_THREADS);
  if constexpr (std::is_same<X, float>::value)
    gat_bwd_wide_sums_kernel<<<sums, SUM_THREADS, 0, stream>>>(
        a.scratch, a.row_ptr, a.rev, a.d_s_src, a.d_s_dst, a.n, h);
  else
    gat_bwd_bf16_wide_sums_kernel<<<sums, SUM_THREADS, 0, stream>>>(
        a.scratch, a.row_ptr, a.rev, a.d_s_src, a.d_s_dst, a.n, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, int VEC>
int launch_wide_groups(const Args<X>& a, int h, int gw, int warps, int batch,
                       cudaStream_t s) {
  switch (gw) {
    case 1: return launch_wide<X, VEC, WIDE_HEADS, 1>(a, h, warps, batch, s);
    case 2: return launch_wide<X, VEC, WIDE_HEADS, 2>(a, h, warps, batch, s);
    case 3: return launch_wide<X, VEC, WIDE_HEADS, 3>(a, h, warps, batch, s);
    default:  // two heads of up to 6 groups: C <= 384 in pairs, one warp
      if constexpr (VEC == 2)
        return launch_wide<X, VEC, 2, 2 * WIDE_GROUPS>(a, h, warps, batch, s);
      else
        return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename X>
int backward(const X* x, const float* s_src, const float* s_dst,
             const X* g_agg, const float* g_rs, const int* row_ptr,
             const int* col, const long long* rev, X* d_x, float* d_s_src,
             float* d_s_dst, float* scratch, int n, int c, int h, int vec,
             int gw, int warps, int batch, void* stream) {
  if (n <= 0 || c <= 0 || h < 1 || (vec != 1 && vec != 2 && vec != 4) ||
      c % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<X> a{x, s_src, s_dst, g_agg, g_rs, row_ptr, col, rev,
                  d_x, d_s_src, d_s_dst, scratch, n, c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gw != 0) {
    if (gw < 1 || (gw > WIDE_GROUPS && (gw != 2 * WIDE_GROUPS || h > 2)) ||
        warps < 1 || warps > WIDE_WARPS || batch < 1 || batch > 32)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (vec) {
      case 4: return launch_wide_groups<X, 4>(a, h, gw, warps, batch, s);
      case 2: return launch_wide_groups<X, 2>(a, h, gw, warps, batch, s);
      default: return launch_wide_groups<X, 1>(a, h, gw, warps, batch, s);
    }
  }
  if (h > MAX_HEADS || c / vec > 32 * MAX_GROUPS || vec == 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (c / vec + 31) / 32;
  switch (h) {
    case 1: return launch<X, 1>(a, vec, groups, s);
    case 2: return launch<X, 2>(a, vec, groups, s);
    case 3: return launch<X, 3>(a, vec, groups, s);
    default: return launch<X, 4>(a, vec, groups, s);
  }
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n, c), s_src/s_dst (n, h), g_agg (n, h, c), g_rs (n, h), row_ptr (n+1),
// col and rev (row_ptr[n], rev int64) on the device, the CSR multiset
// symmetric; d_x (n, c), d_s_src and d_s_dst (n, h) are written in full,
// scratch (row_ptr[n], h) is the caller's.  gw = 0: the bodies above, for
// h <= 4 with c / vec <= 320, vec 4 when c % 4 == 0 and x, g_agg, d_x are
// 16-byte aligned, else 1.  gw > 0: the wide pass at any h and c with gw
// groups a lane, `warps` warps a row and edge batches of `batch`
// (ops/cuda/gat_bwd.py, wide_plan), vec 4, 2 (c even, 8-byte aligned) or 1.
int gat_bwd(const float* x, const float* s_src, const float* s_dst,
            const float* g_agg, const float* g_rs, const int* row_ptr,
            const int* col, const long long* rev, float* d_x, float* d_s_src,
            float* d_s_dst, float* scratch, int n, int c, int h, int vec,
            int gw, int warps, int batch, void* stream) {
  return backward(x, s_src, s_dst, g_agg, g_rs, row_ptr, col, rev, d_x,
                  d_s_src, d_s_dst, scratch, n, c, h, vec, gw, warps, batch,
                  stream);
}

// The same on bf16 x, g_agg and d_x (s_src, s_dst, g_rs, d_s_src, d_s_dst
// and scratch fp32); vec is 4 when c % 4 == 0 and x, g_agg, d_x are 8-byte
// aligned, (wide) 2 when c is even and they are 4-byte aligned, else 1.
int gat_bwd_bf16(const __nv_bfloat16* x, const float* s_src,
                 const float* s_dst, const __nv_bfloat16* g_agg,
                 const float* g_rs, const int* row_ptr, const int* col,
                 const long long* rev, __nv_bfloat16* d_x, float* d_s_src,
                 float* d_s_dst, float* scratch, int n, int c, int h, int vec,
                 int gw, int warps, int batch, void* stream) {
  return backward(x, s_src, s_dst, g_agg, g_rs, row_ptr, col, rev, d_x,
                  d_s_src, d_s_dst, scratch, n, c, h, vec, gw, warps, batch,
                  stream);
}

}  // extern "C"
