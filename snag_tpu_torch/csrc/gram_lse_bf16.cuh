// The row-logsumexp of Gram channels K_m = z_m z_m^T on bf16 z, for Hopper:
// the mixture lse (snag_loss.cu, mixture_lse_bf16, MIX = true) and the
// NT-Xent lse (ntxent.cu, ntxent_lse_bf16, MIX = false).  What it computes
// is gram_lse.cuh's: channels K_m from the bf16 operands in fp32 and, for
// the mixture, mix_a = sum_m alpha[r,m] alpha[c,m] K_m and mix_f =
// sum_m beta[m] K_m in fp32, and
//     lse[ch, r] = log(sum_{c != r} v[c] exp(channel[r, c] / tau - 1/tau)
//                      + 1e-30) + 1/tau;
// each element of a symmetric channel computed once (unordered pairs of
// 128-row tiles, gram_lse.cuh's tile_pair), its exp added to its row's and,
// off the diagonal pair, its column's sum; the partials of each pair
// written once to part[ch][J][rows of I] and part[ch][I][rows of J] and
// added over t ascending by gram_lse.cuh's sum_partials.  No float
// atomics: two runs give the same bits.
//
// K runs as one bf16 mma.sync.m16n8k16 a k16 slice, each slice's product
// from zero and added in fp32 in increasing k (the tensor cores truncate
// when they accumulate), as before.
//
// The design, for a kernel that waited on latency (one k16 slice and one
// block barrier a ring slot, one tile pair a block, 8-byte copies, a
// prologue and an exp epilogue that nothing overlapped):
// * Persistent blocks: the grid fills the SMs once and each block walks a
//   contiguous run of the linear work index (tile pair, and batch for
//   NT-Xent).  The ring runs on across channels and pairs, so a pair's
//   first slots load under the last pair's exps and sums.
// * A ring slot is a slab of KS16 = 4 k16 slices (64 features) of the
//   pair's two row tiles: four products a warp and slice pair for each
//   block barrier, not one.
// * The tensor memory accelerator stages a slot: one thread issues two
//   2-D copies (the slab of each row tile, 128 rows x 64 features, rows
//   past the matrices and features past the row read as 0), completion
//   counted on the slot's mbarrier, so no thread spends issue slots on
//   copies.  The copies write 128-byte rows with the 128-byte swizzle (the
//   16-byte unit u of row r at u ^ (r % 8)), which ldmatrix reads without
//   bank conflicts.  z's rows must be 16-byte multiples: the entry pads z
//   to rows of round8(d) where d % 8 != 0 (gram_grad_bf16.cuh's
//   pad_rows).
// * The exps as ex2.approx of x log2(e) / tau - log2(e) / tau (~2 ulp).
// * NT-Xent: 8 warps over the (128 x 128) tile as 2 x 4 warp tiles of
//   (64 x 32), 64 accumulators a thread, a three-slot ring of 96 KB, two
//   blocks an SM, so that one block's exps run under the other's products.
//   The mixture: 16 warps as 4 x 4 tiles of (32 x 32), whose K tile and
//   the mixtures' running sums (96 floats a thread) fit at 128 registers
//   with a few spilled, a four-slot ring, one block an SM.  A pair's
//   channels leave their warps' sums in shared memory, and the block
//   adds them across warps and writes the partials once a pair, two block
//   barriers a pair, not two a channel.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "gram_grad_bf16.cuh"
#include "gram_lse.cuh"

namespace {
namespace lse16 {

constexpr int T = 128;                   // rows of a tile
constexpr int KS16 = 4;                  // k16 slices of a ring slot
constexpr int SLAB = 16 * KS16;          // features of a ring slot
constexpr int ROW_BYTES = 2 * SLAB;      // 128: a row of a slot
constexpr int HALF_BYTES = T * ROW_BYTES;   // a tile's slab: 16 KB
constexpr int SLOT_BYTES = 2 * HALF_BYTES;  // the rows of I, then of J
constexpr int ALIGN = 1024;              // the 128-byte swizzle's period

// the channels whose sums a pair collects before it writes them: NT-Xent
// its batch's, the mixture every modality's and the two mixtures'
template <bool MIX>
__host__ __device__ constexpr int pair_channels() {
  return MIX ? MAX_MOD + 2 : 1;
}

// a block's shared memory: the ring (from a 1024-byte boundary), its
// warps' row and column sums of a pair's channels, and the ring's barriers
template <bool MIX, int WR, int WC, int DEPTH>
__host__ __device__ constexpr size_t smem_bytes() {
  return ALIGN + (size_t)DEPTH * SLOT_BYTES +
         sizeof(float) * (size_t)pair_channels<MIX>() * (WR + WC) * T +
         sizeof(uint64_t) * DEPTH;
}

// The ring's barriers (mbarrier): one a slot, completed once the slot's
// bytes have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the barrier's phase of this parity has completed; traps
// after ~10 s (a fault, not a wait) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000ll) __trap();
  }
}

// A box of the 2-D tensor map (features x rows) at (f0, r0) to dst (1024
// bytes aligned) by the tensor memory accelerator, counted on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int f0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(f0),
      "r"(r0), "r"(smem_u32(bar))
      : "memory");
}

// Slab s of rows [row0, row0 + T) and [col0, col0 + T) of the map's rows
// into the slot at buf, on bar; by one thread.
__device__ __forceinline__ void load_slab(const CUtensorMap* map, int row0,
                                          int col0, int s, unsigned char* buf,
                                          uint64_t* bar) {
  // the slot was last read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_expect_tx(bar, SLOT_BYTES);
  tma_load(buf, map, SLAB * s, row0, bar);
  tma_load(buf + HALF_BYTES, map, SLAB * s, col0, bar);
}

// Four 8x8 b16 matrices from shared memory (a 32-bit shared address a
// lane).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// e^x for x <= 0 from y = x log2(e): ex2.approx, ~2 ulp.
__device__ __forceinline__ float exp2_approx(float y) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y));
  return e;
}

// The row (in the tile) of half h of this thread's m16 tile i, and the
// column of element c of its n8 tile j: element e of C fragment (i, j)
// sits at (frag_row(i, e / 2), frag_col(j, e % 2)).
template <int WR, int WC>
__device__ __forceinline__ int frag_row(int i, int h) {
  return (threadIdx.x / 32 % WR) * (T / WR) + i * 16 + threadIdx.x % 32 / 4 +
         8 * h;
}

template <int WR, int WC>
__device__ __forceinline__ int frag_col(int j, int c) {
  return (threadIdx.x / 32 / WR) * (T / WC) + j * 8 + 2 * (threadIdx.x % 4) + c;
}

// acc += this warp's (T / WR x T / WC) tile over the slab's first nk16 k16
// slices: A (rows of I) and B (rows of J) by ldmatrix from the swizzled
// slot at buf, each slice one product from zero, added in fp32.  A lane's
// rows are r = 8 q + lane % 8 for some q, so its unit u sits at
// u ^ (lane % 8).
template <int WR, int WC>
__device__ __forceinline__ void k_slab(
    const unsigned char* buf, int nk16,
    float (&acc)[T / (16 * WR)][T / (8 * WC)][4]) {
  constexpr int MT = T / (16 * WR), NT = T / (8 * WC);
  static_assert(NT % 2 == 0, "B fragments come in pairs of n8 tiles");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t swz = lane % 8;
  const uint32_t a_row =
      smem_u32(buf) + ((warp % WR) * (T / WR) + lane % 16) * ROW_BYTES;
  const uint32_t b_row =
      smem_u32(buf) + HALF_BYTES +
      ((warp / WR) * (T / WC) + lane % 8 + 8 * (lane / 16)) * ROW_BYTES;
  const uint32_t a_hi = lane / 16, b_hi = (lane / 8) % 2;
#pragma unroll
  for (int kk = 0; kk < KS16; ++kk) {
    if (kk < nk16) {
      const uint32_t a_unit = ((2 * kk + a_hi) ^ swz) * 16;
      const uint32_t b_unit = ((2 * kk + b_hi) ^ swz) * 16;
      uint32_t b[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        ldsm_x4(b[j], b_row + 16 * j * ROW_BYTES + b_unit);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldsm_x4(a, a_row + 16 * i * ROW_BYTES + a_unit);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          const uint32_t b0[2] = {b[j][0], b[j][1]}, b1[2] = {b[j][2], b[j][3]};
          float p0[4], p1[4];
          grad16::mma_bf16_0(p0, a, b0);
          grad16::mma_bf16_0(p1, a, b1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][2 * j][e] += p0[e];
            acc[i][2 * j + 1][e] += p1[e];
          }
        }
      }
    }
  }
}

// One channel x (rows v_row[0 .. nr) and columns v_col[0 .. nc) valid):
// the exps e^(x / tau - 1 / tau) (as 2^(x l2_tau - l2_tau), l2_tau =
// log2(e) / tau), and each warp's sums of them into red: a row's (its 4
// lanes) at red[w][row] for the warp's column w of the grid, off the
// diagonal a column's (its 8 lanes) at red[WC + w][col] for the warp's row
// w.  flush_sums adds the warps' sums once a pair's channels are in.
template <int WR, int WC>
__device__ __forceinline__ void warp_sums(
    const float (&x)[T / (16 * WR)][T / (8 * WC)][4],
    const float* __restrict__ v_row, int nr, const float* __restrict__ v_col,
    int nc, bool diag, float l2_tau, float* red) {
  constexpr int MT = T / (16 * WR), NT = T / (8 * WC);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float vr[MT][2], vc[NT][2], rs[MT][2], cs[NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row<WR, WC>(i, h);
      vr[i][h] = r < nr ? v_row[r] : 0.f;
      rs[i][h] = 0.f;
    }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = frag_col<WR, WC>(j, c);
      vc[j][c] = col < nc ? v_col[col] : 0.f;
      cs[j][c] = 0.f;
    }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, c = e % 2;
        float ex = exp2_approx(fmaf(x[i][j][e], l2_tau, -l2_tau));
        if (diag && frag_row<WR, WC>(i, h) == frag_col<WR, WC>(j, c)) ex = 0.f;
        rs[i][h] += ex * vc[j][c];
        cs[j][c] += ex * vr[i][h];
      }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = rs[i][h];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) red[(warp / WR) * T + frag_row<WR, WC>(i, h)] = s;
    }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float s = cs[j][c];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) red[(WC + warp % WR) * T + frag_col<WR, WC>(j, c)] = s;
    }
}

// A pair's partials: for each of its channels c (channel ch0 + c, its
// warps' sums at red + c (WR + WC) T), a row's sum over its WC warps in
// order to part[ch][tj][row0 + r], r < nr, and, off the diagonal, a
// column's over its WR warps to part[ch][ti][col0 + c], c < nc.  Each slot
// is written once (tests/test_torch_lse_schedule.py).
template <int WR, int WC>
__device__ __forceinline__ void flush_sums(
    const float* red, int channels, int ch0, float* __restrict__ part,
    int tiles, int n2, int ti, int tj, int nr, int nc, bool diag) {
  constexpr int THREADS = 32 * WR * WC;
  __syncthreads();            // the warps' sums are in red
  for (int k = threadIdx.x; k < channels * 2 * T; k += THREADS) {
    const int c = k / (2 * T), q = k % (2 * T);
    const float* rc = red + c * (WR + WC) * T;
    float* p = part + (size_t)(ch0 + c) * tiles * n2;
    if (q < T) {
      if (q < nr) {
        float s = rc[q];
#pragma unroll
        for (int w = 1; w < WC; ++w) s += rc[w * T + q];
        p[(size_t)tj * n2 + ti * T + q] = s;
      }
    } else if (!diag && q - T < nc) {
      float s = rc[WC * T + q - T];
#pragma unroll
      for (int w = 1; w < WR; ++w) s += rc[(WC + w) * T + q - T];
      p[(size_t)ti * n2 + tj * T + q - T] = s;
    }
  }
  __syncthreads();            // red is free again
}

// The kernel's body.  map: z's nm matrices (batches of NT-Xent,
// modalities of the mixture) of n2 rows, stacked, as a 2-D tensor map
// (make_map).  part is (channels, tiles, n2): NT-Xent's
// channels are its batches, the mixture's [K_0 .. K_{nm-1} | mix_a |
// mix_f].  !MIX: alpha and beta unused.
template <bool MIX, int WR, int WC, int DEPTH>
__device__ __forceinline__ void gram_lse_bf16(
    const CUtensorMap* map, const float* __restrict__ alpha,
    const float* __restrict__ beta, const float* __restrict__ v,
    float* __restrict__ part, int nm, int n2, int d, float inv_tau) {
  constexpr int MT = T / (16 * WR), NT = T / (8 * WC);
  static_assert(MT * 16 * WR == T && NT * 8 * WC == T, "the warp grid");
  static_assert(DEPTH >= 2, "a ring of two slots or more");
  extern __shared__ __align__(16) unsigned char smem16[];
  unsigned char* ring =
      smem16 + ((ALIGN - smem_u32(smem16) % ALIGN) % ALIGN);
  // [pair_channels][WC + WR][T]: the warps' row, then column sums
  float* red = reinterpret_cast<float*>(ring + DEPTH * SLOT_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      red + pair_channels<MIX>() * (WR + WC) * T);                // [DEPTH]

  const float l2_tau = 1.4426950408889634f * inv_tau;
  const int tiles = (n2 + T - 1) / T;
  const int pairs = tiles * (tiles + 1) / 2;
  const int nk = MIX ? nm : 1;                    // K channels a pair
  const int d16 = (d + 15) / 16;
  const int ns = (d16 + KS16 - 1) / KS16;         // slabs a channel
  // this block's run [w0, w1) of the work: w = batch x pairs + pair
  // (NT-Xent) or the pair (MIX)
  const long long work = (long long)pairs * (MIX ? 1 : nm);
  const long long w0 = work * blockIdx.x / gridDim.x;
  const long long w1 = work * (blockIdx.x + 1) / gridDim.x;
  auto decode = [&](long long w, int& batch, int& ti, int& tj) {
    batch = MIX ? 0 : (int)(w / pairs);
    lse::tile_pair((int)(w - (long long)batch * pairs), tiles, ti, tj);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < DEPTH; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the ring: the run's steps (w, m, s) in order, step q in slot q %
  // DEPTH, staged by thread 0 DEPTH - 1 steps ahead of its compute,
  // across channels and pairs
  long long lw = w0;
  int lm = 0, ls = 0, lslot = 0, lbatch = 0, lrow0 = 0, lcol0 = 0;
  auto issue = [&]() {
    if (lw < w1) {
      if (lm == 0 && ls == 0) {
        int ti, tj;
        decode(lw, lbatch, ti, tj);
        lrow0 = ti * T;
        lcol0 = tj * T;
      }
      if (threadIdx.x == 0) {
        const int r0 = (MIX ? lm : lbatch) * n2;
        load_slab(map, r0 + lrow0, r0 + lcol0, ls, ring + lslot * SLOT_BYTES,
                  bars + lslot);
      }
      if (++ls == ns) {
        ls = 0;
        if (++lm == nk) {
          lm = 0;
          ++lw;
        }
      }
    }
    lslot = lslot + 1 == DEPTH ? 0 : lslot + 1;
  };
  // waits for the next step's slot; every thread is done with the last
  // step's, which takes the step DEPTH - 1 ahead
  int cslot = 0;
  uint32_t cphase = 0;
  auto next = [&]() -> const unsigned char* {
    mbar_wait(bars + cslot, cphase);
    __syncthreads();
    issue();
    const unsigned char* buf = ring + cslot * SLOT_BYTES;
    if (++cslot == DEPTH) {
      cslot = 0;
      cphase ^= 1u;
    }
    return buf;
  };
#pragma unroll
  for (int q = 0; q < DEPTH - 1; ++q) issue();

  for (long long w = w0; w < w1; ++w) {
    int batch, ti, tj;
    decode(w, batch, ti, tj);
    const bool diag = ti == tj;
    const int row0 = ti * T, col0 = tj * T;
    const int nr = min(T, n2 - row0), nc = min(T, n2 - col0);
    // slot k of the pair's sums (NT-Xent: its batch's, 0; the mixture:
    // channel k)
    auto sums = [&](const float (&x)[MT][NT][4], int k) {
      warp_sums<WR, WC>(x, v + row0, nr, v + col0, nc, diag, l2_tau,
                        red + k * (WR + WC) * T);
    };
    float mix_a[MT][NT][4], mix_f[MT][NT][4];     // (unused by NT-Xent)
    for (int m = 0; m < nk; ++m) {
      float acc[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      for (int s = 0; s < ns; ++s) {
        const unsigned char* buf = next();
        k_slab<WR, WC>(buf, min(KS16, d16 - KS16 * s), acc);
      }
      sums(acc, MIX ? m : 0);
      // the mixtures' running sums from this modality's K
      float ar[MT][2], ac[NT][2], bm = 0.f;
      if (MIX) {
        bm = beta[m];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = frag_row<WR, WC>(i, h);
            ar[i][h] = r < nr ? alpha[(size_t)(row0 + r) * nm + m] : 0.f;
          }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = frag_col<WR, WC>(j, c);
            ac[j][c] = col < nc ? alpha[(size_t)(col0 + col) * nm + m] : 0.f;
          }
      }
      if (MIX) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float k = acc[i][j][e];
              const float a0 = m == 0 ? 0.f : mix_a[i][j][e];
              const float f0 = m == 0 ? 0.f : mix_f[i][j][e];
              mix_a[i][j][e] = fmaf(ar[i][e / 2] * ac[j][e % 2], k, a0);
              mix_f[i][j][e] = fmaf(bm, k, f0);
            }
      }
    }
    if (MIX) {
      sums(mix_a, nm);
      sums(mix_f, nm + 1);
    }
    flush_sums<WR, WC>(red, MIX ? nm + 2 : 1, MIX ? 0 : batch, part, tiles,
                       n2, ti, tj, nr, nc, diag);
  }
}  // gram_lse_bf16

// How a bf16 lse kernel runs at this shape on the current device: its
// tile, the tiles of n2 and their unordered pairs, the blocks an SM holds
// and the persistent blocks launched, the ring's slots and features a
// slot, warps a block, its dynamic shared memory, and the floats of
// scratch: partials (channels x tiles x n2), then, where d % 8 != 0, z's
// padded copy (from pad_at).
struct Plan {
  int tile, tiles, pairs, per_sm, blocks, depth, slab, warps;
  size_t bytes, scratch, pad_at;
};

// {tile, tile pairs, blocks per SM, persistent blocks, ring slots,
// features a slot, warps a block}: the plan as the C entries report it
inline void report(const Plan& p, int* out) {
  const int fields[] = {p.tile, p.pairs, p.per_sm, p.blocks, p.depth, p.slab,
                        p.warps};
  for (int i = 0; i < 7; ++i) out[i] = fields[i];
}

// kernel: the instantiation <MIX, WR, WC, DEPTH> of a bf16 lse kernel; m
// matrices of z, channels of partials, each pair's work repeated for
// `repeat` batches (NT-Xent: m, the mixture: 1).
template <bool MIX, int WR, int WC, int DEPTH>
int plan(const void* kernel, int m, int channels, int repeat, int n2, int d,
         Plan& p) {
  p.tile = T;
  p.tiles = (n2 + T - 1) / T;
  // tile_pair's int arithmetic needs tiles^2 < 2^31
  if (p.tiles > 46340) return static_cast<int>(cudaErrorInvalidConfiguration);
  p.pairs = p.tiles * (p.tiles + 1) / 2;
  p.depth = DEPTH;
  p.slab = SLAB;
  p.warps = WR * WC;
  p.bytes = smem_bytes<MIX, WR, WC, DEPTH>();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, kernel,
                                                        32 * WR * WC, p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long work = (long long)p.pairs * repeat;
  p.blocks = (int)std::min<long long>(work, (long long)sms * p.per_sm);
  p.scratch = (size_t)channels * p.tiles * n2;
  p.pad_at = grad16::pad_offset(p.scratch);
  if (d % 8) p.scratch = p.pad_at + grad16::pad_floats(m, n2, d);
  return 0;
}

// The kernels' 2-D tensor map of z (rows of ld >= d features, ld % 8 ==
// 0, z 16-byte aligned): rows x ld bf16, boxes of T rows x SLAB features,
// the 128-byte swizzle, zeros outside.  The driver's encoder comes through
// the runtime, so the library needs no link to the driver.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

int make_map(CUtensorMap* map, const __nv_bfloat16* z, long long rows,
             int ld) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || !fn)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)ld, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {SLAB, T};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<__nv_bfloat16*>(z), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace lse16
}  // namespace
