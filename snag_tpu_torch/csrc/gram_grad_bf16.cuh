// The gradient of row-logsumexp losses over Gram channels K_m = z_m z_m^T
// on bf16 z, for Hopper: the mixture gradient (snag_loss.cu,
// mixture_grad_bf16, MIX = true) and the NT-Xent gradient (ntxent.cu,
// ntxent_grad_bf16, MIX = false).  The formulas are gram_grad.cuh's:
// with S = channel / tau and p = exp(min(S - lse, 0)),
//     W = ((c != r)(coef_r p_row v_c + p_col coef_c v_r)
//          - [c == pos(r)](coef_r + coef_c)) / tau,
// NT-Xent dz_m = bf16(W_m) z_m; the mixture dz_m = bf16(W_m(bf16 K_m) +
// W_a alpha_rm alpha_cm + W_f beta_m) z_m, dalpha and dbeta, where at a
// row's positive partner bf16 K_m is kpos, the exact dot rounded once to
// bf16, and the bf16 W_tot that multiplies z_m is wpos, W_tot in f64 from
// the exact dots rounded once (mixture_kpos_bf16_kernel, below).
//
// Both products run as one bf16 mma.sync.m16n8k16 with fp32 accumulation
// (tile_mma.cuh).  The rounding points are the Pallas kernels': K from the
// bf16 operands in fp32, each k16 slice from zero and added in fp32 in
// increasing k (the tensor cores truncate when they accumulate); the two
// mixtures from that fp32 K, in increasing m; the channel's own K rounded
// to bf16 where W_m, dalpha and dbeta read it (at the positive partner
// kpos instead, a value the twin computes alike); W rounded to bf16
// before W z (at the positive partner wpos, also computed alike).  W z takes a column tile's four k16 slices in one
// accumulator from zero and adds the tile's sum in fp32; column splits add
// their partials in a fixed order in a second kernel.  No float atomics:
// two runs give the same bits.
//
// What bounds it on the H100 is arithmetic: M K products and M W z
// products of 2 n2^2 d flops each at the bf16 dense rate, 989 TFLOP/s, and
// 2 exps an element and channel.  The exps and the fp32 adds of K's
// slices take more issue slots than the products, so the design spends
// registers on warps in flight, and keeps everything but the z tiles and
// the exchanges below out of shared memory:
//
// * A block of 16 warps owns 128 rows: 8 strips of 16 rows, PARTS = 2
//   warps a strip, each taking half of the 64-column tile for K and W and
//   half of the block's features for dz.  Two n8 C fragments of K (columns
//   16i .. 16i + 15) are exactly the bf16 A fragment of W for k16 slice i
//   of W z (FlashAttention-2's reuse): a warp rounds its slices of W in
//   registers and trades them with the strip's other warp through shared
//   memory, a barrier of the strip's threads.
// * dz stays in registers, 4 NTW floats a thread (NTW = 19 n8 feature
//   tiles, 152 features a warp, 304 a block); wider d runs in balanced
//   feature chunks (blockIdx.y), which need K over the whole d.  At 128
//   registers a thread, 16 warps an SM.
// * With one chunk (d <= 304) the block keeps its own 128 rows in shared
//   memory for the whole run and stages each column tile once: K's B
//   operand comes from it by ldmatrix, W z's by ldmatrix.trans.  One ring
//   slot and one barrier a column tile.
// * NT-Xent in 2, 4 or 8 chunks (d <= 2,432): the chunks' blocks of a row
//   block form a cluster that splits K's rows: each block keeps 128 / c of
//   the rows resident over every feature, computes K and W for them from
//   column slabs of up to 304 features, and reads the rest of W for its
//   feature chunk from the other blocks' shared memory.  K and W are
//   computed once, not once a chunk.
// * Otherwise (the mixture past 304 features, NT-Xent past 2,432) a column
//   tile is a few large steps: K in slabs of up to KD16 k16 slices, each
//   staging the block's rows and the tile's columns, then one Z step
//   staging the tile's columns over the chunk's features for W z.
// * The mixture's block owns one modality's dz; the M blocks of a row
//   block (chunk, split) form a thread-block cluster.  Each computes its
//   own K_m once and publishes it in its shared memory (two buffers, by
//   the tile's parity, so one cluster barrier a tile); every block reads
//   all M tiles through distributed shared memory for the two mixtures'
//   sums, in increasing m, so no block computes another modality's K.
//
// Operands arrive by 16-byte cp.async into a ring of up to four slots,
// rows >= n2 and features >= d as 0; where d % 8 != 0 the entry first
// copies z to rows of round8(d) (pad_rows), so that every copy is 16 bytes.
// blockIdx.x: the row block; blockIdx.y: chunk x M + batch or modality;
// blockIdx.z: the column split.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gram_grad.cuh"
#include "tile_mma.cuh"

namespace {
namespace grad16 {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int PARTS = 2;             // warps a strip
constexpr int STRIPS = WARPS / PARTS;  // 16-row strips a block
constexpr int ROWS = 16 * STRIPS;
constexpr int COLS = 64;             // columns a tile
constexpr int CN8 = 8 / PARTS;       // a warp's n8 tiles of K
constexpr int CS = 4 / PARTS;        // a warp's k16 slices of W
constexpr int NT = 38;               // n8 feature tiles a block: 304
constexpr int NTW = (NT + PARTS - 1) / PARTS;  // of dz a warp
// Rows of bf16 in shared memory, ldmatrix-ready: strides of an odd number
// of 16-byte units put the 8 rows an ldmatrix phase reads on distinct
// banks.
constexpr int Z_STRIDE = 8 * NT + 8;          // 312: 304 features + 8
constexpr int KD16 = 10;                      // k16 slices of a K slab
constexpr int K_STRIDE = 16 * KD16 + 8;       // 168
// the slots (bf16 elements): a column tile over up to 304 features; a K
// slab of the block's rows and the tile's columns
constexpr int Z_SLOT = COLS * Z_STRIDE;
constexpr int K_SLOT = (ROWS + COLS) * K_STRIDE;
constexpr int MIN_DEPTH = 2, MAX_DEPTH = 4;
// W's A fragments a tile, traded by the warps of a strip: 4 k16 slices
// x 4 registers x 32 lanes a strip
constexpr int W_WORDS = STRIPS * 4 * 4 * 32;
// the mixture's K tile, shared with the cluster: 4 CN8 floats a thread,
// two buffers by the tile's parity; the W exchange uses the other one
constexpr int K_WORDS = 4 * CN8 * THREADS;
static_assert(W_WORDS <= K_WORDS, "the W exchange exceeds the K tile");
static_assert(Z_SLOT <= K_SLOT, "a Z step exceeds a streamed slot");
static_assert((THREADS + PARTS * ROWS) * 4 <= 2 * Z_SLOT,
              "the final reductions exceed a slot");

// Whether a launch keeps the block's rows resident (one chunk).
__host__ __device__ __forceinline__ bool resident(int chunks) {
  return chunks == 1;
}

// NT-Xent in 2, 4 or 8 chunks: the chunks' blocks of a row block form a
// cluster of that size, each block computing K and W for its 1 / c of the
// rows (resident) and reading the rest of W from the others.
__host__ __device__ __forceinline__ int row_split(bool mix, int chunks) {
  return !mix && (chunks == 2 || chunks == 4 || chunks == 8) ? chunks : 1;
}

// a resident row over every feature: an odd number of 16-byte units
__host__ __device__ __forceinline__ int row_stride(int d) {
  return 16 * ((d + 15) / 16) + 8;
}

__host__ __device__ __forceinline__ int slot_elems(bool mix, int chunks) {
  return resident(chunks) || row_split(mix, chunks) > 1 ? Z_SLOT : K_SLOT;
}

size_t smem_bytes(bool mix, int chunks, int d, int depth) {
  const int c = row_split(mix, chunks);
  const size_t rows = resident(chunks) ? (size_t)ROWS * Z_STRIDE
                      : c > 1          ? (size_t)ROWS / c * row_stride(d)
                                       : 0;
  return 2 * (rows + (size_t)depth * slot_elems(mix, chunks)) +
         sizeof(uint32_t) * (mix ? 2 * K_WORDS : W_WORDS);
}

// The cluster's barrier, all threads of all its blocks; release and
// acquire order the shared memory each block wrote before it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of p (this block's shared memory) in block rank's.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// A word of another block's shared memory (an address from cluster_addr).
__device__ __forceinline__ uint32_t ld_cluster(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(x) : "r"(addr)
               : "memory");
  return x;
}

__device__ __forceinline__ void cp_async16_raw(void* dst, const void* src,
                                               bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// Four 8x8 b16 matrices from shared memory, each lane giving one row's
// address (lanes 8i .. 8i + 7 the rows of matrix i); .trans transposes
// each matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}

// d = a b in bf16 with fp32 accumulation, from a zero C operand.
__device__ __forceinline__ void mma_bf16_0(float (&d)[4], const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// Rows [r0, r0 + nr) of zm (n rows of d features at a stride of ld, a
// multiple of 8), features [f0, f0 + nf) (f0 and nf multiples of 8), into
// dst with a row stride of ds elements, by 16-byte copies; rows >= n and
// features >= d as 0.
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ zm,
                                      int n, int d, int ld, int r0, int nr,
                                      int f0, int nf, __nv_bfloat16* dst,
                                      int ds) {
  const int units = nf / 8;
  // copy i = r units + u, i = threadIdx.x + THREADS j, walked without a
  // division a copy
  const int dr = THREADS / units, du = THREADS - dr * units;
  int r = threadIdx.x / units, u = threadIdx.x - r * units;
  for (; r < nr; r += dr, u += du) {
    if (u >= units) {
      u -= units;
      ++r;
      if (r >= nr) break;
    }
    const int f = 8 * u;
    const bool ok = r0 + r < n && f0 + f < d;
    cp_async16_raw(dst + r * ds + f,
                   ok ? zm + (size_t)(r0 + r) * ld + f0 + f : zm, ok);
  }
}

// k[j] += n8 tile j (columns 8 j ..) of K over nk16 k16 slices: A the
// warp's strip at a (row stride as), B the warp's 8 CN8 columns at b
// (stride bs), both from their first feature; each slice one product from
// zero, added in fp32.
__device__ __forceinline__ void k_tile(const __nv_bfloat16* a, int as,
                                       const __nv_bfloat16* b, int bs,
                                       int nk16, float (&k)[CN8][4]) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* ar = a + (lane % 16) * as + 8 * (lane / 16);
  const __nv_bfloat16* br =
      b + (lane % 8 + 8 * (lane / 16)) * bs + 8 * ((lane / 8) % 2);
#pragma unroll 2
  for (int kk = 0; kk < nk16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, ar + 16 * kk);
#pragma unroll
    for (int j = 0; j < CN8 / 2; ++j) {
      uint32_t bf[4];
      ldsm_x4(bf, br + 16 * j * bs + 16 * kk);
      const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
      float p0[4], p1[4];
      mma_bf16_0(p0, af, b0);
      mma_bf16_0(p1, af, b1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k[2 * j][e] += p0[e];
        k[2 * j + 1][e] += p1[e];
      }
    }
  }
}

// acc[f] += W (the strip's 16 rows x the tile's 64 columns, bf16 A
// fragments w[i] of k16 slice i) times the staged z tile (64 rows from zt,
// stride Z_STRIDE, from the warp's first feature) over feature tile f <
// nt.  Per pair of feature tiles one ldmatrix.trans a slice; the tile's
// four slices accumulate from zero, the sum is added in fp32.
__device__ __forceinline__ void wz_tile(const __nv_bfloat16* zt,
                                        const uint32_t (&w)[4][4], int nt,
                                        float (&acc)[NTW][4]) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* zr =
      zt + (lane % 8 + 8 * ((lane / 8) % 2)) * Z_STRIDE + 8 * (lane / 16);
#pragma unroll
  for (int f = 0; f < NTW; f += 2) {
    if (f < nt) {
      float p0[4], p1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, zr + 16 * i * Z_STRIDE + 8 * f);
        const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
        if (i == 0) {
          mma_bf16_0(p0, w[i], b0);
          mma_bf16_0(p1, w[i], b1);
        } else {
          mma_bf16(p0, w[i], b0);
          mma_bf16(p1, w[i], b1);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] += p0[e];
      if (f + 1 < nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f + 1][e] += p1[e];
      }
    }
  }
}

static_assert(CN8 % 2 == 0, "K's B operand comes in pairs of n8 tiles");

// k += one n8 tile of K (8 columns at b, stride bs) over nk16 k16 slices,
// A the strip at a (stride as); each slice from zero, added in fp32.
__device__ __forceinline__ void k_tile1(const __nv_bfloat16* a, int as,
                                        const __nv_bfloat16* b, int bs,
                                        int nk16, float (&k)[4]) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* ar = a + (lane % 16) * as + 8 * (lane / 16);
  const __nv_bfloat16* br = b + (lane % 8) * bs + 8 * ((lane / 8) % 2);
#pragma unroll 2
  for (int kk = 0; kk < nk16; ++kk) {
    uint32_t af[4], bf[2];
    ldsm_x4(af, ar + 16 * kk);
    ldsm_x2(bf, br + 16 * kk);
    float p[4];
    mma_bf16_0(p, af, bf);
#pragma unroll
    for (int e = 0; e < 4; ++e) k[e] += p[e];
  }
}

// What a thread knows of its two rows h (g and g + 8 of its strip).
struct Rows {
  int gr[2], pos[2];
  bool ok[2];
  float v[2];
};

// The kernel's body.  NT-Xent (!MIX): z (nm, n2, d), lse and coef (nm,
// n2).  MIX: alpha (n2, nm), beta (nm,), lse and coef (nm + 2, n2), and
// the launch's clusters are the nm blocks of a row block, chunk and split
// (rank = own), kpos (nm, n2) is the own channel's K at each row's
// positive partner and wpos (nm, n2) the bf16 W_tot there.  blockIdx.y = chunk x nm + own; split 0 writes dz (and,
// chunk 0 of MIX, dalpha and a per-block dbeta partial), split s > 0 its
// partials in part (the layout of gram_grad.cuh's kernels).  z's rows lie
// at a stride of ld (a multiple of 8, z 16-byte aligned).
template <bool MIX>
__device__ __forceinline__ void gram_grad_bf16(
    const __nv_bfloat16* __restrict__ z, const float* __restrict__ alpha,
    const float* __restrict__ beta, const float* __restrict__ lse,
    const float* __restrict__ coef, const float* __restrict__ v,
    const float* __restrict__ kpos, const float* __restrict__ wpos,
    float* __restrict__ dz, float* __restrict__ dalpha,
    float* __restrict__ part, int nm, int chunks, int n2, int d,
    float inv_tau, int depth, int ld) {
  extern __shared__ __align__(16) unsigned char smem16[];
  const bool res = resident(chunks);
  // rc > 1: the cluster of the rc chunk blocks splits K's rows (NT-Xent)
  const int rc = row_split(MIX, chunks), rs = row_stride(d);
  const int slot = slot_elems(MIX, chunks);
  __nv_bfloat16* rows_res = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* ring =
      rows_res + (res ? ROWS * Z_STRIDE : rc > 1 ? ROWS / rc * rs : 0);
  uint32_t* w_x = reinterpret_cast<uint32_t*>(ring + depth * slot);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int strip = warp % STRIPS, wp = warp / STRIPS;
  const int row0 = blockIdx.x * ROWS;
  // MIX: clusters of the nm modalities (y = chunk nm + own); NT-Xent
  // with rc > 1: of the rc chunks (y = own chunks + chunk)
  const int own = MIX ? blockIdx.y % nm : blockIdx.y / chunks;
  const int chunk = MIX ? blockIdx.y / nm : blockIdx.y % chunks;
  const int d8 = (d + 7) / 8, d16 = (d + 15) / 16;
  const int t0 = d8 * chunk / chunks, nt = d8 * (chunk + 1) / chunks - t0;
  // this warp's feature tiles [fa, fa + ntw) of the chunk's nt
  const int fa = nt * wp / PARTS, ntw = nt * (wp + 1) / PARTS - fa;
  const int n_ct = (n2 + COLS - 1) / COLS;
  const int ct0 = n_ct * blockIdx.z / gridDim.z;
  const int ct1 = n_ct * (blockIdx.z + 1) / gridDim.z;
  // K slabs: rows and columns, KD16 deep; with rc > 1 columns only, as
  // deep as a Z slot
  const int kd16 = rc > 1 ? NT / 2 : KD16;
  const int nslab = (d16 + kd16 - 1) / kd16;
  const int per_tile = res ? 1 : nslab + 1;
  const int steps = (ct1 - ct0) * per_tile;
  const __nv_bfloat16* z_own = z + (size_t)own * n2 * ld;

  Rows R;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    R.gr[h] = row0 + 16 * strip + g + 8 * h;
    R.ok[h] = R.gr[h] < n2;
    R.pos[h] = R.gr[h] < n2 / 2 ? R.gr[h] + n2 / 2 : R.gr[h] - n2 / 2;
    R.v[h] = R.ok[h] ? v[R.gr[h]] : 0.f;
  }

  // step i of column tile ct into a ring slot: resident, the tile over
  // every feature; else K slab i (the block's rows and the tile's
  // columns), then the Z step (the tile over the chunk's features and one
  // more tile, for wz_tile's pairs)
  auto load = [&](int ct, int i, __nv_bfloat16* buf) {
    const int col0 = ct * COLS;
    if (res) {
      stage(z_own, n2, d, ld, col0, COLS, 0, 16 * d16, buf, Z_STRIDE);
    } else if (i < nslab && rc > 1) {
      const int k0 = 16 * (d16 * i / nslab), k1 = 16 * (d16 * (i + 1) / nslab);
      stage(z_own, n2, d, ld, col0, COLS, k0, k1 - k0, buf, Z_STRIDE);
    } else if (i < nslab) {
      const int k0 = 16 * (d16 * i / nslab), k1 = 16 * (d16 * (i + 1) / nslab);
      stage(z_own, n2, d, ld, row0, ROWS, k0, k1 - k0, buf, K_STRIDE);
      stage(z_own, n2, d, ld, col0, COLS, k0, k1 - k0, buf + ROWS * K_STRIDE,
            K_STRIDE);
    } else {
      stage(z_own, n2, d, ld, col0, COLS, 8 * t0, 8 * min(nt + 1, NT), buf,
            Z_STRIDE);
    }
  };
  int ld_ct = ct0, ld_i = 0, issued = 0, sl = 0, sc = 0;
  auto issue = [&]() {
    if (issued < steps) {
      load(ld_ct, ld_i, ring + sl * slot);
      if (++ld_i == per_tile) {
        ld_i = 0;
        ++ld_ct;
      }
      ++issued;
    }
    cp_async_commit();
    sl = sl + 1 == depth ? 0 : sl + 1;
  };
  // waits for the next step's slot; every thread is done with the last one
  auto next = [&]() -> const __nv_bfloat16* {
    cp_async_wait_dyn(depth - 2);
    __syncthreads();
    issue();
    const __nv_bfloat16* buf = ring + sc * slot;
    sc = sc + 1 == depth ? 0 : sc + 1;
    return buf;
  };
  if (res) {
    stage(z_own, n2, d, ld, row0, ROWS, 0, 16 * d16, rows_res, Z_STRIDE);
    cp_async_commit();
  } else if (rc > 1) {
    stage(z_own, n2, d, ld, row0 + ROWS / rc * chunk, ROWS / rc, 0, 16 * d16,
          rows_res, rs);
    cp_async_commit();
  }
  for (int q = 0; q < depth - 1; ++q) issue();

  float acc[NTW][4];
#pragma unroll
  for (int f = 0; f < NTW; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  float da[2] = {0.f, 0.f}, db = 0.f;
  // the strip's rows and the warp's columns in a slot of K data
  const int a_off = 16 * strip, b_off = ROWS + 8 * CN8 * wp;

  // rc > 1: this block's K units (its strips x n8 tiles), spread over
  // the warps; W of unit (sl, j) to its strip's fragments of the exchange
  const int spb = STRIPS / rc, units = 8 * spb;
  for (int ct = ct0; rc > 1 && ct < ct1; ++ct) {
    float k[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) k[u][e] = 0.f;
    for (int s = 0; s < nslab; ++s) {
      const __nv_bfloat16* buf = next();
      const int k16 = d16 * s / nslab, nk16 = d16 * (s + 1) / nslab - k16;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int un = warp + WARPS * u;
        if (un < units)
          k_tile1(rows_res + 16 * (un / 8) * rs + 16 * k16, rs,
                  buf + 8 * (un % 8) * Z_STRIDE, Z_STRIDE, nk16, k[u]);
      }
    }
    const __nv_bfloat16* zt = next();
    uint32_t* wxc = w_x + ((ct - ct0) & 1) * spb * 512 + lane;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int un = warp + WARPS * u;
      if (un < units) {
        const int sl = un / 8, j = un % 8;
        float wv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const int gr = row0 + 16 * (spb * chunk + sl) + g + 8 * h;
          const int gc = ct * COLS + 8 * j + 2 * t + e % 2;
          const bool okr = gr < n2, okc = gc < n2;
          const int pos = gr < n2 / 2 ? gr + n2 / 2 : gr - n2 / 2;
          const size_t ro = (size_t)own * n2 + (okr ? gr : 0);
          const size_t co = (size_t)own * n2 + (okc ? gc : 0);
          wv[e] = okr && okc
                      ? w_channel(k[u][e] * inv_tau, lse[ro], lse[co],
                                  coef[ro], coef[co], v[okr ? gr : 0],
                                  v[okc ? gc : 0], gc != gr, gc == pos,
                                  inv_tau)
                      : 0.f;
        }
        // n8 tile j is half of slice j / 2: registers 0, 1 or 2, 3
        uint32_t* x = wxc + sl * 512 + (4 * (j / 2) + 2 * (j % 2)) * 32;
        x[0] = pack_bf16(wv[0], wv[1]);
        x[32] = pack_bf16(wv[2], wv[3]);
      }
    }
    cluster_sync();
    const uint32_t wr =
        cluster_addr(wxc + (strip % spb) * 512, strip / spb);
    uint32_t w[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[i][r] = ld_cluster(wr + 4 * (4 * i + r) * 32);
    wz_tile(zt + 8 * fa, w, ntw, acc);
  }
  // no block leaves while another may read its exchange
  if (rc > 1) cluster_sync();

  for (int ct = ct0; rc == 1 && ct < ct1; ++ct) {
    const int col0 = ct * COLS + 8 * CN8 * wp;
    float k[CN8][4];
    uint32_t kb[CN8][2];     // MIX: the own channel's K in bf16
    float wa[CN8][4], wf[CN8][4];   // MIX: the mixtures' running sums
    const __nv_bfloat16* zt;
#pragma unroll
    for (int j = 0; j < CN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) k[j][e] = 0.f;
    if (res) {
      zt = next();
      k_tile(rows_res + a_off * Z_STRIDE, Z_STRIDE,
             zt + 8 * CN8 * wp * Z_STRIDE, Z_STRIDE, d16, k);
    } else {
      for (int s = 0; s < nslab; ++s) {
        const __nv_bfloat16* buf = next();
        k_tile(buf + a_off * K_STRIDE, K_STRIDE, buf + b_off * K_STRIDE,
               K_STRIDE, d16 * (s + 1) / nslab - d16 * s / nslab, k);
      }
      zt = next();
    }
    // MIX: this tile's K buffer, and the W exchange in the other one,
    // which every block of the cluster has done reading once it passes
    // this tile's cluster barrier
    uint32_t* w_xt = MIX ? w_x + (((ct - ct0) & 1) ^ 1) * K_WORDS : w_x;
    if (MIX) {
      // the own channel's K to the cluster, every channel's back for the
      // mixtures' running sums, in increasing m, from the fp32 K
      float* kx =
          reinterpret_cast<float*>(w_x + ((ct - ct0) & 1) * K_WORDS) + tid;
#pragma unroll
      for (int j = 0; j < CN8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) kx[(4 * j + e) * THREADS] = k[j][e];
      cluster_sync();
      for (int mi = 0; mi < nm; ++mi) {
        const uint32_t km = cluster_addr(kx, mi);
        const float bm = beta[mi];
        float ar[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ar[h] = R.ok[h] ? alpha[(size_t)R.gr[h] * nm + mi] : 0.f;
#pragma unroll
        for (int j = 0; j < CN8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gc = col0 + 8 * j + 2 * t + e % 2;
            const float ac = gc < n2 ? alpha[(size_t)gc * nm + mi] : 0.f;
            const float kv =
                __uint_as_float(ld_cluster(km + 4 * (4 * j + e) * THREADS));
            wa[j][e] = fmaf(ar[e / 2] * ac, kv, mi == 0 ? 0.f : wa[j][e]);
            wf[j][e] = fmaf(bm, kv, mi == 0 ? 0.f : wf[j][e]);
          }
      }
#pragma unroll
      for (int j = 0; j < CN8; ++j) {
        kb[j][0] = pack_bf16(k[j][0], k[j][1]);
        kb[j][1] = pack_bf16(k[j][2], k[j][3]);
      }
    }

    // this warp's CS k16 slices of the weight, rounded to bf16 as A
    // fragments of W z (n8 tiles 2i and 2i + 1 of K are slice i), to the
    // strip's exchange; the tile's four slices back after the strip's
    // barrier (the next step's block barrier orders the next tile's writes)
    uint32_t* wx = w_xt + strip * 4 * 4 * 32 + lane;
    float wrow[2][4];
#pragma unroll
    for (int j = 0; j < CN8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, gc = col0 + 8 * j + 2 * t + e % 2;
        const bool okc = gc < n2, ok = R.ok[h] && okc;
        const bool neq = gc != R.gr[h], oh = gc == R.pos[h];
        const float v_c = okc ? v[gc] : 0.f;
        const size_t ro = (size_t)own * n2 + (R.ok[h] ? R.gr[h] : 0);
        const size_t co = (size_t)own * n2 + (okc ? gc : 0);
        float kv = k[j][e];
        if (MIX) kv = e % 2 ? bf16_hi(kb[j][e / 2]) : bf16_lo(kb[j][e / 2]);
        if (MIX && oh && R.ok[h]) kv = kpos[(size_t)own * n2 + R.gr[h]];
        float wv = 0.f;
        if (ok)
          wv = w_channel(kv * inv_tau, lse[ro], lse[co], coef[ro], coef[co],
                         R.v[h], v_c, neq, oh, inv_tau);
        if (MIX) {
          const size_t ra = (size_t)nm * n2 + (R.ok[h] ? R.gr[h] : 0);
          const size_t ca = (size_t)nm * n2 + (okc ? gc : 0);
          const float ar = R.ok[h] ? alpha[(size_t)R.gr[h] * nm + own] : 0.f;
          const float ac = okc ? alpha[(size_t)gc * nm + own] : 0.f;
          const float w_a =
              ok ? w_channel(wa[j][e] * inv_tau, lse[ra], lse[ca], coef[ra],
                             coef[ca], R.v[h], v_c, neq, oh, inv_tau)
                 : 0.f;
          const float w_f =
              ok ? w_channel(wf[j][e] * inv_tau, lse[ra + n2], lse[ca + n2],
                             coef[ra + n2], coef[ca + n2], R.v[h], v_c, neq,
                             oh, inv_tau)
                 : 0.f;
          if (ok) wv += w_a * (ar * ac) + w_f * beta[own];
          // the positive pair's W_tot, rounded once from its f64 value
          if (oh && R.ok[h]) wv = wpos[(size_t)own * n2 + R.gr[h]];
          da[h] = fmaf(w_a * kv, ac, da[h]);
          db = fmaf(w_f, kv, db);
        }
        wrow[j % 2][e] = wv;
      }
      if (j % 2) {
        uint32_t* x = wx + (CS * wp + j / 2) * 4 * 32;
        x[0] = pack_bf16(wrow[0][0], wrow[0][1]);
        x[32] = pack_bf16(wrow[0][2], wrow[0][3]);
        x[64] = pack_bf16(wrow[1][0], wrow[1][1]);
        x[96] = pack_bf16(wrow[1][2], wrow[1][3]);
      }
    }
    // the strip's warps on barrier 1 + strip
    asm volatile("bar.sync %0, %1;" :: "r"(1 + strip), "r"(32 * PARTS)
                 : "memory");
    uint32_t w[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) w[i][r] = wx[(4 * i + r) * 32];
    wz_tile(zt + 8 * fa, w, ntw, acc);
  }
  // MIX: no block leaves while another may read its K
  if (MIX) cluster_sync();
  cp_async_wait<0>();

  // split 0 writes dz (and dalpha), split s > 0 its partials
  const int nb = gridDim.x, split = blockIdx.z;
  float* dz_out = dz;
  float* da_out = dalpha;
  if (split > 0) {
    if (MIX) {
      const size_t parts = (size_t)gridDim.z * nb * nm;
      da_out = part + parts + (size_t)(split - 1) * n2 * nm;
      dz_out = part + parts + (size_t)(gridDim.z - 1) * n2 * nm +
               (size_t)(split - 1) * nm * n2 * d;
    } else {
      dz_out = part + (size_t)(split - 1) * nm * n2 * d;
    }
  }
  dz_out += (size_t)own * n2 * d;
#pragma unroll
  for (int f = 0; f < NTW; ++f) {
    if (f < ntw) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, feat = 8 * (t0 + fa + f) + 2 * t + e % 2;
        if (R.ok[h] && feat < d) dz_out[(size_t)R.gr[h] * d + feat] = acc[f][e];
      }
    }
  }
  if (!MIX || chunk > 0) return;

  // dalpha: a row's 4 lanes, then its strip's warps, in order; dbeta:
  // the block's threads in order
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    da[h] += __shfl_xor_sync(0xffffffffu, da[h], 1);
    da[h] += __shfl_xor_sync(0xffffffffu, da[h], 2);
  }
  __syncthreads();                    // every warp is done with the ring
  if (t == 0) {
    red[THREADS + wp * ROWS + 16 * strip + g] = da[0];
    red[THREADS + wp * ROWS + 16 * strip + g + 8] = da[1];
  }
  red[tid] = db;
  __syncthreads();
  if (wp == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = red[THREADS + 16 * strip + g + 8 * h];
      for (int q = 1; q < PARTS; ++q)
        x += red[THREADS + q * ROWS + 16 * strip + g + 8 * h];
      if (R.ok[h]) da_out[(size_t)R.gr[h] * nm + own] = x;
    }
  }
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < THREADS; ++i) s += red[i];
    part[((size_t)split * nb + blockIdx.x) * nm + own] = s;
  }
}

// The two entries, named apart so that a profile tells them apart; one
// block of 16 warps an SM, at most 128 registers a thread.
__global__ void __launch_bounds__(THREADS, 1)
mixture_grad_bf16_kernel(const __nv_bfloat16* __restrict__ z,
                         const float* __restrict__ alpha,
                         const float* __restrict__ beta,
                         const float* __restrict__ lse,
                         const float* __restrict__ coef,
                         const float* __restrict__ v,
                         const float* __restrict__ kpos,
                         const float* __restrict__ wpos,
                         float* __restrict__ dz, float* __restrict__ dalpha,
                         float* __restrict__ part, int nm, int chunks, int n2,
                         int d, float inv_tau, int depth, int ld) {
  gram_grad_bf16<true>(z, alpha, beta, lse, coef, v, kpos, wpos, dz, dalpha,
                       part, nm, chunks, n2, d, inv_tau, depth, ld);
}

__global__ void __launch_bounds__(THREADS, 1)
ntxent_grad_bf16_mma_kernel(const __nv_bfloat16* __restrict__ z,
                            const float* __restrict__ lse,
                            const float* __restrict__ coef,
                            const float* __restrict__ v, float* __restrict__ dz,
                            float* __restrict__ part, int nm, int chunks,
                            int n2, int d, float inv_tau, int depth, int ld) {
  gram_grad_bf16<false>(z, nullptr, nullptr, lse, coef, v, nullptr, nullptr,
                        dz, nullptr, part, nm, chunks, n2, d, inv_tau, depth,
                        ld);
}

// zp (rows, ld) = z (rows, d) with zeros past d: rows of 16-byte multiples.
__device__ __forceinline__ void pad_rows(const __nv_bfloat16* __restrict__ z,
                                         __nv_bfloat16* __restrict__ zp,
                                         size_t rows, int d, int ld) {
  const uint16_t* src = reinterpret_cast<const uint16_t*>(z);
  const size_t units = rows * (ld / 8);
  for (size_t i = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x; i < units;
       i += (size_t)gridDim.x * REDUCE_THREADS) {
    const size_t r = i / (ld / 8);
    const int f0 = 8 * (int)(i - r * (ld / 8));
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = f0 + 2 * q;
      const uint32_t lo = f < d ? src[r * d + f] : 0u;
      const uint32_t hi = f + 1 < d ? src[r * d + f + 1] : 0u;
      w[q] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(zp + r * ld + f0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// x rounded once to bf16 (to nearest, ties to even), as a float: to fp32
// toward zero with the last bit set where that was inexact (round to odd),
// then to bf16; the twin's snag_loss.round_bf16_once.
__device__ __forceinline__ float round_bf16_once(double x) {
  uint32_t b = __float_as_uint(__double2float_rz(x));
  if ((double)__uint_as_float(b) != x) b |= 1u;
  return __bfloat162float(__float2bfloat16_rn(__uint_as_float(b)));
}

// W of one channel at (r, pos(r)) in f64: gram_grad.cuh's w_channel with
// neq true and onehot true; k the channel's value, unscaled.
__device__ __forceinline__ double w_positive(double k, float lse_r,
                                             float lse_c, float coef_r,
                                             float coef_c, float v_r,
                                             float v_c, double inv_tau) {
  const double s = k * inv_tau;
  const double p_row = exp(fmin(s - (double)lse_r, 0.0));
  const double p_col = exp(fmin(s - (double)lse_c, 0.0));
  return ((double)coef_r * p_row * (double)v_c +
          p_col * (double)coef_c * (double)v_r -
          ((double)coef_r + (double)coef_c)) * inv_tau;
}

// For each row r and its positive partner c = pos(r), with k_m the exact
// dot <z_m[r], z_m[c]> (the products of two bf16 are exact in fp32 and
// their sum exact in f64 at the loss's widths):
//   kpos[m, r] = k_m rounded once to bf16;
//   wpos[m, r] = W_tot[m, r, c] in f64, rounded once to bf16, where W_m
//     reads kpos, W_a the exact mix_a = sum_m a_rm a_cm k_m and W_f the
//     exact mix_f = sum_m beta_m k_m (increasing m), from the f32 lse,
//     coef, v, alpha and beta.
// Both sides (the twin: snag_loss.positive_k, positive_w) round the same
// values.  A warp a row: lanes over features for each modality's dot, in
// a fixed order; then lane m < nm forms modality m's two values.
__global__ void __launch_bounds__(REDUCE_THREADS)
mixture_kpos_bf16_kernel(const __nv_bfloat16* __restrict__ z,
                         const float* __restrict__ alpha,
                         const float* __restrict__ beta,
                         const float* __restrict__ lse,
                         const float* __restrict__ coef,
                         const float* __restrict__ v,
                         float* __restrict__ kpos, float* __restrict__ wpos,
                         int nm, int n2, int d, float inv_tau) {
  const int lane = threadIdx.x % 32;
  for (size_t i = ((size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x) / 32;
       i < (size_t)n2; i += (size_t)gridDim.x * REDUCE_THREADS / 32) {
    const int r = (int)i;
    const int c = r < n2 / 2 ? r + n2 / 2 : r - n2 / 2;
    double k[MAX_MOD];   // nm <= MAX_MOD (check_shape)
    double mix_a = 0.0, mix_f = 0.0;
    for (int m = 0; m < nm; ++m) {
      const __nv_bfloat16* a = z + ((size_t)m * n2 + r) * d;
      const __nv_bfloat16* b = z + ((size_t)m * n2 + c) * d;
      double s = 0.0;
      for (int f = lane; f < d; f += 32)
        s += (double)(__bfloat162float(a[f]) * __bfloat162float(b[f]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      k[m] = s;
      mix_a += (double)alpha[(size_t)r * nm + m] *
               (double)alpha[(size_t)c * nm + m] * s;
      mix_f += (double)beta[m] * s;
    }
    const double it = (double)inv_tau;
    const size_t ra = (size_t)nm * n2 + r, ca = (size_t)nm * n2 + c;
    const float v_r = v[r], v_c = v[c];
    for (int m = lane; m < nm; m += 32) {
      const float kb = round_bf16_once(k[m]);
      const size_t ro = (size_t)m * n2 + r, co = (size_t)m * n2 + c;
      const double w_tot =
          w_positive(kb, lse[ro], lse[co], coef[ro], coef[co], v_r, v_c, it) +
          w_positive(mix_a, lse[ra], lse[ca], coef[ra], coef[ca], v_r, v_c,
                     it) * ((double)alpha[(size_t)r * nm + m] *
                            (double)alpha[(size_t)c * nm + m]) +
          w_positive(mix_f, lse[ra + n2], lse[ca + n2], coef[ra + n2],
                     coef[ca + n2], v_r, v_c, it) * (double)beta[m];
      kpos[ro] = kb;
      wpos[ro] = round_bf16_once(w_tot);
    }
  }
}

// named after their entries, so that a profile counts them there
__global__ void __launch_bounds__(REDUCE_THREADS)
ntxent_grad_bf16_pad_kernel(const __nv_bfloat16* __restrict__ z,
                            __nv_bfloat16* __restrict__ zp, size_t rows, int d,
                            int ld) {
  pad_rows(z, zp, rows, d, ld);
}

__global__ void __launch_bounds__(REDUCE_THREADS)
mixture_grad_bf16_pad_kernel(const __nv_bfloat16* __restrict__ z,
                             __nv_bfloat16* __restrict__ zp, size_t rows, int d,
                             int ld) {
  pad_rows(z, zp, rows, d, ld);
}

// z's row stride in the kernel: d where d % 8 == 0, else the padded copy's
// round8(d).  z itself must be 16-byte aligned (the wrappers see to it).
int z_stride(int d) { return (d + 7) / 8 * 8; }

// The floats of scratch before the padded copy of z, and the copy's.
size_t pad_offset(size_t scratch) { return (scratch + 3) / 4 * 4; }
size_t pad_floats(int m, int n2, int d) {
  return d % 8 ? ((size_t)m * n2 * z_stride(d) + 1) / 2 : 0;
}

// How a bf16 gradient kernel runs on this device:
//   chunks   balanced feature chunks of at most NT n8 tiles;
//   resident whether the block's rows stay in shared memory (NT-Xent in
//            one chunk: one slot a column tile);
//   depth    the deepest ring that fits;
//   splits   blocks that share a row block's column tiles, chosen so that
//            the last wave fills the SMs (gram_grad.cuh's rule);
//   scratch  the floats of partials (and, for the mixture, of per-block
//            dbeta), in gram_grad.cuh's layout, for the mixture kpos (from
//            kpos_at) and wpos (after it), then, where d % 8 != 0, z's padded copy (from
//            pad_offset).
// kernel must already take all the shared memory a block may opt in to.
struct Plan {
  int chunks, depth, splits, per_sm, rows, resident, cluster;
  size_t bytes, scratch, kpos_at, pad_at;   // wpos at kpos_at + m n2
};

template <bool MIX>
int plan(const void* kernel, int m, int n2, int d, Plan& p) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d8 = (d + 7) / 8;
  p.chunks = (d8 + NT - 1) / NT;
  // NT-Xent: 2, 4 or 8 chunks, a cluster that splits K's rows
  if (!MIX && p.chunks > 1 && p.chunks <= 8)
    p.chunks = p.chunks <= 2 ? 2 : p.chunks <= 4 ? 4 : 8;
  if ((long)m * p.chunks > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  p.rows = ROWS;
  p.resident = resident(p.chunks);
  p.cluster = MIX ? m : row_split(MIX, p.chunks);
  p.depth = MAX_DEPTH;
  while (p.depth > MIN_DEPTH &&
         smem_bytes(MIX, p.chunks, d, p.depth) > (size_t)optin)
    --p.depth;
  p.bytes = smem_bytes(MIX, p.chunks, d, p.depth);
  if (p.bytes > (size_t)optin)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, kernel,
                                                      THREADS, p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n2 + ROWS - 1) / ROWS;
  const int n_ct = (n2 + COLS - 1) / COLS;
  const long blocks = (long)nb * m * p.chunks;
  const long slots = (long)sms * (p.per_sm > 0 ? p.per_sm : 1);
  auto fill = [&](int s) {
    const long b = blocks * s;
    return (double)b / (double)(((b + slots - 1) / slots) * slots);
  };
  p.splits = 1;
  for (int s = 2; s <= 4 && s <= n_ct; ++s)
    if (fill(s) > fill(p.splits) + 0.03) p.splits = s;
  const size_t n_dz = (size_t)m * n2 * d;
  p.scratch = (size_t)(p.splits - 1) * n_dz;
  if (MIX)
    p.scratch += (size_t)p.splits * nb * m + (size_t)(p.splits - 1) * n2 * m;
  p.kpos_at = p.scratch;
  if (MIX) p.scratch += 2 * (size_t)m * n2;
  p.pad_at = pad_offset(p.scratch);
  if (d % 8) p.scratch = p.pad_at + pad_floats(m, n2, d);
  return 0;
}

}  // namespace grad16
}  // namespace
