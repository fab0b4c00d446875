// The gradient of row-logsumexp losses over Gram channels K_m = z_m z_m^T,
// shared by the mixture gradient (snag_loss.cu, MIX = true) and the NT-Xent
// gradient (ntxent.cu, MIX = false).  z is (M, n2 = 2B, d) with unit rows,
// v (n2,) marks valid columns, the positive partner of row r is r + B or
// r - B, and with S = channel / tau and p = exp(min(S - lse, 0)) a
// channel's weight is the G + G^T fold of the symmetric S:
//     W = ((c != r)(coef_r p_row v_c + p_col coef_c v_r)
//          - [c == pos(r)](coef_r + coef_c)) / tau.
// NT-Xent: dz_m = W_m z_m.  The mixture adds two channels built from every
// K_m (snag_loss.cu has their formulas) and also writes dalpha and dbeta.
//
// Both products, K and W z, run on the tensor cores in 3xTF32
// (tile_mma.cuh).  Each k8 step of K starts from zero and is added in
// fp32, because the tensor cores truncate when they accumulate.  fp32 z
// only: bf16 z has its own kernel, gram_grad_bf16.cuh.
//
// A block of 8 warps owns 32 rows and walks a share of the column tiles of
// 64.  Per tile it computes the K tiles it needs into registers (C
// fragments, 8 floats a thread per channel: every modality for the
// mixtures, the block's batch for NT-Xent), then per modality of its group
// the weight W (into shared memory) and W z into the (modalities x 32 rows
// x features) row accumulator.  The accumulator lives in shared memory in
// C-fragment order, so each element belongs to one thread and the per-tile
// read-modify-write needs no barrier.  Operands stream through a ring of up
// to four cp.async slots, one barrier a step.
//
// blockIdx.y: the group, the mixtures' modalities a block holds (where
// the accumulator of every modality does not fit, each group recomputing
// every K tile), NT-Xent's batch.  A block's accumulator holds all of d;
// past that (grad_fits), the wide body below runs instead.
// blockIdx.z: up to four blocks share a row tile's column tiles where that
// fills the last wave; the blocks past the first write partials that a
// second kernel adds in a fixed order.  No float atomics: two runs give the
// same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

#include "tile_mma.cuh"

namespace {

constexpr int MAX_MOD = 6;
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float w_channel(float s, float lse_r, float lse_c,
                                           float coef_r, float coef_c,
                                           float v_r, float v_c, bool neq,
                                           bool onehot, float inv_tau) {
  const float p_row = expf(fminf(s - lse_r, 0.f));
  const float p_col = expf(fminf(s - lse_c, 0.f));
  float w = neq ? coef_r * p_row * v_c + p_col * coef_c * v_r : 0.f;
  if (onehot) w -= coef_r + coef_c;
  return w * inv_tau;
}

// out[i] += part[0][i] + part[1][i] + ..., in that order (the column
// splits' partials, by a grid-stride loop of REDUCE_THREADS blocks).
__device__ __forceinline__ void add_partials(float* __restrict__ out,
                                             const float* __restrict__ part,
                                             size_t n, int parts) {
  for (size_t i = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * REDUCE_THREADS) {
    float s = out[i];
    for (int p = 0; p < parts; ++p) s += part[(size_t)p * n + i];
    out[i] = s;
  }
}

namespace grad {

constexpr int ROWS = 32;             // rows per block: two m16 tiles
constexpr int COLS = 64;             // columns per tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
// K tile: warp w owns rows (w % 2) * 16 + [0, 16) and columns
// (w / 2) * 16 + [0, 16), two n8 tiles.  A K step stages the tile's rows
// and columns KD deep.  Fragments take k slots t and t + 4 from elements
// 2t and 2t + 1 of each k8 slice (tile_mma.cuh), one 64-bit load; the row
// strides keep a half-warp's loads on distinct banks.
constexpr int KD = 32;
constexpr int KD_STRIDE = KD + 8;                 // 40 = 8 mod 32
constexpr int K_SLOT = (ROWS + COLS) * KD_STRIDE;
// W z: a pass covers up to PASS_TILES n8 feature tiles; warp w takes the
// pass's tiles w, w + WARPS, ... over both m16 row tiles.  A Z step stages
// 8 rows of z over the pass's features.
constexpr int NT = 5;
constexpr int PASS_TILES = WARPS * NT;            // 320 features
constexpr int Z_STRIDE = 8 * PASS_TILES + 4;      // 324 = 4 mod 32
constexpr int Z_SLOT = 8 * Z_STRIDE;
constexpr int SLOT = K_SLOT > Z_SLOT ? K_SLOT : Z_SLOT;
constexpr int MIN_DEPTH = 2, MAX_DEPTH = 4;       // slots in the cp.async ring
constexpr int W_STRIDE = COLS + 8;                // 72 = 8 mod 32
constexpr int W_FLOATS = ROWS * W_STRIDE;
// the accumulator of one n8 feature tile: 2 m16 tiles x 32 lanes x 4
constexpr int TILE_FLOATS = 2 * 32 * 4;
static_assert(MAX_MOD * (4 * ROWS + THREADS) <= MIN_DEPTH * SLOT,
              "the final reductions exceed the ring");

// a block's shared memory: the ring, W, and mg accumulators of d columns
size_t smem_bytes(int depth, int mg, int d) {
  return sizeof(float) * (depth * (size_t)SLOT + W_FLOATS +
                          (size_t)TILE_FLOATS * mg * ((d + 7) / 8));
}

// The block's work is one stream of steps, each one ring slot: per column
// tile, for each of the nk channels that feed K the K steps s (depth
// [s KD, (s + 1) KD)), then for each modality mi of the block's group and
// each pass p the Z steps s (rows [col0 + 8 s, col0 + 8 s + 8) of z_m).  A
// Cursor walks it ahead of the compute, for the loads.
struct Cursor {
  int ct, m, p, s;
  bool k;
};

__device__ __forceinline__ void advance(Cursor& c, int nk, int ks, int nmy,
                                        int passes, int zs) {
  if (++c.s < (c.k ? ks : zs)) return;
  c.s = 0;
  if (c.k) {
    if (++c.m < nk) return;
    c.k = false;
    c.m = c.p = 0;
    return;
  }
  if (++c.p < passes) return;
  c.p = 0;
  if (++c.m < nmy) return;
  c.m = 0;
  c.k = true;
  ++c.ct;
}

// A K step: rows [row0, row0 + ROWS) of z_m into buf[0 .. ROWS) and rows
// [col0, col0 + COLS) into buf[ROWS ..), depth [k0, k0 + KD); rows >= n
// and depth >= d read as 0.
template <bool VEC>
__device__ __forceinline__ void load_k(const float* __restrict__ zm, int n,
                                       int d, int row0, int col0, int k0,
                                       float* buf) {
  constexpr int R = ROWS + COLS;
  if (VEC) {
    for (int i = threadIdx.x; i < R * KD / 4; i += THREADS) {
      const int r = i / (KD / 4), k = (i % (KD / 4)) * 4;
      const int gr = r < ROWS ? row0 + r : col0 + r - ROWS;
      const bool ok = gr < n && k0 + k < d;
      cp_async16(buf + r * KD_STRIDE + k,
                 ok ? zm + (size_t)gr * d + k0 + k : zm, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * KD; i += THREADS) {
      const int r = i / KD, k = i % KD;
      const int gr = r < ROWS ? row0 + r : col0 + r - ROWS;
      const bool ok = gr < n && k0 + k < d;
      cp_async4(buf + r * KD_STRIDE + k,
                ok ? zm + (size_t)gr * d + k0 + k : zm, ok);
    }
  }
}

// A Z step: rows [c0, c0 + 8) of z_m, features [f0, f0 + nf), into
// buf[8][Z_STRIDE]; rows >= n and features >= d read as 0.
template <bool VEC>
__device__ __forceinline__ void load_z(const float* __restrict__ zm, int n,
                                       int d, int c0, int f0, int nf,
                                       float* buf) {
  static_assert(WARPS == 8, "one warp per staged row");
  const int r = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool okr = c0 + r < n;
  const float* src = zm + (size_t)(c0 + r) * d + f0;
  float* dst = buf + r * Z_STRIDE;
  if (VEC) {
    for (int f = 4 * lane; f < nf; f += 128) {
      const bool ok = okr && f0 + f < d;
      cp_async16(dst + f, ok ? src + f : zm, ok);
    }
  } else {
    for (int f = lane; f < nf; f += 32) {
      const bool ok = okr && f0 + f < d;
      cp_async4(dst + f, ok ? src + f : zm, ok);
    }
  }
}

// acc[nt] += this warp's n8 tile nt of the staged K slice, in 3xTF32.
// Each k8 step starts from zero and is added in fp32: the tensor cores
// truncate when they accumulate, a bias that would grow with the running
// sum and that the exp multiplies by 1/tau.
__device__ __forceinline__ void k_step(const float* buf, float (&acc)[2][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float* ar = buf + ((warp % 2) * 16 + g) * KD_STRIDE + 2 * t;
  const float* br = buf + (ROWS + (warp / 2) * 16 + g) * KD_STRIDE + 2 * t;
#pragma unroll
  for (int kk = 0; kk < KD; kk += 8) {
    const float2 a0 = *reinterpret_cast<const float2*>(ar + kk);
    const float2 a1 = *reinterpret_cast<const float2*>(ar + kk + 8 * KD_STRIDE);
    uint32_t a_hi[4], a_lo[4];
    split_tf32(a0.x, a_hi[0], a_lo[0]);
    split_tf32(a1.x, a_hi[1], a_lo[1]);
    split_tf32(a0.y, a_hi[2], a_lo[2]);
    split_tf32(a1.y, a_hi[3], a_lo[3]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float2 b = *reinterpret_cast<const float2*>(br + nt * 8 * KD_STRIDE + kk);
      uint32_t b_hi[2], b_lo[2];
      split_tf32(b.x, b_hi[0], b_lo[0]);
      split_tf32(b.y, b_hi[1], b_lo[1]);
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32x3(p, a_hi, a_lo, b_hi, b_lo);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += p[e];
    }
  }
}

// part[i][mt] += W (rows mt * 16 .., columns 8 s .. 8 s + 8) times the
// staged 8 rows of z over this warp's i-th n8 feature tile of the pass, in
// 3xTF32; cnt is the pass's number of feature tiles.
__device__ __forceinline__ void z_step(const float* buf, const float* w, int s,
                                       int cnt, float (&part)[NT][2][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float* wr = w + (mt * 16 + g) * W_STRIDE + 8 * s + 2 * t;
    const float2 a0 = *reinterpret_cast<const float2*>(wr);
    const float2 a1 = *reinterpret_cast<const float2*>(wr + 8 * W_STRIDE);
    split_tf32(a0.x, a_hi[mt][0], a_lo[mt][0]);
    split_tf32(a1.x, a_hi[mt][1], a_lo[mt][1]);
    split_tf32(a0.y, a_hi[mt][2], a_lo[mt][2]);
    split_tf32(a1.y, a_hi[mt][3], a_lo[mt][3]);
  }
  // no branch, so that the loads and the ten product chains interleave: a
  // slot past the pass recomputes its last tile, and add_part drops it
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int lt = min(warp + WARPS * i, cnt - 1);
    uint32_t b_hi[2], b_lo[2];
    split_tf32(buf[2 * t * Z_STRIDE + 8 * lt + g], b_hi[0], b_lo[0]);
    split_tf32(buf[(2 * t + 1) * Z_STRIDE + 8 * lt + g], b_hi[1], b_lo[1]);
    mma_tf32x3(part[i][0], a_hi[0], a_lo[0], b_hi, b_lo);
    mma_tf32x3(part[i][1], a_hi[1], a_lo[1], b_hi, b_lo);
  }
}

// acc (TILE_FLOATS per feature tile, C-fragment order, each element owned
// by one thread) += part over the pass's tiles from p0.
__device__ __forceinline__ void add_part(float* acc, int p0, int cnt,
                                         const float (&part)[NT][2][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int lt = warp + WARPS * i;
    if (lt < cnt) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float4* p = reinterpret_cast<float4*>(
                        acc + ((size_t)(p0 + lt) * 2 + mt) * 128) + lane;
        float4 x = *p;
        x.x += part[i][mt][0];
        x.y += part[i][mt][1];
        x.z += part[i][mt][2];
        x.w += part[i][mt][3];
        *p = x;
      }
    }
  }
}

// k[m] = x and x = k[m], with m known only at run time (k stays in
// registers).
template <int KM>
__device__ __forceinline__ void put_tile(float (&k)[KM][2][4], int m,
                                         const float (&x)[2][4]) {
#pragma unroll
  for (int j = 0; j < KM; ++j)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (j == m) k[j][nt][i] = x[nt][i];
}

template <int KM>
__device__ __forceinline__ void get_tile(const float (&k)[KM][2][4], int m,
                                         float (&x)[2][4]) {
#pragma unroll
  for (int j = 0; j < KM; ++j)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (j == m) x[nt][i] = k[j][nt][i];
}

// What a thread knows of its two rows (h) of every tile: element i of n8
// tile nt of its K fragments sits in row lr[i / 2] and column
// lc[2 nt + i % 2] of the tile.
struct Rows {
  int lr[2], lc[4], gr[2], pos[2];
  bool ok[2];
  float v[2];
};

// The weight of modality m (K tile k[km]) for the current column tile
// into w (fp32).  MIX: the combined weight W_m + W_a alpha_r alpha_c +
// W_f beta_m, and its dalpha and dbeta terms into da and db.
template <bool MIX, int KM>
__device__ __forceinline__ void weight_tile(
    const float (&k)[KM][2][4], const float (&w_a)[2][4],
    const float (&w_f)[2][4], const Rows& R, const int (&gc)[4],
    const bool (&okc)[4], const float (&v_c)[4], const float* __restrict__ alpha,
    const float* __restrict__ beta, const float* __restrict__ lse,
    const float* __restrict__ coef, int m, int km, int nm, int n2,
    float inv_tau, float* w, float (&da)[2], float& db) {
  float kt[2][4];
  get_tile(k, km, kt);
  float bm = 0.f, ar[2], ac[4];
  float lm_r[2], cm_r[2], lm_c[4], cm_c[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (MIX) ar[h] = R.ok[h] ? alpha[(size_t)R.gr[h] * nm + m] : 0.f;
    lm_r[h] = R.ok[h] ? lse[(size_t)m * n2 + R.gr[h]] : 0.f;
    cm_r[h] = R.ok[h] ? coef[(size_t)m * n2 + R.gr[h]] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (MIX) ac[j] = okc[j] ? alpha[(size_t)gc[j] * nm + m] : 0.f;
    lm_c[j] = okc[j] ? lse[(size_t)m * n2 + gc[j]] : 0.f;
    cm_c[j] = okc[j] ? coef[(size_t)m * n2 + gc[j]] : 0.f;
  }
  if (MIX) bm = beta[m];
  da[0] = da[1] = db = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i / 2, j = 2 * nt + i % 2;
      const float kv = kt[nt][i];
      float wv = 0.f;
      if (R.ok[h] && okc[j]) {
        wv = w_channel(kv * inv_tau, lm_r[h], lm_c[j], cm_r[h], cm_c[j],
                       R.v[h], v_c[j], gc[j] != R.gr[h], gc[j] == R.pos[h],
                       inv_tau);
        if (MIX) wv += w_a[nt][i] * (ar[h] * ac[j]) + w_f[nt][i] * bm;
      }
      w[R.lr[h] * W_STRIDE + R.lc[j]] = wv;
      if (MIX) {
        da[h] = fmaf(w_a[nt][i] * kv, ac[j], da[h]);
        db = fmaf(w_f[nt][i], kv, db);
      }
    }
}

// The kernel's body.  MIX: z, alpha, beta, lse and coef (nm + 2, n2) as in
// snag_loss.cu, blockIdx.y the group of mg modalities from m0; dz, dalpha
// and per-block dbeta partials (split 0), or the split's partials in part.
// !MIX: alpha, beta and dalpha unused, lse and coef (nm, n2), mg = 1,
// blockIdx.y the batch; dz (split 0) or the split's dz partials in part.
template <bool MIX, bool VEC>
__device__ __forceinline__ void gram_grad(
    const float* __restrict__ z, const float* __restrict__ alpha,
    const float* __restrict__ beta, const float* __restrict__ lse,
    const float* __restrict__ coef, const float* __restrict__ v,
    float* __restrict__ dz, float* __restrict__ dalpha,
    float* __restrict__ part, int nm, int mg, int n2, int d, float inv_tau,
    int depth) {
  constexpr int ZS = 8;
  constexpr int Z_STEPS = COLS / ZS;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* w = ring + depth * SLOT;
  float* accs = w + W_FLOATS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * ROWS;
  const int m0 = MIX ? blockIdx.y * mg : blockIdx.y;
  // K tiles: every modality for the mixtures, else the block's batch
  constexpr int KM = MIX ? MAX_MOD : 1;
  const int mk0 = MIX ? 0 : m0;
  const int nk = MIX ? nm : 1;
  // this block's share of the column tiles (blockIdx.z of gridDim.z)
  const int n_ct = (n2 + COLS - 1) / COLS;
  const int ct0 = n_ct * blockIdx.z / gridDim.z;
  const int ct1 = n_ct * (blockIdx.z + 1) / gridDim.z;
  const int nmy = MIX ? min(mg, nm - m0) : 1;
  // d's (d + 7) / 8 feature tiles
  const int ntiles = (d + 7) / 8;
  const size_t acc_floats = (size_t)TILE_FLOATS * ntiles;
  const int ks = (d + KD - 1) / KD;
  const int passes = (ntiles + PASS_TILES - 1) / PASS_TILES;
  const int steps = (ct1 - ct0) * (nk * ks + nmy * Z_STEPS * passes);

  // (the first step's barrier publishes the zeros)
  for (size_t i = tid; i < nmy * acc_floats; i += THREADS) accs[i] = 0.f;

  Rows R;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    R.lr[h] = (warp % 2) * 16 + g + 8 * h;
    R.gr[h] = row0 + R.lr[h];
    R.ok[h] = R.gr[h] < n2;
    R.pos[h] = R.gr[h] < n2 / 2 ? R.gr[h] + n2 / 2 : R.gr[h] - n2 / 2;
    R.v[h] = R.ok[h] ? v[R.gr[h]] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) R.lc[j] = (warp / 2) * 16 + (j / 2) * 8 + 2 * t + j % 2;

  float dap[MAX_MOD][2], dbp[MAX_MOD];
  if (MIX) {
#pragma unroll
    for (int j = 0; j < MAX_MOD; ++j) dap[j][0] = dap[j][1] = dbp[j] = 0.f;
  }

  // the ring: ld is the next step to load into slot sl, issued counts
  // them; slot sc holds the step to compute
  Cursor ld = {ct0, 0, 0, 0, true};
  int sl = 0, sc = 0, issued = 0;
  auto issue = [&]() {
    if (issued < steps) {
      const int col0 = ld.ct * COLS;
      float* buf = ring + sl * SLOT;
      if (ld.k) {
        load_k<VEC>(z + (size_t)(mk0 + ld.m) * n2 * d, n2, d, row0, col0,
                    ld.s * KD, buf);
      } else {
        const int p0 = ld.p * PASS_TILES;
        load_z<VEC>(z + (size_t)(m0 + ld.m) * n2 * d, n2, d, col0 + ZS * ld.s,
                    8 * p0, 8 * min(PASS_TILES, ntiles - p0), buf);
      }
      advance(ld, nk, ks, nmy, passes, Z_STEPS);
      ++issued;
    }
    cp_async_commit();
    sl = sl + 1 == depth ? 0 : sl + 1;
  };
  // waits for the next step's slot; every thread is done with the last one
  auto next = [&]() -> const float* {
    cp_async_wait_dyn(depth - 2);
    __syncthreads();
    issue();
    const float* buf = ring + sc * SLOT;
    sc = sc + 1 == depth ? 0 : sc + 1;
    return buf;
  };
  for (int q = 0; q < depth - 1; ++q) issue();

  for (int col0 = ct0 * COLS; col0 < ct1 * COLS; col0 += COLS) {
    // the K tiles, once
    float k[KM][2][4];
    for (int m = 0; m < nk; ++m) {
      float kacc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) kacc[nt][i] = 0.f;
      for (int s = 0; s < ks; ++s) k_step(next(), kacc);
      put_tile(k, m, kacc);
    }

    int gc[4];
    bool okc[4];
    float v_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      gc[j] = col0 + R.lc[j];
      okc[j] = gc[j] < n2;
      v_c[j] = okc[j] ? v[gc[j]] : 0.f;
    }
    // the mixtures, then their weights W_a and W_f, in registers
    float w_a[2][4], w_f[2][4];
    if (MIX) {
      float la_c[4], lf_c[4], ca_c[4], cf_c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        la_c[j] = okc[j] ? lse[(size_t)nm * n2 + gc[j]] : 0.f;
        lf_c[j] = okc[j] ? lse[(size_t)(nm + 1) * n2 + gc[j]] : 0.f;
        ca_c[j] = okc[j] ? coef[(size_t)nm * n2 + gc[j]] : 0.f;
        cf_c[j] = okc[j] ? coef[(size_t)(nm + 1) * n2 + gc[j]] : 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) w_a[nt][i] = w_f[nt][i] = 0.f;
#pragma unroll
      for (int m = 0; m < KM; ++m) {
        if (m < nm) {
          const float bm = beta[m];
          float ar[2], ac[4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ar[h] = R.ok[h] ? alpha[(size_t)R.gr[h] * nm + m] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ac[j] = okc[j] ? alpha[(size_t)gc[j] * nm + m] : 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int h = i / 2, j = 2 * nt + i % 2;
              w_a[nt][i] = fmaf(ar[h] * ac[j], k[m][nt][i], w_a[nt][i]);
              w_f[nt][i] = fmaf(bm, k[m][nt][i], w_f[nt][i]);
            }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t ra = (size_t)nm * n2 + R.gr[h], rf = ra + n2;
        const float la_r = R.ok[h] ? lse[ra] : 0.f;
        const float lf_r = R.ok[h] ? lse[rf] : 0.f;
        const float ca_r = R.ok[h] ? coef[ra] : 0.f;
        const float cf_r = R.ok[h] ? coef[rf] : 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * h + e, j = 2 * nt + e;
            const bool ok = R.ok[h] && okc[j];
            const bool neq = gc[j] != R.gr[h], oh = gc[j] == R.pos[h];
            w_a[nt][i] = ok ? w_channel(w_a[nt][i] * inv_tau, la_r, la_c[j],
                                        ca_r, ca_c[j], R.v[h], v_c[j], neq, oh,
                                        inv_tau)
                            : 0.f;
            w_f[nt][i] = ok ? w_channel(w_f[nt][i] * inv_tau, lf_r, lf_c[j],
                                        cf_r, cf_c[j], R.v[h], v_c[j], neq, oh,
                                        inv_tau)
                            : 0.f;
          }
      }
    }

    // this block's modalities: the weight into shared memory (the next
    // step's barrier publishes it), dalpha and dbeta terms, then W z into
    // the accumulator
    for (int mi = 0; mi < nmy; ++mi) {
      if (mi > 0) __syncthreads();   // every warp is done with the last W
      float da[2], db;
      weight_tile<MIX, KM>(k, w_a, w_f, R, gc, okc, v_c, alpha, beta, lse,
                           coef, m0 + mi, MIX ? m0 + mi : 0, nm, n2, inv_tau,
                           w, da, db);
      if (MIX) {
#pragma unroll
        for (int j = 0; j < MAX_MOD; ++j) {
          if (j == mi) {
            dap[j][0] += da[0];
            dap[j][1] += da[1];
            dbp[j] += db;
          }
        }
      }
      for (int p0 = 0; p0 < ntiles; p0 += PASS_TILES) {
        const int cnt = min(PASS_TILES, ntiles - p0);
        float part[NT][2][4];
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][mt][e] = 0.f;
        for (int s = 0; s < Z_STEPS; ++s) z_step(next(), w, s, cnt, part);
        add_part(accs + mi * acc_floats, p0, cnt, part);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // split 0 writes dz (and dalpha), split s > 0 its partials (the scratch
  // layout of mixture_grad and ntxent_grad)
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

  // dz from the C-fragment order of the accumulator
  for (int mi = 0; mi < nmy; ++mi) {
    const float* acc_m = accs + mi * acc_floats;
    float* dz_m = dz_out + (size_t)(m0 + mi) * n2 * d;
    for (int i = tid; i < ROWS * d; i += THREADS) {
      const int r = i / d, f = i % d;
      if (row0 + r >= n2) continue;
      const int rr = r % 16, col = f % 8;
      const int ln = (rr % 8) * 4 + col / 2, e = (rr / 8) * 2 + col % 2;
      dz_m[(size_t)(row0 + r) * d + f] =
          acc_m[((size_t)(f / 8) * 2 + r / 16) * 128 + ln * 4 + e];
    }
  }
  if (!MIX) return;

  // dalpha: a row's 4 lanes, then its 4 column warps in order; dbeta: the
  // block's threads in order
  float* dbeta_part = part;
  float* red_a = ring;                          // [MAX_MOD][4][ROWS]
  float* red_b = ring + MAX_MOD * 4 * ROWS;     // [MAX_MOD][THREADS]
#pragma unroll
  for (int j = 0; j < MAX_MOD; ++j) {
    if (j < nmy) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = dap[j][h];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (t == 0) red_a[(j * 4 + warp / 2) * ROWS + R.lr[h]] = x;
      }
      red_b[j * THREADS + tid] = dbp[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < nmy * ROWS; i += THREADS) {
    const int mi = i / ROWS, r = i % ROWS;
    if (row0 + r >= n2) continue;
    const float* ra = red_a + mi * 4 * ROWS + r;
    da_out[(size_t)(row0 + r) * nm + m0 + mi] =
        ((ra[0] + ra[ROWS]) + ra[2 * ROWS]) + ra[3 * ROWS];
  }
  if (tid < nmy) {
    float s = 0.f;
    for (int i = 0; i < THREADS; ++i) s += red_b[tid * THREADS + i];
    dbeta_part[((size_t)split * nb + blockIdx.x) * nm + m0 + tid] = s;
  }
}

// The two instantiations, named apart so that a profile tells them apart.
// The mixture's accumulator holds every modality of its group (152 KB at
// M = 4, d = 300), one block per SM; NT-Xent's one batch (38 KB at d =
// 300), two blocks per SM, so that one block's loads can run under the
// other's products.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
mixture_grad_kernel(const float* __restrict__ z, const float* __restrict__ alpha,
                    const float* __restrict__ beta, const float* __restrict__ lse,
                    const float* __restrict__ coef, const float* __restrict__ v,
                    float* __restrict__ dz, float* __restrict__ dalpha,
                    float* __restrict__ part, int nm, int mg, int n2, int d,
                    float inv_tau, int depth) {
  gram_grad<true, VEC>(z, alpha, beta, lse, coef, v, dz, dalpha, part, nm,
                       mg, n2, d, inv_tau, depth);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
ntxent_grad_mma_kernel(const float* __restrict__ z,
                       const float* __restrict__ lse,
                       const float* __restrict__ coef,
                       const float* __restrict__ v, float* __restrict__ dz,
                       float* __restrict__ part, int nm, int n2, int d,
                       float inv_tau, int depth) {
  gram_grad<false, VEC>(z, nullptr, nullptr, lse, coef, v, dz, nullptr, part,
                        nm, 1, n2, d, inv_tau, depth);
}

// ------------------------------------------------------------ the wide body
// Past what the accumulator above holds (grad_fits: d > 1,504 at one
// modality a block on the H100, for NT-Xent and the mixture) the
// blocks of a row block form a thread-block cluster of S = cm x q blocks:
// cm modalities (the mixture's nm, NT-Xent's one batch) times q depth
// slices.  Block (mi, r) of a cluster:
//   * computes modality mi's K partial over depth slice r of d (K steps
//     [ks r / q, ks (r + 1) / q) of KD features), each k8 step from zero
//     and added in fp32, and publishes it in its shared memory;
//   * after the cluster barrier, computes the weights of its share of the
//     row tile's rows (rows [ceil(32 s / S), ceil(32 (s + 1) / S)), s its
//     rank) for every modality of the cluster: K of each modality as the
//     sum of its q partials in rank order, then W (NT-Xent) or the
//     mixtures and W_tot of every modality, with the dalpha and dbeta
//     terms of its rows; and publishes them;
//   * after the next cluster barrier, copies its modality's W of the whole
//     tile from the rows' owners and takes W z over its feature chunk (of
//     q x groups balanced chunks) into its row accumulator, as gram_grad
//     does.
// So K and W are computed once per (row tile, column tile) and cluster,
// and a block's accumulator and ring fit two blocks an SM.  The loop is
// pipelined so that one cluster barrier a column tile orders both
// exchanges: iteration it publishes tile it's K partials and tile it - 1's
// W, each in one of two buffers by the tile's parity, then copies tile
// it - 1's W and takes its W z.  Where one cluster
// cannot hold every chunk (groups > 1, past 16 blocks), each group of
// chunks is a cluster that computes K and W again; group 0 alone writes
// dalpha and dbeta.  Column splits as in gram_grad; dbeta's per-block
// partials are per (split, row block, rank).  No float atomics.
constexpr int KP_FLOATS = ROWS * COLS;           // a K partial, row-major
constexpr int WIDE_DA = 6;       // a thread's dalpha terms: J x nm <= 6
static_assert((4 * 8 + 8) * MAX_MOD <= MIN_DEPTH * SLOT,
              "the wide body's final reductions exceed the ring");

// the first row of share s of S
__host__ __device__ __forceinline__ int share_row(int s, int S) {
  return (ROWS * s + S - 1) / S;
}

// a wide block's shared memory: the ring, W, two K partials, two buffers
// of the weights of a share's rows for cm modalities, and the accumulator
// of a chunk of `cols` columns
size_t wide_smem_bytes(int depth, int cm, int S, int cols) {
  const size_t rs = (ROWS + S - 1) / S;
  return sizeof(float) * (depth * (size_t)SLOT + W_FLOATS + 2 * (size_t)KP_FLOATS +
                          2 * (size_t)cm * rs * COLS +
                          (size_t)TILE_FLOATS * ((cols + 7) / 8));
}

// The cluster's barrier, all threads of all its blocks; release and
// acquire order the shared memory each block wrote before it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of p (this block's shared memory) in block rank's.
__device__ __forceinline__ uint32_t dsmem_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_dsmem(uint32_t addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(x) : "r"(addr)
               : "memory");
  return x;
}

__device__ __forceinline__ float4 ld_dsmem4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w) : "r"(addr)
               : "memory");
  return x;
}

// a[i] = x y + a[i], with i known only at run time (a stays in
// registers)
__device__ __forceinline__ void fma_at(float (&a)[WIDE_DA], int i, float x,
                                       float y) {
#pragma unroll
  for (int j = 0; j < WIDE_DA; ++j)
    if (j == i) a[j] = fmaf(x, y, a[j]);
}

__device__ __forceinline__ float get_at(const float (&a)[WIDE_DA], int i) {
  float x = 0.f;
#pragma unroll
  for (int j = 0; j < WIDE_DA; ++j)
    if (j == i) x = a[j];
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The wide body.  MIX: z, alpha, beta, lse and coef as in gram_grad, nm
// modalities, blockIdx.y = group x S + rank with rank = modality x q +
// slice; !MIX: nm batches, blockIdx.y = (batch x groups + group) x q +
// slice.  The launch's clusters are (1, S, 1).  dz over the block's chunk
// (and, group 0 of MIX, dalpha of its rows and its dbeta partials) for
// split 0, or the split's partials, in gram_grad's scratch layout with
// S dbeta partials a row block.
template <bool MIX, bool VEC>
__device__ __forceinline__ void gram_grad_wide(
    const float* __restrict__ z, const float* __restrict__ alpha,
    const float* __restrict__ beta, const float* __restrict__ lse,
    const float* __restrict__ coef, const float* __restrict__ v,
    float* __restrict__ dz, float* __restrict__ dalpha,
    float* __restrict__ part, int nm, int q, int groups, int n2, int d,
    float inv_tau, int depth) {
  constexpr int ZS = 8;
  constexpr int Z_STEPS = COLS / ZS;
  const int cm = MIX ? nm : 1, S = cm * q;
  const int rs = (ROWS + S - 1) / S;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* w = ring + depth * SLOT;
  float* kp = w + W_FLOATS;                       // [2][ROWS][COLS]
  float* wp = kp + 2 * KP_FLOATS;                 // [2][cm][rs][COLS]
  float* acc = wp + 2 * (size_t)cm * rs * COLS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * ROWS;
  const int rank = blockIdx.y % S, cid = blockIdx.y / S;
  const int grp = MIX ? cid : cid % groups;
  const int mi = MIX ? rank / q : 0, sl = rank % q;
  const int m = MIX ? mi : cid / groups;          // modality or batch
  const float* zm = z + (size_t)m * n2 * d;
  // the feature chunk (of q x groups) and the K depth slice
  const int chunks = q * groups, ci = grp * q + sl;
  const int d8 = (d + 7) / 8;
  const int t0 = d8 * ci / chunks, t1 = d8 * (ci + 1) / chunks;
  const int ntiles = t1 - t0;
  const int ks = (d + KD - 1) / KD;
  const int k_lo = ks * sl / q, k_hi = ks * (sl + 1) / q;
  const int passes = (ntiles + PASS_TILES - 1) / PASS_TILES;
  // this split's column tiles
  const int n_ct = (n2 + COLS - 1) / COLS;
  const int ct0 = n_ct * blockIdx.z / gridDim.z;
  const int n_tiles = n_ct * (blockIdx.z + 1) / gridDim.z - ct0;
  // this block's share of the rows' weights
  const int r_lo = share_row(rank, S), r_n = share_row(rank + 1, S) - r_lo;
  const int n_el = r_n * COLS;

  for (int i = tid; i < TILE_FLOATS * ntiles; i += THREADS) acc[i] = 0.f;

  // the stream of ring steps: iteration it's K steps of tile it (it <
  // n_tiles), then its Z steps of tile it - 1 (it >= 1)
  const int nks = k_hi - k_lo, nzs = passes * Z_STEPS;
  const int steps = n_tiles * (nks + nzs);
  int ld_it = 0, ld_i = 0, sl_ = 0, sc = 0, issued = 0;
  auto issue = [&]() {
    if (issued < steps) {
      // the iteration's next step (empty iterations skipped)
      while (ld_i == (ld_it < n_tiles ? nks : 0) + (ld_it >= 1 ? nzs : 0)) {
        ++ld_it;
        ld_i = 0;
      }
      float* buf = ring + sl_ * SLOT;
      const int nk = ld_it < n_tiles ? nks : 0;
      if (ld_i < nk) {
        load_k<VEC>(zm, n2, d, row0, (ct0 + ld_it) * COLS,
                    (k_lo + ld_i) * KD, buf);
      } else {
        const int p0 = (ld_i - nk) / Z_STEPS * PASS_TILES;
        load_z<VEC>(zm, n2, d,
                    (ct0 + ld_it - 1) * COLS + ZS * ((ld_i - nk) % Z_STEPS),
                    8 * (t0 + p0), 8 * min(PASS_TILES, ntiles - p0), buf);
      }
      ++ld_i;
      ++issued;
    }
    cp_async_commit();
    sl_ = sl_ + 1 == depth ? 0 : sl_ + 1;
  };
  // waits for the next step's slot; every thread is done with the last one
  auto next = [&]() -> const float* {
    cp_async_wait_dyn(depth - 2);
    __syncthreads();    // the wide body's ring
    issue();
    const float* buf = ring + sc * SLOT;
    sc = sc + 1 == depth ? 0 : sc + 1;
    return buf;
  };
  for (int i = 0; i < depth - 1; ++i) issue();

  // MIX: this thread's dalpha terms (element j of its share, modality mm
  // at j nm + mm) and dbeta terms
  float dap[WIDE_DA], dbp[MAX_MOD];
#pragma unroll
  for (int i = 0; i < WIDE_DA; ++i) dap[i] = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_MOD; ++i) dbp[i] = 0.f;
  const int r_fr = (warp % 2) * 16 + g;           // the C fragment's rows
  const int c_fr = (warp / 2) * 16 + 2 * t;       // and columns

  // the loop: K of tile it, then W and W z of tile it - 1
  for (int it = 0; it <= n_tiles; ++it) {
    if (it < n_tiles) {
      float kacc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) kacc[nt][i] = 0.f;
      for (int s = k_lo; s < k_hi; ++s) k_step(next(), kacc);
      // publish the K partial
      float* kpp = kp + (it & 1) * KP_FLOATS;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(kpp + (r_fr + 8 * h) * COLS + c_fr + 8 * nt) =
              make_float2(kacc[nt][2 * h], kacc[nt][2 * h + 1]);
    }
    // the weights of tile it - 1's share of rows
    if (it > 0) {
      const int col0 = (ct0 + it - 1) * COLS;
      const float* kpp = kp + ((it - 1) & 1) * KP_FLOATS;
      float* wpp = wp + ((it - 1) & 1) * cm * rs * COLS;
      for (int e = tid, j = 0; e < n_el; e += THREADS, ++j) {
        const int lr = r_lo + e / COLS, lc = e % COLS;
        const int gr = row0 + lr, gc = col0 + lc;
        const bool okr = gr < n2, okc = gc < n2, ok = okr && okc;
        const bool neq = gc != gr;
        const bool oh = gc == (gr < n2 / 2 ? gr + n2 / 2 : gr - n2 / 2);
        const int rr = okr ? gr : 0, cc = okc ? gc : 0;
        const float v_r = v[rr], v_c = v[cc];
        // K of each modality of the cluster: its q partials in rank order
        float km[MIX ? MAX_MOD : 1];
#pragma unroll
        for (int mm = 0; mm < (MIX ? MAX_MOD : 1); ++mm) {
          if (mm < cm) {
            const float* p = kpp + lr * COLS + lc;
            float x = ld_dsmem(dsmem_addr(p, mm * q));
            for (int r = 1; r < q; ++r) x += ld_dsmem(dsmem_addr(p, mm * q + r));
            km[mm] = x;
          }
        }
        if (!MIX) {
          const size_t ro = (size_t)m * n2 + rr, co = (size_t)m * n2 + cc;
          wpp[e] = ok ? w_channel(km[0] * inv_tau, lse[ro], lse[co], coef[ro],
                                  coef[co], v_r, v_c, neq, oh, inv_tau)
                      : 0.f;
          continue;
        }
        // the mixtures, in increasing m, and their weights
        float w_a = 0.f, w_f = 0.f;
#pragma unroll
        for (int mm = 0; mm < (MIX ? MAX_MOD : 1); ++mm) {
          if (mm < nm) {
            const float ar = okr ? alpha[(size_t)gr * nm + mm] : 0.f;
            const float ac = okc ? alpha[(size_t)gc * nm + mm] : 0.f;
            w_a = fmaf(ar * ac, km[mm], w_a);
            w_f = fmaf(beta[mm], km[mm], w_f);
          }
        }
        const size_t ra = (size_t)nm * n2 + rr, ca = (size_t)nm * n2 + cc;
        const float wa = ok ? w_channel(w_a * inv_tau, lse[ra], lse[ca],
                                        coef[ra], coef[ca], v_r, v_c, neq, oh,
                                        inv_tau)
                            : 0.f;
        const float wf = ok ? w_channel(w_f * inv_tau, lse[ra + n2],
                                        lse[ca + n2], coef[ra + n2],
                                        coef[ca + n2], v_r, v_c, neq, oh,
                                        inv_tau)
                            : 0.f;
        // W_tot of every modality, and its dalpha and dbeta terms
#pragma unroll
        for (int mm = 0; mm < (MIX ? MAX_MOD : 1); ++mm) {
          if (mm < nm) {
            const float ar = okr ? alpha[(size_t)gr * nm + mm] : 0.f;
            const float ac = okc ? alpha[(size_t)gc * nm + mm] : 0.f;
            const size_t ro = (size_t)mm * n2 + rr, co = (size_t)mm * n2 + cc;
            float wv = 0.f;
            if (ok) {
              wv = w_channel(km[mm] * inv_tau, lse[ro], lse[co], coef[ro],
                             coef[co], v_r, v_c, neq, oh, inv_tau);
              wv += wa * (ar * ac) + wf * beta[mm];
            }
            wpp[(mm * rs) * COLS + e] = wv;
            fma_at(dap, j * nm + mm, wa * km[mm], ac);
            dbp[mm] = fmaf(wf, km[mm], dbp[mm]);
          }
        }
      }
    }
    // every block's K partials of tile it and W of tile it - 1 published
    cluster_barrier();
    if (it > 0) {
      // the modality's W of tile it - 1 from its rows' owners (the next
      // step's barrier publishes it)
      const float* wpp = wp + (((it - 1) & 1) * cm + mi) * rs * COLS;
      for (int f = tid; f < ROWS * COLS / 4; f += THREADS) {
        const int lr = f / (COLS / 4), c4 = 4 * (f % (COLS / 4));
        const int own = lr * S / ROWS;
        const float4 x = ld_dsmem4(dsmem_addr(
            wpp + (lr - share_row(own, S)) * COLS + c4, own));
        *reinterpret_cast<float4*>(w + lr * W_STRIDE + c4) = x;
      }
      // W z of tile it - 1 over the chunk's features
      for (int p0 = 0; p0 < ntiles; p0 += PASS_TILES) {
        const int cnt = min(PASS_TILES, ntiles - p0);
        float part[NT][2][4];
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][mt][e] = 0.f;
        for (int s = 0; s < Z_STEPS; ++s) z_step(next(), w, s, cnt, part);
        add_part(acc, p0, cnt, part);
      }
    }
  }
  // no block leaves while another may read its shared memory
  cluster_barrier();
  cp_async_wait<0>();
  __syncthreads();

  // split 0 writes dz (and dalpha), split s > 0 its partials
  const int nb = gridDim.x, split = blockIdx.z;
  const size_t parts = (size_t)gridDim.z * nb * S * nm;
  float* dz_out = dz;
  float* da_out = dalpha;
  if (split > 0) {
    if (MIX) {
      da_out = part + parts + (size_t)(split - 1) * n2 * nm;
      dz_out = part + parts + (size_t)(gridDim.z - 1) * n2 * nm +
               (size_t)(split - 1) * nm * n2 * d;
    } else {
      dz_out = part + (size_t)(split - 1) * nm * n2 * d;
    }
  }
  const int f0 = 8 * t0, nf = min(8 * t1, d) - f0;
  float* dz_m = dz_out + (size_t)m * n2 * d + f0;
  for (int i = tid; i < ROWS * nf; i += THREADS) {
    const int r = i / nf, f = i % nf;
    if (row0 + r >= n2) continue;
    const int rr = r % 16, col = f % 8;
    const int ln = (rr % 8) * 4 + col / 2, e = (rr / 8) * 2 + col % 2;
    dz_m[(size_t)(row0 + r) * d + f] =
        acc[((size_t)(f / 8) * 2 + r / 16) * 128 + ln * 4 + e];
  }
  if (!MIX || grp > 0) return;

  // dalpha: a row's 64 columns are two warps' lanes (element j of thread
  // tid is row 4 j + warp / 2 of the share): each warp's butterfly, then
  // the two warps in order; dbeta: each warp's butterfly, then the warps
  // in order
  float* red_a = ring;                      // [4][WARPS][MAX_MOD]
  float* red_b = ring + 4 * WARPS * MAX_MOD;  // [WARPS][MAX_MOD]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mm = 0; mm < MAX_MOD; ++mm) {
      const int i = j * nm + mm;
      const float x = warp_sum(mm < nm && i < WIDE_DA ? get_at(dap, i) : 0.f);
      if (lane == 0) red_a[(j * WARPS + warp) * MAX_MOD + mm] = x;
    }
#pragma unroll
  for (int mm = 0; mm < MAX_MOD; ++mm) {
    const float x = warp_sum(dbp[mm]);
    if (lane == 0) red_b[warp * MAX_MOD + mm] = x;
  }
  __syncthreads();
  for (int i = tid; i < r_n * nm; i += THREADS) {
    const int lr = i / nm, mm = i % nm;
    const int j = lr / 4, w2 = 2 * (lr % 4);
    const int gr = row0 + r_lo + lr;
    if (gr < n2)
      da_out[(size_t)gr * nm + mm] = red_a[(j * WARPS + w2) * MAX_MOD + mm] +
                                     red_a[(j * WARPS + w2 + 1) * MAX_MOD + mm];
  }
  if (tid < nm) {
    float s = 0.f;
    for (int i = 0; i < WARPS; ++i) s += red_b[i * MAX_MOD + tid];
    part[(((size_t)split * nb + blockIdx.x) * S + rank) * nm + tid] = s;
  }
}

// The wide instantiations, named apart so that a profile tells them apart;
// two blocks an SM.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
mixture_grad_wide_kernel(const float* __restrict__ z,
                         const float* __restrict__ alpha,
                         const float* __restrict__ beta,
                         const float* __restrict__ lse,
                         const float* __restrict__ coef,
                         const float* __restrict__ v, float* __restrict__ dz,
                         float* __restrict__ dalpha, float* __restrict__ part,
                         int nm, int q, int groups, int n2, int d,
                         float inv_tau, int depth) {
  gram_grad_wide<true, VEC>(z, alpha, beta, lse, coef, v, dz, dalpha, part,
                            nm, q, groups, n2, d, inv_tau, depth);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
ntxent_grad_wide_kernel(const float* __restrict__ z,
                        const float* __restrict__ lse,
                        const float* __restrict__ coef,
                        const float* __restrict__ v, float* __restrict__ dz,
                        float* __restrict__ part, int nm, int q, int groups,
                        int n2, int d, float inv_tau, int depth) {
  gram_grad_wide<false, VEC>(z, nullptr, nullptr, lse, coef, v, dz, nullptr,
                             part, nm, q, groups, n2, d, inv_tau, depth);
}

}  // namespace grad

// How a gradient kernel runs on this device, on either body:
//   chunks  the feature chunks: 1 on the main-path body, whose accumulator
//           holds all of d; on the wide body q x groups;
//   depth   the deepest cp.async ring that fits beside the accumulator;
//   splits  the number of blocks that share a row tile's column tiles,
//           chosen so that the last wave of blocks fills the SMs: at 7,000
//           rows, 219 row tiles on 132 SMs leave the second of two waves
//           a third empty, three splits fill five waves to 99.5 %;
//   per_sm  blocks an SM (the occupancy query's);
//   wide    1 on the wide body; then cluster (blocks a cluster, cm x q),
//           groups (clusters of feature chunks a row tile and batch) and
//           q (depth slices of K a cluster), all 1 on the main-path body;
//   bytes   dynamic shared memory a block;
//   scratch the floats of partials (and, for the mixtures, of per-block
//           dbeta).
struct GradPlan {
  int chunks, depth, splits, per_sm, wide, cluster, groups, q;
  size_t bytes, scratch;
};

// {chunks, depth, splits, per_sm, wide, cluster, groups, q} to out, the
// order ops/cuda/ntxent.py GRAD_PLAN_F32 reads.
void report_plan(const GradPlan& plan, int* out) {
  const int v[8] = {plan.chunks, plan.depth,   plan.splits, plan.per_sm,
                    plan.wide,   plan.cluster, plan.groups, plan.q};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// The feature tiles of 8 columns that the main-path body's accumulator of
// mg modalities holds beside the shallowest ring, in `optin` bytes a block.
long grad_cap(int mg, int optin) {
  const long room = (long)optin - (long)grad::smem_bytes(grad::MIN_DEPTH, 0, 0);
  return room / (long)(sizeof(float) * grad::TILE_FLOATS * mg);
}

// Whether the main-path body takes d at mg modalities a block: its
// accumulator holds all of d's feature tiles.  Past it (d > 1,504 at one
// modality on the H100) the wide body runs.
bool grad_fits(int mg, int d, int optin) {
  return (d + 7) / 8 <= grad_cap(mg, optin);
}

// Column splits of a row tile's column tiles (of n_ct) that fill the last
// wave of `blocks` on `slots`: the share of the SMs' time that full waves
// would use; a split pays for its partials, so it must gain 3 %.
int fill_splits(long blocks, int n_ct, long slots) {
  auto fill = [&](int s) {
    const long b = blocks * s;
    return (double)b / (double)(((b + slots - 1) / slots) * slots);
  };
  int splits = 1;
  for (int s = 2; s <= 4 && s <= n_ct; ++s)
    if (fill(s) > fill(splits) + 0.03) splits = s;
  return splits;
}

// The floats of scratch of a launch: the column splits' dz partials, and
// for the mixtures their dalpha partials and `parts` per-block dbeta
// partials a split.
size_t grad_scratch(bool mix, int m, int n2, int d, int splits, long parts) {
  size_t floats = (size_t)(splits - 1) * m * n2 * d;
  if (mix) floats += (size_t)splits * parts + (size_t)(splits - 1) * n2 * m;
  return floats;
}

// The main-path body's plan, mg modalities a block (1 for NT-Xent);
// cudaErrorInvalidValue where its accumulator does not hold d
// (grad_fits).  kernel is the VEC instantiation, for the occupancy query;
// its dynamic shared-memory limit must be set.
template <bool MIX>
int grad_plan(const void* kernel, int m, int mg, int n2, int d,
              GradPlan& plan) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grad_cap(mg, optin) < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (!grad_fits(mg, d, optin)) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = MIX ? (m + mg - 1) / mg : m;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  plan = GradPlan{1, grad::MAX_DEPTH, 1, 0, 0, 1, 1, 1, 0, 0};
  while (plan.depth > grad::MIN_DEPTH &&
         grad::smem_bytes(plan.depth, mg, d) > (size_t)optin)
    --plan.depth;
  plan.bytes = grad::smem_bytes(plan.depth, mg, d);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &plan.per_sm, kernel, grad::THREADS, plan.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n2 + grad::ROWS - 1) / grad::ROWS;
  const int n_ct = (n2 + grad::COLS - 1) / grad::COLS;
  plan.splits = fill_splits((long)nb * groups, n_ct,
                            (long)sms * (plan.per_sm > 0 ? plan.per_sm : 1));
  plan.scratch = grad_scratch(MIX, m, n2, d, plan.splits, (long)nb * m);
  return 0;
}

// The wide body's launches (grad::gram_grad_wide): clusters of S blocks.

// Lets the wide instantiations (kernels, the VEC one first) take all the
// shared memory a block may opt in to and clusters past the portable 8,
// and writes what a plan is chosen from to out: {dynamic shared memory a
// block may take (the opt-in less the kernels' static shared memory),
// shared memory an SM, shared memory the system reserves a block, SMs,
// blocks an SM that registers and threads allow}.
int wide_limits(const void* const* kernels, int n, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[] = {cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                  cudaDevAttrReservedSharedMemoryPerBlock,
                                  cudaDevAttrMultiProcessorCount};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = cudaDeviceGetAttribute(&out[i], attrs[i], dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernels[0]);
  if (err == cudaSuccess) out[0] -= static_cast<int>(fa.sharedSizeBytes);
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    err = cudaFuncSetAttribute(kernels[i],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               out[0]);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernels[i], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernels[0],
                                                        grad::THREADS, 0);
  return static_cast<int>(err);
}

// The launch configuration of a wide kernel: clusters (1, S, 1).
struct WideLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  WideLaunch(dim3 grid, int cluster, size_t bytes, cudaStream_t s) : cfg{} {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(grad::THREADS);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = cluster;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The wide body's plan at (m, n2, d), MIX: the mixture's m modalities a
// cluster (cm = m), else NT-Xent's one batch (cm = 1); kernels as for
// wide_limits.  Clusters of cm x q blocks over chunks = q x groups
// balanced feature chunks.  Of the chunk counts whose block fits the card,
// it takes the fewest cluster groups (each group computes K and W again),
// then the most of two blocks an SM times the share of its W z passes that
// a chunk's feature tiles fill (a pass costs PASS_TILES tiles; in
// hundredths, so that the ring decides between near equals), then a ring
// of three slots or more, then the fewest chunks; clusters of up to 16
// blocks where the card holds them (cudaOccupancyMaxActiveClusters), else
// up to 8.  The mixture's dalpha terms of a thread (grad::WIDE_DA) bound
// its elements a tile times its modalities.  cudaErrorInvalidValue where
// no plan fits.
template <bool MIX>
int wide_plan(const void* const* kernels, int n, int m, int n2, int d,
              GradPlan& plan) {
  using namespace grad;
  int lim[5];
  const int err = wide_limits(kernels, n, lim);
  if (err) return err;
  const int optin = lim[0], smem_sm = lim[1], reserved = lim[2], sms = lim[3];
  const int by_regs = lim[4];
  const int d8 = (d + 7) / 8, ks = (d + KD - 1) / KD, cm = MIX ? m : 1;
  const int nb = (n2 + ROWS - 1) / ROWS, n_ct = (n2 + COLS - 1) / COLS;
  for (const int most : {16, 8}) {
    const int qmax = std::min(most / cm, ks);
    if (qmax < 2) continue;
    bool found = false;
    long key[4] = {0, 0, 0, 0};
    for (int c = 2; c <= d8; ++c) {
      const int q = std::min(c, qmax), groups = (c + q - 1) / q;
      const int chunks = groups * q, cluster = cm * q;
      if (chunks > d8 || (found && groups > plan.groups)) break;
      const int rs = (ROWS + cluster - 1) / cluster;      // rows of a share
      if (MIX && (rs * COLS + THREADS - 1) / THREADS * m > WIDE_DA) continue;
      const int tiles = (d8 + chunks - 1) / chunks;
      const double fill =
          (double)tiles / (((tiles + PASS_TILES - 1) / PASS_TILES) * PASS_TILES);
      for (int depth = MAX_DEPTH; depth >= MIN_DEPTH; --depth) {
        const size_t bytes = wide_smem_bytes(depth, cm, cluster, 8 * tiles);
        const int per_sm = std::min(
            by_regs, static_cast<int>(smem_sm / (bytes + reserved)));
        if (bytes > (size_t)optin || per_sm < 1) continue;
        const long k[4] = {-groups,
                           (long)std::nearbyint(std::min(per_sm, 2) * fill * 100),
                           std::min(depth, 3), -c};
        if (found && !std::lexicographical_compare(key, key + 4, k, k + 4))
          continue;
        found = true;
        std::copy(k, k + 4, key);
        plan = GradPlan{chunks, depth, 1, per_sm, 1, cluster, groups, q, bytes, 0};
      }
    }
    if (!found) continue;
    WideLaunch l(dim3(1, plan.cluster, 1), plan.cluster, plan.bytes, 0);
    int held = 0;
    cudaError_t e = cudaOccupancyMaxActiveClusters(&held, kernels[0], &l.cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (held < 1) continue;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan.per_sm, kernels[0],
                                                      THREADS, plan.bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (plan.per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if ((long)(MIX ? plan.groups * plan.cluster : m * plan.chunks) > 65535)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    plan.splits = fill_splits((long)nb * m * plan.chunks, n_ct,
                              (long)sms * plan.per_sm);
    plan.scratch = grad_scratch(MIX, m, n2, d, plan.splits,
                                (long)nb * plan.cluster * m);
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
