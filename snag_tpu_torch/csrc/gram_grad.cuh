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
// blockIdx.y: (group, feature chunk), group * chunks + chunk.  A group is
// the mixtures' modalities a block holds (where the accumulator of every
// modality does not fit, each group recomputing every K tile), NT-Xent's
// batch.  A chunk is a balanced share of the n8 feature tiles that fits
// the accumulator, each chunk recomputing K over the whole d; past one
// modality's fit the mixtures take chunks too.  W and K, and so dalpha and
// dbeta, do not depend on the chunk: chunk 0 alone writes them.
// blockIdx.z: up to four blocks share a row tile's column tiles where that
// fills the last wave; the blocks past the first write partials that a
// second kernel adds in a fixed order.  No float atomics: two runs give the
// same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// snag_loss.cu, blockIdx.y = group * chunks + chunk, the group of mg
// modalities from m0; dz over the chunk's features, and from chunk 0
// dalpha and per-block dbeta partials (split 0), or the split's partials
// in part.  !MIX: alpha, beta and dalpha unused, lse and coef (nm, n2),
// mg = 1, blockIdx.y = batch * chunks + chunk; dz (split 0) or the split's
// dz partials in part.
template <bool MIX, bool VEC>
__device__ __forceinline__ void gram_grad(
    const float* __restrict__ z, const float* __restrict__ alpha,
    const float* __restrict__ beta, const float* __restrict__ lse,
    const float* __restrict__ coef, const float* __restrict__ v,
    float* __restrict__ dz, float* __restrict__ dalpha,
    float* __restrict__ part, int nm, int mg, int chunks, int n2, int d,
    float inv_tau, int depth) {
  constexpr int ZS = 8;
  constexpr int Z_STEPS = COLS / ZS;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* w = ring + depth * SLOT;
  float* accs = w + W_FLOATS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * ROWS;
  const int m0 = MIX ? blockIdx.y / chunks * mg : blockIdx.y / chunks;
  // K tiles: every modality for the mixtures, else the block's batch
  constexpr int KM = MIX ? MAX_MOD : 1;
  const int mk0 = MIX ? 0 : m0;
  const int nk = MIX ? nm : 1;
  // this block's share of the column tiles (blockIdx.z of gridDim.z)
  const int n_ct = (n2 + COLS - 1) / COLS;
  const int ct0 = n_ct * blockIdx.z / gridDim.z;
  const int ct1 = n_ct * (blockIdx.z + 1) / gridDim.z;
  const int nmy = MIX ? min(mg, nm - m0) : 1;
  // this block's feature tiles [t0, t1) of d's (d + 7) / 8
  const int chunk = blockIdx.y % chunks;
  const int t0 = (d + 7) / 8 * chunk / chunks;
  const int t1 = (d + 7) / 8 * (chunk + 1) / chunks;
  const int ntiles = t1 - t0;
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
                    8 * (t0 + p0), 8 * min(PASS_TILES, ntiles - p0), buf);
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

  // dz, features [f0, f0 + nf), from the C-fragment order of the
  // accumulator
  const int f0 = 8 * t0, nf = min(8 * t1, d) - f0;
  for (int mi = 0; mi < nmy; ++mi) {
    const float* acc_m = accs + mi * acc_floats;
    float* dz_m = dz_out + (size_t)(m0 + mi) * n2 * d + f0;
    for (int i = tid; i < ROWS * nf; i += THREADS) {
      const int r = i / nf, f = i % nf;
      if (row0 + r >= n2) continue;
      const int rr = r % 16, col = f % 8;
      const int ln = (rr % 8) * 4 + col / 2, e = (rr / 8) * 2 + col % 2;
      dz_m[(size_t)(row0 + r) * d + f] =
          acc_m[((size_t)(f / 8) * 2 + r / 16) * 128 + ln * 4 + e];
    }
  }
  if (!MIX || chunk > 0) return;

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
// M = 4, d = 300), or one modality's chunk of the features, one block per
// SM; NT-Xent's one batch (38 KB at d = 300), two blocks per SM, so that
// one block's loads can run under the other's products.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
mixture_grad_kernel(const float* __restrict__ z, const float* __restrict__ alpha,
                    const float* __restrict__ beta, const float* __restrict__ lse,
                    const float* __restrict__ coef, const float* __restrict__ v,
                    float* __restrict__ dz, float* __restrict__ dalpha,
                    float* __restrict__ part, int nm, int mg, int chunks,
                    int n2, int d, float inv_tau, int depth) {
  gram_grad<true, VEC>(z, alpha, beta, lse, coef, v, dz, dalpha, part, nm,
                       mg, chunks, n2, d, inv_tau, depth);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
ntxent_grad_mma_kernel(const float* __restrict__ z,
                       const float* __restrict__ lse,
                       const float* __restrict__ coef,
                       const float* __restrict__ v, float* __restrict__ dz,
                       float* __restrict__ part, int nm, int chunks, int n2,
                       int d, float inv_tau, int depth) {
  gram_grad<false, VEC>(z, nullptr, nullptr, lse, coef, v, dz, nullptr, part,
                        nm, 1, chunks, n2, d, inv_tau, depth);
}

}  // namespace grad

// How a gradient kernel runs on this device:
//   chunks  the fewest feature chunks whose accumulator (of mg modalities)
//           fits beside the shallowest ring, of balanced size, or the
//           caller's (chunks > 0 on entry), which must fit;
//   depth   the deepest cp.async ring that fits beside the accumulator;
//   splits  the number of blocks that share a row tile's column tiles,
//           chosen so that the last wave of blocks fills the SMs: at 7,000
//           rows, 219 row tiles on 132 SMs leave the second of two waves
//           a third empty, three splits fill five waves to 99.5 %;
//   scratch the floats of partials (and, for the mixtures, of per-block
//           dbeta).
// kernel is the VEC instantiation, for the occupancy query; its dynamic
// shared-memory limit must be set.
struct GradPlan {
  int chunks, depth, splits, per_sm;
  size_t bytes, scratch;
};

template <bool MIX>
int grad_plan(const void* kernel, int m, int mg, int n2, int d,
              GradPlan& plan, int chunks = 0) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d8 = (d + 7) / 8;
  // the feature tiles an accumulator of mg modalities holds
  const long room = (long)optin - (long)grad::smem_bytes(grad::MIN_DEPTH, 0, 0);
  const long cap = room / (long)(sizeof(float) * grad::TILE_FLOATS * mg);
  if (cap < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  plan.chunks = chunks > 0 ? chunks : static_cast<int>((d8 + cap - 1) / cap);
  const int groups = MIX ? (m + mg - 1) / mg : m;
  if (plan.chunks > d8) return static_cast<int>(cudaErrorInvalidValue);
  if ((long)groups * plan.chunks > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // the widest chunk's columns
  const int cols = 8 * ((d8 + plan.chunks - 1) / plan.chunks);
  plan.depth = grad::MAX_DEPTH;
  while (plan.depth > grad::MIN_DEPTH &&
         grad::smem_bytes(plan.depth, mg, cols) > (size_t)optin)
    --plan.depth;
  plan.bytes = grad::smem_bytes(plan.depth, mg, cols);
  if (plan.bytes > (size_t)optin) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &plan.per_sm, kernel, grad::THREADS, plan.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n2 + grad::ROWS - 1) / grad::ROWS;
  const int n_ct = (n2 + grad::COLS - 1) / grad::COLS;
  const long blocks = (long)nb * groups * plan.chunks;
  const long slots = (long)sms * (plan.per_sm > 0 ? plan.per_sm : 1);
  // the share of the SMs' time that full waves would use; a split pays for
  // its partials, so it must gain 3 %
  auto fill = [&](int s) {
    const long b = blocks * s;
    return (double)b / (double)(((b + slots - 1) / slots) * slots);
  };
  plan.splits = 1;
  for (int s = 2; s <= 4 && s <= n_ct; ++s)
    if (fill(s) > fill(plan.splits) + 0.03) plan.splits = s;
  const size_t n_dz = (size_t)m * n2 * d;
  plan.scratch = (size_t)(plan.splits - 1) * n_dz;
  if (MIX)
    plan.scratch += (size_t)plan.splits * nb * m +
                    (size_t)(plan.splits - 1) * n2 * m;
  return 0;
}

}  // namespace
