// SNAG's fused loss bundle for Hopper, f32: the row-logsumexp of M modality
// channels and two mixture channels from shared similarity tiles, and its
// gradient, neither of which writes a quadratic array.
//
// Replaces snag_tpu/ops/pallas/snag_loss_kernel.py::mixture_lse (kernel
// _mix_lse_kernel) and ::mixture_grad (kernel _mix_grad_kernel).  z is
// (M, n2 = 2B, d) with L2-normalised rows, K_m = z_m z_m^T, alpha (n2, M)
// and beta (M,) are unit vectors, v (n2,) marks valid rows, and the
// positive partner of row r is r + B or r - B.  Channels are
// [K_0 .. K_{M-1} | mix_a | mix_f] with
//     mix_a[r,c] = sum_m alpha[r,m] alpha[c,m] K_m[r,c]
//     mix_f[r,c] = sum_m beta[m] K_m[r,c]
// and S = channel / tau.  |S| <= 1/tau (unit rows; Cauchy-Schwarz for the
// mixtures), so the logsumexp takes the static max 1/tau:
//
//   mixture_lse:  lse[ch,r] = log(sum_{c != r} v[c] exp(S - 1/tau) + 1e-30)
//                             + 1/tau;
//   mixture_grad: with W_ch = ((c != r)(coef_r p_row v_c + p_col coef_c v_r)
//                 - [c == pos(r)](coef_r + coef_c)) / tau,
//                 p = exp(min(S - lse, 0)) (the G + G^T fold of the
//                 symmetric S, as in ntxent.cu):
//     dz_m[r]     = sum_c (W_m + W_a alpha[r,m] alpha[c,m] + W_f beta_m) z_m[c]
//     dalpha[r,m] = sum_c W_a alpha[c,m] K_m[r,c]
//     dbeta[m]    = 1/2 sum_{r,c} W_f K_m[r,c]  (the fold counts each pair
//                   twice for beta; alpha[r,m] sits in row r and column r
//                   of S, so dalpha needs no halving).
//
// mixture_lse: M tile products, 2 n2^2 d M flops (1.18e11 at M = 4,
// B = 3500, d = 300) plus the mixtures and M + 2 exps per element, in fp32
// SIMT tiles (tile_dot.cuh), because one TF32 product is far from the 1e-5
// lse tolerance.
//
// mixture_grad: what bounds it on the H100 is arithmetic, M products
// K_m = z_r z_c^T and M products W z per tile, 4 n2^2 d M flops (2.35e11
// at M = 4), taken on the tensor cores in 3xTF32 (tile_mma.cuh): mma.sync
// m16n8k8 on hi = rna_tf32(x) and lo = rna_tf32(x - hi) of each operand,
// a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32, so the bound is the flops
// over 495 / 3 TFLOP/s.  One TF32 product is refused: K's error is
// multiplied by 1/tau = 10 before the exp.  max|err| / max|ref| of (dz,
// dalpha, dbeta) at tau = 0.1 with the two products emulated on the CPU
// and the rest in f64, against f64 (tests/test_torch_tf32x3.py::rel_errors):
//     (M, B, d)       fp32 products            3xTF32                   1xTF32
//     (4, 500, 300)   6.0e-6 2.2e-6 7.0e-8     7.0e-6 3.4e-6 8.2e-8     7.8e-4 4.1e-4 4.2e-5
//     (6, 300, 300)   8.9e-6 1.3e-6 5.9e-7     1.0e-5 1.7e-6 5.8e-7     1.2e-3 2.3e-4 1.1e-5
//     (4, 400, 48)    3.1e-6 6.7e-7 2.3e-8     2.9e-6 9.7e-7 2.2e-7     1.7e-3 4.0e-4 1.4e-4
// against a limit of 1e-4: 3xTF32 is as close as fp32 products, one TF32
// product misses dz by 8-17x.  The tensor cores also truncate when they
// accumulate, so each k8 step of K starts from zero and is added in fp32.
//
// A block of 8 warps owns 32 rows and walks a share of the column tiles of
// 64.  Per tile it computes every K_m once into registers (C fragments, 8
// floats a thread per modality), forms the mixture weights W_a and W_f
// from them, and then per modality of its group W_m, the combined weight
// (into shared memory), its dalpha and dbeta terms, and W z into the
// (modalities x 32 rows x d) row accumulator.  The accumulator lives in
// shared memory in C-fragment order, so each element belongs to one thread
// and the per-tile read-modify-write needs no barrier; it is 152 KB at
// M = 4, d = 300, one block (8 warps) per SM.  Where the accumulator of
// every modality does not fit (M = 6 at d = 300), a block takes a group of
// modalities (blockIdx.y, chosen by the wrapper), each group recomputing
// the K tiles for the mixtures.  Operands stream through a ring of up to
// four cp.async slots, one barrier a step.  The column tiles of a row tile
// are shared by up to four blocks (blockIdx.z) where that fills the last
// wave of blocks; the blocks past the first write partials that a second
// kernel adds in a fixed order.  dbeta is summed per block, written as
// per-block partials and reduced in a fixed order too: no atomics, two
// runs give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_dot.cuh"
#include "tile_mma.cuh"

namespace {

constexpr float LSE_EPS = 1e-30f;
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

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
mixture_lse_kernel(const float* __restrict__ z, const float* __restrict__ alpha,
                   const float* __restrict__ beta, const float* __restrict__ v,
                   float* __restrict__ lse, int nm, int n2, int d,
                   float inv_tau) {
  __shared__ __align__(16) Smem sm;
  // thread-private partial row sums of every channel
  __shared__ float sums[MAX_MOD + 2][TM][THREADS];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * BM;

  for (int ch = 0; ch < nm + 2; ++ch)
#pragma unroll
    for (int r = 0; r < TM; ++r) sums[ch][r][tid] = 0.f;

  for (int col0 = 0; col0 < n2; col0 += BN) {
    float vc[TN];
    bool neq[TM][TN];
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gc = col0 + tile_col(tx, c);
      vc[c] = gc < n2 ? v[gc] : 0.f;
#pragma unroll
      for (int r = 0; r < TM; ++r) neq[r][c] = gc != row0 + ty * TM + r;
    }
    float mix_a[TM][TN], mix_f[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) mix_a[r][c] = mix_f[r][c] = 0.f;

    for (int m = 0; m < nm; ++m) {
      const float* zm = z + (size_t)m * n2 * d;
      float acc[TM][TN];
      tile_dot<VEC>(zm, zm, n2, d, row0, col0, sm, acc);
      const float bm = beta[m];
      float ar[TM], ac[TN], part[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int gr = row0 + ty * TM + r;
        ar[r] = gr < n2 ? alpha[(size_t)gr * nm + m] : 0.f;
        part[r] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int gc = col0 + tile_col(tx, c);
        ac[c] = gc < n2 ? alpha[(size_t)gc * nm + m] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < TN; ++c)
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float k = acc[r][c];
          if (neq[r][c]) part[r] += expf(k * inv_tau - inv_tau) * vc[c];
          mix_a[r][c] = fmaf(ar[r] * ac[c], k, mix_a[r][c]);
          mix_f[r][c] = fmaf(bm, k, mix_f[r][c]);
        }
#pragma unroll
      for (int r = 0; r < TM; ++r) sums[m][r][tid] += part[r];
    }

    float pa[TM], pf[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) pa[r] = pf[r] = 0.f;
#pragma unroll
    for (int c = 0; c < TN; ++c)
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        if (!neq[r][c]) continue;
        pa[r] += expf(mix_a[r][c] * inv_tau - inv_tau) * vc[c];
        pf[r] += expf(mix_f[r][c] * inv_tau - inv_tau) * vc[c];
      }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      sums[nm][r][tid] += pa[r];
      sums[nm + 1][r][tid] += pf[r];
    }
  }

  // merge the row's TX partial sums (lanes of one half-warp)
  for (int ch = 0; ch < nm + 2; ++ch) {
    float s[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) s[r] = sums[ch][r][tid];
#pragma unroll
    for (int off = TX / 2; off >= 1; off >>= 1) {
#pragma unroll
      for (int r = 0; r < TM; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
    }
    if (tx == 0) {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int gr = row0 + ty * TM + r;
        if (gr < n2) lse[(size_t)ch * n2 + gr] = logf(s[r] + LSE_EPS) + inv_tau;
      }
    }
  }
}

// ------------------------------------------------------------- mixture_grad

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
// 8 rows of z (8 columns of the tile) over the pass's features.
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

size_t smem_bytes(int depth, int mg, int d) {
  return sizeof(float) * (depth * (size_t)SLOT + W_FLOATS +
                          (size_t)TILE_FLOATS * mg * ((d + 7) / 8));
}

// The block's work is one stream of steps, each one ring slot: per column
// tile, for every modality m the K steps s (depth [s KD, (s + 1) KD)),
// then for each modality mi of the block's group and each pass p the Z
// steps s (rows [col0 + 8 s, col0 + 8 s + 8) of z_m).  A Cursor walks it
// ahead of the compute, for the loads.
struct Cursor {
  int ct, m, p, s;
  bool k;
};

__device__ __forceinline__ void advance(Cursor& c, int nm, int ks, int nmy,
                                        int passes) {
  if (++c.s < (c.k ? ks : 8)) return;
  c.s = 0;
  if (c.k) {
    if (++c.m < nm) return;
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
__device__ __forceinline__ void put_tile(float (&k)[MAX_MOD][2][4], int m,
                                         const float (&x)[2][4]) {
#pragma unroll
  for (int j = 0; j < MAX_MOD; ++j)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (j == m) k[j][nt][i] = x[nt][i];
}

__device__ __forceinline__ void get_tile(const float (&k)[MAX_MOD][2][4],
                                         int m, float (&x)[2][4]) {
#pragma unroll
  for (int j = 0; j < MAX_MOD; ++j)
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

// The combined weight of modality m for the current column tile into w
// (fp32), and its dalpha and dbeta terms into da and db.
__device__ __forceinline__ void weight_tile(
    const float (&k)[MAX_MOD][2][4], const float (&w_a)[2][4],
    const float (&w_f)[2][4], const Rows& R, const int (&gc)[4],
    const bool (&okc)[4], const float (&v_c)[4], const float* __restrict__ alpha,
    const float* __restrict__ beta, const float* __restrict__ lse,
    const float* __restrict__ coef, int m, int nm, int n2, float inv_tau,
    float* w, float (&da)[2], float& db) {
  float km[2][4];
  get_tile(k, m, km);
  const float bm = beta[m];
  float ar[2], lm_r[2], cm_r[2], ac[4], lm_c[4], cm_c[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ar[h] = R.ok[h] ? alpha[(size_t)R.gr[h] * nm + m] : 0.f;
    lm_r[h] = R.ok[h] ? lse[(size_t)m * n2 + R.gr[h]] : 0.f;
    cm_r[h] = R.ok[h] ? coef[(size_t)m * n2 + R.gr[h]] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ac[j] = okc[j] ? alpha[(size_t)gc[j] * nm + m] : 0.f;
    lm_c[j] = okc[j] ? lse[(size_t)m * n2 + gc[j]] : 0.f;
    cm_c[j] = okc[j] ? coef[(size_t)m * n2 + gc[j]] : 0.f;
  }
  da[0] = da[1] = db = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i / 2, j = 2 * nt + i % 2;
      const float kv = km[nt][i];
      float wv = 0.f;
      if (R.ok[h] && okc[j]) {
        wv = w_channel(kv * inv_tau, lm_r[h], lm_c[j], cm_r[h], cm_c[j],
                       R.v[h], v_c[j], gc[j] != R.gr[h], gc[j] == R.pos[h],
                       inv_tau);
        wv += w_a[nt][i] * (ar[h] * ac[j]) + w_f[nt][i] * bm;
      }
      w[R.lr[h] * W_STRIDE + R.lc[j]] = wv;
      da[h] = fmaf(w_a[nt][i] * kv, ac[j], da[h]);
      db = fmaf(w_f[nt][i], kv, db);
    }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
mixture_grad_kernel(const float* __restrict__ z, const float* __restrict__ alpha,
                    const float* __restrict__ beta, const float* __restrict__ lse,
                    const float* __restrict__ coef, const float* __restrict__ v,
                    float* __restrict__ dz, float* __restrict__ dalpha,
                    float* __restrict__ part, int nm, int mg, int n2,
                    int d, float inv_tau, int depth) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* w = ring + depth * SLOT;
  float* accs = w + W_FLOATS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * ROWS;
  const int m0 = blockIdx.y * mg;
  // this block's share of the column tiles (blockIdx.z of gridDim.z)
  const int n_ct = (n2 + COLS - 1) / COLS;
  const int ct0 = n_ct * blockIdx.z / gridDim.z;
  const int ct1 = n_ct * (blockIdx.z + 1) / gridDim.z;
  const int nmy = min(mg, nm - m0);
  const int ntiles = (d + 7) / 8;
  const size_t acc_floats = (size_t)TILE_FLOATS * ntiles;
  const int ks = (d + KD - 1) / KD;
  const int passes = (ntiles + PASS_TILES - 1) / PASS_TILES;
  const int steps = (ct1 - ct0) * (nm * ks + nmy * 8 * passes);

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
#pragma unroll
  for (int j = 0; j < MAX_MOD; ++j) dap[j][0] = dap[j][1] = dbp[j] = 0.f;

  // the ring: ld is the next step to load into slot sl, issued counts
  // them; slot sc holds the step to compute
  Cursor ld = {ct0, 0, 0, 0, true};
  int sl = 0, sc = 0, issued = 0;
  auto issue = [&]() {
    if (issued < steps) {
      const int col0 = ld.ct * COLS;
      float* buf = ring + sl * SLOT;
      if (ld.k) {
        load_k<VEC>(z + (size_t)ld.m * n2 * d, n2, d, row0, col0, ld.s * KD, buf);
      } else {
        const int p0 = ld.p * PASS_TILES;
        load_z<VEC>(z + (size_t)(m0 + ld.m) * n2 * d, n2, d, col0 + 8 * ld.s,
                    8 * p0, 8 * min(PASS_TILES, ntiles - p0), buf);
      }
      advance(ld, nm, ks, nmy, passes);
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
    // every modality's K tile, once
    float k[MAX_MOD][2][4];
    for (int m = 0; m < nm; ++m) {
      float kacc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) kacc[nt][i] = 0.f;
      for (int s = 0; s < ks; ++s) k_step(next(), kacc);
      put_tile(k, m, kacc);
    }

    // the mixtures, then their weights W_a and W_f, in registers
    int gc[4];
    bool okc[4];
    float v_c[4], w_a[2][4], w_f[2][4];
    {
      float la_c[4], lf_c[4], ca_c[4], cf_c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gc[j] = col0 + R.lc[j];
        okc[j] = gc[j] < n2;
        v_c[j] = okc[j] ? v[gc[j]] : 0.f;
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
      for (int m = 0; m < MAX_MOD; ++m) {
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

    // this block's modalities: the combined weight into shared memory
    // (the next step's barrier publishes it), dalpha and dbeta terms, then
    // W z into the accumulator
    for (int mi = 0; mi < nmy; ++mi) {
      if (mi > 0) __syncthreads();   // every warp is done with the last W
      float da[2], db;
      weight_tile(k, w_a, w_f, R, gc, okc, v_c, alpha, beta, lse, coef,
                  m0 + mi, nm, n2, inv_tau, w, da, db);
#pragma unroll
      for (int j = 0; j < MAX_MOD; ++j) {
        if (j == mi) {
          dap[j][0] += da[0];
          dap[j][1] += da[1];
          dbp[j] += db;
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
        for (int s = 0; s < 8; ++s) z_step(next(), w, s, cnt, part);
        add_part(accs + mi * acc_floats, p0, cnt, part);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this block's dz, dalpha and dbeta: split 0 into dz and dalpha, split
  // s > 0 into its partials (mixture_grad's scratch layout)
  const int nb = gridDim.x, split = blockIdx.z;
  float* dbeta_part = part;
  float* dz_out = dz;
  float* da_out = dalpha;
  if (split > 0) {
    const size_t parts = (size_t)gridDim.z * nb * nm;
    da_out = part + parts + (size_t)(split - 1) * n2 * nm;
    dz_out = part + parts + (size_t)(gridDim.z - 1) * n2 * nm +
             (size_t)(split - 1) * nm * n2 * d;
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

  // dalpha: a row's 4 lanes, then its 4 column warps in order; dbeta: the
  // block's threads in order
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

}  // namespace grad

// dbeta[m] = 1/2 sum_b part[b, m], in a fixed order: one block per m.
__global__ void __launch_bounds__(REDUCE_THREADS)
mixture_dbeta_kernel(const float* __restrict__ part, float* __restrict__ dbeta,
                     int n_blocks, int nm) {
  __shared__ float red[REDUCE_THREADS];
  const int m = blockIdx.x;
  float s = 0.f;
  for (int b = threadIdx.x; b < n_blocks; b += REDUCE_THREADS)
    s += part[(size_t)b * nm + m];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int off = REDUCE_THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) dbeta[m] = 0.5f * red[0];
}

// out[i] += part[0][i] + part[1][i] + ..., in that order.
__global__ void __launch_bounds__(REDUCE_THREADS)
mixture_sum_kernel(float* __restrict__ out, const float* __restrict__ part,
                   size_t n, int parts) {
  for (size_t i = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * REDUCE_THREADS) {
    float s = out[i];
    for (int p = 0; p < parts; ++p) s += part[(size_t)p * n + i];
    out[i] = s;
  }
}

// How mixture_grad runs on this device: the deepest cp.async ring that fits
// beside the accumulator, and the number of blocks that share a row tile's
// column tiles (splits), chosen so that the last wave of blocks fills the
// SMs: at 7,000 rows, 219 row tiles on 132 SMs leave the second of two
// waves a third empty, three splits fill five waves to 99.5 %.
struct GradPlan {
  int depth, splits;
  size_t bytes, scratch;
};

int grad_plan(int m, int mg, int n2, int d, GradPlan& plan) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan.depth = grad::MAX_DEPTH;
  while (plan.depth > grad::MIN_DEPTH &&
         grad::smem_bytes(plan.depth, mg, d) > (size_t)optin)
    --plan.depth;
  plan.bytes = grad::smem_bytes(plan.depth, mg, d);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, grad::mixture_grad_kernel<true>, grad::THREADS, plan.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n2 + grad::ROWS - 1) / grad::ROWS;
  const int n_ct = (n2 + grad::COLS - 1) / grad::COLS;
  const long blocks = (long)nb * ((m + mg - 1) / mg);
  const long slots = (long)sms * (per_sm > 0 ? per_sm : 1);
  // the share of the SMs' time that full waves would use; a split pays for
  // its partials, so it must gain 3 %
  auto fill = [&](int s) {
    const long b = blocks * s;
    return (double)b / (double)(((b + slots - 1) / slots) * slots);
  };
  plan.splits = 1;
  for (int s = 2; s <= 4 && s <= n_ct; ++s)
    if (fill(s) > fill(plan.splits) + 0.03) plan.splits = s;
  plan.scratch = (size_t)plan.splits * nb * m +
                 (size_t)(plan.splits - 1) * ((size_t)n2 * m + (size_t)m * n2 * d);
  return 0;
}

bool vec_ok(const float* z, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
}

int check_shape(int m, int n2, int d) {
  return (m <= 0 || m > MAX_MOD || n2 <= 0 || n2 % 2 || d <= 0)
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

}  // namespace

extern "C" {

const char* snag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// z (m, n2, d) unit rows, alpha (n2, m), beta (m,), v (n2,) 0/1 column
// validity; writes lse (m + 2, n2) in full.
int mixture_lse(const float* z, const float* alpha, const float* beta,
                const float* v, float* lse, int m, int n2, int d,
                float inv_tau, void* stream) {
  if (check_shape(m, n2, d)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n2 + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok(z, d))
    mixture_lse_kernel<true><<<grid, THREADS, 0, s>>>(z, alpha, beta, v, lse, m, n2, d, inv_tau);
  else
    mixture_lse_kernel<false><<<grid, THREADS, 0, s>>>(z, alpha, beta, v, lse, m, n2, d, inv_tau);
  return static_cast<int>(cudaGetLastError());
}

// Once per device, before the first mixture_grad on it: lets the gradient
// kernel take all the shared memory a block may opt in to, and returns the
// largest (modalities per block) x (d rounded up to a multiple of 8) its
// row accumulator then holds, or a negative CUDA error.
int mixture_grad_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grad::mixture_grad_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grad::mixture_grad_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long room = (long)optin - (long)grad::smem_bytes(grad::MIN_DEPTH, 0, 0);
  return room > 0 ? 8 * static_cast<int>(room / (sizeof(float) * grad::TILE_FLOATS)) : 0;
}

// The floats of scratch that mixture_grad needs at this shape (per-block
// dbeta partials, and the dalpha and dz partials of the column splits past
// the first), or a negative CUDA error.  Call after mixture_grad_init.
long mixture_grad_scratch(int m, int mg, int n2, int d) {
  if (check_shape(m, n2, d) || mg < 1 || mg > m)
    return -static_cast<long>(cudaErrorInvalidValue);
  GradPlan plan;
  const int err = grad_plan(m, mg, n2, d, plan);
  return err ? -static_cast<long>(err) : static_cast<long>(plan.scratch);
}

// z, alpha, beta, v as for mixture_lse; lse and coef (m + 2, n2); writes
// dz (m, n2, d), dalpha (n2, m) and dbeta (m,) in full, using part
// (mixture_grad_scratch floats) as scratch.  Each block handles mg
// modalities; mg x d rounded up to a multiple of 8 must not exceed what
// mixture_grad_init returned for this device.
int mixture_grad(const float* z, const float* alpha, const float* beta,
                 const float* lse, const float* coef, const float* v,
                 float* dz, float* dalpha, float* dbeta, float* part,
                 int m, int mg, int n2, int d, float inv_tau, void* stream) {
  if (check_shape(m, n2, d) || mg < 1 || mg > m)
    return static_cast<int>(cudaErrorInvalidValue);
  GradPlan plan;
  int err = grad_plan(m, mg, n2, d, plan);
  if (err) return err;
  const int nb = (n2 + grad::ROWS - 1) / grad::ROWS;
  const dim3 grid(nb, (m + mg - 1) / mg, plan.splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok(z, d))
    grad::mixture_grad_kernel<true><<<grid, grad::THREADS, plan.bytes, s>>>(
        z, alpha, beta, lse, coef, v, dz, dalpha, part, m, mg, n2, d, inv_tau,
        plan.depth);
  else
    grad::mixture_grad_kernel<false><<<grid, grad::THREADS, plan.bytes, s>>>(
        z, alpha, beta, lse, coef, v, dz, dalpha, part, m, mg, n2, d, inv_tau,
        plan.depth);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (plan.splits > 1) {
    const size_t parts = (size_t)plan.splits * nb * m;
    const size_t n_da = (size_t)n2 * m, n_dz = (size_t)m * n2 * d;
    mixture_sum_kernel<<<1024, REDUCE_THREADS, 0, s>>>(
        dalpha, part + parts, n_da, plan.splits - 1);
    mixture_sum_kernel<<<1024, REDUCE_THREADS, 0, s>>>(
        dz, part + parts + (plan.splits - 1) * n_da, n_dz, plan.splits - 1);
  }
  mixture_dbeta_kernel<<<m, REDUCE_THREADS, 0, s>>>(part, dbeta,
                                                    plan.splits * nb, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
