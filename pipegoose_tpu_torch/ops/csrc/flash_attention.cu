// Flash attention for Hopper (sm_90a): the forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of pipegoose_tpu/ops/flash_attention.py
// and computes the same functions:
//   flash_fwd_*  <- _flash_fwd_pallas :88  (pallas_call :152)
//   flash_dq_*   <- _flash_dq_pallas  :187 (pallas_call :242)
//   flash_dkv_*  <- _flash_dkv_pallas :270 (pallas_call :334)
//
// Layout, as the JAX wrapper flattens it: q (BH, S, HD); k, v (BH/g, S, HD),
// query row r reading kv row r / g (GQA, g = 1 for plain MHA); slopes (BH,);
// kv_pos, kv_neg (BH/g, S) float32. The score of (query i, key j) is
//   q_i . k_j * scale + (keep(i, j) ? slope * kv_pos[j] + kv_neg[j] : NEG_INF)
// with NEG_INF = -1e9 (finite, as in the JAX package): the causal test
// j <= i and the window test i - j < window are on the INDEX and REPLACE the
// ALiBi + padding term; kv_neg adds -1e9 for padded keys. Keys past S do not
// exist (probability exactly 0). Everything after the loads is float32:
//   fwd: out = softmax(scores) . v in q's dtype, lse = m + log(max(l, 1e-30));
//   dq:  dq = scale * sum_j p * (dO . v_j - delta) * k_j, p = exp(s - lse);
//   dkv: dv = P^T dO, dk = scale * dS^T q, PER QUERY HEAD (BH rows): the
//        wrapper sums the g heads that share a kv row.
//
// What bounds it on this card: per visible (query, key) pair the forward does
// 4*HD flops, dQ 6*HD and dK/dV 8*HD, while each call reads q, k, v (and dO,
// lse, delta) and writes its outputs once; at bloom-560m's attention (B*nh =
// 128, S = 1024, HD = 64, bf16) the bf16 tensor-core time of those flops and
// the device-memory time of those bytes are alike, 0.02-0.035 ms.
//
// Two routes for each kernel, picked by the wrapper (ops/flash_attention.py
// fwd_plan for the forward, bwd_plan for dQ and dK/dV): float32 inputs take
// the first, bf16 inputs the second.
//
// 1. The FMA route (flash_fwd_kernel, flash_dq_kernel, flash_dkv_kernel):
//    the simple first version, float32 FMAs on the CUDA cores (67 TFLOP/s
//    peak, not the tensor cores' 989), so these sit far above that bound,
//    limited by the FMA rate and by shared-memory reads (one 4-byte load per
//    2 FMAs in the 4 x 4 register micro-tiles). The TPU's sequential grid
//    axis becomes a loop inside one block:
//      fwd, dq: one block per (row of BH, 64-query tile); it walks the
//        64-key tiles from the window's first key to the diagonal (the
//        Pallas pl.when skip becomes the loop bound), carrying m, l and the
//        accumulator in registers (fwd) or the dQ accumulator (dq);
//      dkv: one block per (row of BH, 64-key tile); it walks the query
//        tiles from the diagonal on, so each block owns its dK/dV rows: no
//        atomics and no second pass.
//    256 threads as 16 x 16; thread (ty, tx) owns rows ty + 16a and columns
//    tx + 16b (a, b < 4) of every 64 x 64 score tile, and columns tx + 16c of
//    the HD-wide accumulators. Tiles are staged in shared memory as float32
//    rows of stride HD + 1, so a column walk over 16 consecutive rows hits
//    16 distinct banks. Row max and row sum of the online softmax are
//    reduced across the 16 lanes that share a row with warp shuffles. Rows
//    and keys past S (the ragged last tile) are staged as zeros and masked
//    to probability 0.
// 2. The tensor-core route (flash_fwd_mma_kernel, flash_dq_mma_kernel,
//    flash_dkv_mma_kernel): thin shells over the main loops they share with
//    the ring-chunk kernels B7-B9 (attn_mma.cuh fwd_mma_walk, dq_mma_walk,
//    dkv_mma_walk), with the flash walk and score of the policies below. The
//    same blocks and walks, the forward's and dq's query tiles in reverse so
//    that the longest walks start first, but 128 threads, four warps of 16
//    rows each of the block's own tile (fwd, dq: queries; dkv: keys); every
//    product is bf16 mma.sync.m16n8k16 with float32 accumulators, the
//    block's own tiles read from shared memory at each k step, the walked
//    tiles with their kv_pos, kv_neg (fwd, dq) or lse, delta (dkv) streaming
//    through a two-deep cp.async ring of 16-byte-padded bf16 rows. The
//    forward runs the online softmax in float32 registers, reduced over the
//    4 lanes of a quad, and packs P from the score's C fragments into A
//    fragments for acc += P V; dq and dkv recompute P = exp(s - lse) and dS
//    = P (dP - delta) in float32 registers and pack them the same way for
//    dQ += dS K, dV += P^T dO and dK += dS^T Q (dkv in passes of 16 queries).
//    exp is one ex2.approx (relative error ~2^-22). The causal and window
//    tests run per element only on the tiles that straddle them. A GQA block
//    reads kv row row / g. The forward's epilogue divides by max(l, 1e-30),
//    rounds to bf16 and writes lse; dq, dk and dv are scaled (dq and dk by
//    scale) and rounded to bf16. P and dS are rounded once to bf16 before
//    the second product (a relative 2^-9, as the TPU's matrix unit rounds
//    them at JAX's default precision); l sums the float32 p and every sum is
//    float32. So out, dq, dk and dv hold to 1e-5 + 2^-7 of the largest
//    |plain| value, the bf16 output tolerance they had before, and lse to
//    2^-21 of the largest, which only the order of the score's sums moves.
//    q, k, v and dO must start on a 16-byte boundary. Each warp reads the
//    whole walked tile from shared memory for its 16 rows, so shared-memory
//    traffic, not the tensor cores, bounds the loops: wgmma (one read a
//    warpgroup) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_mma.cuh"

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr int kTile = 64;        // queries per query tile = keys per key tile
constexpr int kSub = kTile / 16; // rows (and score columns) per thread
constexpr int kLdp = kTile + 1;  // row stride of a staged 64 x 64 score tile
static_assert(kTile == kMmaTile, "both routes walk 64 x 64 tile pairs");

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Stage rows [r0, r0 + kTile) of one (S, HD) matrix as float32 rows of
// stride HD + 1; rows past S read as zero.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src,
                                           int r0, int s) {
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    dst[r * (HD + 1) + d] =
        (r0 + r < s) ? to_f32(src[(int64_t)(r0 + r) * HD + d]) : 0.f;
  }
}

// Stage kTile entries [r0, r0 + kTile) of a per-position vector.
__device__ __forceinline__ void stage_vec(float* dst, const float* __restrict__ src,
                                          int r0, int s) {
  for (int e = threadIdx.x; e < kTile; e += kThreads)
    dst[e] = (r0 + e < s) ? src[r0 + e] : 0.f;
}

// acc[a][b] += A[ra + 16a] . B[rb + 16b] over staged rows of stride HD + 1.
template <int HD>
__device__ __forceinline__ void dot_tile(float (&acc)[kSub][kSub], const float* A,
                                         int ra, const float* B, int rb) {
  constexpr int kLd = HD + 1;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float x[kSub], y[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      x[i] = A[(ra + 16 * i) * kLd + d];
      y[i] = B[(rb + 16 * i) * kLd + d];
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// The additive term of score (i, j), _bias_block of the Pallas kernels.
__device__ __forceinline__ float bias_of(int i, int j, float slope, float kp, float kn,
                                         int causal, int window) {
  bool keep = true;
  if (causal) keep = keep && (j <= i);
  if (window > 0) keep = keep && (i - j < window);
  return keep ? slope * kp + kn : kNegInf;
}

// Reductions over the 16 lanes (tx = 0..15) that share a score row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Keys a query tile [q0, q0 + kTile) can see: [first, end), first a tile start.
__device__ __forceinline__ void key_range(int q0, int s, int causal, int window,
                                          int* first, int* end) {
  const int q_last = min(q0 + kTile, s) - 1;
  *end = causal ? q_last + 1 : s;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  *first = lo / kTile * kTile;
}

template <int HD>
constexpr size_t fwd_smem_floats() { return 3 * kTile * (HD + 1) + kTile * kLdp + 2 * kTile; }
template <int HD>
constexpr size_t dq_smem_floats() { return 4 * kTile * (HD + 1) + kTile * kLdp + 2 * kTile; }
template <int HD>
constexpr size_t dkv_smem_floats() { return 4 * kTile * (HD + 1) + 2 * kTile * kLdp + 2 * kTile; }

// ---------------------------------------------------------------------------
// Forward: grid (BH, ceil(S / 64)). Out in q's dtype, lse float32 (BH, S).

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ slopes,
                 const float* __restrict__ kpos, const float* __restrict__ kneg,
                 T* __restrict__ out, float* __restrict__ lse, int s, int g,
                 int causal, int window, float scale) {
  constexpr int kLd = HD + 1, kCw = HD / 16;
  const int row = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest walks first
  const int kvr = row / g;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* Qs = smem;               // [64][HD + 1]
  float* Ks = Qs + kTile * kLd;   // [64][HD + 1]
  float* Vs = Ks + kTile * kLd;   // [64][HD + 1]
  float* Ps = Vs + kTile * kLd;   // [64][65] probabilities of the tile
  float* KP = Ps + kTile * kLdp;  // [64] kv_pos of the key tile
  float* KN = KP + kTile;         // [64] kv_neg of the key tile

  const T* kr = k + (int64_t)kvr * s * HD;
  const T* vr = v + (int64_t)kvr * s * HD;
  const float slope = slopes[row];
  stage_rows<T, HD>(Qs, q + (int64_t)row * s * HD, q0, s);

  float m[kSub], l[kSub], acc[kSub][kCw];
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kCw; ++c) acc[a][c] = 0.f;
  }
  int k_first, k_end;
  key_range(q0, s, causal, window, &k_first, &k_end);
  for (int k0 = k_first; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and Qs staged)
    stage_rows<T, HD>(Ks, kr, k0, s);
    stage_rows<T, HD>(Vs, vr, k0, s);
    stage_vec(KP, kpos + (int64_t)kvr * s, k0, s);
    stage_vec(KN, kneg + (int64_t)kvr * s, k0, s);
    __syncthreads();
    float sc[kSub][kSub] = {};
    dot_tile<HD>(sc, Qs, ty, Ks, tx);
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const int i = q0 + ty + 16 * a;
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < kSub; ++b) {
        const int jl = tx + 16 * b, j = k0 + jl;
        sc[a][b] = j < s ? sc[a][b] * scale +
                               bias_of(i, j, slope, KP[jl], KN[jl], causal, window)
                         : -INFINITY;
        mx = fmaxf(mx, sc[a][b]);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < kSub; ++b) {
        const float p = expf(sc[a][b] - m_new);
        Ps[(ty + 16 * a) * kLdp + tx + 16 * b] = p;
        sum += p;
      }
      const float alpha = expf(m[a] - m_new);
      l[a] = l[a] * alpha + row_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < kCw; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {  // acc += P . V
      float p[kSub], vv[kCw];
#pragma unroll
      for (int a = 0; a < kSub; ++a) p[a] = Ps[(ty + 16 * a) * kLdp + j];
#pragma unroll
      for (int c = 0; c < kCw; ++c) vv[c] = Vs[j * kLd + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < kSub; ++a)
#pragma unroll
        for (int c = 0; c < kCw; ++c) acc[a][c] = fmaf(p[a], vv[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= s) continue;
    const float lv = fmaxf(l[a], 1e-30f);
    T* orow = out + ((int64_t)row * s + i) * HD;
#pragma unroll
    for (int c = 0; c < kCw; ++c) orow[tx + 16 * c] = from_f32<T>(acc[a][c] / lv);
    if (tx == 0) lse[(int64_t)row * s + i] = m[a] + logf(lv);
  }
}

// ---------------------------------------------------------------------------
// Forward on the tensor cores: grid (BH, ceil(S / 64)), the query tiles in
// reverse. Out bf16, lse float32 (BH, S).

// Whether the pair of the query tile at q0 and the key tile at k0 holds a
// pair (i, j) that the causal test (j > i) or the window test (i - j >=
// window) masks: only such a tile needs the per-element test.
__device__ __forceinline__ bool straddles(int q0, int k0, int causal, int window) {
  return (causal && k0 + kTile - 1 > q0) || (window > 0 && q0 + kTile - 1 - k0 >= window);
}

// The flash forward's score and walk for fwd_mma_walk: the key tiles of
// key_range, in order; the causal and window tests on the index, per
// element only on a tile that straddles one of them.
struct FlashFwdPolicy {
  int t_first, t_end, n_kt, q0, i0, causal, window;
  float scale, slope;
  __device__ int first() const { return t_first < t_end ? t_first : n_kt; }
  __device__ int next(int t) const { return t + 1 < t_end ? t + 1 : n_kt; }
  __device__ bool tested(int k0, const float*, int) const {
    return straddles(q0, k0, causal, window);
  }
  __device__ float score(float dot, int h, int j, float kp, float kn, bool test) const {
    return dot * scale +
           (test ? bias_of(i0 + 8 * h, j, slope, kp, kn, causal, window) : slope * kp + kn);
  }
};

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, FwdSmem<HD>::kMinBlocks)
flash_fwd_mma_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, const float* __restrict__ slopes,
                     const float* __restrict__ kpos, const float* __restrict__ kneg,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int s, int g,
                     int causal, int window, float scale) {
  constexpr int ND = HD / 8;
  const int row = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest walks first
  const int kvr = row / g;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = lane % 4;
  const int i0 = q0 + 16 * warp + lane / 4;   // this lane's rows: i0 and i0 + 8
  int k_first, k_end;
  key_range(q0, s, causal, window, &k_first, &k_end);
  const FlashFwdPolicy pol{k_first / kTile, (k_end + kTile - 1) / kTile, (s + kTile - 1) / kTile,
                           q0, i0, causal, window, scale, slopes[row]};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int64_t kvo = (int64_t)kvr * s;
  fwd_mma_walk<HD>(m, l, acc, q + (int64_t)row * s * HD, q0, s, k + kvo * HD, v + kvo * HD,
                   kpos + kvo, kneg + kvo, s, pol);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 8 * h;
    if (i >= s) continue;
    const float lv = fmaxf(l[h], 1e-30f);
    const int64_t r = (int64_t)row * s + i;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + r * HD + 8 * n + 2 * c) =
          __floats2bfloat162_rn(acc[n][2 * h] / lv, acc[n][2 * h + 1] / lv);
    if (c == 0) lse[r] = m[h] + logf(lv);
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (BH, ceil(S / 64)). dq in q's dtype.

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ slopes, const float* __restrict__ kpos,
                const float* __restrict__ kneg, T* __restrict__ dq, int s, int g,
                int causal, int window, float scale) {
  constexpr int kLd = HD + 1, kCw = HD / 16;
  const int row = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int kvr = row / g;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* Qs = smem;               // [64][HD + 1]
  float* Os = Qs + kTile * kLd;   // [64][HD + 1] dO
  float* Ks = Os + kTile * kLd;   // [64][HD + 1]
  float* Vs = Ks + kTile * kLd;   // [64][HD + 1]
  float* Ds = Vs + kTile * kLd;   // [64][65] dS of the tile
  float* KP = Ds + kTile * kLdp;
  float* KN = KP + kTile;

  const T* kr = k + (int64_t)kvr * s * HD;
  const T* vr = v + (int64_t)kvr * s * HD;
  const float slope = slopes[row];
  stage_rows<T, HD>(Qs, q + (int64_t)row * s * HD, q0, s);
  stage_rows<T, HD>(Os, dout + (int64_t)row * s * HD, q0, s);
  float lse_r[kSub], dl_r[kSub], acc[kSub][kCw];
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int i = q0 + ty + 16 * a;
    lse_r[a] = i < s ? lse[(int64_t)row * s + i] : 0.f;
    dl_r[a] = i < s ? delta[(int64_t)row * s + i] : 0.f;
#pragma unroll
    for (int c = 0; c < kCw; ++c) acc[a][c] = 0.f;
  }
  int k_first, k_end;
  key_range(q0, s, causal, window, &k_first, &k_end);
  for (int k0 = k_first; k0 < k_end; k0 += kTile) {
    __syncthreads();
    stage_rows<T, HD>(Ks, kr, k0, s);
    stage_rows<T, HD>(Vs, vr, k0, s);
    stage_vec(KP, kpos + (int64_t)kvr * s, k0, s);
    stage_vec(KN, kneg + (int64_t)kvr * s, k0, s);
    __syncthreads();
    float sc[kSub][kSub] = {}, dp[kSub][kSub] = {};
    dot_tile<HD>(sc, Qs, ty, Ks, tx);
    dot_tile<HD>(dp, Os, ty, Vs, tx);
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const int i = q0 + ty + 16 * a;
#pragma unroll
      for (int b = 0; b < kSub; ++b) {
        const int jl = tx + 16 * b, j = k0 + jl;
        float p = 0.f;
        if (i < s && j < s)
          p = expf(sc[a][b] * scale +
                   bias_of(i, j, slope, KP[jl], KN[jl], causal, window) - lse_r[a]);
        Ds[(ty + 16 * a) * kLdp + jl] = p * (dp[a][b] - dl_r[a]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {  // acc += dS . K
      float ds[kSub], kk[kCw];
#pragma unroll
      for (int a = 0; a < kSub; ++a) ds[a] = Ds[(ty + 16 * a) * kLdp + j];
#pragma unroll
      for (int c = 0; c < kCw; ++c) kk[c] = Ks[j * kLd + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < kSub; ++a)
#pragma unroll
        for (int c = 0; c < kCw; ++c) acc[a][c] = fmaf(ds[a], kk[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= s) continue;
    T* drow = dq + ((int64_t)row * s + i) * HD;
#pragma unroll
    for (int c = 0; c < kCw; ++c) drow[tx + 16 * c] = from_f32<T>(scale * acc[a][c]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: grid (BH, ceil(S / 64)), one block per 64-key tile of one query
// head. dk, dv (BH, S, HD) in k's dtype.

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ slopes, const float* __restrict__ kpos,
                 const float* __restrict__ kneg, T* __restrict__ dk,
                 T* __restrict__ dv, int s, int g, int causal, int window,
                 float scale) {
  constexpr int kLd = HD + 1, kCw = HD / 16;
  const int row = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // early key tiles walk the most queries
  const int kvr = row / g;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* Ks = smem;               // [64][HD + 1]
  float* Vs = Ks + kTile * kLd;   // [64][HD + 1]
  float* Qs = Vs + kTile * kLd;   // [64][HD + 1]
  float* Os = Qs + kTile * kLd;   // [64][HD + 1] dO
  float* Pt = Os + kTile * kLd;   // [64 keys][65] P^T of the tile
  float* Dt = Pt + kTile * kLdp;  // [64 keys][65] dS^T of the tile
  float* LS = Dt + kTile * kLdp;  // [64] lse of the query tile
  float* DL = LS + kTile;         // [64] delta of the query tile

  const float slope = slopes[row];
  stage_rows<T, HD>(Ks, k + (int64_t)kvr * s * HD, k0, s);
  stage_rows<T, HD>(Vs, v + (int64_t)kvr * s * HD, k0, s);
  const T* qr = q + (int64_t)row * s * HD;
  const T* dor = dout + (int64_t)row * s * HD;
  float kp[kSub], kn[kSub], dk_acc[kSub][kCw], dv_acc[kSub][kCw];
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int j = k0 + ty + 16 * a;
    kp[a] = j < s ? kpos[(int64_t)kvr * s + j] : 0.f;
    kn[a] = j < s ? kneg[(int64_t)kvr * s + j] : 0.f;
#pragma unroll
    for (int c = 0; c < kCw; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;
  }
  // queries that can see a key of the tile: [q_first, q_end)
  const int k_last = min(k0 + kTile, s) - 1;
  const int q_first = causal ? k0 : 0;
  const int q_end = window > 0 ? min(s, k_last + window) : s;
  for (int q0 = q_first / kTile * kTile; q0 < q_end; q0 += kTile) {
    __syncthreads();
    stage_rows<T, HD>(Qs, qr, q0, s);
    stage_rows<T, HD>(Os, dor, q0, s);
    stage_vec(LS, lse + (int64_t)row * s, q0, s);
    stage_vec(DL, delta + (int64_t)row * s, q0, s);
    __syncthreads();
    float st[kSub][kSub] = {}, dpt[kSub][kSub] = {};
    dot_tile<HD>(st, Ks, ty, Qs, tx);   // S^T: key rows, query columns
    dot_tile<HD>(dpt, Vs, ty, Os, tx);  // (dO . V^T)^T
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const int j = k0 + ty + 16 * a;
#pragma unroll
      for (int b = 0; b < kSub; ++b) {
        const int il = tx + 16 * b, i = q0 + il;
        float p = 0.f;
        if (i < s && j < s)
          p = expf(st[a][b] * scale + bias_of(i, j, slope, kp[a], kn[a], causal, window) -
                   LS[il]);
        Pt[(ty + 16 * a) * kLdp + il] = p;
        Dt[(ty + 16 * a) * kLdp + il] = p * (dpt[a][b] - DL[il]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {  // dv += P^T . dO, dk += dS^T . Q
      float p[kSub], ds[kSub], oo[kCw], qq[kCw];
#pragma unroll
      for (int a = 0; a < kSub; ++a) {
        p[a] = Pt[(ty + 16 * a) * kLdp + i];
        ds[a] = Dt[(ty + 16 * a) * kLdp + i];
      }
#pragma unroll
      for (int c = 0; c < kCw; ++c) {
        oo[c] = Os[i * kLd + tx + 16 * c];
        qq[c] = Qs[i * kLd + tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < kSub; ++a)
#pragma unroll
        for (int c = 0; c < kCw; ++c) {
          dv_acc[a][c] = fmaf(p[a], oo[c], dv_acc[a][c]);
          dk_acc[a][c] = fmaf(ds[a], qq[c], dk_acc[a][c]);
        }
    }
  }
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= s) continue;
    T* krow = dk + ((int64_t)row * s + j) * HD;
    T* vrow = dv + ((int64_t)row * s + j) * HD;
#pragma unroll
    for (int c = 0; c < kCw; ++c) {
      krow[tx + 16 * c] = from_f32<T>(scale * dk_acc[a][c]);
      vrow[tx + 16 * c] = from_f32<T>(dv_acc[a][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ and dK/dV on the tensor cores, on the backward main loops of
// attn_mma.cuh.

// The flash backward's walk and score for dq_mma_walk and dkv_mma_walk: the
// walked tiles [t_first, t_end) in order (dq: the key tiles of key_range;
// dkv: the query tiles from the key tile's diagonal to the window's far
// edge); the causal and window tests on the index, per element only on a
// tile pair that straddles one of them.
struct FlashBwdPolicy {
  int t_first, t_end, n_t, causal, window;
  float scale, slope;
  static constexpr bool kQueryPos = false;
  __device__ int first() const { return t_first < t_end ? t_first : n_t; }
  __device__ int next(int t) const { return t + 1 < t_end ? t + 1 : n_t; }
  __device__ bool tested(int q0, int k0) const { return straddles(q0, k0, causal, window); }
  __device__ float score(float dot, int i, int j, float kp, float kn, float, bool test) const {
    return dot * scale +
           (test ? bias_of(i, j, slope, kp, kn, causal, window) : slope * kp + kn);
  }
  __device__ static float prob(float x) { return exp_approx(x); }
};

// dQ: grid (BH, ceil(S / 64)), the query tiles in reverse (query tile t
// walks t + 1 key tiles under the causal mask). dq bf16 (BH, S, HD).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, BwdSmem<HD>::kMinBlocks)
flash_dq_mma_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ slopes, const float* __restrict__ kpos,
                    const float* __restrict__ kneg, __nv_bfloat16* __restrict__ dq, int s,
                    int g, int causal, int window, float scale) {
  constexpr int ND = HD / 8;
  const int row = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;   // longest walks first
  int k_first, k_end;
  key_range(q0, s, causal, window, &k_first, &k_end);
  const FlashBwdPolicy pol{k_first / kTile, (k_end + kTile - 1) / kTile, (s + kTile - 1) / kTile,
                           causal, window, scale, slopes[row]};
  const int64_t rs = (int64_t)row * s, kvo = (int64_t)(row / g) * s;
  float acc[ND][4];
  dq_mma_walk<HD>(acc, q + rs * HD, dout + rs * HD, lse + rs, delta + rs, nullptr, q0, s,
                  k + kvo * HD, v + kvo * HD, kpos + kvo, kneg + kvo, s, pol);
  const int lane = threadIdx.x % 32, c = lane % 4;
  const int i0 = q0 + 16 * (threadIdx.x / 32) + lane / 4;   // this lane's rows: i0, i0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (i0 + 8 * h >= s) continue;
    __nv_bfloat16* out = dq + (rs + i0 + 8 * h) * HD + 2 * c;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
          __floats2bfloat162_rn(scale * acc[n][2 * h], scale * acc[n][2 * h + 1]);
  }
}

// dK/dV: grid (BH, ceil(S / 64)), one block per 64-key tile of one query
// head (key tile t walks the n - t query tiles from its diagonal on under
// the causal mask). dk, dv bf16 (BH, S, HD).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, BwdSmem<HD>::kMinBlocks)
flash_dkv_mma_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ slopes, const float* __restrict__ kpos,
                     const float* __restrict__ kneg, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int s, int g, int causal, int window,
                     float scale) {
  constexpr int ND = HD / 8;
  const int row = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  // queries that can see a key of the tile: [q_first, q_end)
  const int k_last = min(k0 + kTile, s) - 1;
  const int q_first = causal ? k0 : 0;
  const int q_end = window > 0 ? min(s, k_last + window) : s;
  const FlashBwdPolicy pol{q_first / kTile, (q_end + kTile - 1) / kTile, (s + kTile - 1) / kTile,
                           causal, window, scale, slopes[row]};
  const int64_t rs = (int64_t)row * s, kvo = (int64_t)(row / g) * s;
  float dk_acc[ND][4], dv_acc[ND][4];
  dkv_mma_walk<HD>(dk_acc, dv_acc, k + kvo * HD, v + kvo * HD, kpos + kvo, kneg + kvo, k0, s,
                   q + rs * HD, dout + rs * HD, lse + rs, delta + rs, nullptr, s, pol);
  const int lane = threadIdx.x % 32, c = lane % 4;
  const int j0 = k0 + 16 * (threadIdx.x / 32) + lane / 4;   // this lane's keys: j0, j0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (j0 + 8 * h >= s) continue;
    const int64_t at = (rs + j0 + 8 * h) * HD + 2 * c;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * n) =
          __floats2bfloat162_rn(scale * dk_acc[n][2 * h], scale * dk_acc[n][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * n) =
          __floats2bfloat162_rn(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch: the opt-in to more than 48 KB of dynamic shared memory is set once
// per instantiation, at its first launch, so that later launches (a CUDA
// graph capture among them) only queue the kernel.

template <typename Kernel, typename... Args>
int launch(Kernel kernel, bool* opted_in, size_t smem, int threads, int bh, int s,
           cudaStream_t stream, Args... args) {
  if (!*opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    *opted_in = true;
  }
  const dim3 grid(bh, (s + kTile - 1) / kTile);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

using cf = const float*;
using cb = const uint16_t*;

// The forward: float32 inputs on the FMA kernel, bf16 on the tensor cores.
template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, const void* slopes,
        const void* kpos, const void* kneg, void* out, void* lse, int bh, int s,
        int g, int causal, int window, float scale, cudaStream_t stream) {
  static bool opted_in = false;
  if constexpr (std::is_same_v<T, float>)
    return launch(flash_fwd_kernel<float, HD>, &opted_in, fwd_smem_floats<HD>() * sizeof(float),
                  kThreads, bh, s, stream, static_cast<cf>(q), static_cast<cf>(k),
                  static_cast<cf>(v), static_cast<cf>(slopes), static_cast<cf>(kpos),
                  static_cast<cf>(kneg), static_cast<float*>(out), static_cast<float*>(lse), s,
                  g, causal, window, scale);
  else
    return launch(flash_fwd_mma_kernel<HD>, &opted_in, FwdSmem<HD>::kBytes, kMmaThreads, bh, s,
                  stream, static_cast<cb>(q), static_cast<cb>(k), static_cast<cb>(v),
                  static_cast<cf>(slopes), static_cast<cf>(kpos), static_cast<cf>(kneg),
                  static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), s, g, causal,
                  window, scale);
}

// dQ and dK/dV: float32 inputs on the FMA kernels, bf16 on the tensor cores.
template <typename T, int HD>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, const void* slopes, const void* kpos,
       const void* kneg, void* dq_out, int bh, int s, int g, int causal,
       int window, float scale, cudaStream_t stream) {
  static bool opted_in = false;
  if constexpr (std::is_same_v<T, float>)
    return launch(flash_dq_kernel<float, HD>, &opted_in, dq_smem_floats<HD>() * sizeof(float),
                  kThreads, bh, s, stream, static_cast<cf>(q), static_cast<cf>(k),
                  static_cast<cf>(v), static_cast<cf>(dout), static_cast<cf>(lse),
                  static_cast<cf>(delta), static_cast<cf>(slopes), static_cast<cf>(kpos),
                  static_cast<cf>(kneg), static_cast<float*>(dq_out), s, g, causal, window,
                  scale);
  else
    return launch(flash_dq_mma_kernel<HD>, &opted_in, BwdSmem<HD>::kBytes, kMmaThreads, bh, s,
                  stream, static_cast<cb>(q), static_cast<cb>(k), static_cast<cb>(v),
                  static_cast<cb>(dout), static_cast<cf>(lse), static_cast<cf>(delta),
                  static_cast<cf>(slopes), static_cast<cf>(kpos), static_cast<cf>(kneg),
                  static_cast<__nv_bfloat16*>(dq_out), s, g, causal, window, scale);
}

template <typename T, int HD>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* slopes, const void* kpos,
        const void* kneg, void* dk, void* dv, int bh, int s, int g, int causal,
        int window, float scale, cudaStream_t stream) {
  static bool opted_in = false;
  if constexpr (std::is_same_v<T, float>)
    return launch(flash_dkv_kernel<float, HD>, &opted_in, dkv_smem_floats<HD>() * sizeof(float),
                  kThreads, bh, s, stream, static_cast<cf>(q), static_cast<cf>(k),
                  static_cast<cf>(v), static_cast<cf>(dout), static_cast<cf>(lse),
                  static_cast<cf>(delta), static_cast<cf>(slopes), static_cast<cf>(kpos),
                  static_cast<cf>(kneg), static_cast<float*>(dk), static_cast<float*>(dv), s,
                  g, causal, window, scale);
  else
    return launch(flash_dkv_mma_kernel<HD>, &opted_in, BwdSmem<HD>::kBytes, kMmaThreads, bh, s,
                  stream, static_cast<cb>(q), static_cast<cb>(k), static_cast<cb>(v),
                  static_cast<cb>(dout), static_cast<cf>(lse), static_cast<cf>(delta),
                  static_cast<cf>(slopes), static_cast<cf>(kpos), static_cast<cf>(kneg),
                  static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), s, g,
                  causal, window, scale);
}

}  // namespace

// Entry points, one per kernel and dtype (float32, bf16), head_dim 32, 64 or
// 128. causal is 0 or 1; window <= 0 means no window. The bf16 entries launch
// the tensor-core kernels, whose 16-byte copies need q, k, v (and dO) to
// start on a 16-byte boundary. Each returns the launch's cudaError_t: 0 when
// the kernel was queued on `stream`.
#define FLASH_ENTRIES(SUFFIX, T)                                                    \
  extern "C" int flash_fwd_##SUFFIX(                                                \
      const void* q, const void* k, const void* v, const void* slopes,              \
      const void* kpos, const void* kneg, void* out, void* lse, int bh, int s,      \
      int hd, int g, int causal, int window, float scale, void* stream) {           \
    auto st = static_cast<cudaStream_t>(stream);                                    \
    switch (hd) {                                                                   \
      case 32: return fwd<T, 32>(q, k, v, slopes, kpos, kneg, out, lse, bh, s, g,   \
                                 causal, window, scale, st);                        \
      case 64: return fwd<T, 64>(q, k, v, slopes, kpos, kneg, out, lse, bh, s, g,   \
                                 causal, window, scale, st);                        \
      case 128: return fwd<T, 128>(q, k, v, slopes, kpos, kneg, out, lse, bh, s, g, \
                                   causal, window, scale, st);                      \
      default: return (int)cudaErrorInvalidValue;                                   \
    }                                                                               \
  }                                                                                 \
  extern "C" int flash_dq_##SUFFIX(                                                 \
      const void* q, const void* k, const void* v, const void* dout,                \
      const void* lse, const void* delta, const void* slopes, const void* kpos,     \
      const void* kneg, void* dq_out, int bh, int s, int hd, int g, int causal,     \
      int window, float scale, void* stream) {                                      \
    auto st = static_cast<cudaStream_t>(stream);                                    \
    switch (hd) {                                                                   \
      case 32: return dq<T, 32>(q, k, v, dout, lse, delta, slopes, kpos, kneg,      \
                                dq_out, bh, s, g, causal, window, scale, st);       \
      case 64: return dq<T, 64>(q, k, v, dout, lse, delta, slopes, kpos, kneg,      \
                                dq_out, bh, s, g, causal, window, scale, st);       \
      case 128: return dq<T, 128>(q, k, v, dout, lse, delta, slopes, kpos, kneg,    \
                                  dq_out, bh, s, g, causal, window, scale, st);     \
      default: return (int)cudaErrorInvalidValue;                                   \
    }                                                                               \
  }                                                                                 \
  extern "C" int flash_dkv_##SUFFIX(                                                \
      const void* q, const void* k, const void* v, const void* dout,                \
      const void* lse, const void* delta, const void* slopes, const void* kpos,     \
      const void* kneg, void* dk, void* dv, int bh, int s, int hd, int g,           \
      int causal, int window, float scale, void* stream) {                          \
    auto st = static_cast<cudaStream_t>(stream);                                    \
    switch (hd) {                                                                   \
      case 32: return dkv<T, 32>(q, k, v, dout, lse, delta, slopes, kpos, kneg, dk, \
                                 dv, bh, s, g, causal, window, scale, st);          \
      case 64: return dkv<T, 64>(q, k, v, dout, lse, delta, slopes, kpos, kneg, dk, \
                                 dv, bh, s, g, causal, window, scale, st);          \
      case 128: return dkv<T, 128>(q, k, v, dout, lse, delta, slopes, kpos, kneg,   \
                                   dk, dv, bh, s, g, causal, window, scale, st);    \
      default: return (int)cudaErrorInvalidValue;                                   \
    }                                                                               \
  }

FLASH_ENTRIES(f32, float)
FLASH_ENTRIES(bf16, __nv_bfloat16)
