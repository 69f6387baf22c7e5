// Ring-attention chunk kernels for Hopper (sm_90a): one ring step's forward
// update, and that chunk's dQ and dK/dV.
//
// Replaces the three Pallas TPU kernels of pipegoose_tpu/ops/flash_attention.py
// that ring_flash_attention (nn/sequence_parallel/ring_attention.py) calls
// once per ring step, and computes the same functions:
//   flash_chunk_fwd_*  <- _flash_chunk_pallas :371 (pallas_call :436)
//   flash_chunk_dq_*   <- _chunk_dq_pallas    :514 (pallas_call :567)
//   flash_chunk_dkv_*  <- _chunk_dkv_pallas   :596 (pallas_call :653)
//
// Layout, as the ring flattens it: q, dO (BH, Sq, HD); k, v (BH/g, Skv, HD),
// query row r reading kv row r / g (GQA); slopes (BH,); qpos (BH, Sq); kpos,
// kneg (BH/g, Skv); all of these float32 but q, k, v, dO. The score of
// (query i, key j) is
//   q_i . k_j * scale + slope * kpos[j] + kneg[j] + (kpos[j] <= qpos[i] ? 0 : NEG_INF)
// with NEG_INF = -1e9, finite and ADDED: the causal test is on the position
// VALUES the ring passes (global positions of this chunk's queries and of the
// resident K/V chunk), never on the index, and it does not replace the ALiBi
// + padding term (the flash kernels of flash_attention.cu test the index and
// replace it). kneg carries the padding and, under mask-aware ALiBi, the
// per-head correction slope * (alibi_pos - kpos). Keys past Skv do not exist
// (probability exactly 0). Everything after the loads is float32, and so is
// every output:
//   fwd: reads the carried unnormalized online-softmax state (m, l, acc) of
//        each query row and writes it updated against this K/V chunk; the
//        ring normalizes once, after its last step;
//   dq:  dq = scale * sum_j p * (dO . v_j - delta) * k_j, p = exp(s - lse)
//        with the FINAL lse, so chunks' contributions simply add;
//   dkv: dv = P^T dO, dk = scale * dS^T q, PER QUERY HEAD (BH rows): the ring
//        sums the g heads that share a kv row.
// A (64-query tile, 64-key tile) pair with min(kpos) > max(qpos) over its
// valid rows is skipped whole, as the Pallas kernels skip their blocks: every
// key of it lies in the future of every query, so a row that has already
// seen a key is left bit for bit as it was (p = 0, alpha = 1). Only a row
// that has seen no unmasked key yet (m still near NEG_INF: a padded query)
// can come out otherwise than from the dense formula; the models zero it.
//
// What bounds it on this card: per visible (query, key) pair the forward does
// 4*HD flops, dQ 6*HD and dK/dV 8*HD, against one read of each input and one
// write of each output (the forward also reads and writes the float32 state,
// acc of the same size as q in float32). At the ring's diagonal chunk of
// bloom-560m at 8192 tokens (BH = 16, S = 8192, HD = 64, bf16) the flops
// at 989 TFLOP/s bf16 take 0.14-0.28 ms and the bytes at 3.35 TB/s about a
// tenth of that: the operations bound it.
//
// Two routes, picked by the wrapper (ops/flash_attention.py fwd_plan for the
// forward, chunk_bwd_plan for dQ and dK/dV):
//
// 1. The FMA route: float32 inputs, whose rounding to bf16 would change the
//    function. float32 FMAs on the CUDA cores (67 TFLOP/s peak, not the
//    tensor cores' 989) from 64 x 64 tiles staged in shared memory, so these
//    sit far above the bound.
//    - The TPU's sequential grid axis becomes a loop inside one block. fwd,
//      dq: one block per (row of BH, 64-query tile); it walks every 64-key
//      tile of the chunk, skipping fully-future ones, with the state (fwd)
//      or the dQ accumulator (dq) in registers. dkv: one block per (row of
//      BH, 64-key tile); it walks every query tile, so each block owns its
//      dK/dV rows: no atomics and no second pass.
//    - The skip test reads the tile's positions from shared memory, so
//      every thread of a block takes the same branch. 256 threads as 16 x
//      16; thread (ty, tx) owns rows ty + 16a and columns tx + 16b (a, b <
//      4) of every 64 x 64 score tile, and columns tx + 16c of the HD-wide
//      accumulators. Tiles are staged as float32 rows of stride HD + 1 (a
//      column walk over 16 rows hits 16 distinct banks); row max and row
//      sum are reduced over the 16 lanes of a row with warp shuffles.
//      Ragged tiles are staged as zeros and masked.
// 2. The tensor-core route, bf16 inputs: chunk_fwd_mma_kernel (B7),
//    chunk_dq_mma_kernel (B8) and chunk_dkv_mma_kernel (B9), thin shells over
//    the main loops of attn_mma.cuh (fwd_mma_walk, dq_mma_walk,
//    dkv_mma_walk), which the flash kernels B1-B3 of flash_attention.cu
//    share; the policies below give the ring's walk and score. Same blocks
//    and walks as the FMA route, same skip and score order, but every
//    product runs as bf16 mma.sync.m16n8k16 with float32 accumulators:
//    - 128 threads, four warps of 16 rows each of the block's own 64-row
//      tile (fwd, dq: queries; dkv: keys), staged once and read by ldmatrix
//      as A fragments from shared memory at each k step, so that the
//      kernels fit 128 registers and an SM holds 4 blocks at HD <= 64.
//    - The walked tiles stream through a two-deep cp.async ring: the next
//      visible tile is in flight while the block computes on this one.
//    - fwd: the online softmax in float32 registers, exp as one
//      ex2.approx (relative error ~2^-22; expf cost 12% more). A full key
//      tile wholly at or before every query of the block skips the
//      per-element position test (its causal term is 0 everywhere): on the
//      diagonal chunk every pair but the diagonal's. The carried (m, l,
//      acc) is read into registers and written back.
//    - dq, dkv: P = expf(s - lse) and dS = P (dP - delta) in float32
//      registers, every element tested against the position values.
//    - P (fwd, dq, dkv) and dS (dq, dkv) are rounded once to bf16 before the
//      second product (a relative 2^-9 each, as the TPU's matrix unit
//      rounds them at JAX's default precision); every sum is float32, and
//      the forward's l sums the float32 p. So acc, dq, dk and dv hold to
//      1e-5 + 2^-7 of the largest value of their plain versions, and m and
//      l to the float32 bounds (m 2^-21 of the largest, l 2e-4), which only
//      the order of the score's sums moves.
//    - The skip test takes a tile's smallest or largest position from a
//      warp reduction of its 64 positions read from device memory, four
//      tiles a round: every warp reads the same values and reduces them in
//      the same order, so the block agrees on the branch without a
//      barrier, and a skipped tile is never staged. Positions need not be
//      monotone.
//    - On the diagonal chunk the forward's and dq's query tile i walks
//      i + 1 key tiles and dkv's key tile j walks n - j query tiles: the
//      forward's and dq's grids run the query tiles in reverse, so on every
//      kernel the longest blocks start first.
//    - No atomics, no workspace: a repeat call gives the same bits.
// Both routes write float32 outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_mma.cuh"

namespace {

constexpr int kThreads = 256;    // FMA route: 16 x 16
constexpr int kTile = 64;        // queries per query tile = keys per key tile
constexpr int kSub = kTile / 16; // rows (and score columns) per thread
constexpr int kLdp = kTile + 1;  // row stride of a staged 64 x 64 score tile
static_assert(kTile == kMmaTile, "both routes walk 64 x 64 tile pairs");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// Smallest and largest of the first n staged positions (n >= 1). Every
// thread reads the same shared values, so every thread gets the same answer.
__device__ __forceinline__ float vec_min(const float* v, int n) {
  float x = INFINITY;
  for (int e = 0; e < n; ++e) x = fminf(x, v[e]);
  return x;
}
__device__ __forceinline__ float vec_max(const float* v, int n) {
  float x = -INFINITY;
  for (int e = 0; e < n; ++e) x = fmaxf(x, v[e]);
  return x;
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

// The score of (query at qp, key at kp) from its dot product, in the order
// of the Pallas body: scaled dot, + slope * kpos, + kneg, + the causal term.
__device__ __forceinline__ float score(float dot, float scale, float slope, float kp,
                                       float kn, float qp) {
  const float s = dot * scale + slope * kp + kn;
  return s + (kp <= qp ? 0.f : kNegInf);
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

template <int HD>
constexpr size_t fwd_smem_floats() { return 3 * kTile * (HD + 1) + kTile * kLdp + 3 * kTile; }
template <int HD>
constexpr size_t dq_smem_floats() { return 4 * kTile * (HD + 1) + kTile * kLdp + 3 * kTile; }
template <int HD>
constexpr size_t dkv_smem_floats() { return 4 * kTile * (HD + 1) + 2 * kTile * kLdp + 4 * kTile; }

// ---------------------------------------------------------------------------
// Forward: grid (BH, ceil(Sq / 64)). Reads (m, l, acc) in, writes them out.

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
chunk_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ slopes,
                 const float* __restrict__ qpos, const float* __restrict__ kpos,
                 const float* __restrict__ kneg, const float* __restrict__ m_in,
                 const float* __restrict__ l_in, const float* __restrict__ acc_in,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 float* __restrict__ acc_out, int sq, int skv, int g, float scale) {
  constexpr int kLd = HD + 1, kCw = HD / 16;
  const int row = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int kvr = row / g;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* Qs = smem;               // [64][HD + 1]
  float* Ks = Qs + kTile * kLd;   // [64][HD + 1]
  float* Vs = Ks + kTile * kLd;   // [64][HD + 1]
  float* Ps = Vs + kTile * kLd;   // [64][65] probabilities of the tile
  float* KP = Ps + kTile * kLdp;  // [64] kpos of the key tile
  float* KN = KP + kTile;         // [64] kneg of the key tile
  float* QP = KN + kTile;         // [64] qpos of the query tile

  const T* kr = k + (int64_t)kvr * skv * HD;
  const T* vr = v + (int64_t)kvr * skv * HD;
  const float* kpr = kpos + (int64_t)kvr * skv;
  const float* knr = kneg + (int64_t)kvr * skv;
  const int64_t rs = (int64_t)row * sq;  // first entry of this row's (Sq,) vectors
  const float slope = slopes[row];
  stage_rows<T, HD>(Qs, q + rs * HD, q0, sq);
  stage_vec(QP, qpos + rs, q0, sq);

  float m[kSub], l[kSub], qp[kSub], acc[kSub][kCw];
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int i = q0 + ty + 16 * a;
    const bool ok = i < sq;
    m[a] = ok ? m_in[rs + i] : kNegInf;
    l[a] = ok ? l_in[rs + i] : 0.f;
    qp[a] = ok ? qpos[rs + i] : 0.f;
#pragma unroll
    for (int c = 0; c < kCw; ++c)
      acc[a][c] = ok ? acc_in[(rs + i) * HD + tx + 16 * c] : 0.f;
  }
  __syncthreads();
  const float q_max = vec_max(QP, min(kTile, sq - q0));

  for (int k0 = 0; k0 < skv; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage_vec(KP, kpr, k0, skv);
    stage_vec(KN, knr, k0, skv);
    __syncthreads();
    if (vec_min(KP, min(kTile, skv - k0)) > q_max) continue;  // fully future
    stage_rows<T, HD>(Ks, kr, k0, skv);
    stage_rows<T, HD>(Vs, vr, k0, skv);
    __syncthreads();
    float sc[kSub][kSub] = {};
    dot_tile<HD>(sc, Qs, ty, Ks, tx);
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < kSub; ++b) {
        const int jl = tx + 16 * b;
        sc[a][b] = k0 + jl < skv
                       ? score(sc[a][b], scale, slope, KP[jl], KN[jl], qp[a])
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
    if (i >= sq) continue;
#pragma unroll
    for (int c = 0; c < kCw; ++c) acc_out[(rs + i) * HD + tx + 16 * c] = acc[a][c];
    if (tx == 0) {
      m_out[rs + i] = m[a];
      l_out[rs + i] = l[a];
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (BH, ceil(Sq / 64)). dq float32 (BH, Sq, HD).

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
chunk_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ slopes, const float* __restrict__ qpos,
                const float* __restrict__ kpos, const float* __restrict__ kneg,
                float* __restrict__ dq, int sq, int skv, int g, float scale) {
  constexpr int kLd = HD + 1, kCw = HD / 16;
  const int row = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
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
  float* QP = KN + kTile;

  const T* kr = k + (int64_t)kvr * skv * HD;
  const T* vr = v + (int64_t)kvr * skv * HD;
  const float* kpr = kpos + (int64_t)kvr * skv;
  const float* knr = kneg + (int64_t)kvr * skv;
  const int64_t rs = (int64_t)row * sq;
  const float slope = slopes[row];
  stage_rows<T, HD>(Qs, q + rs * HD, q0, sq);
  stage_rows<T, HD>(Os, dout + rs * HD, q0, sq);
  stage_vec(QP, qpos + rs, q0, sq);
  float lse_r[kSub], dl_r[kSub], qp[kSub], acc[kSub][kCw];
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int i = q0 + ty + 16 * a;
    const bool ok = i < sq;
    lse_r[a] = ok ? lse[rs + i] : 0.f;
    dl_r[a] = ok ? delta[rs + i] : 0.f;
    qp[a] = ok ? qpos[rs + i] : 0.f;
#pragma unroll
    for (int c = 0; c < kCw; ++c) acc[a][c] = 0.f;
  }
  __syncthreads();
  const float q_max = vec_max(QP, min(kTile, sq - q0));

  for (int k0 = 0; k0 < skv; k0 += kTile) {
    __syncthreads();
    stage_vec(KP, kpr, k0, skv);
    stage_vec(KN, knr, k0, skv);
    __syncthreads();
    if (vec_min(KP, min(kTile, skv - k0)) > q_max) continue;
    stage_rows<T, HD>(Ks, kr, k0, skv);
    stage_rows<T, HD>(Vs, vr, k0, skv);
    __syncthreads();
    float sc[kSub][kSub] = {}, dp[kSub][kSub] = {};
    dot_tile<HD>(sc, Qs, ty, Ks, tx);
    dot_tile<HD>(dp, Os, ty, Vs, tx);
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const int i = q0 + ty + 16 * a;
#pragma unroll
      for (int b = 0; b < kSub; ++b) {
        const int jl = tx + 16 * b;
        float p = 0.f;
        if (i < sq && k0 + jl < skv)
          p = expf(score(sc[a][b], scale, slope, KP[jl], KN[jl], qp[a]) - lse_r[a]);
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
    if (i >= sq) continue;
#pragma unroll
    for (int c = 0; c < kCw; ++c) dq[(rs + i) * HD + tx + 16 * c] = scale * acc[a][c];
  }
}

// ---------------------------------------------------------------------------
// dK/dV: grid (BH, ceil(Skv / 64)), one block per 64-key tile of one query
// head. dk, dv float32 (BH, Skv, HD).

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
chunk_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ slopes, const float* __restrict__ qpos,
                 const float* __restrict__ kpos, const float* __restrict__ kneg,
                 float* __restrict__ dk, float* __restrict__ dv, int sq, int skv,
                 int g, float scale) {
  constexpr int kLd = HD + 1, kCw = HD / 16;
  const int row = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
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
  float* QP = DL + kTile;         // [64] qpos of the query tile
  float* KP = QP + kTile;         // [64] kpos of this block's key tile

  const float* kpr = kpos + (int64_t)kvr * skv;
  const float* knr = kneg + (int64_t)kvr * skv;
  const int64_t rs = (int64_t)row * sq;
  const float slope = slopes[row];
  stage_rows<T, HD>(Ks, k + (int64_t)kvr * skv * HD, k0, skv);
  stage_rows<T, HD>(Vs, v + (int64_t)kvr * skv * HD, k0, skv);
  stage_vec(KP, kpr, k0, skv);
  const T* qr = q + rs * HD;
  const T* dor = dout + rs * HD;
  float kp[kSub], kn[kSub], dk_acc[kSub][kCw], dv_acc[kSub][kCw];
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int j = k0 + ty + 16 * a;
    kp[a] = j < skv ? kpr[j] : 0.f;
    kn[a] = j < skv ? knr[j] : 0.f;
#pragma unroll
    for (int c = 0; c < kCw; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;
  }
  __syncthreads();
  const float k_min = vec_min(KP, min(kTile, skv - k0));

  for (int q0 = 0; q0 < sq; q0 += kTile) {
    __syncthreads();
    stage_vec(QP, qpos + rs, q0, sq);
    stage_vec(LS, lse + rs, q0, sq);
    stage_vec(DL, delta + rs, q0, sq);
    __syncthreads();
    if (k_min > vec_max(QP, min(kTile, sq - q0))) continue;  // fully future
    stage_rows<T, HD>(Qs, qr, q0, sq);
    stage_rows<T, HD>(Os, dor, q0, sq);
    __syncthreads();
    float st[kSub][kSub] = {}, dpt[kSub][kSub] = {};
    dot_tile<HD>(st, Ks, ty, Qs, tx);   // S^T: key rows, query columns
    dot_tile<HD>(dpt, Vs, ty, Os, tx);  // (dO . V^T)^T
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const int j = k0 + ty + 16 * a;
#pragma unroll
      for (int b = 0; b < kSub; ++b) {
        const int il = tx + 16 * b;
        float p = 0.f;
        if (q0 + il < sq && j < skv)
          p = expf(score(st[a][b], scale, slope, kp[a], kn[a], QP[il]) - LS[il]);
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
  const int64_t ks = (int64_t)row * skv;
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= skv) continue;
#pragma unroll
    for (int c = 0; c < kCw; ++c) {
      dk[(ks + j) * HD + tx + 16 * c] = scale * dk_acc[a][c];
      dv[(ks + j) * HD + tx + 16 * c] = dv_acc[a][c];
    }
  }
}


// ---------------------------------------------------------------------------
// Tensor-core route (bf16 q, k, v, dO): the staging, the fragment loads, the
// skip scan and the main loops live in attn_mma.cuh.

// ---------------------------------------------------------------------------
// Forward on the tensor cores: grid (BH, ceil(Sq / 64)), the query tiles in
// reverse. Reads (m, l, acc) in, writes them out, all float32.

// The ring step's score and walk for fwd_mma_walk: every visible key tile,
// each element tested against the query row's position value.
struct ChunkFwdPolicy {
  const float* kpr;
  int skv, lane;
  float q_max, q_min, scale, slope, qp[2];
  __device__ int first() const { return next_visible<true>(kpr, skv, 0, q_max, lane); }
  __device__ int next(int t) const { return next_visible<true>(kpr, skv, t + 1, q_max, lane); }
  // a full tile whose keys all lie at or before every query of the block
  // adds 0 for the causal term everywhere, so it takes the untested score:
  // on the diagonal chunk all but the 64 x 64 pairs on the diagonal (B7 at
  // 8192 tokens on an H100: 0.85 ms, 1.11 without; scripts/sweep_attn_fwd.py)
  __device__ bool tested(int, const float* KP, int ln) const {
    float x = fmaxf(KP[ln], KP[ln + 32]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, shfl_xor(x, o));
    return x > q_min;
  }
  __device__ float score(float dot, int h, int, float kp, float kn, bool test) const {
    const float s = dot * scale + slope * kp + kn;
    return test ? s + (kp <= qp[h] ? 0.f : kNegInf) : s;
  }
};

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, FwdSmem<HD>::kMinBlocks)
chunk_fwd_mma_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, const float* __restrict__ slopes,
                     const float* __restrict__ qpos, const float* __restrict__ kpos,
                     const float* __restrict__ kneg, const float* __restrict__ m_in,
                     const float* __restrict__ l_in, const float* __restrict__ acc_in,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     float* __restrict__ acc_out, int sq, int skv, int g, float scale) {
  constexpr int ND = HD / 8;
  const int row = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // the longest walks first
  const int q0 = qt * kTile;
  const int kvr = row / g;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = lane % 4;
  const int64_t rs = (int64_t)row * sq;
  const float* kpr = kpos + (int64_t)kvr * skv;

  // this lane's query rows: r0 (state elements 0, 1) and r0 + 8 (2, 3)
  const int r0 = q0 + 16 * warp + lane / 4;
  ChunkFwdPolicy pol{kpr, skv, lane, tile_extreme<false>(qpos + rs, sq, qt, lane),
                     tile_extreme<true>(qpos + rs, sq, qt, lane), scale, slopes[row],
                     {0.f, 0.f}};
  float m[2], l[2], acc[ND][4];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    ok[h] = r < sq;
    pol.qp[h] = ok[h] ? qpos[rs + r] : 0.f;
    m[h] = ok[h] ? m_in[rs + r] : kNegInf;
    l[h] = ok[h] ? l_in[rs + r] : 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float2 a = ok[h] ? *reinterpret_cast<const float2*>(acc_in + (rs + r) * HD + 8 * n + 2 * c)
                             : make_float2(0.f, 0.f);
      acc[n][2 * h] = a.x;
      acc[n][2 * h + 1] = a.y;
    }
  }
  fwd_mma_walk<HD>(m, l, acc, q + rs * HD, q0, sq, k + (int64_t)kvr * skv * HD,
                   v + (int64_t)kvr * skv * HD, kpr, kneg + (int64_t)kvr * skv, skv, pol);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!ok[h]) continue;
    const int64_t r = rs + r0 + 8 * h;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(acc_out + r * HD + 8 * n + 2 * c) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    if (c == 0) {
      m_out[r] = m[h];
      l_out[r] = l[h];
    }
  }
}

// ---------------------------------------------------------------------------
// dQ and dK/dV on the tensor cores, on the backward main loops of
// attn_mma.cuh.

// The ring step's backward walk and score for dq_mma_walk (kMin: the key
// tiles whose smallest position is at or before the block's largest query
// position) and dkv_mma_walk (the query tiles whose largest position is at
// or after the block's smallest key position), with the barrier-free skip
// scan of next_visible; every element tested against the position values.
template <bool kMin>
struct ChunkBwdPolicy {
  const float* pos;   // positions of the walked tiles: keys (dq) or queries (dkv)
  int n, lane;
  float bound, scale, slope;
  static constexpr bool kQueryPos = true;
  __device__ int first() const { return next_visible<kMin>(pos, n, 0, bound, lane); }
  __device__ int next(int t) const { return next_visible<kMin>(pos, n, t + 1, bound, lane); }
  __device__ bool tested(int, int) const { return true; }
  __device__ float score(float dot, int, int, float kp, float kn, float qp, bool) const {
    return ::score(dot, scale, slope, kp, kn, qp);   // the FMA route's score, in its order
  }
  __device__ static float prob(float x) { return expf(x); }
};

// dQ: grid (BH, ceil(Sq / 64)), the query tiles in reverse. dq float32
// (BH, Sq, HD).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, BwdSmem<HD>::kMinBlocks)
chunk_dq_mma_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ slopes, const float* __restrict__ qpos,
                    const float* __restrict__ kpos, const float* __restrict__ kneg,
                    float* __restrict__ dq, int sq, int skv, int g, float scale) {
  constexpr int ND = HD / 8;
  const int row = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // the longest walks first
  const int q0 = qt * kTile;
  const int lane = threadIdx.x % 32, c = lane % 4;
  const int64_t rs = (int64_t)row * sq, kvo = (int64_t)(row / g) * skv;
  const ChunkBwdPolicy<true> pol{kpos + kvo, skv, lane,
                                 tile_extreme<false>(qpos + rs, sq, qt, lane), scale,
                                 slopes[row]};
  float acc[ND][4];
  dq_mma_walk<HD>(acc, q + rs * HD, dout + rs * HD, lse + rs, delta + rs, qpos + rs, q0, sq,
                  k + kvo * HD, v + kvo * HD, kpos + kvo, kneg + kvo, skv, pol);
  const int r0 = q0 + 16 * (threadIdx.x / 32) + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= sq) continue;
    float* out = dq + (rs + r0 + 8 * h) * HD + 2 * c;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(scale * acc[n][2 * h], scale * acc[n][2 * h + 1]);
  }
}

// dK/dV: grid (BH, ceil(Skv / 64)), one block per 64-key tile of one query
// head. dk, dv float32 (BH, Skv, HD).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, BwdSmem<HD>::kMinBlocks)
chunk_dkv_mma_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ slopes, const float* __restrict__ qpos,
                     const float* __restrict__ kpos, const float* __restrict__ kneg,
                     float* __restrict__ dk, float* __restrict__ dv, int sq, int skv,
                     int g, float scale) {
  constexpr int ND = HD / 8;
  const int row = blockIdx.x;
  const int kt = blockIdx.y;
  const int k0 = kt * kTile;
  const int lane = threadIdx.x % 32, c = lane % 4;
  const int64_t rs = (int64_t)row * sq, kvo = (int64_t)(row / g) * skv;
  const ChunkBwdPolicy<false> pol{qpos + rs, sq, lane,
                                  tile_extreme<true>(kpos + kvo, skv, kt, lane), scale,
                                  slopes[row]};
  float dk_acc[ND][4], dv_acc[ND][4];
  dkv_mma_walk<HD>(dk_acc, dv_acc, k + kvo * HD, v + kvo * HD, kpos + kvo, kneg + kvo, k0, skv,
                   q + rs * HD, dout + rs * HD, lse + rs, delta + rs, qpos + rs, sq, pol);
  const int64_t ks = (int64_t)row * skv;
  const int j0 = k0 + 16 * (threadIdx.x / 32) + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (j0 + 8 * h >= skv) continue;
    const int64_t at = (ks + j0 + 8 * h) * HD + 2 * c;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(dk + at + 8 * n) =
          make_float2(scale * dk_acc[n][2 * h], scale * dk_acc[n][2 * h + 1]);
      *reinterpret_cast<float2*>(dv + at + 8 * n) =
          make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch: the opt-in to more than 48 KB of dynamic shared memory is set once
// per instantiation, at its first launch, so that later launches (a CUDA
// graph capture among them) only queue the kernel.

template <typename Kernel, typename... Args>
int launch(Kernel kernel, bool* opted_in, size_t smem, int threads, int bh, int tiles_of,
           cudaStream_t stream, Args... args) {
  if (!*opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    *opted_in = true;
  }
  const dim3 grid(bh, (tiles_of + kTile - 1) / kTile);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

using cf = const float*;
using cb = const uint16_t*;

// Each kernel: float32 inputs on the FMA kernels, bf16 on the tensor cores.
template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, const void* slopes,
        const void* qpos, const void* kpos, const void* kneg, const void* m_in,
        const void* l_in, const void* acc_in, void* m_out, void* l_out,
        void* acc_out, int bh, int sq, int skv, int g, float scale,
        cudaStream_t stream) {
  static bool opted_in = false;
  if constexpr (std::is_same_v<T, float>)
    return launch(chunk_fwd_kernel<float, HD>, &opted_in,
                  fwd_smem_floats<HD>() * sizeof(float), kThreads, bh, sq, stream,
                  static_cast<cf>(q), static_cast<cf>(k), static_cast<cf>(v),
                  static_cast<cf>(slopes), static_cast<cf>(qpos), static_cast<cf>(kpos),
                  static_cast<cf>(kneg), static_cast<cf>(m_in), static_cast<cf>(l_in),
                  static_cast<cf>(acc_in), static_cast<float*>(m_out),
                  static_cast<float*>(l_out), static_cast<float*>(acc_out), sq, skv, g, scale);
  else
    return launch(chunk_fwd_mma_kernel<HD>, &opted_in, FwdSmem<HD>::kBytes, kMmaThreads, bh,
                  sq, stream, static_cast<cb>(q), static_cast<cb>(k), static_cast<cb>(v),
                  static_cast<cf>(slopes), static_cast<cf>(qpos), static_cast<cf>(kpos),
                  static_cast<cf>(kneg), static_cast<cf>(m_in), static_cast<cf>(l_in),
                  static_cast<cf>(acc_in), static_cast<float*>(m_out),
                  static_cast<float*>(l_out), static_cast<float*>(acc_out), sq, skv, g, scale);
}

template <typename T, int HD>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, const void* slopes, const void* qpos,
       const void* kpos, const void* kneg, void* dq_out, int bh, int sq, int skv,
       int g, float scale, cudaStream_t stream) {
  static bool opted_in = false;
  if constexpr (std::is_same_v<T, float>)
    return launch(chunk_dq_kernel<float, HD>, &opted_in, dq_smem_floats<HD>() * sizeof(float),
                  kThreads, bh, sq, stream, static_cast<cf>(q), static_cast<cf>(k),
                  static_cast<cf>(v), static_cast<cf>(dout), static_cast<cf>(lse),
                  static_cast<cf>(delta), static_cast<cf>(slopes), static_cast<cf>(qpos),
                  static_cast<cf>(kpos), static_cast<cf>(kneg), static_cast<float*>(dq_out),
                  sq, skv, g, scale);
  else
    return launch(chunk_dq_mma_kernel<HD>, &opted_in, BwdSmem<HD>::kBytes, kMmaThreads, bh, sq,
                  stream, static_cast<cb>(q), static_cast<cb>(k), static_cast<cb>(v),
                  static_cast<cb>(dout), static_cast<cf>(lse), static_cast<cf>(delta),
                  static_cast<cf>(slopes), static_cast<cf>(qpos), static_cast<cf>(kpos),
                  static_cast<cf>(kneg), static_cast<float*>(dq_out), sq, skv, g, scale);
}

template <typename T, int HD>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* slopes, const void* qpos,
        const void* kpos, const void* kneg, void* dk, void* dv, int bh, int sq,
        int skv, int g, float scale, cudaStream_t stream) {
  static bool opted_in = false;
  if constexpr (std::is_same_v<T, float>)
    return launch(chunk_dkv_kernel<float, HD>, &opted_in,
                  dkv_smem_floats<HD>() * sizeof(float), kThreads, bh, skv, stream,
                  static_cast<cf>(q), static_cast<cf>(k), static_cast<cf>(v),
                  static_cast<cf>(dout), static_cast<cf>(lse), static_cast<cf>(delta),
                  static_cast<cf>(slopes), static_cast<cf>(qpos), static_cast<cf>(kpos),
                  static_cast<cf>(kneg), static_cast<float*>(dk), static_cast<float*>(dv), sq,
                  skv, g, scale);
  else
    return launch(chunk_dkv_mma_kernel<HD>, &opted_in, BwdSmem<HD>::kBytes, kMmaThreads, bh,
                  skv, stream, static_cast<cb>(q), static_cast<cb>(k), static_cast<cb>(v),
                  static_cast<cb>(dout), static_cast<cf>(lse), static_cast<cf>(delta),
                  static_cast<cf>(slopes), static_cast<cf>(qpos), static_cast<cf>(kpos),
                  static_cast<cf>(kneg), static_cast<float*>(dk), static_cast<float*>(dv), sq,
                  skv, g, scale);
}

}  // namespace

// Entry points, one per kernel and dtype of q/k/v/dO (float32, bf16), head_dim
// 32, 64 or 128; every other array is float32. The bf16 entries launch the
// tensor-core kernels, whose 16-byte copies need q, k, v (and dO) to start on
// a 16-byte boundary, and whose float2 state reads need acc_in on an 8-byte
// one. Each returns the launch's cudaError_t: 0 when the kernel was queued
// on `stream`.

template <typename Fn>
int by_head_dim(int hd, Fn fn) {
  switch (hd) {
    case 32: return fn(std::integral_constant<int, 32>{});
    case 64: return fn(std::integral_constant<int, 64>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

#define CHUNK_ENTRIES(SUFFIX, T)                                                  \
  extern "C" int flash_chunk_fwd_##SUFFIX(                                        \
      const void* q, const void* k, const void* v, const void* slopes,            \
      const void* qpos, const void* kpos, const void* kneg, const void* m_in,     \
      const void* l_in, const void* acc_in, void* m_out, void* l_out,             \
      void* acc_out, int bh, int sq, int skv, int hd, int g, float scale,         \
      void* stream) {                                                             \
    auto st = static_cast<cudaStream_t>(stream);                                  \
    return by_head_dim(hd, [&](auto h) {                                          \
      return fwd<T, decltype(h)::value>(q, k, v, slopes, qpos, kpos, kneg, m_in,  \
                                        l_in, acc_in, m_out, l_out, acc_out, bh,  \
                                        sq, skv, g, scale, st);                   \
    });                                                                           \
  }                                                                               \
  extern "C" int flash_chunk_dq_##SUFFIX(                                         \
      const void* q, const void* k, const void* v, const void* dout,              \
      const void* lse, const void* delta, const void* slopes, const void* qpos,   \
      const void* kpos, const void* kneg, void* dq_out, int bh, int sq, int skv,  \
      int hd, int g, float scale, void* stream) {                                 \
    auto st = static_cast<cudaStream_t>(stream);                                  \
    return by_head_dim(hd, [&](auto h) {                                          \
      return dq<T, decltype(h)::value>(q, k, v, dout, lse, delta, slopes, qpos,   \
                                       kpos, kneg, dq_out, bh, sq, skv, g, scale, \
                                       st);                                       \
    });                                                                           \
  }                                                                               \
  extern "C" int flash_chunk_dkv_##SUFFIX(                                        \
      const void* q, const void* k, const void* v, const void* dout,              \
      const void* lse, const void* delta, const void* slopes, const void* qpos,   \
      const void* kpos, const void* kneg, void* dk, void* dv, int bh, int sq,     \
      int skv, int hd, int g, float scale, void* stream) {                        \
    auto st = static_cast<cudaStream_t>(stream);                                  \
    return by_head_dim(hd, [&](auto h) {                                          \
      return dkv<T, decltype(h)::value>(q, k, v, dout, lse, delta, slopes, qpos,  \
                                        kpos, kneg, dk, dv, bh, sq, skv, g,       \
                                        scale, st);                               \
    });                                                                           \
  }

CHUNK_ENTRIES(f32, float)
CHUNK_ENTRIES(bf16, __nv_bfloat16)
