// Device pieces shared by the tensor-core attention kernels (sm_90a): bf16
// mma.sync with float32 accumulators, ldmatrix, cp.async staging with a
// zero-fill predicate, the pack of float32 accumulator (C) fragments into
// bf16 operand (A) fragments, the staging and fragment loads of 64-row bf16
// tiles, the skip scan over positions, and the main loops that the flash
// kernels (flash_attention.cu) and the ring-chunk kernels (flash_chunk.cu)
// share: the forward (B1, B7), dQ (B2, B8) and dK/dV (B3, B9).
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 g + c, g < 8, c < 4):
//   A (16 x 16, row-major), four b16x2 registers: rows g | g + 8, columns
//     2c, 2c + 1 | 2c + 8, 2c + 9, in the order (g, lo), (g + 8, lo),
//     (g, hi), (g + 8, hi);
//   B (16 x 8, column-major), two registers: rows 2c, 2c + 1 | 2c + 8,
//     2c + 9 of column g;
//   C/D (16 x 8), four float32: (g, 2c), (g, 2c + 1), (g + 8, 2c),
//     (g + 8, 2c + 1).
// So the C fragments of two neighbouring n-tiles of a product, each pair
// packed to bf16x2, are the A fragment of the next product's 16-wide k step
// (pack_a): a score tile goes from one product to the next in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// -- PTX wrappers --
__device__ __forceinline__ uint8_t* dyn_smem() {
  extern __shared__ __align__(16) uint8_t smem_[];
  return smem_;
}

__device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}

// 16 bytes global -> shared, in flight until cp_async_wait; zeros if !valid
// (src is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x8 b16 matrices: lane l gives the address of row l % 8 of matrix
// l / 8 and gets word l % 4 of row l / 4 of each (of each transposed
// matrix with kTrans: the elements (2 (l % 4), l / 4) and (2 (l % 4) + 1,
// l / 4)).
template <bool kTrans>
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a)
                 : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major); bf16 in, float32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e^x as one ex2.approx of x log2(e): relative error about 2^-22, and 0 for
// x = -inf
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// bf16x2 {lo, hi}, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// -- end PTX wrappers --

// The A fragment of a 16-wide k step from the C fragments of the two
// n-tiles c0 (k columns 0-7) and c1 (8-15), rounded once to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}


// ---------------------------------------------------------------------------
// Staged tiles: 64 rows of a (rows, HD) bf16 matrix, each row padded by 16
// bytes so that the 8 row addresses of an ldmatrix fall in 8 distinct bank
// quads. Four warps of 16 rows each work on a 64-row tile.

constexpr int kMmaTile = 64;      // rows of a staged tile: queries or keys
constexpr int kMmaThreads = 128;  // four warps
constexpr int kScanTiles = 4;     // tiles a position scan tests per round
constexpr float kNegInf = -1e9f;  // finite, as NEG_INF in the JAX package

template <int HD>
struct MmaTile {
  static constexpr int kPitch = HD * 2 + 16;     // bytes a staged bf16 row
  static constexpr int kBytes = kMmaTile * kPitch;
};

// Queue rows [r0, r0 + 64) of a (rows, HD) bf16 matrix into a staged tile;
// rows at or past `rows` are zero filled.
template <int HD>
__device__ __forceinline__ void stage_tile(uint8_t* dst, const uint16_t* __restrict__ src,
                                           int r0, int rows, int tid) {
  constexpr int kChunks = HD * 2 / 16;   // 16-byte pieces a row
  for (int e = tid; e < kMmaTile * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, j = e % kChunks;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * MmaTile<HD>::kPitch + 16 * j,
               src + (int64_t)(ok ? r0 + r : 0) * HD + 8 * j, ok);
  }
}

// Queue entries [r0, r0 + 64) of a float32 vector of n; past n zero filled.
__device__ __forceinline__ void stage_vec_async(float* dst, const float* __restrict__ src,
                                                int r0, int n, int tid) {
  for (int e = tid; e < kMmaTile; e += kMmaThreads) {
    const bool ok = r0 + e < n;
    cp_async4(dst + e, src + (ok ? r0 + e : 0), ok);
  }
}

// The smallest (kMin) or largest position of 64-position tile t of the n
// at `pos`, over the positions that exist; every lane gets the same value.
template <bool kMin>
__device__ __forceinline__ float tile_extreme(const float* __restrict__ pos, int n, int t,
                                              int lane) {
  const float fill = kMin ? INFINITY : -INFINITY;
  const int i = t * kMmaTile + lane;
  const float a = i < n ? pos[i] : fill, b = i + 32 < n ? pos[i + 32] : fill;
  float x = kMin ? fminf(a, b) : fmaxf(a, b);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = shfl_xor(x, o);
    x = kMin ? fminf(x, y) : fmaxf(x, y);
  }
  return x;
}

// The first tile t >= from of the n positions at `pos` that the block must
// visit, or the tile count if none: with kMin a key tile whose smallest
// position is <= bound (the largest query position of the block: the
// forward and dq), else a query tile whose largest position is >= bound
// (the smallest key position of the block: dkv). The other tiles are fully
// future. Tests kScanTiles tiles a round, their loads all in flight
// together; every warp reads the same values and reduces them in the same
// order, so the whole block agrees without a barrier.
template <bool kMin>
__device__ __forceinline__ int next_visible(const float* __restrict__ pos, int n, int from,
                                            float bound, int lane) {
  const int n_tiles = (n + kMmaTile - 1) / kMmaTile;
  const float fill = kMin ? INFINITY : -INFINITY;
  for (int t0 = from; t0 < n_tiles; t0 += kScanTiles) {
    float x[kScanTiles];
#pragma unroll
    for (int u = 0; u < kScanTiles; ++u) {
      const int i = (t0 + u) * kMmaTile + lane;
      const float a = i < n ? pos[i] : fill, b = i + 32 < n ? pos[i + 32] : fill;
      x[u] = kMin ? fminf(a, b) : fmaxf(a, b);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kScanTiles; ++u) {
        const float y = shfl_xor(x[u], o);
        x[u] = kMin ? fminf(x[u], y) : fmaxf(x[u], y);
      }
#pragma unroll
    for (int u = 0; u < kScanTiles; ++u)
      if (t0 + u < n_tiles && (kMin ? x[u] <= bound : x[u] >= bound)) return t0 + u;
  }
  return n_tiles;
}

// The A fragment of rows 16 w .. 16 w + 15 and k columns 16 kk .. 16 kk + 15
// of a staged tile.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* tile, int w, int kk,
                                       int lane) {
  const int mi = lane / 8, mr = lane % 8;
  ldmatrix4<false>(a, tile + (16 * w + (mi % 2) * 8 + mr) * MmaTile<HD>::kPitch +
                          (16 * kk + (mi / 2) * 8) * 2);
}

// B fragments of n-tiles 2 np and 2 np + 1 for k step kk, where the
// product's n runs over the staged tile's rows 16 np .. 16 np + 15 and its k
// over their columns (A . tile^T): b[0], b[1] for n-tile 2 np, b[2], b[3]
// for 2 np + 1.
template <int HD>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const uint8_t* tile, int np, int kk,
                                        int lane) {
  const int mi = lane / 8, mr = lane % 8;
  ldmatrix4<false>(b, tile + ((2 * np + mi / 2) * 8 + mr) * MmaTile<HD>::kPitch +
                          (16 * kk + (mi % 2) * 8) * 2);
}

// B fragments of n-tiles 2 np and 2 np + 1 for k step kk, where the
// product's k runs over the staged tile's rows 16 kk .. 16 kk + 15 and its n
// over their columns 16 np .. 16 np + 15 (A . tile), by ldmatrix.trans.
template <int HD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const uint8_t* tile, int np, int kk,
                                       int lane) {
  const int mi = lane / 8, mr = lane % 8;
  ldmatrix4<true>(b, tile + (16 * kk + (mi % 2) * 8 + mr) * MmaTile<HD>::kPitch +
                         (16 * np + (mi / 2) * 8) * 2);
}

// ---------------------------------------------------------------------------
// The forward main loop (B1, B7): one block of four warps takes the 64
// queries at q0 of one (row of BH) against the key tiles its policy names,
// with the online-softmax state of each query row in float32 registers.
//
// Shared memory: the block's Q tile, then a two-deep cp.async ring of
// stages, each the K and V tiles of one key tile with its 64 key positions
// and key biases (float32): while the block computes on one key tile the
// next visible one is in flight.
//
// Per key tile and warp: S = Q K^T (bf16 mma.sync; the warp's Q rows read
// by ldmatrix as A fragments at each k step, K rows by plain ldmatrix as B
// fragments), the score in float32 registers by the policy, the row max
// and row sum over the 4 lanes of a quad, alpha = exp(m - m_new) rescaling l
// and acc, and acc += P V with P packed straight from the score's C
// fragments into A fragments (pack_a: rounded once to bf16) and V read by
// ldmatrix.trans. l sums the float32 p; exp is exp_approx. Keys past skv
// get probability exactly 0.
//
// Measured on an H100 at B7's 8192-token diagonal chunk and B1's training
// shape (scripts/sweep_attn_fwd.py): holding the warp's Q fragments in
// registers instead spilled at HD = 64 under the 128 registers that 4
// blocks an SM allow and ran 2-4% slower; expf for exp_approx cost 12-13%;
// 3 blocks an SM with more registers a thread, 10-16%.
//
// Lane (g = lane / 4, c = lane % 4) of warp w holds query rows
// q0 + 16 w + g (h = 0) and + 8 (h = 1): m[h], l[h], and acc[n][2h],
// acc[n][2h + 1] at columns 8 n + 2 c, 8 n + 2 c + 1.
//
// The policy P gives
//   int first() / int next(int t): the first key tile >= 0 / > t to visit,
//     or the tile count when none is left;
//   bool tested(int k0, const float* KP, int lane): whether the tile at key
//     k0 (its positions staged at KP) needs a per-element mask test (else
//     every element takes the policy's plain score); every lane of the
//     block must give the same answer;
//   float score(float dot, int h, int j, float kp, float kn, bool test):
//     the score of row h and key j from the raw product q . k.

template <int HD>
struct FwdSmem {
  static constexpr int kMat = MmaTile<HD>::kBytes;
  static constexpr int kStage = 2 * kMat + 2 * kMmaTile * 4;  // K, V, kpos, kneg
  static constexpr int kBytes = kMat + 2 * kStage;             // Q + the ring
  // blocks an SM holds: 4 (<= 128 registers a thread) where shared memory
  // allows it (HD <= 64, at most ~46 KB a block), else 2
  static constexpr int kMinBlocks = HD <= 64 ? 4 : 2;
};

template <int HD, class P>
__device__ __forceinline__ void fwd_mma_walk(float (&m)[2], float (&l)[2],
                                             float (&acc)[HD / 8][4],
                                             const uint16_t* __restrict__ qr, int q0, int sq,
                                             const uint16_t* __restrict__ kr,
                                             const uint16_t* __restrict__ vr,
                                             const float* __restrict__ kpr,
                                             const float* __restrict__ knr, int skv,
                                             const P& pol) {
  using S = FwdSmem<HD>;
  constexpr int KS = HD / 16;   // k steps of S = Q K^T
  constexpr int ND = HD / 8;    // n-tiles of acc
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, c = lane % 4;
  uint8_t* Qs = dyn_smem();
  uint8_t* ring = Qs + S::kMat;
  const int n_kt = (skv + kMmaTile - 1) / kMmaTile;

  stage_tile<HD>(Qs, qr, q0, sq, tid);
  cp_async_commit();
  auto stage_keys = [&](int t, int slot) {
    uint8_t* st = ring + slot * S::kStage;
    stage_tile<HD>(st, kr, t * kMmaTile, skv, tid);
    stage_tile<HD>(st + S::kMat, vr, t * kMmaTile, skv, tid);
    float* vec = reinterpret_cast<float*>(st + 2 * S::kMat);
    stage_vec_async(vec, kpr, t * kMmaTile, skv, tid);
    stage_vec_async(vec + kMmaTile, knr, t * kMmaTile, skv, tid);
  };
  int cur = pol.first();
  if (cur < n_kt) stage_keys(cur, 0);
  cp_async_commit();

  for (int slot = 0; cur < n_kt; slot ^= 1) {
    const int nxt = pol.next(cur);
    if (nxt < n_kt) stage_keys(nxt, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // key tile `cur` has landed in `slot` (and Q before it)
    const uint8_t* Ks = ring + slot * S::kStage;
    const uint8_t* Vs = Ks + S::kMat;
    const float* KP = reinterpret_cast<const float*>(Ks + 2 * S::kMat);
    const float* KN = KP + kMmaTile;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {   // S = Q K^T
      uint32_t a[4];
      load_a<HD>(a, Qs, warp, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        load_bt<HD>(b, Ks, np, kk, lane);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    const int k0 = cur * kMmaTile;
    float mx[2] = {-INFINITY, -INFINITY};
    if (k0 + kMmaTile > skv || pol.tested(k0, KP, lane)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * n + 2 * c + (e & 1), h = e >> 1;
          s[n][e] = k0 + j < skv ? pol.score(s[n][e], h, k0 + j, KP[j], KN[j], true)
                                 : -INFINITY;
          mx[h] = fmaxf(mx[h], s[n][e]);
        }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * n + 2 * c + (e & 1), h = e >> 1;
          s[n][e] = pol.score(s[n][e], h, k0 + j, KP[j], KN[j], false);
          mx[h] = fmaxf(mx[h], s[n][e]);
        }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], shfl_xor(mx[h], 1));
      mx[h] = fmaxf(mx[h], shfl_xor(mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp_approx(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp_approx(s[n][e] - m[e >> 1]);   // p, float32
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += shfl_xor(sum[h], 1);
      sum[h] += shfl_xor(sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {   // acc += P V, 16 keys a k step
      uint32_t a[4];
      pack_a(a, s[2 * kp], s[2 * kp + 1]);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t b[4];
        load_b<HD>(b, Vs, np, kp, lane);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // `slot` is free for the tile after next
    cur = nxt;
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// The backward main loops (B2 + B3, B8 + B9), both from the final lse, so
// that the pairs' contributions simply add:
//   dq_mma_walk: one block of four warps takes the 64 queries at q0 against
//     the key tiles its policy names, S = Q K^T and dP = dO V^T, then in
//     float32 registers P = exp(s - lse) and dS = P (dP - delta), and
//     dQ += dS K (the caller scales it);
//   dkv_mma_walk: one block takes the 64 keys at k0 against the query tiles
//     its policy names, S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in
//     registers, dV += P^T dO and dK += dS^T Q, in passes of 16 queries.
// Every product is bf16 mma.sync with float32 accumulators. The block's
// own two tiles (dq: Q, dO; dkv: K, V) are staged once and read by ldmatrix
// as A fragments at each k step: holding them in registers left both 2
// blocks an SM (~175 registers a thread); read from shared memory they fit
// 128 registers and an SM holds 4 blocks at HD <= 64 (2 at HD = 128, where
// shared memory allows no more), ~30% faster on an H100 at bloom-560m's
// 8192-token ring chunk. The walked tiles (dq: K, V, kpos, kneg; dkv: Q,
// dO, qpos, lse, delta) stream through a two-deep cp.async ring: the next
// one is in flight while the block computes on this one. P and dS go from
// the C fragments straight into A fragments (pack_a), rounded once to bf16
// (a relative 2^-9 each, as the TPU's matrix unit rounds them at JAX's
// default precision); every sum is float32. So dq, dk and dv hold to 1e-5
// + 2^-7 of the largest value of their plain versions. The dK/dV pass loop
// stays rolled, so that one pass's scores never share registers with the
// next's and the kernel fits 128 registers with no spills. Rows past sq
// and keys past skv get probability exactly 0. No atomics, no workspace: a
// repeat call gives the same bits.
//
// Lane (g = lane / 4, c = lane % 4) of warp w holds the accumulator rows
// (queries for dq, keys for dkv) r0 + 16 w + g (h = 0) and + 8 (h = 1), at
// columns 8 n + 2 c, 8 n + 2 c + 1 of acc[n][2 h], acc[n][2 h + 1].
//
// The policy P gives, as for fwd_mma_walk, first() / next(t) over the
// walked tiles, and
//   bool tested(int q0, int k0): whether the pair of the query tile at q0
//     and the key tile at k0 needs the per-element test;
//   float score(float dot, int i, int j, float kp, float kn, float qp,
//     bool test): the score of query i and key j (indices in the call; kp,
//     kn the key's position and bias, qp the query's position) from the raw
//     product q . k;
//   static float prob(float x): e^x, for P = e^(s - lse);
//   static constexpr bool kQueryPos: whether the score reads query
//     positions (the walks then load and stage them from qpr).

template <int HD>
struct BwdSmem {
  static constexpr int kMat = MmaTile<HD>::kBytes;             // one staged 64-row tile
  static constexpr int kStage = 2 * kMat + 3 * kMmaTile * 4;   // two tiles + three vectors
  static constexpr int kBytes = 2 * kMat + 2 * kStage;         // resident tiles + the ring
  // blocks an SM holds: 4 (<= 128 registers a thread) where shared memory
  // allows it (HD <= 64, ~57 KB a block), else 2
  static constexpr int kMinBlocks = HD <= 64 ? 4 : 2;
};

// dQ of the queries [q0, q0 + 64) of one row: qr, dor the row's (sq, HD)
// q and dO, lser, dlr, qpr its (sq,) lse, delta and query positions (qpr
// read only with P::kQueryPos); kr, vr the kv row's (skv, HD) k and v, kpr,
// knr its (skv,) key positions and biases. acc comes out unscaled.
template <int HD, class P>
__device__ __forceinline__ void dq_mma_walk(float (&acc)[HD / 8][4],
                                            const uint16_t* __restrict__ qr,
                                            const uint16_t* __restrict__ dor,
                                            const float* __restrict__ lser,
                                            const float* __restrict__ dlr,
                                            const float* __restrict__ qpr, int q0, int sq,
                                            const uint16_t* __restrict__ kr,
                                            const uint16_t* __restrict__ vr,
                                            const float* __restrict__ kpr,
                                            const float* __restrict__ knr, int skv,
                                            const P& pol) {
  using S = BwdSmem<HD>;
  constexpr int KS = HD / 16;   // k steps of a product over HD
  constexpr int ND = HD / 8;    // n-tiles of the dQ accumulator
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, c = lane % 4;
  uint8_t* Qs = dyn_smem();                // [64][pitch] the block's Q rows
  uint8_t* Os = Qs + S::kMat;              // [64][pitch] its dO rows
  uint8_t* ring = Qs + 2 * S::kMat;        // two stages of K, V, kpos, kneg
  const int n_kt = (skv + kMmaTile - 1) / kMmaTile;

  stage_tile<HD>(Qs, qr, q0, sq, tid);
  stage_tile<HD>(Os, dor, q0, sq, tid);
  cp_async_commit();
  auto stage_keys = [&](int t, int slot) {
    uint8_t* st = ring + slot * S::kStage;
    stage_tile<HD>(st, kr, t * kMmaTile, skv, tid);
    stage_tile<HD>(st + S::kMat, vr, t * kMmaTile, skv, tid);
    float* vec = reinterpret_cast<float*>(st + 2 * S::kMat);
    stage_vec_async(vec, kpr, t * kMmaTile, skv, tid);
    stage_vec_async(vec + kMmaTile, knr, t * kMmaTile, skv, tid);
  };

  const int r0 = q0 + 16 * warp + lane / 4;
  float lse_r[2], dl_r[2], qp_r[2];
  bool ok_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    ok_r[h] = r < sq;
    lse_r[h] = ok_r[h] ? lser[r] : 0.f;
    dl_r[h] = ok_r[h] ? dlr[r] : 0.f;
    qp_r[h] = P::kQueryPos && ok_r[h] ? qpr[r] : 0.f;
  }

  int cur = pol.first();
  if (cur < n_kt) stage_keys(cur, 0);
  cp_async_commit();
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int slot = 0; cur < n_kt; slot ^= 1) {
    const int nxt = pol.next(cur);
    if (nxt < n_kt) stage_keys(nxt, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // key tile `cur` has landed in `slot` (and Q, dO before it)
    const uint8_t* Ks = ring + slot * S::kStage;
    const uint8_t* Vs = Ks + S::kMat;
    const float* KP = reinterpret_cast<const float*>(Ks + 2 * S::kMat);
    const float* KN = KP + kMmaTile;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ao[4];
      load_a<HD>(aq, Qs, warp, kk, lane);
      load_a<HD>(ao, Os, warp, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        load_bt<HD>(b, Ks, np, kk, lane);
        mma_bf16(s[2 * np], aq, b[0], b[1]);
        mma_bf16(s[2 * np + 1], aq, b[2], b[3]);
        load_bt<HD>(b, Vs, np, kk, lane);
        mma_bf16(dp[2 * np], ao, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], ao, b[2], b[3]);
      }
    }
    const int k0 = cur * kMmaTile;
    // one flag for the tile, read per element (B2 on an H100 at bloom-560m's
    // training shape: 6-7% faster than a copy of this loop for each value)
    const bool test = pol.tested(q0, k0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // s <- dS, in float32
        const int j = 8 * n + 2 * c + (e & 1), h = e >> 1;
        float p = 0.f;
        if (ok_r[h] && k0 + j < skv)
          p = P::prob(pol.score(s[n][e], r0 + 8 * h, k0 + j, KP[j], KN[j], qp_r[h], test) -
                      lse_r[h]);
        s[n][e] = p * (dp[n][e] - dl_r[h]);
      }
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {   // dQ += dS K, 16 keys a k step
      uint32_t a[4];
      pack_a(a, s[2 * kp], s[2 * kp + 1]);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t b[4];
        load_b<HD>(b, Ks, np, kp, lane);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // `slot` is free for the tile after next
    cur = nxt;
  }
  cp_async_wait<0>();
}

// dK and dV (per query head) of the keys [k0, k0 + 64) of one kv row,
// against one query row: the arguments as dq_mma_walk's. dk_acc comes out
// unscaled.
template <int HD, class P>
__device__ __forceinline__ void dkv_mma_walk(float (&dk_acc)[HD / 8][4],
                                             float (&dv_acc)[HD / 8][4],
                                             const uint16_t* __restrict__ kr,
                                             const uint16_t* __restrict__ vr,
                                             const float* __restrict__ kpr,
                                             const float* __restrict__ knr, int k0, int skv,
                                             const uint16_t* __restrict__ qr,
                                             const uint16_t* __restrict__ dor,
                                             const float* __restrict__ lser,
                                             const float* __restrict__ dlr,
                                             const float* __restrict__ qpr, int sq,
                                             const P& pol) {
  using S = BwdSmem<HD>;
  constexpr int KS = HD / 16;
  constexpr int ND = HD / 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, c = lane % 4;
  uint8_t* Ks = dyn_smem();                // [64][pitch] the block's K rows
  uint8_t* Vs = Ks + S::kMat;              // [64][pitch] its V rows
  uint8_t* ring = Ks + 2 * S::kMat;        // two stages of Q, dO, qpos, lse, delta
  const int n_qt = (sq + kMmaTile - 1) / kMmaTile;

  stage_tile<HD>(Ks, kr, k0, skv, tid);
  stage_tile<HD>(Vs, vr, k0, skv, tid);
  cp_async_commit();
  auto stage_queries = [&](int t, int slot) {
    uint8_t* st = ring + slot * S::kStage;
    stage_tile<HD>(st, qr, t * kMmaTile, sq, tid);
    stage_tile<HD>(st + S::kMat, dor, t * kMmaTile, sq, tid);
    float* vec = reinterpret_cast<float*>(st + 2 * S::kMat);
    if (P::kQueryPos) stage_vec_async(vec, qpr, t * kMmaTile, sq, tid);
    stage_vec_async(vec + kMmaTile, lser, t * kMmaTile, sq, tid);
    stage_vec_async(vec + 2 * kMmaTile, dlr, t * kMmaTile, sq, tid);
  };

  const int j0 = k0 + 16 * warp + lane / 4;
  float kp_r[2], kn_r[2];
  bool ok_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + 8 * h;
    ok_r[h] = j < skv;
    kp_r[h] = ok_r[h] ? kpr[j] : 0.f;
    kn_r[h] = ok_r[h] ? knr[j] : 0.f;
  }

  int cur = pol.first();
  if (cur < n_qt) stage_queries(cur, 0);
  cp_async_commit();
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  for (int slot = 0; cur < n_qt; slot ^= 1) {
    const int nxt = pol.next(cur);
    if (nxt < n_qt) stage_queries(nxt, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // query tile `cur` has landed in `slot` (and K, V before it)
    const uint8_t* Qt = ring + slot * S::kStage;
    const uint8_t* Ot = Qt + S::kMat;
    const float* QP = reinterpret_cast<const float*>(Qt + 2 * S::kMat);
    const float* LS = QP + kMmaTile;
    const float* DL = LS + kMmaTile;
    const int q0 = cur * kMmaTile;
    // 16 queries a pass (one k step of the second products): the pass loop
    // stays rolled so that its scores never share registers with the next
    // pass's, and the kernel fits 128 registers; one copy of it for a tested
    // tile pair and one for an untested one (B3 on an H100 at bloom-560m's
    // training shape: 5% faster than the test's branch inside the loop)
    auto passes = [&](bool test) {
#pragma unroll 1
      for (int pass = 0; pass < kMmaTile / 16; ++pass) {
        float st[2][4], dpt[2][4];   // S^T, dP^T: key rows, query columns
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t ak[4], av[4], b[4];
          load_a<HD>(ak, Ks, warp, kk, lane);
          load_a<HD>(av, Vs, warp, kk, lane);
          load_bt<HD>(b, Qt, pass, kk, lane);
          mma_bf16(st[0], ak, b[0], b[1]);
          mma_bf16(st[1], ak, b[2], b[3]);
          load_bt<HD>(b, Ot, pass, kk, lane);
          mma_bf16(dpt[0], av, b[0], b[1]);
          mma_bf16(dpt[1], av, b[2], b[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {   // st <- P^T, dpt <- dS^T, in float32
            const int i = 16 * pass + 8 * n + 2 * c + (e & 1), h = e >> 1;
            float p = 0.f;
            if (ok_r[h] && q0 + i < sq)
              p = P::prob(pol.score(st[n][e], q0 + i, j0 + 8 * h, kp_r[h], kn_r[h],
                                    P::kQueryPos ? QP[i] : 0.f, test) -
                          LS[i]);
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - DL[i]);
          }
        uint32_t ap[4], as[4];   // dV += P^T dO, dK += dS^T Q
        pack_a(ap, st[0], st[1]);
        pack_a(as, dpt[0], dpt[1]);
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t b[4];
          load_b<HD>(b, Ot, np, pass, lane);
          mma_bf16(dv_acc[2 * np], ap, b[0], b[1]);
          mma_bf16(dv_acc[2 * np + 1], ap, b[2], b[3]);
          load_b<HD>(b, Qt, np, pass, lane);
          mma_bf16(dk_acc[2 * np], as, b[0], b[1]);
          mma_bf16(dk_acc[2 * np + 1], as, b[2], b[3]);
        }
      }
    };
    if (pol.tested(q0, k0))
      passes(true);
    else
      passes(false);
    __syncthreads();   // `slot` is free for the tile after next
    cur = nxt;
  }
  cp_async_wait<0>();
}

}  // namespace
