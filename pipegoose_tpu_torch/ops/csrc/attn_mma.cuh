// Device pieces shared by the tensor-core attention kernels (sm_90a): bf16
// mma.sync with float32 accumulators, ldmatrix, cp.async staging with a
// zero-fill predicate, the pack of float32 accumulator (C) fragments into
// bf16 operand (A) fragments, the staging and fragment loads of 64-row bf16
// tiles, the skip scan over positions, and the forward main loop that the
// flash forward (flash_attention.cu, B1) and the ring-chunk forward
// (flash_chunk.cu, B7) share.
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

}  // namespace
