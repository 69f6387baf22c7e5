// Paged attention for Hopper (sm_90a): a ragged C-query attention that
// walks the page table directly.
//
// Replaces the Pallas TPU kernel pipegoose_tpu/ops/paged_attention.py:
// paged_attention (kernel body :256-320, pallas_call :354) and computes the
// same function. Row b's query c sits at global position start[b] + c; a key
// at LOGICAL position w*ps + o (whatever physical page holds it) is kept iff
// key_pos <= q_pos; the score is q.k * hd^-0.5 + (slope[h] * key_pos + 0 or
// -1e9); the softmax is online, in float32; the output is acc / max(l,
// 1e-30) as float32 (B, C, nh, hd). q is float32 or bf16, read through its
// own strides (the head stride is 3 hd for a view of the fused qkv product),
// so no cast runs before the kernel. Pages are float32, bf16, or int8
// {q (P, ps, nh, hd), scale f32 (P, ps, nh)}.
//
// Two block shapes, chosen by the wrapper (ops/paged_attention.py
// paged_plan), each one launch a call:
//
// 1. The FMA route, paged_fma_*: every C below the tensor-core threshold
//    (decode, C = 1), and float32 q or float32 pages at every C, whose
//    rounding to bf16 would change the function. Decode is memory-bound:
//    each K/V value pair read (4 bytes in bf16) feeds two FMAs, about one
//    operation per byte, while the H100 needs ~20 float32 operations a byte
//    before its CUDA cores and not its 3.35 TB/s of device memory limit.
//    What bounds it in practice is how much of that memory is in flight:
//    at the decode shape the whole call moves ~11.5 MB, a few microseconds.
//    - Each (row, head, group of 1 or 4 queries) gets a thread-block
//      cluster of 1-8 blocks (the split) of four warps each; the row's
//      visible keys are split evenly over the cluster's blocks and then over
//      each block's warps, so the card holds one warp per ~10-50 keys.
//    - A warp reads whole key rows as 16-byte vectors (8 bytes for int8):
//      8 lanes cover one bf16 row of hd = 64, and each lane issues the loads
//      of 4-8 K and V rows before it uses any of them, so a warp's whole
//      share of the context is usually requested at once.
//    - bf16 and int8 values are widened in registers; the int8 K scale
//      multiplies the dot product and the V scale is folded into p.
//    - Dot products reduce over the row's lanes with warp shuffles, and the
//      online softmax runs per warp (the max over the warp's rows by
//      shuffles, each lane keeping the sums of its own rows).
//    - The warps' (m, l, acc) states merge in warp order through shared
//      memory, then the cluster's blocks merge theirs in split order through
//      distributed shared memory after a cluster barrier, each block writing
//      a slice of the output. No workspace, no atomics, no second kernel:
//      calls repeat bit for bit.
//    - Every product and sum is float32.
// 2. The tensor-core route, paged_mma_*: bf16 q with bf16 or int8 pages and
//    C >= 16 (chunked prefill). There each key tile is reused by up to 64
//    queries, so float32 FMAs, not bytes, would bound it.
//    - A block owns 64 queries of one (row, head), 16 a warp, and walks its
//      split's keys in tiles of 64 logical positions, staged by cp.async
//      into a two-deep shared-memory ring (the next tile is in flight while
//      the current one computes). int8 tiles are converted once to bf16 in
//      shared memory (exactly: |q| <= 127), their scales staged beside them.
//    - S = Q K^T and O += P V run as bf16 mma.sync.m16n8k16 with float32
//      accumulators, operands read with ldmatrix (V transposed). Products
//      of bf16 values are exact in float32, so S matches the float32
//      version up to the order of its sums. P goes in as bf16 hi + lo, two
//      MMAs, leaving about 2^-16 of p; it is never rounded to bf16 once.
//      The K scale multiplies S's columns, the V scale is folded into p
//      before the split.
//    - A warp skips a tile whose first key lies past its last query (the
//      TPU kernel's skip at :278); where the (row, head, query tile) blocks
//      alone would leave SMs idle, the keys are split over a cluster's
//      blocks and merged as on the FMA route.
//
// Keys are addressed by logical position, so any page size works: each
// staged row looks its page up in the row's table. A page id outside
// [0, P) traps: a corrupt table fails loudly instead of reading another
// allocation.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // four warps, both routes
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;      // the portable thread-block cluster size
constexpr int kQT = 64;            // tensor-core route: queries a block
constexpr int kKT = 64;            // tensor-core route: keys a staged tile
constexpr float kNegInf = -1e9f;   // the mask, finite as NEG_INF in JAX
constexpr float kEmpty = -1e30f;   // a running max before any key

struct Args {
  const void* q;          // (B, C, nh, hd) float32 or bf16, strides below
  const void* k;          // (P, ps, nh, hd) pages
  const void* v;
  const float* ks;        // (P, ps, nh) int8 scales, or null
  const float* vs;
  const int* table;       // (B, W)
  const int* start;       // (B,)
  const float* slopes;    // (nh,)
  float* out;             // (B, C, nh, hd) float32
  int C, nh, ps, W, P;
  float scale;
  long long sqb, sqc, sqh;  // q's strides in elements (d's is 1)
};

// -- PTX wrappers --
__device__ __forceinline__ uint8_t* dyn_smem() {
  extern __shared__ __align__(16) uint8_t smem_[];
  return smem_;
}

__device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}

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

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x8 b16 matrices: lane l gives the address of row l % 8 of matrix
// l / 8 and gets word l % 4 of row l / 4 of each (of each transposed
// matrix with kTrans).
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

// bf16x2 {lo, hi}, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Every thread of every block of the cluster arrives here; shared-memory
// writes before it are visible to the cluster's blocks after it.
__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }

// `p` in this block's shared memory, as the same address in the shared
// memory of the cluster's block `rank`
template <typename T>
__device__ __forceinline__ T* cluster_smem(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}
// -- end PTX wrappers --

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

template <typename QT>
__device__ __forceinline__ float load_q(const void* q, long long at) {
  if constexpr (sizeof(QT) == 4)
    return static_cast<const float*>(q)[at];
  else
    return __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(q)[at]) << 16);
}

// One lane's 16 bytes (8 for int8) of a page row, widened to float32.
// T: float (4 values a lane), uint16_t for bf16 (8) or int8_t (8).
template <typename T>
struct Lane;
template <>
struct Lane<float> {
  using Vec = float4;
  static constexpr int kDims = 4;
  static __device__ __forceinline__ void widen(const Vec& v, float (&f)[4]) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};
template <>
struct Lane<uint16_t> {
  using Vec = uint4;
  static constexpr int kDims = 8;
  static __device__ __forceinline__ void widen(const Vec& v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bf16_lo(w[i]);
      f[2 * i + 1] = bf16_hi(w[i]);
    }
  }
};
template <>
struct Lane<int8_t> {
  using Vec = uint2;
  static constexpr int kDims = 8;
  static __device__ __forceinline__ void widen(const Vec& v, float (&f)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = static_cast<float>(static_cast<int8_t>(((i < 4 ? v.x : v.y) >> (8 * (i % 4))) & 0xFF));
  }
};

// The (page, offset, head) index of logical key `key` of a row: page row
// `index * hd` of a bank, entry `index` of a scale plane.
__device__ __forceinline__ long long key_index(const Args& a, const int* row_table, int key,
                                               int h) {
  const int page = row_table[key / a.ps];
  if (page < 0 || page >= a.P) __trap();
  return (static_cast<long long>(page) * a.ps + key % a.ps) * a.nh + h;
}

// This split's keys [k0, k1) of n_keys, split evenly in multiples of `align`
__device__ __forceinline__ void split_range(int n_keys, int split, int splits, int align,
                                            int& k0, int& k1) {
  int chunk = (n_keys + splits - 1) / splits;
  chunk = (chunk + align - 1) / align * align;
  k0 = min(n_keys, split * chunk);
  k1 = min(n_keys, k0 + chunk);
}

// out = sum_r acc_r e^(m_r - M) / max(sum_r l_r e^(m_r - M), 1e-30) over the
// states (m, l, acc[d]) at `row` of the cluster's blocks, in split order.
__device__ __forceinline__ float merge_splits(float* row, int d, int splits) {
  float m[kMaxSplits];
  float mx = kEmpty;
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r) {
    m[r] = r < splits ? cluster_smem(row, r)[0] : kEmpty;
    mx = fmaxf(mx, m[r]);
  }
  float l = 0.f, acc = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r) {
    if (r < splits) {
      const float* s = cluster_smem(row, r);
      const float f = expf(m[r] - mx);
      l = fmaf(s[1], f, l);
      acc = fmaf(s[2 + d], f, acc);
    }
  }
  return acc / fmaxf(l, 1e-30f);
}

// ---------------------------------------------------------------------------
// FMA route. Block (split, head + nh * query group, row); QG queries a block.
template <typename QT, typename T, bool kScaled, int HD, int QG>
__global__ void __launch_bounds__(kThreads) paged_fma_kernel(const Args a) {
  using L = Lane<T>;
  constexpr int DPL = L::kDims;      // dims a lane
  constexpr int LPR = HD / DPL;      // lanes a key row
  constexpr int RPI = 32 / LPR;      // key rows a warp load instruction
  constexpr int U = QG == 1 ? 8 : 4; // key rows a lane keeps in flight
  constexpr int kBatch = RPI * U;
  constexpr int kRow = HD + 2;       // floats of one (m, l, acc) state
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "lane geometry");

  const int split = blockIdx.x, splits = gridDim.x;
  const int h = blockIdx.y % a.nh, c0 = (blockIdx.y / a.nh) * QG, b = blockIdx.z;
  const int nq = min(QG, a.C - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPR, d0 = (lane % LPR) * DPL;
  const int pos0 = a.start[b] + c0;
  const int n_keys = min(a.W * a.ps, pos0 + nq);
  int k0, k1;
  split_range(n_keys, split, splits, 1, k0, k1);
  const int per = (k1 - k0 + kWarps - 1) / kWarps;
  const int wk0 = min(k1, k0 + warp * per), wk1 = min(k1, wk0 + per);
  const float slope = a.slopes[h];
  const int* row_table = a.table + static_cast<long long>(b) * a.W;
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  float qf[QG][DPL];
#pragma unroll
  for (int i = 0; i < QG; ++i)
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      qf[i][j] = i < nq ? load_q<QT>(a.q, b * a.sqb + (c0 + i) * a.sqc + h * a.sqh + d0 + j)
                        : 0.f;
  float m[QG], l[QG], acc[QG][DPL];
#pragma unroll
  for (int i = 0; i < QG; ++i) {
    m[i] = kEmpty;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  for (int kb = wk0; kb < wk1; kb += kBatch) {
    typename L::Vec kv[U], vv[U];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {   // every load of the batch before any use
      const int key = kb + grp + RPI * u;
      kv[u] = {};
      vv[u] = {};
      ksc[u] = vsc[u] = 0.f;
      if (key < wk1) {
        const long long at = key_index(a, row_table, key, h);
        kv[u] = *reinterpret_cast<const typename L::Vec*>(kp + at * HD + d0);
        vv[u] = *reinterpret_cast<const typename L::Vec*>(vp + at * HD + d0);
        if constexpr (kScaled) {
          ksc[u] = a.ks[at];
          vsc[u] = a.vs[at];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < QG; ++i) {
      float s[U];
      float bm = kEmpty;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[DPL];
        L::widen(kv[u], kf);
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) dot = fmaf(qf[i][j], kf[j], dot);
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1) dot += shfl_xor(dot, o);
        if constexpr (kScaled) dot *= ksc[u];
        const int key = kb + grp + RPI * u;
        const float bias = slope * static_cast<float>(key) + (key <= pos0 + i ? 0.f : kNegInf);
        s[u] = key < wk1 ? dot * a.scale + bias : kEmpty;   // kEmpty: weight exactly 0
        bm = fmaxf(bm, s[u]);
      }
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) bm = fmaxf(bm, shfl_xor(bm, o));
      const float mn = fmaxf(m[i], bm);
      const float alpha = expf(m[i] - mn);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[u] - mn);
        ls += p;
        const float w = kScaled ? p * vsc[u] : p;
        float vf[DPL];
        L::widen(vv[u], vf);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] = fmaf(w, vf[j], acc[i][j]);
      }
      l[i] = fmaf(l[i], alpha, ls);
      m[i] = mn;
    }
  }
  // the warp's sums over its row groups (the max is already warp-wide)
#pragma unroll
  for (int i = 0; i < QG; ++i)
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      l[i] += shfl_xor(l[i], o);
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] += shfl_xor(acc[i][j], o);
    }

  // the block's state per query: the warps' states merged in warp order
  float* part = reinterpret_cast<float*>(dyn_smem());   // [kWarps][QG][kRow]
  float* mine = part + kWarps * QG * kRow;               // [QG][kRow]
  if (lane < LPR) {
#pragma unroll
    for (int i = 0; i < QG; ++i) {
      float* r = part + (warp * QG + i) * kRow;
      if (lane == 0) {
        r[0] = m[i];
        r[1] = l[i];
      }
#pragma unroll
      for (int j = 0; j < DPL; ++j) r[2 + d0 + j] = acc[i][j];
    }
  }
  __syncthreads();
  for (int e = tid; e < QG * kRow; e += kThreads) {
    const int i = e / kRow, col = e % kRow;
    float mx = kEmpty;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part[(w * QG + i) * kRow]);
    float v = mx;
    if (col > 0) {
      v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* r = part + (w * QG + i) * kRow;
        v = fmaf(r[col], expf(r[0] - mx), v);
      }
    }
    mine[e] = v;
  }
  if (splits > 1)
    cluster_sync();
  else
    __syncthreads();

  // this block's slice of the outputs, the splits merged in split order
  const int E = QG * HD;
  for (int e = split * E / splits + tid; e < (split + 1) * E / splits; e += kThreads) {
    const int i = e / HD, d = e % HD;
    if (i >= nq) continue;
    a.out[((static_cast<long long>(b) * a.C + c0 + i) * a.nh + h) * HD + d] =
        merge_splits(mine + i * kRow, d, splits);
  }
  if (splits > 1) cluster_sync();   // every block's state stays until the last read
}

// ---------------------------------------------------------------------------
// Tensor-core route. Block (split, head + nh * query tile, row); T is
// uint16_t (bf16 pages) or int8_t.
template <typename T, int HD>
struct MmaSmem {
  static constexpr bool kInt8 = sizeof(T) == 1;
  static constexpr int kPitch = HD * static_cast<int>(sizeof(T)) + 16;  // bytes a staged row
  static constexpr int kTile = kKT * kPitch;
  static constexpr int kScales = kInt8 ? 2 * kKT * 4 : 0;
  static constexpr int kStage = 2 * kTile + kScales;
  static constexpr int kBf16Pitch = HD * 2 + 16;   // bytes a bf16 row read by ldmatrix
  static constexpr int kConv = kInt8 ? 2 * kKT * kBf16Pitch : 0;
  static constexpr int kLoop = 2 * kStage + kConv;
  static constexpr int kRow = HD + 2;              // floats of one query's (m, l, acc)
  static constexpr int kMerge = kQT * kRow * 4;
  static constexpr int kBytes = kLoop > kMerge ? kLoop : kMerge;
};

// Queue the tile of keys [kt0, kt0 + kKT) of one (row, head) into a ring
// slot: K rows, V rows and (int8) the rows' scales. Keys at or past k1 are
// zero filled.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(uint8_t* slot, const Args& a, const int* row_table,
                                          int h, int kt0, int k1, int tid) {
  using S = MmaSmem<T, HD>;
  constexpr int kChunks = HD * static_cast<int>(sizeof(T)) / 16;   // 16-byte pieces a row
  constexpr int kRowBytes = HD * static_cast<int>(sizeof(T));
  const uint8_t* kp = static_cast<const uint8_t*>(a.k);
  const uint8_t* vp = static_cast<const uint8_t*>(a.v);
  for (int c = tid; c < kKT * kChunks; c += kThreads) {
    const int r = c / kChunks, j = c % kChunks;
    const int key = kt0 + r;
    const bool ok = key < k1;
    const long long at = ok ? key_index(a, row_table, key, h) : 0;
    cp_async16(slot + r * S::kPitch + 16 * j, kp + at * kRowBytes + 16 * j, ok);
    cp_async16(slot + S::kTile + r * S::kPitch + 16 * j, vp + at * kRowBytes + 16 * j, ok);
  }
  if constexpr (S::kInt8) {
    float* ss = reinterpret_cast<float*>(slot + 2 * S::kTile);
    for (int r = tid; r < kKT; r += kThreads) {
      const int key = kt0 + r;
      const bool ok = key < k1;
      const long long at = ok ? key_index(a, row_table, key, h) : 0;
      cp_async4(ss + r, a.ks + at, ok);
      cp_async4(ss + kKT + r, a.vs + at, ok);
    }
  }
}

// int8 K and V rows of a slot to bf16 rows (exact), 8 values a step
template <int HD>
__device__ __forceinline__ void int8_to_bf16(uint8_t* dst, const uint8_t* slot, int tid) {
  using S = MmaSmem<int8_t, HD>;
  for (int c = tid; c < 2 * kKT * (HD / 8); c += kThreads) {
    const int r = c / (HD / 8), j = c % (HD / 8);   // r: K rows, then V rows
    const uint8_t* src = slot + (r / kKT) * S::kTile + (r % kKT) * S::kPitch + 8 * j;
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t word = i < 2 ? w.x : w.y;
      const int sh = 16 * (i % 2);
      const float lo = static_cast<float>(static_cast<int8_t>((word >> sh) & 0xFF));
      const float hi = static_cast<float>(static_cast<int8_t>((word >> (sh + 8)) & 0xFF));
      o[i] = (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
    }
    *reinterpret_cast<uint4*>(dst + r * S::kBf16Pitch + 16 * j) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_mma_kernel(const Args a) {
  using S = MmaSmem<T, HD>;
  constexpr int NK = kKT / 8;   // score n-tiles of a key tile
  constexpr int ND = HD / 8;    // output n-tiles
  const int split = blockIdx.x, splits = gridDim.x;
  const int h = blockIdx.y % a.nh, tile0 = (blockIdx.y / a.nh) * kQT, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int mi = lane / 8, mr = lane % 8;   // ldmatrix: this lane's matrix and row
  uint8_t* smem = dyn_smem();

  const int pos_first = a.start[b] + tile0;
  const int nq = min(kQT, a.C - tile0);
  const int n_keys = min(a.W * a.ps, pos_first + nq);
  int k0, k1;
  split_range(n_keys, split, splits, kKT, k0, k1);
  const int n_tiles = (k1 - k0 + kKT - 1) / kKT;
  const int* row_table = a.table + static_cast<long long>(b) * a.W;
  const float slope = a.slopes[h];
  const int qrow = tile0 + 16 * warp + g;      // this lane's rows: qrow, qrow + 8
  const int wpos_last = pos_first + 16 * warp + 15;

  // the warp's 16 queries as MMA A fragments, read once from global memory
  uint32_t qa[HD / 16][4];
  {
    const uint16_t* q = static_cast<const uint16_t*>(a.q);
    auto pair = [&](int row, int d) -> uint32_t {
      if (row >= a.C) return 0u;
      const long long at = b * a.sqb + row * a.sqc + h * a.sqh + d;
      return static_cast<uint32_t>(q[at]) | (static_cast<uint32_t>(q[at + 1]) << 16);
    };
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = pair(qrow, 16 * kk + 2 * c);
      qa[kk][1] = pair(qrow + 8, 16 * kk + 2 * c);
      qa[kk][2] = pair(qrow, 16 * kk + 2 * c + 8);
      qa[kk][3] = pair(qrow + 8, 16 * kk + 2 * c + 8);
    }
  }
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kEmpty, m1 = kEmpty, l0 = 0.f, l1 = 0.f;

  if (n_tiles > 0) load_tile<T, HD>(smem, a, row_table, h, k0, k1, tid);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles)
      load_tile<T, HD>(smem + ((t + 1) & 1) * S::kStage, a, row_table, h, k0 + (t + 1) * kKT,
                       k1, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile t has landed in slot t & 1
    uint8_t* slot = smem + (t & 1) * S::kStage;
    const uint8_t* kb = slot;
    const uint8_t* vb = slot + S::kTile;
    const float* kscale = reinterpret_cast<const float*>(slot + 2 * S::kTile);
    if constexpr (S::kInt8) {
      uint8_t* conv = smem + 2 * S::kStage;
      int8_to_bf16<HD>(conv, slot, tid);
      __syncthreads();
      kb = conv;
      vb = conv + kKT * S::kBf16Pitch;
    }
    constexpr int P = S::kInt8 ? S::kBf16Pitch : S::kPitch;
    const int kt0 = k0 + t * kKT;
    if (kt0 <= wpos_last) {   // else every key of the tile is in this warp's future
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t bf[4];
          ldmatrix4<false>(bf, kb + ((2 * np + mi / 2) * 8 + mr) * P + (16 * kk + (mi % 2) * 8) * 2);
          mma_bf16(s[2 * np], qa[kk], bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], qa[kk], bf[2], bf[3]);
        }
      // scores, mask, and the online softmax of rows qrow (e < 2) and qrow + 8
      float mx0 = kEmpty, mx1 = kEmpty;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * n + 2 * c + (e & 1);
          const int key = kt0 + j;
          const int qpos = pos_first + 16 * warp + g + 8 * (e >> 1);
          float x = s[n][e];
          if constexpr (S::kInt8) x *= kscale[j];
          const float bias =
              slope * static_cast<float>(key) + (key < k1 && key <= qpos ? 0.f : kNegInf);
          x = x * a.scale + bias;
          s[n][e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, shfl_xor(mx0, off));
        mx1 = fmaxf(mx1, shfl_xor(mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[n][e] - (e < 2 ? mn0 : mn1));
          if (e < 2)
            ls0 += p;
          else
            ls1 += p;
          s[n][e] = S::kInt8 ? p * kscale[kKT + 8 * n + 2 * c + (e & 1)] : p;
        }
      l0 = fmaf(l0, al0, ls0);
      l1 = fmaf(l1, al1, ls1);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
      // O += P V with P = hi + lo, both bf16
#pragma unroll
      for (int kp = 0; kp < NK / 2; ++kp) {
        const float* p0 = s[2 * kp];
        const float* p1 = s[2 * kp + 1];
        uint32_t hi[4], lo[4];
        const float pv[4][2] = {{p0[0], p0[1]}, {p0[2], p0[3]}, {p1[0], p1[1]}, {p1[2], p1[3]}};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          hi[r] = pack_bf16x2(pv[r][0], pv[r][1]);
          lo[r] = pack_bf16x2(pv[r][0] - bf16_lo(hi[r]), pv[r][1] - bf16_hi(hi[r]));
        }
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t bv[4];
          ldmatrix4<true>(bv, vb + (16 * kp + (mi % 2) * 8 + mr) * P + (16 * np + (mi / 2) * 8) * 2);
          mma_bf16(o[2 * np], hi, bv[0], bv[1]);
          mma_bf16(o[2 * np], lo, bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], hi, bv[2], bv[3]);
          mma_bf16(o[2 * np + 1], lo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // slot t & 1 (and the bf16 rows) are free for the next tile
  }
  cp_async_wait<0>();
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += shfl_xor(l0, off);
    l1 += shfl_xor(l1, off);
  }
  float* out = a.out;
  const long long row_stride = static_cast<long long>(a.nh) * HD;
  const long long base = (static_cast<long long>(b) * a.C) * row_stride + static_cast<long long>(h) * HD;
  if (splits == 1) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qrow + 8 * (e >> 1);
        if (row < a.C)
          out[base + row * row_stride + 8 * n + 2 * c + (e & 1)] =
              o[n][e] / fmaxf(e < 2 ? l0 : l1, 1e-30f);
      }
    return;
  }
  // this split's per-query states, left in shared memory for the cluster
  __syncthreads();   // the ring is no longer read
  float* st = reinterpret_cast<float*>(smem);   // [kQT][kRow]
  const int r0 = 16 * warp + g;
  if (c == 0) {
    st[r0 * S::kRow] = m0;
    st[r0 * S::kRow + 1] = l0;
    st[(r0 + 8) * S::kRow] = m1;
    st[(r0 + 8) * S::kRow + 1] = l1;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[(r0 + 8 * (e >> 1)) * S::kRow + 2 + 8 * n + 2 * c + (e & 1)] = o[n][e];
  cluster_sync();
  constexpr int E = kQT * HD;
  for (int e = split * E / splits + tid; e < (split + 1) * E / splits; e += kThreads) {
    const int row = e / HD, d = e % HD;
    if (tile0 + row >= a.C) continue;
    out[base + (tile0 + row) * row_stride + d] = merge_splits(st + row * S::kRow, d, splits);
  }
  cluster_sync();   // every block's states stay until the last read
}

// ---------------------------------------------------------------------------
template <typename Kernel>
int launch(Kernel kernel, const Args& a, int B, int groups, int splits, int smem,
           cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    static bool sized[64] = {};   // the shared-memory limit raised, per device
    if (dev >= 64 || !sized[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 64) sized[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.nh * groups, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename T, bool kScaled, int HD>
int launch_fma(const Args& a, int B, int splits, cudaStream_t stream) {
  if (a.C == 1) {
    constexpr int smem = (kWarps + 1) * 1 * (HD + 2) * 4;
    return launch(paged_fma_kernel<QT, T, kScaled, HD, 1>, a, B, 1, splits, smem, stream);
  }
  constexpr int smem = (kWarps + 1) * 4 * (HD + 2) * 4;
  return launch(paged_fma_kernel<QT, T, kScaled, HD, 4>, a, B, (a.C + 3) / 4, splits, smem,
                stream);
}

template <typename T, int HD>
int launch_mma(const Args& a, int B, int splits, cudaStream_t stream) {
  return launch(paged_mma_kernel<T, HD>, a, B, (a.C + kQT - 1) / kQT, splits,
                MmaSmem<T, HD>::kBytes, stream);
}

bool bad_args(const Args& a, int B, int hd, int splits) {
  return B < 1 || a.C < 1 || a.nh < 1 || a.ps < 1 || a.W < 1 || a.P < 1 || splits < 1 ||
         splits > kMaxSplits || (hd != 32 && hd != 64 && hd != 128) ||
         reinterpret_cast<uintptr_t>(a.k) % 16 || reinterpret_cast<uintptr_t>(a.v) % 16;
}

template <typename QT, typename T, bool kScaled>
int dispatch_fma(const Args& a, int B, int hd, int splits, cudaStream_t stream) {
  if (bad_args(a, B, hd, splits)) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch_fma<QT, T, kScaled, 32>(a, B, splits, stream);
    case 64:
      return launch_fma<QT, T, kScaled, 64>(a, B, splits, stream);
    default:
      return launch_fma<QT, T, kScaled, 128>(a, B, splits, stream);
  }
}

template <typename T>
int dispatch_mma(const Args& a, int B, int hd, int splits, cudaStream_t stream) {
  if (bad_args(a, B, hd, splits)) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch_mma<T, 32>(a, B, splits, stream);
    case 64:
      return launch_mma<T, 64>(a, B, splits, stream);
    default:
      return launch_mma<T, 128>(a, B, splits, stream);
  }
}

}  // namespace

// One entry point per (route, q dtype, page format), all with the same
// arguments: q (B, C, nh, hd) with element strides sqb, sqc, sqh (d's is 1),
// the K and V banks, their int8 scale planes (null for fp pages), the page
// table, start, slopes, the float32 output, and `splits`, the cluster's
// blocks per (row, head, query group). Returns the launch's cudaError_t: 0
// when the kernel was queued on `stream`.
#define PAGED_ATTENTION_ENTRY(NAME, CALL)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* ks,          \
                      const void* vs, const void* table, const void* start,                 \
                      const void* slopes, void* out, int B, int C, int nh, int hd, int ps,  \
                      int W, int P, int splits, float scale, long long sqb, long long sqc,  \
                      long long sqh, void* stream) {                                        \
    const Args a{q,                                                                         \
                 k,                                                                         \
                 v,                                                                         \
                 static_cast<const float*>(ks),                                             \
                 static_cast<const float*>(vs),                                             \
                 static_cast<const int*>(table),                                            \
                 static_cast<const int*>(start),                                            \
                 static_cast<const float*>(slopes),                                         \
                 static_cast<float*>(out),                                                  \
                 C, nh, ps, W, P, scale, sqb, sqc, sqh};                                    \
    return CALL(a, B, hd, splits, static_cast<cudaStream_t>(stream));                       \
  }

PAGED_ATTENTION_ENTRY(paged_fma_f32q_f32, (dispatch_fma<float, float, false>))
PAGED_ATTENTION_ENTRY(paged_fma_f32q_bf16, (dispatch_fma<float, uint16_t, false>))
PAGED_ATTENTION_ENTRY(paged_fma_f32q_int8, (dispatch_fma<float, int8_t, true>))
PAGED_ATTENTION_ENTRY(paged_fma_bf16q_f32, (dispatch_fma<uint16_t, float, false>))
PAGED_ATTENTION_ENTRY(paged_fma_bf16q_bf16, (dispatch_fma<uint16_t, uint16_t, false>))
PAGED_ATTENTION_ENTRY(paged_fma_bf16q_int8, (dispatch_fma<uint16_t, int8_t, true>))
PAGED_ATTENTION_ENTRY(paged_mma_bf16q_bf16, dispatch_mma<uint16_t>)
PAGED_ATTENTION_ENTRY(paged_mma_bf16q_int8, dispatch_mma<int8_t>)
