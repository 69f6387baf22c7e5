// Fused vocab cross entropy for Hopper (sm_90a): forward, d-hidden and
// d-weight kernels. The (T, V) logits never exist in device memory.
//
// Replaces the three Pallas TPU kernels of pipegoose_tpu/ops/fused_ce.py and
// computes the same functions:
//   fused_ce_fwd_*  <- _fwd_pallas :63  (pallas_call :108)
//   fused_ce_dh_*   <- _dh_pallas  :163 (pallas_call :194)
//   fused_ce_dw_*   <- _dw_pallas  :221 (pallas_call :258)
// The wrapper runs dh and dw here for float32 inputs and for bf16 with H
// above 4096; bf16 with H <= 4096 goes to fused_ce_mma.cu's tensor-core
// kernel (ops/fused_ce.py bwd_plan).
//
// Inputs: h (T, H); w (V, H) when vh = 1 (the tied embedding) or (H, V) when
// vh = 0 (an untied head), read in place in either layout; targets int32
// (T,); for the backward also lse and g float32 (T,). The logit of (token t,
// local column j) is h_t . w_j in float32; its global column is offset + j,
// and columns >= valid become NEG_INF = -1e9 (finite, as in the JAX package)
// before the max, the sum and the target pick:
//   fwd: lse = m + log(max(l, 1e-30)) with the running max m starting at
//        NEG_INF, and the target logit (0 when the target lies outside the
//        shard), both float32;
//   dh:  dh = sum_j dl_tj w_j,  dw: dw_j = sum_t dl_tj h_t, with
//        dl = g * (exp(logit - lse) - onehot(target)), in the input dtype.
// Any T and V: ragged token and vocab tiles are staged as zeros and left out
// of every max, sum and output. H must be a multiple of 16.
//
// What bounds it on this card: at the bench shape (T = 8184, H = 1024,
// V = 250880, bf16) the forward does 2 T V H = 4.2e12 flops, dh and dw each
// twice that (the logits tile is rebuilt, then the second product), against
// 0.5 GB of weight: 4.3 / 8.5 / 8.5 ms of bf16 tensor-core time at 989
// TFLOP/s, 0.16 ms of device-memory time. Operations bound all three, so the
// products run on the tensor cores through the WMMA API (mma.sync):
//   bf16 inputs: bf16 x bf16 fragments into float32 accumulators. The
//     products are exact in float32, so the logits differ from the Pallas
//     kernel's only in summation order. The second products take the float32
//     dl tile rounded to bf16 (relative error 2^-9 per term; the outputs are
//     bf16 anyway).
//   float32 inputs: split TF32, a = a_hi + a_lo with both halves TF32, and
//     a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi (three products): about float32
//     accuracy at a third of the TF32 rate.
// Accumulation: the tensor cores' float32 accumulator does not round each
// addition to nearest (a split-TF32 sum over H = 1040 came out 2e-5 relative
// low on the card), so each fragment's product over one staged chunk (128
// bytes of H per row for the logits, one k-step of vocab rows or tokens for
// the second products) starts in a fresh fragment and is added to the
// running sum by float32 adds.
//
// Data movement: every chunk is staged into shared memory in 16-byte pieces
// by cp.async, the next chunk loading while the tensor cores work on the
// current one, one __syncthreads per chunk; pieces at a ragged edge, and the
// (H, V) layout, which is transposed on the way in, are copied by plain
// loads instead. No TMA and no wgmma: the tensor cores are fed through WMMA
// (mma.sync), and the kernels run an order of magnitude above their bound.
// On an NVIDIA H100 80GB HBM3 at 700 W, rings three and four deep, 128-row
// forward tiles and second products summed straight in the fragments all
// timed within the noise of this version, so the load latency and the
// float32 adds are not what holds them; the WMMA fragment path (shared-
// memory fragment loads and instruction issue) is the suspect.
//
// Design. The TPU carried accumulators in VMEM along a sequential grid axis;
// here a loop inside one 256-thread block (8 warps) takes that axis:
//   fwd: one block per (64-token tile, vocab split): 64 x 128 logits tiles,
//     an online (m, l, target) per row over the split's vocab tiles, written
//     as partials; a second small kernel combines the splits per token in
//     split order (the math of _combine). The vocab split fills the 132 SMs:
//     128 token tiles alone would not.
//   dh and dw are one kernel with the roles of tokens and vocab swapped. A
//     block owns 32 rows (tokens for dh, vocab rows for dw) and a 1024-wide
//     slice of H, and walks the other operand in tiles of 128 rows (vocab
//     rows for dh, tokens for dw): logits (32 x 128), dl, then
//     acc (32 x 1024) += dl . tile. The float32 accumulator lives in
//     registers: 128 of each thread's, all the register file allows.
// Of the three ways to fit the accumulator (fewer rows, split H, split the
// vocab or tokens with a second pass), dh and dw take fewer rows: 32 rows
// keep the whole H = 1024 in registers, so no logits are recomputed per H
// slice (an H above 1024 takes more slices, each recomputing the logits).
// The cost is reuse: every dh block streams all of w, and every dw block all
// of h, twice through L2 (once per product), about 32 flops per byte. Sums
// run in a fixed order, with no atomics, so float32 runs repeat exactly.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBS = 128;          // streamed rows per tile: vocab (fwd, dh), tokens (dw)
constexpr int kFwdBR = 64;        // forward: tokens per block
constexpr int kBwdBR = 32;        // dh / dw: resident rows per block
constexpr int kHs = 1024;         // H slice of the dh / dw accumulators
constexpr int kAccCols = kHs / 16 / kWarps;  // accumulator fragment columns per warp
constexpr float kNegInf = -1e9f;  // finite, as NEG_INF in the JAX package

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

// Shared-memory row stride in elements: 16 bytes of padding per row keeps
// WMMA's 32-byte alignment and moves neighbouring rows to other banks.
template <typename T, int C>
__host__ __device__ constexpr int ld_of() { return C + 16 / (int)sizeof(T); }

// The tensor-core step for each input type, and the staging chunks: kKc H
// columns (128 bytes) per logits chunk, kK streamed rows per chunk of the
// second product. A fragment is loaded from shared memory once and then used
// for several products.
template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static constexpr int kK = 16;
  static constexpr int kKc = 64;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  template <typename L> struct A { wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, L> x; };
  template <typename L> struct B { wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, L> x; };
  template <typename F>
  static __device__ __forceinline__ void load(F& f, const __nv_bfloat16* p, int ld) {
    wmma::load_matrix_sync(f.x, p, ld);
  }
  template <typename FA, typename FB>
  static __device__ __forceinline__ void mma(Acc& c, const FA& a, const FB& b) {
    wmma::mma_sync(c, a.x, b.x, c);
  }
};

template <> struct Mma<float> {
  static constexpr int kK = 8;
  static constexpr int kKc = 32;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  template <typename L> struct A {
    wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, L> hi, lo;
  };
  template <typename L> struct B {
    wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, L> hi, lo;
  };
  // split TF32: hi = tf32(x), lo = tf32(x - hi)
  template <typename F>
  static __device__ __forceinline__ void load(F& f, const float* p, int ld) {
    wmma::load_matrix_sync(f.hi, p, ld);
#pragma unroll
    for (int i = 0; i < f.hi.num_elements; ++i) {
      const float x = f.hi.x[i];
      f.hi.x[i] = wmma::__float_to_tf32(x);
      f.lo.x[i] = wmma::__float_to_tf32(x - f.hi.x[i]);
    }
  }
  template <typename FA, typename FB>
  static __device__ __forceinline__ void mma(Acc& c, const FA& a, const FB& b) {
    wmma::mma_sync(c, a.lo, b.hi, c);  // the small terms first
    wmma::mma_sync(c, a.hi, b.lo, c);
    wmma::mma_sync(c, a.hi, b.hi, c);
  }
};

// acc += part in float32, element by element (both fragments share one
// layout).
template <typename F>
__device__ __forceinline__ void add_to(F& acc, const F& part) {
#pragma unroll
  for (int e = 0; e < acc.num_elements; ++e) acc.x[e] += part.x[e];
}

// dst[r][c] = src[r0 + r][c0 + c] of a row-major (rows, cols) matrix, for
// r < R, c < C; zero outside it. In flight until the group is waited for:
// a 16-byte piece that lies inside the matrix goes by cp.async when src is
// 16-byte aligned (cols, a multiple of 16, keeps every row so), any other
// piece by plain loads.
template <typename T, int R, int C>
__device__ __forceinline__ void stage(T* dst, int ld, const T* __restrict__ src, int rows,
                                      int cols, int r0, int c0) {
  constexpr int kPiece = 16 / (int)sizeof(T), kPieces = C / kPiece, kN = R * kPieces;
  static_assert(C % kPiece == 0, "a staged row is whole 16-byte pieces");
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
#pragma unroll
  for (int i = 0; i < (kN + kThreads - 1) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (kN % kThreads != 0 && e >= kN) break;
    const int r = e / kPieces, c = e % kPieces * kPiece;
    T* d = dst + r * ld + c;
    const int gr = r0 + r, gc = c0 + c;
    const T* s = src + (int64_t)min(gr, rows - 1) * cols + gc;
    if (aligned && gr < rows && gc + kPiece <= cols) {
      __pipeline_memcpy_async(d, s, 16);
    } else {
#pragma unroll
      for (int k = 0; k < kPiece; ++k)
        d[k] = gr < rows && gc + k < cols ? s[k] : from_f32<T>(0.f);
    }
  }
}

// dst[r][c] = src[c0 + c][r0 + r] of a row-major (rows, cols) matrix: the
// transpose, for the (H, V) layout, by plain loads; zero outside it.
template <typename T, int R, int C>
__device__ __forceinline__ void stage_t(T* dst, int ld, const T* __restrict__ src,
                                        int rows, int cols, int r0, int c0) {
  for (int e = threadIdx.x; e < R * C; e += kThreads) {
    const int r = e % R, c = e / R;  // neighbouring threads, neighbouring columns of src
    const bool in = c0 + c < rows && r0 + r < cols;
    dst[r * ld + c] = in ? src[(int64_t)(c0 + c) * cols + r0 + r] : from_f32<T>(0.f);
  }
}

// Rows [r0, r0 + R) x H columns [k0, k0 + C) of an operand whose row i is a
// token's hidden state or a vocab entry's weight, as dst[row][h]: stored
// (n, hd) row-major, or (hd, n) when `trans` (the (H, V) weight).
template <typename T, int R, int C>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* __restrict__ src, int n,
                                           int hd, int r0, int k0, bool trans) {
  if (trans)
    stage_t<T, R, C>(dst, ld, src, hd, n, r0, k0);
  else
    stage<T, R, C>(dst, ld, src, n, hd, r0, k0);
}

// acc[i] += (rows 16 i of the staged resident chunk) . (rows 16 warp of the
// staged streamed chunk)^T over one staged chunk of H: the warp's column of
// logits fragments.
template <typename T, int NR>
__device__ __forceinline__ void logits_chunk(typename Mma<T>::Acc (&acc)[NR], const T* rs,
                                             const T* ss) {
  using M = Mma<T>;
  constexpr int kLd = ld_of<T, M::kKc>();
  const int warp = threadIdx.x / 32;
  typename M::Acc part[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) wmma::fill_fragment(part[i], 0.f);
#pragma unroll
  for (int kk = 0; kk < M::kKc; kk += M::kK) {
    typename M::template B<wmma::col_major> b;
    M::load(b, ss + 16 * warp * kLd + kk, kLd);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      typename M::template A<wmma::row_major> a;
      M::load(a, rs + 16 * i * kLd + kk, kLd);
      M::mma(part[i], a, b);
    }
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) add_to(acc[i], part[i]);
}

// The masked logit of global column col, and g * (softmax - onehot).
__device__ __forceinline__ float mask_col(float x, int col, int valid) {
  return col >= valid ? kNegInf : x;
}
__device__ __forceinline__ float dlogit(float x, int col, int valid, int tgt, float lse,
                                        float g) {
  const float p = expf(mask_col(x, col, valid) - lse);
  return g * (p - (col == tgt ? 1.f : 0.f));
}

// Sum and max over the kLanes neighbouring lanes that share a forward row.
constexpr int kLanes = kThreads / kFwdBR;
__device__ __forceinline__ float lanes_max(float x) {
#pragma unroll
  for (int o = 1; o < kLanes; o *= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int o = 1; o < kLanes; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr size_t align32(size_t n) { return (n + 31) / 32 * 32; }

// The staging ring. Chunk n of a block's sequence sits in buffer n % kStages;
// kStages - 1 chunks are in flight while one is multiplied. At each step a
// block waits for chunk n, passes one __syncthreads (after which every warp
// is done with chunk n - 1), issues chunk n + kStages - 1 into chunk n - 1's
// buffer, and multiplies chunk n. Every issue commits one cp.async group,
// empty past the end of the sequence, so the wait counts are fixed. Two
// buffers keep the forward at two blocks per SM.
constexpr int kStages = 2;

__device__ __forceinline__ void ring_wait() {
  __pipeline_wait_prior(kStages - 2);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Forward: grid (ceil(T / 64), splits), two blocks per SM. The block's
// sequence is, per vocab tile of its split, the chunks of H; warp w computes
// logits columns 16 w .. 16 w + 15 of every tile for all 64 rows. Thread
// r * 4 + q then owns row r and columns q, q + 4, ... of the tile for the
// online softmax.

template <typename T>
__host__ __device__ constexpr size_t fwd_stage_bytes() {
  return align32((kFwdBR + kBS) * ld_of<T, Mma<T>::kKc>() * sizeof(T));
}

template <typename T>
constexpr size_t fwd_smem() {
  return align32(kFwdBR * (kBS + 4) * 4) + kStages * fwd_stage_bytes<T>();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fused_ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                    const int* __restrict__ targets, float* __restrict__ part, int t,
                    int hd, int v, int offset, int valid, int vh) {
  using M = Mma<T>;
  constexpr int kLl = kBS + 4, kLd = ld_of<T, M::kKc>();
  constexpr int kStage = fwd_stage_bytes<T>() / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  float* ls = reinterpret_cast<float*>(smem);                           // [64][132] logits
  T* ring = reinterpret_cast<T*>(smem + align32(kFwdBR * kLl * 4));     // [2][64 + 128][ld]
  const int t0 = blockIdx.x * kFwdBR, split = blockIdx.y, splits = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int r = threadIdx.x / kLanes, q = threadIdx.x % kLanes;
  const int tgt = t0 + r < t ? targets[t0 + r] : -1;
  const int n_tiles = (v + kBS - 1) / kBS, nk = (hd + M::kKc - 1) / M::kKc;
  const int tile0 = (int)((int64_t)split * n_tiles / splits);
  const int tile_end = (int)((int64_t)(split + 1) * n_tiles / splits);
  const int n_chunks = (tile_end - tile0) * nk;
  auto issue = [&](int n) {  // h rows, then w rows
    if (n < n_chunks) {
      T* b = ring + (n % kStages) * kStage;
      const int tile = tile0 + n / nk, k0 = n % nk * M::kKc;
      stage<T, kFwdBR, M::kKc>(b, kLd, h, t, hd, t0, k0);
      stage_rows<T, kBS, M::kKc>(b + kFwdBR * kLd, kLd, w, v, hd, tile * kBS, k0, !vh);
    }
    __pipeline_commit();
  };
  float m = kNegInf, l = 0.f, tsum = 0.f;
  typename M::Acc acc[kFwdBR / 16];
  for (int n = 0; n < kStages - 1; ++n) issue(n);
  for (int n = 0; n < n_chunks; ++n) {
    const int kc = n % nk;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < kFwdBR / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
    }
    ring_wait();
    issue(n + kStages - 1);
    const T* b = ring + (n % kStages) * kStage;
    logits_chunk<T, kFwdBR / 16>(acc, b, b + kFwdBR * kLd);
    if (kc + 1 < nk) continue;
    // The tile's logits are whole: the online softmax over them. ls is
    // written again only after the next tile's first ring_wait.
#pragma unroll
    for (int i = 0; i < kFwdBR / 16; ++i)
      wmma::store_matrix_sync(ls + 16 * i * kLl + 16 * warp, acc[i], kLl, wmma::mem_row_major);
    __syncthreads();
    const int v0 = (tile0 + n / nk) * kBS;
    float mx = -INFINITY;  // no column past V
    for (int c = q; c < kBS && v0 + c < v; c += kLanes) {
      const int col = offset + v0 + c;
      const float x = mask_col(ls[r * kLl + c], col, valid);
      if (col == tgt) tsum += x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, lanes_max(mx));
    float s = 0.f;
    for (int c = q; c < kBS && v0 + c < v; c += kLanes)
      s += expf(mask_col(ls[r * kLl + c], offset + v0 + c, valid) - m_new);
    l = l * expf(m - m_new) + lanes_sum(s);
    m = m_new;
  }
  tsum = lanes_sum(tsum);
  if (q == 0 && t0 + r < t) {
    part[(int64_t)split * t + t0 + r] = m;
    part[(int64_t)(splits + split) * t + t0 + r] = l;
    part[(int64_t)(2 * splits + split) * t + t0 + r] = tsum;
  }
}

// Combine the splits' (m, l, target) per token, in split order.
__global__ void __launch_bounds__(kThreads)
fused_ce_combine_kernel(const float* __restrict__ part, float* __restrict__ lse,
                        float* __restrict__ tl, int t, int splits) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= t) return;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part[(int64_t)s * t + i]);
  float l = 0.f, tsum = 0.f;
  for (int s = 0; s < splits; ++s) {
    l += part[(int64_t)(splits + s) * t + i] * expf(part[(int64_t)s * t + i] - mx);
    tsum += part[(int64_t)(2 * splits + s) * t + i];
  }
  lse[i] = mx + logf(fmaxf(l, 1e-30f));
  tl[i] = tsum;
}

// ---------------------------------------------------------------------------
// dh and dw: grid (ceil(rows / 32), ceil(H / 1024)), rows = T for dh and V
// for dw. The resident rows R are tokens (dh) or vocab rows (dw), the
// streamed rows S the other operand. Per 128-row tile of S:
//   logits L (32 x 128) = R . S^T, warp w holding columns 16 w .. 16 w + 15;
//   dl (32 x 128) = g * (softmax - onehot) of L, thread 8 r + c owning row r,
//     columns c, c + 8, ...; token and vocab index are row and column (dh)
//     or column and row (dw);
//   acc (32 x 1024) += dl . S_tile, warp w holding H columns
//     128 w .. 128 w + 127 of both 16-row halves.
// The block's sequence is, per tile, the chunks of H for the logits (R and
// S rows), then S_tile's rows kK at a time for the second product, all
// through one ring.

template <typename T>
__host__ __device__ constexpr size_t bwd_stage_bytes() {
  constexpr size_t logits = (kBwdBR + kBS) * ld_of<T, Mma<T>::kKc>() * sizeof(T);
  constexpr size_t product = Mma<T>::kK * ld_of<T, kHs>() * sizeof(T);
  return align32(logits > product ? logits : product);
}

template <typename T>
constexpr size_t bwd_smem() {
  return align32(kBwdBR * (kBS + 4) * 4) +                // ls
         align32(kBwdBR * ld_of<T, kBS>() * sizeof(T)) +  // dl
         kStages * bwd_stage_bytes<T>() +                 // ring
         3 * kBS * 4;                                     // token columns (dw)
}

template <typename T, bool kDw>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_bwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                    const int* __restrict__ targets, const float* __restrict__ lse,
                    const float* __restrict__ g, T* __restrict__ out, int t, int hd, int v,
                    int offset, int valid, int vh) {
  using M = Mma<T>;
  constexpr int kLl = kBS + 4, kLdd = ld_of<T, kBS>(), kLd = ld_of<T, M::kKc>();
  constexpr int kLdp = ld_of<T, kHs>();
  constexpr int kStage = bwd_stage_bytes<T>() / sizeof(T);
  constexpr int kNp = kBS / M::kK;  // second-product chunks per tile
  extern __shared__ __align__(128) unsigned char smem[];
  float* ls = reinterpret_cast<float*>(smem);                                  // [32][132]
  T* dls = reinterpret_cast<T*>(smem + align32(kBwdBR * kLl * 4));             // [32][ldd]
  T* ring = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(dls) +
                                 align32(kBwdBR * kLdd * sizeof(T)));  // [2][kStage]
  float* col_lse = reinterpret_cast<float*>(ring + kStages * kStage);  // dw: per token column
  float* col_g = col_lse + kBS;
  int* col_tgt = reinterpret_cast<int*>(col_g + kBS);

  const T* rsrc = kDw ? w : h;
  const T* ssrc = kDw ? h : w;
  const int n_r = kDw ? v : t, n_s = kDw ? t : v;
  const bool rtrans = kDw && !vh, strans = !kDw && !vh;
  const int r0 = blockIdx.x * kBwdBR, h0 = blockIdx.y * kHs;
  const int hs_len = min(kHs, hd - h0);
  const int warp = threadIdx.x / 32;
  const int rr = threadIdx.x >> 3, cc = threadIdx.x & 7;  // dl: row rr, columns cc + 8 i
  const bool row_in = r0 + rr < n_r;
  // dh: the row is a token; dw: the row is a vocab entry
  const int row_tgt = !kDw && row_in ? targets[r0 + rr] : -1;
  const float row_lse = !kDw && row_in ? lse[r0 + rr] : 0.f;
  const float row_g = !kDw && row_in ? g[r0 + rr] : 0.f;
  const int row_col = offset + r0 + rr;

  const int nk = (hd + M::kKc - 1) / M::kKc, per_tile = nk + kNp;
  const int n_chunks = (n_s + kBS - 1) / kBS * per_tile;
  auto issue = [&](int n) {
    if (n < n_chunks) {
      T* b = ring + (n % kStages) * kStage;
      const int s0 = n / per_tile * kBS, c = n % per_tile;
      if (c < nk) {  // logits: R rows, then S rows, over H columns [k0, k0 + kKc)
        stage_rows<T, kBwdBR, M::kKc>(b, kLd, rsrc, n_r, hd, r0, c * M::kKc, rtrans);
        stage_rows<T, kBS, M::kKc>(b + kBwdBR * kLd, kLd, ssrc, n_s, hd, s0, c * M::kKc,
                                   strans);
      } else {  // second product: S rows [s0 + kK j, + kK) over the H slice
        stage_rows<T, M::kK, kHs>(b, kLdp, ssrc, n_s, hd, s0 + (c - nk) * M::kK, h0, strans);
      }
    }
    __pipeline_commit();
  };

  typename M::Acc acc[2][kAccCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  typename M::Acc lacc[2];
  for (int n = 0; n < kStages - 1; ++n) issue(n);
  for (int n = 0; n < n_chunks; ++n) {
    const int s0 = n / per_tile * kBS, c = n % per_tile;
    if (c == 0) {
      wmma::fill_fragment(lacc[0], 0.f);
      wmma::fill_fragment(lacc[1], 0.f);
      if (kDw) {  // last read by the previous tile's dl, kNp ring_waits ago
        for (int e = threadIdx.x; e < kBS; e += kThreads) {
          const bool in = s0 + e < t;
          col_lse[e] = in ? lse[s0 + e] : 0.f;
          col_g[e] = in ? g[s0 + e] : 0.f;
          col_tgt[e] = in ? targets[s0 + e] : -1;
        }
      }
    }
    ring_wait();
    issue(n + kStages - 1);
    const T* b = ring + (n % kStages) * kStage;
    if (c < nk) {
      logits_chunk<T, 2>(lacc, b, b + kBwdBR * kLd);
      if (c + 1 < nk) continue;
      // The tile's logits are whole: dl, read by the next kNp chunks after
      // their ring_wait.
      wmma::store_matrix_sync(ls + 16 * warp, lacc[0], kLl, wmma::mem_row_major);
      wmma::store_matrix_sync(ls + 16 * kLl + 16 * warp, lacc[1], kLl, wmma::mem_row_major);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kBS / 8; ++i) {
        const int cl = cc + 8 * i;
        float d = 0.f;
        if (kDw) {
          if (row_in && s0 + cl < t)
            d = dlogit(ls[rr * kLl + cl], row_col, valid, col_tgt[cl], col_lse[cl], col_g[cl]);
        } else {
          if (row_in && s0 + cl < v)
            d = dlogit(ls[rr * kLl + cl], offset + s0 + cl, valid, row_tgt, row_lse, row_g);
        }
        dls[rr * kLdd + cl] = from_f32<T>(d);
      }
      continue;
    }
    // acc += dl[:, kK j .. kK j + kK) . S rows [kK j, kK j + kK), one k-step
    const int j = c - nk;
    typename M::template A<wmma::row_major> fa[2];
    M::load(fa[0], dls + j * M::kK, kLdd);
    M::load(fa[1], dls + 16 * kLdd + j * M::kK, kLdd);
#pragma unroll
    for (int jj = 0; jj < kAccCols; ++jj) {
      const int col = 16 * (kAccCols * warp + jj);
      if (col < hs_len) {
        typename M::template B<wmma::row_major> fb;
        M::load(fb, b + col, kLdp);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          typename M::Acc part;
          wmma::fill_fragment(part, 0.f);
          M::mma(part, fa[i], fb);
          add_to(acc[i][jj], part);
        }
      }
    }
  }
  // Epilogue: each warp writes its fragments through a 16 x 16 float32
  // patch of ls of its own (ls was last read by the last tile's dl, kNp
  // ring_waits ago).
  float* patch = ls + 16 * warp;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < kAccCols; ++jj) {
      const int col = 16 * (kAccCols * warp + jj);
      if (col >= hs_len) continue;
      wmma::store_matrix_sync(patch, acc[i][jj], kLl, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = r0 + 16 * i + e / 16, hc = h0 + col + e % 16;
        if (row < n_r) {
          const int64_t at = !kDw || vh ? (int64_t)row * hd + hc : (int64_t)hc * v + row;
          out[at] = from_f32<T>(patch[(e / 16) * kLl + e % 16]);
        }
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// Launch: the opt-in to more than 48 KB of dynamic shared memory is set once
// per instantiation, at its first launch, so that later launches (a CUDA
// graph capture among them) only queue the kernel.

template <typename Kernel, typename... Args>
int launch(Kernel kernel, bool* opted_in, size_t smem, dim3 grid, cudaStream_t stream,
           Args... args) {
  if (!*opted_in) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    *opted_in = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* h, const void* w, const void* targets, void* part, void* lse, void* tl,
        int t, int hd, int v, int offset, int valid, int vh, int splits, cudaStream_t stream) {
  static bool opted_in = false;
  const dim3 grid((t + kFwdBR - 1) / kFwdBR, splits);
  int err = launch(fused_ce_fwd_kernel<T>, &opted_in, fwd_smem<T>(), grid, stream,
                   static_cast<const T*>(h), static_cast<const T*>(w),
                   static_cast<const int*>(targets), static_cast<float*>(part), t, hd, v,
                   offset, valid, vh);
  if (err != 0) return err;
  fused_ce_combine_kernel<<<(t + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(lse), static_cast<float*>(tl), t,
      splits);
  return (int)cudaGetLastError();
}

template <typename T, bool kDw>
int bwd(const void* h, const void* w, const void* targets, const void* lse, const void* g,
        void* out, int t, int hd, int v, int offset, int valid, int vh, cudaStream_t stream) {
  static bool opted_in = false;
  const int rows = kDw ? v : t;
  const dim3 grid((rows + kBwdBR - 1) / kBwdBR, (hd + kHs - 1) / kHs);
  return launch(fused_ce_bwd_kernel<T, kDw>, &opted_in, bwd_smem<T>(), grid, stream,
                static_cast<const T*>(h), static_cast<const T*>(w),
                static_cast<const int*>(targets), static_cast<const float*>(lse),
                static_cast<const float*>(g), static_cast<T*>(out), t, hd, v, offset, valid,
                vh);
}

}  // namespace

// Entry points, one per kernel and dtype (float32, bf16). vh is 1 for a
// (V, H) weight, 0 for (H, V); valid >= 2^31 - 1 masks nothing; the forward's
// part is float32 scratch of 3 x splits x T. Each returns the launch's
// cudaError_t: 0 when the kernel was queued on `stream`.
#define FUSED_CE_ENTRIES(SUFFIX, T)                                                         \
  extern "C" int fused_ce_fwd_##SUFFIX(const void* h, const void* w, const void* targets,   \
                                       void* part, void* lse, void* tl, int t, int hd,      \
                                       int v, int offset, int valid, int vh, int splits,    \
                                       void* stream) {                                      \
    if (hd % 16 || splits < 1) return (int)cudaErrorInvalidValue;                           \
    return fwd<T>(h, w, targets, part, lse, tl, t, hd, v, offset, valid, vh, splits,        \
                  static_cast<cudaStream_t>(stream));                                       \
  }                                                                                         \
  extern "C" int fused_ce_dh_##SUFFIX(const void* h, const void* w, const void* targets,    \
                                      const void* lse, const void* g, void* out, int t,     \
                                      int hd, int v, int offset, int valid, int vh,         \
                                      void* stream) {                                       \
    if (hd % 16) return (int)cudaErrorInvalidValue;                                         \
    return bwd<T, false>(h, w, targets, lse, g, out, t, hd, v, offset, valid, vh,           \
                         static_cast<cudaStream_t>(stream));                                \
  }                                                                                         \
  extern "C" int fused_ce_dw_##SUFFIX(const void* h, const void* w, const void* targets,    \
                                      const void* lse, const void* g, void* out, int t,     \
                                      int hd, int v, int offset, int valid, int vh,         \
                                      void* stream) {                                       \
    if (hd % 16) return (int)cudaErrorInvalidValue;                                         \
    return bwd<T, true>(h, w, targets, lse, g, out, t, hd, v, offset, valid, vh,            \
                        static_cast<cudaStream_t>(stream));                                 \
  }

FUSED_CE_ENTRIES(f32, float)
FUSED_CE_ENTRIES(bf16, __nv_bfloat16)
