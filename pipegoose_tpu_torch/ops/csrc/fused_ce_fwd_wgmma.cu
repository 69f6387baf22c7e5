// Fused vocab cross entropy for Hopper (sm_90a): the forward for bf16
// inputs on warpgroup MMAs (wgmma) fed by the Tensor Memory Accelerator
// (route "wgmma"). fused_ce.cu keeps the float32 forward (split-TF32 WMMA)
// and the bf16 forward that TMA cannot address (route "wmma").
//
// Replaces, for bf16 inputs, the Pallas TPU kernel
// pipegoose_tpu/ops/fused_ce.py:_fwd_pallas :63 (pallas_call :108) and
// computes the same function: with the logit of (token t, local vocab
// column j) h_t . w_j in float32, its global column offset + j, and
// columns >= valid set to NEG_INF = -1e9 (finite, as in the JAX package),
//   lse_t = m + log(max(l, 1e-30)), the running max m starting at NEG_INF,
//   tl_t  = the masked logit of the target's column (0 when the target lies
//           outside [offset, offset + V)),
// both float32 (T,). h is (T, H); w is (V, H) when vh = 1 (the tied
// embedding) or (H, V) when vh = 0 (an untied head), read in place in
// either layout. Any T and V; H a multiple of 16.
//
// What bounds it on this card: 2 T V H flops (4.2e12 at T = 8184, H = 1024,
// V = 250880: 4.25 ms at 989 TFLOP/s bf16) against 0.5 GB of weight (0.16
// ms at 3.35 TB/s). Operations bound it, and only wgmma reads its operands
// at the tensor cores' full rate, so the design keeps the tensor cores fed
// and hides everything else behind them:
//   - a block of 384 threads, one an SM: a producer warpgroup whose one
//     thread issues TMA loads into a ring of kStages stages (it gives up
//     its registers, setmaxnreg 40), and two consumer warpgroups (232
//     registers each) that own 64 of the block's BM = 128 token rows each;
//   - a stage is the block's h slice (128 rows x 64 H columns) and the
//     vocab tile's w slice (BN rows x 64 H columns), 128 bytes a row, with
//     TMA's 128-byte swizzle, which wgmma reads as it lies; the (H, V)
//     weight arrives as 64-column boxes and is read MN-major (the
//     descriptor's transpose bit). Full and empty mbarriers per stage; the
//     empty one counts the four warps of both consumers;
//   - per stage each consumer issues four m64nBNk16 products into its 64 x
//     BN float32 accumulator (128 registers at BN = 256) and releases the
//     stage before, so one group of products is always queued;
//   - the epilogue of a vocab tile (mask, target pick, online max and sum
//     with ex2.approx) runs in registers on wgmma's fragment layout: no
//     logits go to shared memory. The two consumers take their epilogues in
//     turns (named barriers 1 and 2), so the tensor cores run one
//     consumer's products while the other does its softmax; the ring's
//     depth absorbs the offset between them;
//   - the grid is ceil(T / 128) token tiles (fastest) by `splits` vocab
//     ranges. A split walks its range in order, so the ~132 resident blocks
//     cover about two splits and a w tile is read from device memory about
//     once and from L2 by the 64 blocks of its split; h stays in L2. The
//     splits' (m, l, target) partials, (3, splits, T), are combined per
//     token in split order by fused_ce_fwd_wgmma_combine.
// Nothing is atomic and every sum runs in a fixed order, so a repeat call
// gives the same bits.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W at bench.py's shape
// (scripts/sweep_fused_ce_fwd.py): 5.9-6.5 ms with the (V, H) weight,
// 6.0-6.3 with the (H, V) one, 680-715 TFLOP/s, 1.4-1.5x the bound. With
// the softmax left out, the loads and products run at up to 950 TFLOP/s:
// the epilogue holds the kernel, though neither its exponentials nor its
// instruction count (about 12% of the tensor time) do: while one consumer
// does its softmax, the other's chain alone does not keep the tensor cores
// full. The turns are worth up to 5%, the fourth stage up to 8%, BN = 256
// over 128 13-24%; 24 / 240 registers change nothing.
//
// Accuracy. The products of bf16 values are exact in float32; the tensor
// cores add them to the accumulator without rounding each addition to
// nearest (fused_ce.cu's measurement), so the error grows with the
// number of k steps one accumulator chain takes. One chain sums at most
// kChainK = 1024 H columns (64 k steps): above H = 1024 the wrapper's plan
// takes BN = 128, whose consumers add chains of 1024 columns in float32
// into a second accumulator. lse and the target logit stay within 2^-18 of
// the largest value of the plain version (0.04 and 0.48 of it at bench.py's
// shape).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;             // tokens a block: two consumers of 64 rows
constexpr int kBK = 64;              // H columns a stage: 128 bytes of bf16
constexpr int kStages = 4;           // ring depth
constexpr int kThreads = 384;        // producer warpgroup + two consumers
constexpr int kProducerRegs = 40;    // 128 x 40 + 256 x 232 = 384 x 168
constexpr int kConsumerRegs = 232;
constexpr int kChainK = 1024;        // H columns one accumulator chain sums
constexpr int kChainStages = kChainK / kBK;
// BN = 256 runs only with H <= kChainK (one chain a tile); BN = 128 adds
// chains in float32
template <int BN>
constexpr bool kSum = BN == 128;
constexpr int kTurn = 1;             // named barriers kTurn + c: consumer c's epilogue turn
constexpr float kNegInf = -1e9f;     // finite, as NEG_INF in the JAX package
constexpr float kLog2e = 1.4426950408889634f;

template <int BN>
struct Smem {
  static constexpr int kHBytes = kBM * kBK * 2;          // the block's h slice
  static constexpr int kWBytes = BN * kBK * 2;           // the vocab tile's w slice
  static constexpr int kStageBytes = kHBytes + kWBytes;  // a multiple of 1024
  static constexpr int kBarrierOffset = kStages * kStageBytes;
  // the ring, full and empty barriers, and room to align the ring to 1024
  static constexpr int kBytes = kBarrierOffset + 2 * kStages * 8 + 1024;
};

// The producer: for each vocab tile of [tile0, tile_end) and each 64-column
// chunk of H, one stage: the block's h rows [t0, t0 + 128) and the tile's w
// rows [BN tile, + BN) over H columns [64 kc, + 64).
template <int BN, bool kHV>
__device__ __forceinline__ void produce(uint8_t* ring, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* tm_h, const CUtensorMap* tm_w,
                                        int t0, int tile0, int tile_end, int nk) {
  using S = Smem<BN>;
  int stage = 0, phase = 0;
  for (int tile = tile0; tile < tile_end; ++tile) {
    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait(&empty[stage], phase ^ 1);
      uint8_t* sh = ring + stage * S::kStageBytes;
      uint8_t* sw = sh + S::kHBytes;
      mbar_arrive_expect_tx(&full[stage], S::kStageBytes);
      tma_load_2d(sh, tm_h, kc * kBK, t0, &full[stage]);
      if constexpr (kHV) {  // (H, V): BN / 64 boxes of 64 vocab columns x 64 H rows
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(sw + j * 64 * kBK * 2, tm_w, tile * BN + 64 * j, kc * kBK, &full[stage]);
      } else {  // (V, H): one box of BN vocab rows x 64 H columns
        tma_load_2d(sw, tm_w, kc * kBK, tile * BN, &full[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// The ring's barriers, before any thread uses them: a stage is full once
// the producer's arrival and its bytes have come, empty once lane 0 of each
// of the eight consumer warps has arrived.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The consumer's walk over the ring: its place and phase, and the stage it
// still has to release.
struct Walk {
  int stage = 0, phase = 0, held = -1;
};

__device__ __forceinline__ void release(Walk& r, uint64_t* empty) {
  if (r.held >= 0 && threadIdx.x % 32 == 0) mbar_arrive(&empty[r.held]);
  r.held = -1;
}

// acc = consumer c's 64 x BN logits of one vocab tile: rows [64 c, + 64) of
// the h slices times the tile's w slices over the nk stages of H. Chains of
// kChainStages stages start afresh; at BN = 128 `run` adds them in float32.
template <int BN, bool kHV>
__device__ __forceinline__ void tile_logits(float (&acc)[BN / 2], float (&run)[BN / 2],
                                            uint8_t* ring, uint64_t* full, uint64_t* empty,
                                            Walk& r, int c, int nk) {
  using S = Smem<BN>;
  for (int kc = 0; kc < nk; ++kc) {
    if (kSum<BN> && kc % kChainStages == 0 && kc > 0) {
      wgmma_wait<0>();
      fence_acc(acc);
      release(r, empty);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) run[i] = kc == kChainStages ? acc[i] : run[i] + acc[i];
    }
    mbar_wait(&full[r.stage], r.phase);
    uint8_t* sh = ring + r.stage * S::kStageBytes + c * 64 * kBK * 2;
    uint8_t* sw = ring + r.stage * S::kStageBytes + S::kHBytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const uint64_t a = wgmma_desc(sh + 32 * ks, 16, 1024);
      const uint64_t b = kHV ? wgmma_desc(sw + 16 * 128 * ks, 64 * kBK * 2, 1024)
                             : wgmma_desc(sw + 32 * ks, 16, 1024);
      const int scale_d = kc % kChainStages != 0 || ks > 0;
      if constexpr (BN == 256)
        wgmma_m64n256k16<kHV>(acc, a, b, scale_d);
      else
        wgmma_m64n128k16<kHV>(acc, a, b, scale_d);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    release(r, empty);
    r.held = r.stage;
    if (++r.stage == kStages) {
      r.stage = 0;
      r.phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  release(r, empty);
  if (kSum<BN> && nk > kChainStages) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += run[i];
  }
}

// Max and sum over the four lanes of a quad, which share a row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, shfl_xor(x, 1));
  return fmaxf(x, shfl_xor(x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += shfl_xor(x, 1);
  return x + shfl_xor(x, 2);
}

// The online softmax over one vocab tile of the thread's two rows (j = 0,
// 1: accumulator values i with (i / 2) % 2 == j), whose value i lies in
// column 8 (i / 4) + q2 + i % 2 of the tile. Columns >= lim_v are past V
// and left out (-inf); columns >= lim_valid are masked to NEG_INF; then the
// target (tile column tc[j]) is picked and (m, l) updated.
template <int N>
__device__ __forceinline__ void tile_softmax(float (&acc)[N], int q2, int lim_v, int lim_valid,
                                             const int (&tc)[2], float (&m)[2], float (&l)[2],
                                             float (&ts)[2]) {
  if (lim_v < 2 * N || lim_valid < 2 * N) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int col = 8 * (i / 4) + q2 + i % 2;
      acc[i] = col >= lim_v ? -INFINITY : col >= lim_valid ? kNegInf : acc[i];
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if ((unsigned)tc[j] < (unsigned)(2 * N)) {  // the target lies in this tile
#pragma unroll
      for (int i = 0; i < N; ++i)
        if ((i / 2) % 2 == j && 8 * (i / 4) + q2 + i % 2 == tc[j]) ts[j] += acc[i];
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if ((i / 2) % 2 == j) mx = fmaxf(mx, acc[i]);
    const float mn = fmaxf(m[j], quad_max(mx));
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if ((i / 2) % 2 == j) s += exp2_approx((acc[i] - mn) * kLog2e);
    l[j] = l[j] * exp2_approx((m[j] - mn) * kLog2e) + quad_sum(s);
    m[j] = mn;
  }
}

// grid (ceil(T / 128), splits), 384 threads, Smem<BN>::kBytes of shared
// memory. Split s walks vocab tiles [s n / splits, (s + 1) n / splits) of
// the n = ceil(V / BN) and writes its (m, l, target logit) partials.
template <int BN, bool kHV>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_h,
                          const __grid_constant__ CUtensorMap tm_w,
                          const int* __restrict__ targets, float* __restrict__ part, int t,
                          int hd, int v, int offset, int valid) {
  using S = Smem<BN>;
  uint8_t* ring = align1024(dyn_smem());
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::kBarrierOffset);
  uint64_t* empty = full + kStages;
  const int t0 = blockIdx.x * kBM, split = blockIdx.y, splits = gridDim.y;
  const int n_tiles = (v + BN - 1) / BN, nk = (hd + kBK - 1) / kBK;
  const int tile0 = (int)((int64_t)split * n_tiles / splits);
  const int tile_end = (int)((int64_t)(split + 1) * n_tiles / splits);
  init_ring(full, empty);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      produce<BN, kHV>(ring, full, empty, &tm_h, &tm_w, t0, tile0, tile_end, nk);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1, lane = threadIdx.x % 32;
    const int row = 64 * c + 16 * (threadIdx.x / 32 % 4) + lane / 4;  // and row + 8
    const int q2 = 2 * (lane % 4);
    int tgt[2];  // the rows' targets as local vocab columns, -1 outside [0, V)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tok = t0 + row + 8 * j;
      const int local = tok < t ? targets[tok] - offset : -1;
      tgt[j] = local >= 0 && local < v ? local : -1;
    }
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, ts[2] = {0.f, 0.f};
    float acc[BN / 2], run[BN / 2];
    Walk r;
    for (int tile = tile0; tile < tile_end; ++tile) {
      tile_logits<BN, kHV>(acc, run, ring, full, empty, r, c, nk);
      // softmax turns: consumer 0 after consumer 1's previous tile, then 1
      if (c == 1 || tile > tile0) bar_sync(kTurn + c, 256);
      const int v0 = tile * BN;
      const int tc[2] = {tgt[0] < 0 ? -1 : tgt[0] - v0, tgt[1] < 0 ? -1 : tgt[1] - v0};
      tile_softmax(acc, q2, v - v0, valid - offset - v0, tc, m, l, ts);
      if (c == 0 || tile + 1 < tile_end) bar_arrive(kTurn + 1 - c, 256);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float tsum = quad_sum(ts[j]);
      const int tok = t0 + row + 8 * j;
      if (lane % 4 == 0 && tok < t) {
        part[(int64_t)split * t + tok] = m[j];
        part[(int64_t)(splits + split) * t + tok] = l[j];
        part[(int64_t)(2 * splits + split) * t + tok] = tsum;
      }
    }
  }
}

// Combine the splits' (m, l, target) per token, in split order (the math
// of fused_ce.cu's fused_ce_combine_kernel).
__global__ void __launch_bounds__(256)
fused_ce_fwd_wgmma_combine(const float* __restrict__ part, float* __restrict__ lse,
                           float* __restrict__ tl, int t, int splits) {
  const int i = blockIdx.x * 256 + threadIdx.x;
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

// One block's 128 x BN logits tile at token tile t0, vocab tile `tile`,
// written as float32 out (128, BN) row-major: the producer and one
// tile_logits of each consumer, as the forward kernel runs them, without
// the softmax. A check of TMA, the swizzle, the descriptors and the
// fragment layout against a plain product.
template <int BN, bool kHV>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_wgmma_logits_kernel(const __grid_constant__ CUtensorMap tm_h,
                             const __grid_constant__ CUtensorMap tm_w, float* __restrict__ out,
                             int hd, int t0, int tile) {
  using S = Smem<BN>;
  uint8_t* ring = align1024(dyn_smem());
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::kBarrierOffset);
  uint64_t* empty = full + kStages;
  const int nk = (hd + kBK - 1) / kBK;
  init_ring(full, empty);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) produce<BN, kHV>(ring, full, empty, &tm_h, &tm_w, t0, tile, tile + 1, nk);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1, lane = threadIdx.x % 32;
    const int row = 64 * c + 16 * (threadIdx.x / 32 % 4) + lane / 4;
    float acc[BN / 2], run[BN / 2];
    Walk r;
    tile_logits<BN, kHV>(acc, run, ring, full, empty, r, c, nk);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      out[(row + 8 * ((i / 2) % 2)) * BN + 8 * (i / 4) + 2 * (lane % 4) + i % 2] = acc[i];
  }
}

// -- host --------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major (outer, inner) bf16 matrix at `base`, read in
// boxes of (box_outer, box_inner) with the 128-byte swizzle; 0 or a
// cudaError_t.
int tensor_map(CUtensorMap* map, const void* base, int inner, int outer, int box_inner,
               int box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The maps of h (T, H) and of w, (V, H) or (H, V), for tiles of BN vocab
// entries.
int operand_maps(CUtensorMap* tm_h, CUtensorMap* tm_w, const void* h, const void* w, int t,
                 int hd, int v, int vh, int bn) {
  int err = tensor_map(tm_h, h, hd, t, kBK, kBM);
  if (err) return err;
  return vh ? tensor_map(tm_w, w, hd, v, kBK, bn) : tensor_map(tm_w, w, v, hd, 64, kBK);
}

// What TMA and the plan need: 16-byte aligned operands, rows of a multiple
// of 16 bytes ((H, V): V a multiple of 8), BN 256 (H <= kChainK) or 128.
bool addressable(const void* h, const void* w, int t, int hd, int v, int vh, int bn) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  return aligned && t > 0 && v > 0 && hd > 0 && hd % 16 == 0 && (vh || v % 8 == 0) &&
         (bn == 128 || (bn == 256 && hd <= kChainK));
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, bool* opted_in, size_t smem, dim3 grid, cudaStream_t stream,
           Args... args) {
  if (!*opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    *opted_in = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int BN, bool kHV>
int fwd(const CUtensorMap& tm_h, const CUtensorMap& tm_w, const void* targets, void* part,
        int t, int hd, int v, int offset, int valid, int splits, cudaStream_t stream) {
  static bool opted_in = false;
  const dim3 grid((t + kBM - 1) / kBM, splits);
  return launch(fused_ce_fwd_wgmma_kernel<BN, kHV>, &opted_in, Smem<BN>::kBytes, grid, stream,
                tm_h, tm_w, static_cast<const int*>(targets), static_cast<float*>(part), t, hd,
                v, offset, valid);
}

template <int BN, bool kHV>
int logits(const CUtensorMap& tm_h, const CUtensorMap& tm_w, void* out, int hd, int t0,
           int tile, cudaStream_t stream) {
  static bool opted_in = false;
  return launch(fused_ce_wgmma_logits_kernel<BN, kHV>, &opted_in, Smem<BN>::kBytes, dim3(1),
                stream, tm_h, tm_w, static_cast<float*>(out), hd, t0, tile);
}

}  // namespace

// The bf16 forward: h (T, H), w (V, H) (vh = 1) or (H, V) (vh = 0), targets
// int32 (T,) -> lse, tl float32 (T,), with part float32 scratch of 3 x
// splits x T; valid >= 2^31 - 1 masks nothing; bn is the plan's vocab tile,
// 256 (H <= 1024) or 128. Returns the launches' cudaError_t: 0 when both
// kernels were queued on `stream`.
extern "C" int fused_ce_fwd_wgmma(const void* h, const void* w, const void* targets, void* part,
                                  void* lse, void* tl, int t, int hd, int v, int offset,
                                  int valid, int vh, int splits, int bn, void* stream) {
  if (!addressable(h, w, t, hd, v, vh, bn) || splits < 1 || splits > (v + bn - 1) / bn)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_h, tm_w;
  int err = operand_maps(&tm_h, &tm_w, h, w, t, hd, v, vh, bn);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 256)
    err = vh ? fwd<256, false>(tm_h, tm_w, targets, part, t, hd, v, offset, valid, splits, st)
             : fwd<256, true>(tm_h, tm_w, targets, part, t, hd, v, offset, valid, splits, st);
  else
    err = vh ? fwd<128, false>(tm_h, tm_w, targets, part, t, hd, v, offset, valid, splits, st)
             : fwd<128, true>(tm_h, tm_w, targets, part, t, hd, v, offset, valid, splits, st);
  if (err) return err;
  fused_ce_fwd_wgmma_combine<<<(t + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(lse), static_cast<float*>(tl), t,
      splits);
  return (int)cudaGetLastError();
}

// The logits of token rows [t0, t0 + 128) and vocab entries [bn tile, + bn)
// as the forward's products form them, float32 out (128, bn) (rows and
// columns past T and V are products of TMA's zero fill): a check of the
// product alone.
extern "C" int fused_ce_fwd_wgmma_logits(const void* h, const void* w, void* out, int t, int hd,
                                         int v, int vh, int t0, int tile, int bn, void* stream) {
  if (!addressable(h, w, t, hd, v, vh, bn)) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_h, tm_w;
  const int err = operand_maps(&tm_h, &tm_w, h, w, t, hd, v, vh, bn);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 256)
    return vh ? logits<256, false>(tm_h, tm_w, out, hd, t0, tile, st)
              : logits<256, true>(tm_h, tm_w, out, hd, t0, tile, st);
  return vh ? logits<128, false>(tm_h, tm_w, out, hd, t0, tile, st)
            : logits<128, true>(tm_h, tm_w, out, hd, t0, tile, st);
}
