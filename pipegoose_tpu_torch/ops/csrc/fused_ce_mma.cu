// Fused vocab cross entropy for Hopper (sm_90a): the d-hidden and d-weight
// kernels for bf16 inputs on the tensor cores (route "mma"). fused_ce.cu
// keeps the forward, the float32 backward (split-TF32 WMMA, route "wmma")
// and the bf16 backward for H above 4096.
//
// Replaces, for bf16 inputs, two Pallas TPU kernels of
// pipegoose_tpu/ops/fused_ce.py and computes the same functions:
//   fused_ce_dh_mma <- _dh_pallas :163 (pallas_call :194)
//   fused_ce_dw_mma <- _dw_pallas :221 (pallas_call :258)
// With the logit of (token t, local vocab column j) h_t . w_j in float32,
// its global column offset + j, and columns >= valid set to NEG_INF = -1e9:
//   dl = g_t * (exp(logit - lse_t) - onehot(target_t)),
//   dh = dl . W (T, H),  dw = dl^T . h, in w's layout, both bf16.
// w is (V, H) when vh = 1 or (H, V) when vh = 0, read in place in either
// layout. Any T and V; H a multiple of 16 and at most 4096.
//
// dh and dw are one kernel with the roles of tokens and vocab swapped: a
// block keeps BM resident rows (tokens for dh, vocab rows for dw) and walks
// the other operand (the streamed rows: vocab rows for dh, tokens for dw) in
// tiles of BN = BM / 2 rows; per tile it forms the logits (BM x BN), dl, and
// adds dl . tile to its float32 accumulator (BM x H).
//
// A thread-block cluster splits H. Its C blocks (C = 1, 2, 4 or 8) own C
// contiguous slices of H, each a multiple of 16 columns and at most 32768 /
// BM wide, so that block r's accumulator (BM x its slice, float32) fills 128
// registers of each of its 256 threads: BM = 128 with slices of up to 256
// (H <= 2048, C = 4 at H = 1024), or BM = 64 with slices of up to 512 (H up
// to 4096). Block r stages its slice of the resident rows once, and its
// slice of each streamed tile once, for both products:
//   1. partial logits P_r = R[:, slice] . S_tile[:, slice]^T, to shared
//      memory (float32);
//   2. after a cluster barrier, block r adds the C partials of its share of
//      the rows (BM / C rows) in rank order 0..C-1, read through
//      distributed shared memory (16-byte remote loads), forms dl there,
//      rounds it once to bf16, and writes it into every block's dl buffer;
//   3. after the next cluster barrier, acc += dl . S_tile[:, slice].
// Sums run in a fixed order and nothing is atomic, so a repeat call gives
// the same bits. Per tile and block, the tensor cores do 4 BM BN (H / C)
// flops against BN (H / C) bf16 staged from L2: 2 BM = 256 flops a byte at
// BM = 128 (the WMMA kernel: about 29).
//
// Waves. One block an SM and a cluster's blocks in one GPC: an H100 SXM
// holds 30 clusters of 4 (132 of 1, 66 of 2, 15 of 8). dh has few row
// clusters (64 at T = 8184: three waves, the last of 4), so its streamed
// rows may run in `splits` parts along the grid's y axis, each a cluster of
// its own writing float32 sums to a workspace, which fused_ce_split_combine
// adds in split order and rounds once to bf16 (the wrapper's plan fills the
// waves: 5 splits at T = 8184).
//
// Barriers. The two cluster barriers of tile i are split into arrive and
// wait, and each window holds half of the tile's tensor-core work:
//   wait(L[i-1]); store P_i; arrive(K_i); acc += dl_{i-1} . S_{i-1};
//   wait(K_i); reduce P_i -> dl_i; arrive(L_i); P_{i+1} = R . S_{i+1}^T.
// K_i publishes the partials of tile i; L_i says every block is done
// reading them and has written dl_i. dl is double-buffered (block X may
// still read dl_{i-1} while another block, past K_i, writes dl_i); one
// partial buffer suffices. The streamed tiles go through a three-deep
// cp.async ring: tile i in product 1, tile i - 1 in product 2, tile i + 1
// in flight.
//
// Products: bf16 mma.sync.m16n8k16 with float32 accumulators, fragments by
// ldmatrix (.trans where the operand is stored the other way round: the
// (H, V) weight is staged as it lies in memory). Product 1: warps 4 x 2
// over the BM x BN partial. Product 2: warps of 32 accumulator rows (two
// m16 tiles) by 128 columns (16 n8 tiles), so each B fragment read from
// shared memory feeds two MMAs. Shared-memory rows are unpadded and
// swizzled (16-byte chunk index XOR the row), so the 8 row addresses of an
// ldmatrix fall in 8 distinct bank quads. Shared memory a block: the
// resident slice (64 KB), the ring (3 x 32 KB), the partials (BM BN 4
// bytes), two dl buffers (BM BN 2 bytes each) and the tokens' lse, g and
// target (2.3 KB): 226 KB at BM = 128, 177 KB at BM = 64.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, at bench.py's shape, both
// layouts (scripts/sweep_fused_ce_bwd.py): the registers bind. The
// accumulator takes 128 of the 255 a thread, and this version spills at
// most 12 bytes. One m16 tile a warp in product 2 (164-216 bytes spilled)
// ran 18-25% slower; 16 warps a block (64 accumulator registers), 3-8%;
// four ranks' loads in flight or an unrolled staging loop (up to 256), -3
// to +8%; an earlier build that issued the reduction's loads behind half
// of product 2 spilled and ran slower. Every block reducing every row (3x
// the remote reads) ran 67-75% slower; C = 2 with 64 resident rows
// 21-28%; one split of dh's vocabulary walk 35%; expf for ex2.approx 1%.
// Of B5's 60 ms, leaving out the reduction saved 17 (its remote loads 7),
// product 2 9, product 1 6.
//
// Accuracy: the logits are exact products of bf16 values summed in float32
// (in another order than the plain version's); dl is rounded once to bf16
// (2^-9 of each term) before the second product, as fused_ce.cu does; exp
// is one ex2.approx (relative error about 2^-22). dh and dw stay within
// 1e-5 + 2^-6 of the largest value of their plain versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

// -- PTX wrappers --
// this block's rank in its cluster
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier, split: arrive publishes this thread's earlier
// shared-memory writes (release); wait returns once every thread of every
// block of the cluster has arrived, and makes their writes visible
// (acquire). Arrive and wait alternate.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of `p` (in this block's shared memory) in the
// shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(rank));
  return d;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t a) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(a)
               : "memory");
  return x;
}

__device__ __forceinline__ void st_cluster_u4(uint32_t a, uint4 x) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1,%2,%3,%4};\n" ::"r"(a), "r"(x.x),
               "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));   // round to nearest even
}
// -- end PTX wrappers --

constexpr int kCeWarps128 = 8;        // warps a block at BM = 128 (8 at BM = 64)
constexpr int kCeStages = 3;          // streamed tiles: in flight, in product 1, in product 2
constexpr int kCeWarpRows = 32;       // accumulator rows a warp in product 2: two m16 tiles
// the reduction's remote loads of this many ranks at once (4 spilled up to
// 104 bytes at BM = 128; see the header)
constexpr int kRanksInFlight = 2;

template <int BM>
struct CeShape {
  static constexpr int kWarps = BM == 128 ? kCeWarps128 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSlice = 32768 / BM;   // widest H slice: BM x kSlice float32 accumulators
  static constexpr int kBN = BM / 2;          // streamed rows a tile
  // product 1 (the BM x BN partial): warps 4 x kP1WC
  static constexpr int kP1WC = kWarps / 4;
  static constexpr int kP1M = BM / 4 / 16;    // m16 tiles a warp
  static constexpr int kP1N = kBN / kP1WC / 8;   // n8 tiles a warp
  // product 2 (the BM x kSlice accumulator): warps kWarpsR x kWarpsC
  static constexpr int kWarpsR = BM / kCeWarpRows;
  static constexpr int kWarpsC = kWarps / kWarpsR;
  static constexpr int kWN = kSlice / kWarpsC;   // accumulator columns a warp
  static constexpr int kAccM = kCeWarpRows / 16, kAccN = kWN / 8;
  static constexpr int kRBytes = BM * kSlice * 2;      // the resident slice, bf16
  static constexpr int kSBytes = kBN * kSlice * 2;     // one streamed slice, bf16
  static constexpr int kPartBytes = BM * kBN * 4;      // the partial logits, float32
  static constexpr int kDlBytes = BM * kBN * 2;        // one dl buffer, bf16
  // the tokens' lse, g and target: the resident rows' (dh), or each ring
  // slot's streamed rows' (dw)
  static constexpr int kVecBytes = 12 * (BM > kCeStages * kBN ? BM : kCeStages * kBN);
  static constexpr int kBytes =
      kRBytes + kCeStages * kSBytes + kPartBytes + 2 * kDlBytes + kVecBytes;
  static_assert(kP1M >= 1 && kP1N % 2 == 0 && kAccN % 2 == 0 && kWarpsR * kWarpsC == kWarps,
                "warp tiling");
};

// Byte offset of byte `byte` of row `row` in a swizzled tile of kPitch bytes
// a row: the 16-byte chunk index XOR the row (kPitch >= 128), or XOR row / 2
// (kPitch = 64), so that 8 consecutive rows at one chunk hit 8 distinct bank
// quads.
template <int kPitch>
__device__ __forceinline__ int sw(int row, int byte) {
  constexpr int kChunks = kPitch / 16;
  static_assert(kChunks == 4 || kChunks >= 8, "pitch of 64 or >= 128 bytes");
  const int x = kChunks >= 8 ? (row & 7) : ((row >> 1) & 3);
  return row * kPitch + ((((byte >> 4) ^ x)) << 4) + (byte & 15);
}

// Byte offset of float `col` of row `row` of the partial logits (kBN
// floats a row): the 32-byte group index XOR the row, so that the 8 rows of
// an accumulator fragment's float2 stores hit distinct banks.
template <int kBN>
__device__ __forceinline__ int part_off(int row, int col) {
  constexpr int kGroups = kBN / 8;
  return row * kBN * 4 + ((((col >> 3) ^ (row & (kGroups - 1)))) << 5) + (col & 7) * 4;
}

// Tile rows [0, tr) x columns [0, tc) (tc a multiple of 8) <- the row-major
// bf16 matrix src (nr x nc, row stride ld) at (r0, c0), zero outside it. A
// 16-byte piece inside the matrix goes by cp.async when `vec` (src and ld
// 16-byte aligned; in flight until the group is waited for), any other by
// plain loads and stores.
template <int kPitch, int kThreads>
__device__ __forceinline__ void stage_sw(uint8_t* tile, const uint16_t* __restrict__ src,
                                         int64_t ld, int nr, int nc, int r0, int c0, int tr,
                                         int tc, bool vec) {
  const int pieces = tc >> 3;
  for (int e = threadIdx.x; e < tr * pieces; e += kThreads) {
    const int r = e / pieces, j = e - r * pieces;
    uint8_t* d = tile + sw<kPitch>(r, 16 * j);
    const int gr = r0 + r, gc = c0 + 8 * j;
    if (gr >= nr || gc >= nc) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec && gc + 8 <= nc) {
      cp_async16(d, src + gr * ld + gc, true);
    } else {
      uint32_t x[4];
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        const uint32_t lo = gc + k < nc ? src[gr * ld + gc + k] : 0;
        const uint32_t hi = gc + k + 1 < nc ? src[gr * ld + gc + k + 1] : 0;
        x[k / 2] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(x[0], x[1], x[2], x[3]);
    }
  }
}

// stage_sw of a whole kTr x kTc tile whose columns all lie inside the
// matrix, with src and ld 16-byte aligned: every piece by cp.async, rows at
// or past nr zero filled; the piece count a thread is fixed. The loop stays
// rolled: unrolled, its addresses spilled up to 256 bytes at BM = 128.
template <int kPitch, int kThreads, int kTr, int kTc>
__device__ __forceinline__ void stage_whole(uint8_t* tile, const uint16_t* __restrict__ src,
                                            int64_t ld, int nr, int r0, int c0) {
  constexpr int kPieces = kTc / 8, kN = kTr * kPieces;
  static_assert(kN % kThreads == 0, "whole pieces a thread");
#pragma unroll 1
  for (int k = 0; k < kN / kThreads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int r = e / kPieces, j = e % kPieces, gr = r0 + r;
    cp_async16(tile + sw<kPitch>(r, 16 * j), src + (gr < nr ? gr : 0) * ld + c0 + 8 * j,
               gr < nr);
  }
}

// n floats (or ints) of src from i0 into dst by cp.async, zero past n
template <int kThreads>
__device__ __forceinline__ void stage_vec(float* dst, const void* __restrict__ src, int i0,
                                          int rows, int n) {
  for (int e = threadIdx.x; e < rows; e += kThreads) {
    const bool ok = i0 + e < n;
    cp_async4(dst + e, static_cast<const float*>(src) + (ok ? i0 + e : 0), ok);
  }
}

// The A fragment (16 x 16) at rows m0, columns k0 of a logical matrix
// stored as [m][k] (kT false) or [k][m] (kT true) in a swizzled tile.
template <bool kT, int kPitch>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint8_t* tile, int m0, int k0,
                                       int lane) {
  const int mi = lane / 8, mr = lane % 8;
  if (kT)
    ldmatrix4<true>(a, tile + sw<kPitch>(k0 + (mi / 2) * 8 + mr, 2 * (m0 + (mi % 2) * 8)));
  else
    ldmatrix4<false>(a, tile + sw<kPitch>(m0 + (mi % 2) * 8 + mr, 2 * (k0 + (mi / 2) * 8)));
}

// B fragments of the n-tiles n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]) at k
// rows k0 of a logical (k x n) operand stored as [n][k] (kT false) or
// [k][n] (kT true) in a swizzled tile.
template <bool kT, int kPitch>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const uint8_t* tile, int n0, int k0,
                                       int lane) {
  const int mi = lane / 8, mr = lane % 8;
  if (kT)
    ldmatrix4<true>(b, tile + sw<kPitch>(k0 + (mi % 2) * 8 + mr, 2 * (n0 + (mi / 2) * 8)));
  else
    ldmatrix4<false>(b, tile + sw<kPitch>(n0 + (mi / 2) * 8 + mr, 2 * (k0 + (mi % 2) * 8)));
}

// g * (softmax - onehot) of a logit at global column col
__device__ __forceinline__ float ce_dlogit(float x, int col, int valid, int tgt, float lse,
                                           float g) {
  const float z = (col >= valid ? kNegInf : x) - lse;
  return g * (exp_approx(z) - (col == tgt ? 1.f : 0.f));
}

// grid: C x ceil(rows / BM) blocks in clusters of C along x, rows = T for dh
// and V for dw; along y the splits of the streamed rows (dh only), each
// writing its float32 sums to ws (splits x T x H) when there are several.
// kHV: w is (H, V).
template <bool kDw, bool kHV, int BM>
__global__ void __launch_bounds__(CeShape<BM>::kThreads, 1)
fused_ce_bwd_mma_kernel(const uint16_t* __restrict__ h, const uint16_t* __restrict__ w,
                        const int* __restrict__ targets, const float* __restrict__ lse,
                        const float* __restrict__ g, uint16_t* __restrict__ out,
                        float* __restrict__ ws, int t, int hd, int v, int offset, int valid,
                        int cluster) {
  using S = CeShape<BM>;
  constexpr int BN = S::kBN, SL = S::kSlice;
  // the resident (R) and streamed (S) operands are stored [H][rows] when
  // they are the (H, V) weight, else [rows][H]
  constexpr bool kRT = kDw && kHV, kST = !kDw && kHV;
  constexpr int kRP = kRT ? BM * 2 : SL * 2;   // row pitches in bytes
  constexpr int kSP = kST ? BN * 2 : SL * 2;
  constexpr int kDP = BN * 2;
  constexpr int kGroups = BN / 8;              // 8-column groups of a dl row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, cq = lane % 4;
  const int rank = cluster_rank();
  const int r0 = blockIdx.x / cluster * BM;
  const int n16 = hd / 16;
  const int kb = rank * n16 / cluster * 16;                 // this block's H slice [kb, kb + W)
  const int W = (rank + 1) * n16 / cluster * 16 - kb;
  const uint16_t* rsrc = kDw ? w : h;
  const uint16_t* ssrc = kDw ? h : w;
  const int n_r = kDw ? v : t, n_s = kDw ? t : v;
  const int nt = (n_s + BN - 1) / BN;
  const int share = BM / cluster;   // rows whose dl each block forms
  const bool rvec = (reinterpret_cast<uintptr_t>(rsrc) & 15) == 0 && (!kRT || v % 8 == 0);
  const bool svec = (reinterpret_cast<uintptr_t>(ssrc) & 15) == 0 && (!kST || v % 8 == 0);

  uint8_t* Rs = dyn_smem();
  uint8_t* ring = Rs + S::kRBytes;
  uint8_t* part = ring + kCeStages * S::kSBytes;
  uint8_t* dlb = part + S::kPartBytes;   // two dl buffers
  // lse, g, target of the resident tokens (dh) or of each slot's (dw)
  float* vec = reinterpret_cast<float*>(dlb + 2 * S::kDlBytes);
  constexpr int kVecRows = kDw ? BN : BM;

  constexpr int kT = S::kThreads;
  auto stage_vecs = [&](float* dst, int i0) {
    stage_vec<kT>(dst, lse, i0, kVecRows, t);
    stage_vec<kT>(dst + kVecRows, g, i0, kVecRows, t);
    stage_vec<kT>(dst + 2 * kVecRows, targets, i0, kVecRows, t);
  };
  // streamed tile i (this split's j-th) into ring slot j % kCeStages
  auto stage_s = [&](int i, int j) {
    uint8_t* st = ring + (j % kCeStages) * S::kSBytes;
    const int s0 = i * BN;
    if (kST) {   // [H][BN]: whole when the slice is and the tile's columns exist
      if (W == SL && svec && s0 + BN <= v)
        stage_whole<kSP, kT, SL, BN>(st, ssrc, v, hd, kb, s0);
      else
        stage_sw<kSP, kT>(st, ssrc, v, hd, v, kb, s0, W, BN, svec);
    } else {     // [BN][H]: whole when the slice is
      if (W == SL && svec)
        stage_whole<kSP, kT, BN, SL>(st, ssrc, hd, n_s, s0, kb);
      else
        stage_sw<kSP, kT>(st, ssrc, hd, n_s, hd, s0, kb, BN, W, svec);
    }
    if (kDw) stage_vecs(vec + (j % kCeStages) * 3 * BN, s0);
  };
  // this split's streamed tiles [t_lo, t_hi)
  const int split = blockIdx.y, splits = gridDim.y;
  const int t_lo = split * nt / splits, nloc = (split + 1) * nt / splits - t_lo;
  if (kRT)
    stage_sw<kRP, kT>(Rs, rsrc, v, hd, v, kb, r0, W, BM, rvec);
  else
    stage_sw<kRP, kT>(Rs, rsrc, hd, n_r, hd, r0, kb, BM, W, rvec);
  if (!kDw) stage_vecs(vec, r0);
  stage_s(t_lo, 0);
  cp_async_commit();

  // product 1: warp (warp / kP1WC, warp % kP1WC) holds partial rows
  // pm0 + [0, BM / 4) and columns pn0 + [0, BN / kP1WC)
  const int pm0 = warp / S::kP1WC * (BM / 4), pn0 = warp % S::kP1WC * (BN / S::kP1WC);
  // product 2: warp holds accumulator rows am0 + [0, 32), columns an0 + [0, kWN)
  const int am0 = warp / S::kWarpsC * kCeWarpRows, an0 = warp % S::kWarpsC * S::kWN;
  float acc[S::kAccM][S::kAccN][4];
#pragma unroll
  for (int m = 0; m < S::kAccM; ++m)
#pragma unroll
    for (int n = 0; n < S::kAccN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  // acc += dl . S over the tile's BN rows
  auto product2 = [&](const uint8_t* dl, const uint8_t* st) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[S::kAccM][4];
#pragma unroll
      for (int m = 0; m < S::kAccM; ++m) frag_a<false, kDP>(a[m], dl, am0 + 16 * m, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < S::kAccN / 2; ++np) {
        if (an0 + 16 * np < W) {
          uint32_t b[4];
          frag_b<!kST, kSP>(b, st, an0 + 16 * np, 16 * kk, lane);
#pragma unroll
          for (int m = 0; m < S::kAccM; ++m) {
            mma_bf16(acc[m][2 * np], a[m], b[0], b[1]);
            mma_bf16(acc[m][2 * np + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
  };

  // dl of tile i (this split's j-th) from the cluster's partials: this
  // block's share of the rows, [row0, row0 + share), each 8-column group by
  // one thread
  const int row0 = rank * share;
  // the partials of ranks [q0, q0 + kRanksInFlight) at this block's unit u
  // of the reduction (row, 8-column group)
  auto load_partials = [&](float4 (&x)[kRanksInFlight][2], int u, int q0) {
    const uint8_t* src = part + part_off<BN>(row0 + u / kGroups, 8 * (u % kGroups));
#pragma unroll
    for (int q = 0; q < kRanksInFlight; ++q)
      if (q0 + q < cluster) {
        const uint32_t a = cluster_addr(src, q0 + q);
        x[q][0] = ld_cluster_f4(a);
        x[q][1] = ld_cluster_f4(a + 16);
      }
  };
  auto reduce = [&](int i, int j, uint8_t* dl) {
    const int s0 = i * BN;
    for (int u = tid; u < share * kGroups; u += S::kThreads) {
      const int row = row0 + u / kGroups, grp = u % kGroups;
      float s[8];
      for (int q0 = 0; q0 < cluster; q0 += kRanksInFlight) {   // in rank order
        float4 x[kRanksInFlight][2];
        load_partials(x, u, q0);
#pragma unroll
        for (int q = 0; q < kRanksInFlight; ++q)
          if (q0 + q < cluster) {
            const float y[8] = {x[q][0].x, x[q][0].y, x[q][0].z, x[q][0].w,
                                x[q][1].x, x[q][1].y, x[q][1].z, x[q][1].w};
#pragma unroll
            for (int k = 0; k < 8; ++k) s[k] = q0 + q == 0 ? y[k] : s[k] + y[k];
          }
      }
      const int re = r0 + row, ce = s0 + 8 * grp;   // row entity, first column entity
      float d[8];
      if (!kDw) {   // rows are tokens, columns vocab entries
        const bool in = re < t;
        const float l = vec[row], gg = vec[BM + row];
        const int tg = __float_as_int(vec[2 * BM + row]);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          d[k] = in && ce + k < v ? ce_dlogit(s[k], offset + ce + k, valid, tg, l, gg) : 0.f;
      } else {      // rows are vocab entries, columns tokens
        const bool in = re < v;
        const float* cv = vec + (j % kCeStages) * 3 * BN + 8 * grp;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          d[k] = in && ce + k < t ? ce_dlogit(s[k], offset + re, valid,
                                              __float_as_int(cv[2 * BN + k]), cv[k], cv[BN + k])
                                  : 0.f;
      }
      const uint4 pk = make_uint4(pack_bf16x2(d[0], d[1]), pack_bf16x2(d[2], d[3]),
                                  pack_bf16x2(d[4], d[5]), pack_bf16x2(d[6], d[7]));
      uint8_t* dst = dl + sw<kDP>(row, 16 * grp);
      for (int q = 0; q < cluster; ++q) st_cluster_u4(cluster_addr(dst, q), pk);
    }
  };

  for (int j = 0; j < nloc; ++j) {
    const int i = t_lo + j;
    cp_async_wait<0>();
    __syncthreads();   // tile i (and R) landed; every warp is done with tile i - 2's slot
    if (j + 1 < nloc) stage_s(i + 1, j + 1);
    cp_async_commit();
    const uint8_t* st = ring + (j % kCeStages) * S::kSBytes;
    // 1. the partial logits of tile i over this block's slice
    float p[S::kP1M][S::kP1N][4];
#pragma unroll
    for (int m = 0; m < S::kP1M; ++m)
#pragma unroll
      for (int n = 0; n < S::kP1N; ++n) p[m][n][0] = p[m][n][1] = p[m][n][2] = p[m][n][3] = 0.f;
    auto k_step = [&](int kk) {
      uint32_t a[S::kP1M][4];
#pragma unroll
      for (int m = 0; m < S::kP1M; ++m) frag_a<kRT, kRP>(a[m], Rs, pm0 + 16 * m, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < S::kP1N / 2; ++np) {
        uint32_t b[4];
        frag_b<kST, kSP>(b, st, pn0 + 16 * np, 16 * kk, lane);
#pragma unroll
        for (int m = 0; m < S::kP1M; ++m) {
          mma_bf16(p[m][2 * np], a[m], b[0], b[1]);
          mma_bf16(p[m][2 * np + 1], a[m], b[2], b[3]);
        }
      }
    };
    for (int kk = 0; kk < W / 16; ++kk) k_step(kk);
    if (j > 0) cluster_wait();   // L_{i-1}: every block is done reading the partials
#pragma unroll
    for (int m = 0; m < S::kP1M; ++m)
#pragma unroll
      for (int n = 0; n < S::kP1N; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = pm0 + 16 * m + gq + 8 * hh, col = pn0 + 8 * n + 2 * cq;
          *reinterpret_cast<float2*>(part + part_off<BN>(row, col)) =
              make_float2(p[m][n][2 * hh], p[m][n][2 * hh + 1]);
        }
    cluster_arrive();            // K_i: the partials of tile i
    // 3. for tile i - 1, whose dl every block has written before L_{i-1}
    if (j > 0)
      product2(dlb + ((j - 1) & 1) * S::kDlBytes, ring + ((j - 1) % kCeStages) * S::kSBytes);
    cluster_wait();              // K_i
    // 2. dl of tile i
    reduce(i, j, dlb + (j & 1) * S::kDlBytes);
    cluster_arrive();            // L_i
  }
  cluster_wait();                // the last L: no block reads this one's shared memory after it
  product2(dlb + ((nloc - 1) & 1) * S::kDlBytes,
           ring + ((nloc - 1) % kCeStages) * S::kSBytes);

  if (splits > 1) {   // this split's float32 sums, for fused_ce_split_combine
    float* wsp = ws + static_cast<int64_t>(split) * n_r * hd;
#pragma unroll
    for (int m = 0; m < S::kAccM; ++m)
#pragma unroll
      for (int n = 0; n < S::kAccN; ++n) {
        const int col = an0 + 8 * n + 2 * cq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + am0 + 16 * m + gq + 8 * hh;
          if (col < W && row < n_r)
            *reinterpret_cast<float2*>(wsp + static_cast<int64_t>(row) * hd + kb + col) =
                make_float2(acc[m][n][2 * hh], acc[m][n][2 * hh + 1]);
        }
      }
    return;
  }

  // Epilogue: the accumulator in bf16, in the resident slice's layout (the
  // output has the resident operand's), then to global memory in 16-byte
  // pieces where they fit. Every read of Rs came before the last cluster
  // barrier.
#pragma unroll
  for (int m = 0; m < S::kAccM; ++m)
#pragma unroll
    for (int n = 0; n < S::kAccN; ++n) {
      const int col = an0 + 8 * n + 2 * cq;
      if (col >= W) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = am0 + 16 * m + gq + 8 * hh;
        if (kRT) {
          *reinterpret_cast<uint16_t*>(Rs + sw<kRP>(col, 2 * row)) = bf16_bits(acc[m][n][2 * hh]);
          *reinterpret_cast<uint16_t*>(Rs + sw<kRP>(col + 1, 2 * row)) =
              bf16_bits(acc[m][n][2 * hh + 1]);
        } else {
          *reinterpret_cast<uint32_t*>(Rs + sw<kRP>(row, 2 * col)) =
              pack_bf16x2(acc[m][n][2 * hh], acc[m][n][2 * hh + 1]);
        }
      }
    }
  __syncthreads();
  const bool ovec = (reinterpret_cast<uintptr_t>(out) & 15) == 0 && (!kRT || v % 8 == 0);
  const int tr = kRT ? W : BM, tc = kRT ? BM : W;       // the tile's rows and columns
  const int gr0 = kRT ? kb : r0, gc0 = kRT ? r0 : kb;   // its origin in `out`
  const int nr = kRT ? hd : n_r, nc = kRT ? v : hd;     // the shape of `out`
  const int pieces = tc >> 3;
  for (int e = tid; e < tr * pieces; e += S::kThreads) {
    const int r = e / pieces, j = e - r * pieces;
    const int gr = gr0 + r, gc = gc0 + 8 * j;
    if (gr >= nr || gc >= nc) continue;
    const uint4 x = *reinterpret_cast<const uint4*>(Rs + sw<kRP>(r, 16 * j));
    uint16_t* dst = out + static_cast<int64_t>(gr) * nc + gc;
    if (ovec && gc + 8 <= nc) {
      *reinterpret_cast<uint4*>(dst) = x;
    } else {
      const uint32_t y[4] = {x.x, x.y, x.z, x.w};
      for (int k = 0; k < 8 && gc + k < nc; ++k)
        dst[k] = static_cast<uint16_t>(y[k / 2] >> (16 * (k % 2)));
    }
  }
}

// dh = the splits' float32 sums added in split order, rounded once to bf16;
// n4 = T x H / 4 (H is a multiple of 16)
__global__ void __launch_bounds__(256)
fused_ce_split_combine(const float* __restrict__ ws, uint16_t* __restrict__ out, int64_t n4,
                       int splits) {
  const float4* src = reinterpret_cast<const float4*>(ws);
  for (int64_t e = blockIdx.x * 256ll + threadIdx.x; e < n4; e += gridDim.x * 256ll) {
    float4 s = src[e];
    for (int k = 1; k < splits; ++k) {
      const float4 x = src[k * n4 + e];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    reinterpret_cast<uint2*>(out)[e] = make_uint2(pack_bf16x2(s.x, s.y), pack_bf16x2(s.z, s.w));
  }
}

// ---------------------------------------------------------------------------
// Launch: one launch of C x ceil(rows / BM) x splits blocks in clusters of
// C, then, with several splits, fused_ce_split_combine. The shared-memory
// opt-in, and the check that a cluster of C such blocks can be resident
// (cudaOccupancyMaxActiveClusters), run once per instantiation, cluster
// size and device, at the first launch; a cluster that cannot be resident
// is an error, not a smaller launch.

constexpr int kMaxDevices = 64;

// The launch configuration of `clusters` clusters of `cluster` blocks, with
// the kernel's shared-memory opt-in set (once per device). Returns the
// cudaError_t of the opt-in.
template <bool kDw, bool kHV, int BM>
int configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int cluster, int clusters,
              cudaStream_t stream, int* dev) {
  static bool sized[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!sized[*dev]) {
    err = cudaFuncSetAttribute(fused_ce_bwd_mma_kernel<kDw, kHV, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, CeShape<BM>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized[*dev] = true;
  }
  cfg = {};
  cfg.gridDim = dim3(cluster * clusters, 1, 1);
  cfg.blockDim = dim3(CeShape<BM>::kThreads, 1, 1);
  cfg.dynamicSmemBytes = CeShape<BM>::kBytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return 0;
}

// how many clusters of `cluster` blocks the card holds at once, or minus a
// cudaError_t
template <bool kDw, bool kHV, int BM>
int resident_clusters(int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int dev = 0, n = 0;
  const int err = configure<kDw, kHV, BM>(cfg, attr, cluster, 1, nullptr, &dev);
  if (err) return -err;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, fused_ce_bwd_mma_kernel<kDw, kHV, BM>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <bool kDw, bool kHV, int BM>
int launch_mma(const void* h, const void* w, const void* targets, const void* lse,
               const void* g, void* out, void* ws, int t, int hd, int v, int offset, int valid,
               int cluster, int splits, cudaStream_t stream) {
  auto kernel = fused_ce_bwd_mma_kernel<kDw, kHV, BM>;
  static bool resident[kMaxDevices][4] = {};   // by log2 of the cluster size
  const int rows = kDw ? v : t;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int dev = 0;
  int e = configure<kDw, kHV, BM>(cfg, attr, cluster, (rows + BM - 1) / BM, stream, &dev);
  if (e) return e;
  cfg.gridDim.y = splits;
  const int lg = cluster == 1 ? 0 : cluster == 2 ? 1 : cluster == 4 ? 2 : 3;
  if (!resident[dev][lg]) {
    const int n = resident_clusters<kDw, kHV, BM>(cluster);
    if (n < 0) return -n;
    if (n < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    resident[dev][lg] = true;
  }
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint16_t*>(h), static_cast<const uint16_t*>(w),
      static_cast<const int*>(targets), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<uint16_t*>(out), static_cast<float*>(ws), t, hd,
      v, offset, valid, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const int64_t n4 = static_cast<int64_t>(rows) * hd / 4;
    const int blocks = static_cast<int>(n4 / 256 + 1 < 1056 ? n4 / 256 + 1 : 1056);
    fused_ce_split_combine<<<blocks, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                       static_cast<uint16_t*>(out), n4, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kDw>
int dispatch_mma(const void* h, const void* w, const void* targets, const void* lse,
                 const void* g, void* out, void* ws, int t, int hd, int v, int offset,
                 int valid, int vh, int bm, int cluster, int splits, cudaStream_t stream) {
  const int bn = bm / 2, n_s = kDw ? t : v;
  if (t < 1 || v < 1 || hd < 16 || hd % 16 || (bm != 64 && bm != 128) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      static_cast<long long>(cluster) * (32768 / bm) < hd || splits < 1 ||
      splits > (n_s + bn - 1) / bn || (splits > 1 && (kDw || ws == nullptr ||
                                                      reinterpret_cast<uintptr_t>(ws) % 16 ||
                                                      reinterpret_cast<uintptr_t>(out) % 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vh)
    return bm == 128 ? launch_mma<kDw, false, 128>(h, w, targets, lse, g, out, ws, t, hd, v,
                                                   offset, valid, cluster, splits, stream)
                     : launch_mma<kDw, false, 64>(h, w, targets, lse, g, out, ws, t, hd, v,
                                                  offset, valid, cluster, splits, stream);
  return bm == 128 ? launch_mma<kDw, true, 128>(h, w, targets, lse, g, out, ws, t, hd, v,
                                                offset, valid, cluster, splits, stream)
                   : launch_mma<kDw, true, 64>(h, w, targets, lse, g, out, ws, t, hd, v, offset,
                                               valid, cluster, splits, stream);
}

}  // namespace

// Entry points: bf16 h (T, H), w (V, H) with vh = 1 or (H, V) with vh = 0,
// int32 targets, float32 lse and g (T,), the bf16 output (dh: T x H; dw: w's
// shape), and ws, float32 scratch of splits x T x H (dh with splits > 1;
// else unused, may be null); valid >= 2^31 - 1 masks nothing; bm (128 or
// 64), cluster (1, 2, 4 or 8, with cluster x 32768 / bm >= H) and splits
// (of the streamed rows, dh only) from the wrapper's plan. Each returns the
// launches' cudaError_t: 0 when the kernels were queued on `stream`.
extern "C" int fused_ce_dh_mma(const void* h, const void* w, const void* targets,
                               const void* lse, const void* g, void* out, void* ws, int t,
                               int hd, int v, int offset, int valid, int vh, int bm, int cluster,
                               int splits, void* stream) {
  return dispatch_mma<false>(h, w, targets, lse, g, out, ws, t, hd, v, offset, valid, vh, bm,
                             cluster, splits, static_cast<cudaStream_t>(stream));
}

// How many clusters of `cluster` blocks of the dh (dw = 0) or dw (dw = 1)
// kernel for the layout vh and bm fit on the current card at once (0: none
// fits), or minus a cudaError_t.
extern "C" int fused_ce_mma_resident_clusters(int dw, int vh, int bm, int cluster) {
  if ((bm != 64 && bm != 128) || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (bm == 128)
    return dw ? (vh ? resident_clusters<true, false, 128>(cluster)
                    : resident_clusters<true, true, 128>(cluster))
              : (vh ? resident_clusters<false, false, 128>(cluster)
                    : resident_clusters<false, true, 128>(cluster));
  return dw ? (vh ? resident_clusters<true, false, 64>(cluster)
                  : resident_clusters<true, true, 64>(cluster))
            : (vh ? resident_clusters<false, false, 64>(cluster)
                  : resident_clusters<false, true, 64>(cluster));
}

extern "C" int fused_ce_dw_mma(const void* h, const void* w, const void* targets,
                               const void* lse, const void* g, void* out, void* ws, int t,
                               int hd, int v, int offset, int valid, int vh, int bm, int cluster,
                               int splits, void* stream) {
  return dispatch_mma<true>(h, w, targets, lse, g, out, ws, t, hd, v, offset, valid, vh, bm,
                            cluster, splits, static_cast<cudaStream_t>(stream));
}
