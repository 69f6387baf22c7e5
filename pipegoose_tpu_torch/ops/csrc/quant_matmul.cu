// Dequant-fused matmuls for Hopper (sm_90a): y = x @ dequantize(q, scale)
// with the weights kept as int8 in device memory.
//
// Replaces the two Pallas TPU kernels of pipegoose_tpu/quant/matmul.py and
// computes what each computes, in its scaling order:
// - B10, _matmul_int8_pallas (:94, pallas_call :111): q (K, N) int8 with a
//   per-out-channel scale (N,): y[t, n] = (sum_k x[t, k] * q[k, n]) *
//   scale[n], the scale applied once per output element, after the sum;
// - B11, _matmul_int4_pallas (:132, pallas_call :153): q (K/2, N) int8
//   holding two nibbles a byte along K (row 2i the low nibble, row 2i + 1
//   the high one, sign-extended) with a grouped scale (K/G, N): y[t, n] =
//   sum_k x[t, k] * (q4[k, n] * scale[k / G, n]).
// x (T, K) is float32 or bf16 and y (T, N) float32, as in JAX. Two routes,
// chosen by the wrapper (quant/matmul.py kernel_route), never one as a
// fallback for the other:
//
// 1. The tensor-core route, quant_mma_int8 / quant_mma_int4, for bf16 x with
//    K % 16 == 0 (and G % 16 == 0 for int4): the serving path. A bf16 x times
//    an int8 or int4 value is exact in float32, so bf16 mma.sync.m16n8k16
//    with float32 accumulators forms the same products as float32 FMAs; only
//    the order of the sums differs, and for int4 the scale multiplies each
//    group's sum of 16-32 products instead of each weight.
//    - Operands swapped: the weight's N is the MMA's M and the tokens are its
//      N (8, 16, 32 or 64 a block, zero-padded past T). Each warp owns one
//      m16 tile, 16 columns, with every token tile and every k step of the
//      block: four warps (64 columns) for up to 16 tokens, eight (128) above.
//      Its M rows are permuted so that lane (g, tig) holds columns 2g and
//      2g + 1 and reads them as one 2-byte word per q row from shared
//      memory, with row pitches padded so that a warp's reads fall on
//      distinct banks.
//    - A four-deep cp.async ring stages 128 k a stage: q rows as 16-byte
//      copies along N (q's contiguous axis), x rows as bf16 (read by
//      ldmatrix), and for int4 the group rows of scale the stage touches.
//    - Conversion in registers, exact: int8 bytes become floats under the
//      exponent of 2^23 (__byte_perm, one subtraction) whose upper halves are
//      the bf16 values; an int4 byte becomes bf16x2 {128 + lo, 128 + hi} by
//      one __byte_perm and one mask, and one bf16x2 FMA removes the biases.
//    - Every two k16 steps (every group for G % 32 != 0) the MMA fragment is
//      folded into float32 accumulators: acc += part (int8) or acc =
//      fma(scale[g, n], part, acc) (int4), so the tensor cores' own
//      accumulation never runs longer than 32 products and an int4 scale is
//      never rounded to bf16.
//    - K is split where the (column, token) tiles alone leave SMs idle, into
//      at most 8 splits: the blocks of one tile's splits are one thread-block
//      cluster. Each leaves its sums in shared memory; after a cluster
//      barrier each block finishes a slice of the tile, adding the splits'
//      sums in split order over distributed shared memory. Results repeat
//      bit for bit, and no second kernel, workspace or memset runs. The
//      same epilogue applies the int8 scale and, for a bf16 y, the cast and
//      the bias: bf16(bf16(y) + bias), rounded to nearest even twice,
//      exactly as y.to(bf16) + bias.
// 2. The float32 route, quant_matmul_{int8,int4}_{f32,bf16} (the first design):
//    float32 x, whose rounding to bf16 would change the function, and any x
//    the tensor-core route does not take. Every product is a float32 FMA on
//    the CUDA cores; y is float32, and with a split of K a second kernel
//    adds the splits.
//
// What bounds them on the card: at the decode shape (T = 8 tokens, K x N of
// 1-4 M weights) each weight byte feeds 2 T = 16 operations, far under the
// ~295 bf16 operations per byte at which the H100's tensor cores, not its
// 3.35 TB/s of device memory, become the limit: the tensor-core route is
// bound by the bytes of q it reads (1-4 MB, 0.3-1.2 us) and, at these sizes,
// by launch and memory latency. At the prefill shapes (T = 128-512) it sits
// far from both bounds: each warp re-reads the staged x tile for its 16
// columns (about 147 KB of shared-memory reads a 128-k stage at 64 tokens,
// as much time as its MMAs), and each stage is one dependent chain of
// copies, conversions and MMAs; wider warp tiles or wgmma are the next step.
// The float32 route is bound by its float32 FMAs at every T >= 8.
//
// Float32-route design (simple first):
// - one block of 256 threads per (256 output columns, K split, 8-token
//   tile): 16 lanes along N with 16 columns (16 bytes of q) each, 16 lanes
//   along K taking every 16th row of the block's K range;
// - x is staged in shared memory as float32, 256 q rows at a time;
// - a byte becomes a float exactly and without an int-to-float convert:
//   __byte_perm places the biased byte (q + 128, or nibble + 8) under the
//   exponent of 2^23, and one subtraction removes the bias;
// - the 16 K lanes' partial sums are combined in shared memory in lane
//   order, and with more than one K split a second kernel adds the splits'
//   partial sums in split order: no atomics, so float32 results repeat bit
//   for bit from run to run.
// Any T >= 1 and any N are masked at the edge on both routes; N % 16 != 0,
// or a q or scale pointer not 16-byte aligned, takes byte (and float) loads
// instead of 16-byte ones.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;                    // columns (bytes of q) per thread
constexpr int kNLanes = 16;                  // threads along N
constexpr int kKLanes = kThreads / kNLanes;  // threads along K
constexpr int kBlockN = kNLanes * kCols;     // 256 columns per block
constexpr int kStageUnits = 256;             // q rows per staged x tile
constexpr int kBatch = 4;                    // q rows loaded before use
constexpr float kInt8Bias = 8388736.0f;      // 2^23 + 128
constexpr float kInt4Bias = 8388616.0f;      // 2^23 + 8
static_assert(kThreads == kBlockN, "the reduction gives each thread one column");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Byte i of `biased` (a value in [0, 255]) as the float 2^23 + value.
__device__ __forceinline__ float magic(uint32_t biased, uint32_t i) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | i));
}

// 16 bytes of one q row from column n0, zero past column N.
__device__ __forceinline__ uint4 load_row(const int8_t* __restrict__ row,
                                          int n0, int N, bool vec) {
  if (vec && n0 + kCols <= N) return __ldg(reinterpret_cast<const uint4*>(row + n0));
  uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (n0 + j < N)
      b[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[n0 + j])) << (8 * (j % 4));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// 16 scales of one group row from column n0, zero past column N.
__device__ __forceinline__ void load_scales(const float* __restrict__ row, int n0,
                                            int N, bool vec, float (&s)[kCols]) {
  if (vec && n0 + kCols <= N) {
#pragma unroll
    for (int j = 0; j < kCols; j += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + n0 + j));
      s[j] = v.x; s[j + 1] = v.y; s[j + 2] = v.z; s[j + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) s[j] = n0 + j < N ? row[n0 + j] : 0.0f;
}

template <int TT>
__device__ __forceinline__ void fma_int8(float (&acc)[TT][kCols], const uint4& w,
                                         const float (&xv)[TT]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int wi = 0; wi < 4; ++wi) {
    const uint32_t b = words[wi] ^ 0x80808080u;  // each byte q + 128
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = magic(b, i) - kInt8Bias;
#pragma unroll
      for (int t = 0; t < TT; ++t)
        acc[t][wi * 4 + i] = fmaf(xv[t], v, acc[t][wi * 4 + i]);
    }
  }
}

template <int TT>
__device__ __forceinline__ void fma_int4(float (&acc)[TT][kCols], const uint4& w,
                                         const float (&s)[kCols], const float (&xl)[TT],
                                         const float (&xh)[TT]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int wi = 0; wi < 4; ++wi) {
    const uint32_t b = words[wi] ^ 0x88888888u;  // each nibble q4 + 8
    const uint32_t lo = b & 0x0F0F0F0Fu;         // rows 2u
    const uint32_t hi = (b >> 4) & 0x0F0F0F0Fu;  // rows 2u + 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = wi * 4 + i;
      const float wl = (magic(lo, i) - kInt4Bias) * s[j];
      const float wh = (magic(hi, i) - kInt4Bias) * s[j];
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        acc[t][j] = fmaf(xl[t], wl, acc[t][j]);
        acc[t][j] = fmaf(xh[t], wh, acc[t][j]);
      }
    }
  }
}

// One q row (unit s0 + r) into the accumulators, with its x values from
// the staged tile.
template <bool kInt4, int TT, int kStageRows>
__device__ __forceinline__ void consume(float (&acc)[TT][kCols], const uint4& w,
                                        const float (*xs)[kStageRows], int r, int s0,
                                        const float* __restrict__ scale, int n0, int N,
                                        int G, bool vec) {
  if constexpr (kInt4) {
    float s[kCols];
    const int group = (2 * (s0 + r)) / G;
    load_scales(scale + static_cast<size_t>(group) * N, n0, N, vec, s);
    float xl[TT], xh[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      xl[t] = xs[t][2 * r];
      xh[t] = xs[t][2 * r + 1];
    }
    fma_int4<TT>(acc, w, s, xl, xh);
  } else {
    float xv[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) xv[t] = xs[t][r];
    fma_int8<TT>(acc, w, xv);
  }
}

// A "unit" is one q row: one row of K for int8, two (a packed row) for
// int4. The block covers units [split * per, min(U, (split + 1) * per)).
// `out` is y (T, N) with one split, else the splits' partial sums (splits,
// T, N), which quant_matmul_combine adds.
template <typename XT, bool kInt4, int TT>
__global__ void __launch_bounds__(kThreads, 1)
quant_matmul_kernel(const XT* __restrict__ x,         // (T, K)
                    const int8_t* __restrict__ q,     // (K, N) | (K/2, N)
                    const float* __restrict__ scale,  // (N,) | (K/G, N)
                    float* __restrict__ out, int T, int K, int N, int G,
                    int splits, int per, bool vec) {
  constexpr int R = kInt4 ? 2 : 1;
  constexpr int kStageRows = kStageUnits * R;
  __shared__ float xs[TT][kStageRows];
  __shared__ float red[kKLanes][kBlockN];

  const int tid = threadIdx.x;
  const int nx = tid % kNLanes;
  const int ky = tid / kNLanes;
  const int n_block = blockIdx.x * kBlockN;
  const int n0 = n_block + nx * kCols;
  const int split = blockIdx.y;
  const int t0 = blockIdx.z * TT;
  const int u_begin = split * per;
  const int u_end = min(K / R, u_begin + per);

  float acc[TT][kCols];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[t][j] = 0.0f;

  for (int s0 = u_begin; s0 < u_end; s0 += kStageUnits) {
    const int units = min(kStageUnits, u_end - s0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < TT * kStageRows; i += kThreads) {
      const int t = i / kStageRows;
      const int kk = i % kStageRows;
      float v = 0.0f;
      if (t0 + t < T && kk < units * R)
        v = to_f32(x[static_cast<size_t>(t0 + t) * K + static_cast<size_t>(s0) * R + kk]);
      xs[t][kk] = v;
    }
    __syncthreads();

    int r = ky;
    for (; r + (kBatch - 1) * kKLanes < units; r += kBatch * kKLanes) {
      uint4 w[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        w[b] = load_row(q + static_cast<size_t>(s0 + r + b * kKLanes) * N, n0, N, vec);
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        consume<kInt4, TT, kStageRows>(acc, w[b], xs, r + b * kKLanes, s0, scale, n0, N, G, vec);
    }
    for (; r < units; r += kKLanes)
      consume<kInt4, TT, kStageRows>(acc, load_row(q + static_cast<size_t>(s0 + r) * N, n0, N, vec),
                                     xs, r, s0, scale, n0, N, G, vec);
  }

  // the K lanes' partial sums, added in lane order: one column per thread
  const int n = n_block + tid;
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[ky][nx * kCols + j] = acc[t][j];
    __syncthreads();
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kKLanes; ++k) sum += red[k][tid];
    if (t0 + t < T && n < N) {
      if (splits == 1)
        out[static_cast<size_t>(t0 + t) * N + n] = kInt4 ? sum : sum * scale[n];
      else
        out[(static_cast<size_t>(split) * T + t0 + t) * N + n] = sum;
    }
  }
}

// y[t, n] = (sum over splits, in split order, of ws[split, t, n]), times
// scale[n] for int8.
template <bool kScaleOut>
__global__ void __launch_bounds__(256)
quant_matmul_combine(const float* __restrict__ ws, const float* __restrict__ scale,
                     float* __restrict__ y, int T, int N, int splits) {
  const size_t total = static_cast<size_t>(T) * N;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float sum = 0.0f;
    for (int k = 0; k < splits; ++k) sum += ws[k * total + i];
    y[i] = kScaleOut ? sum * scale[i % N] : sum;
  }
}

template <typename XT, bool kInt4, int TT>
int launch(const XT* x, const int8_t* q, const float* scale, float* ws, float* y,
           int T, int K, int N, int G, int splits, int per, cudaStream_t stream) {
  const bool vec = N % kCols == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  const dim3 grid((N + kBlockN - 1) / kBlockN, splits, (T + TT - 1) / TT);
  quant_matmul_kernel<XT, kInt4, TT><<<grid, kThreads, 0, stream>>>(
      x, q, scale, splits > 1 ? ws : y, T, K, N, G, splits, per, vec);
  if (splits > 1) {
    const size_t total = static_cast<size_t>(T) * N;
    const size_t want = (total + 255) / 256;
    const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
    quant_matmul_combine<!kInt4><<<blocks, 256, 0, stream>>>(ws, scale, y, T, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, bool kInt4>
int dispatch(const void* x, const void* q, const void* scale, void* ws, void* y, int T,
             int K, int N, int G, int splits, int per, cudaStream_t stream) {
  constexpr int R = kInt4 ? 2 : 1;
  if (T < 1 || K < R || N < 1 || K % R || splits < 1 || per < 1 ||
      static_cast<long long>(splits) * per < K / R || (splits > 1 && ws == nullptr) ||
      (kInt4 && (G < 2 || G % 2 || K % G)))
    return static_cast<int>(cudaErrorInvalidValue);
  const XT* xp = static_cast<const XT*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* wp = static_cast<float*>(ws);
  float* yp = static_cast<float*>(y);
  // tokens per block: a power of two up to 8 (token_tile in quant/matmul.py)
  if (T >= 8) return launch<XT, kInt4, 8>(xp, qp, sp, wp, yp, T, K, N, G, splits, per, stream);
  if (T > 2) return launch<XT, kInt4, 4>(xp, qp, sp, wp, yp, T, K, N, G, splits, per, stream);
  if (T == 2) return launch<XT, kInt4, 2>(xp, qp, sp, wp, yp, T, K, N, G, splits, per, stream);
  return launch<XT, kInt4, 1>(xp, qp, sp, wp, yp, T, K, N, G, splits, per, stream);
}

// ---------------------------------------------------------------------------
// The tensor-core route: bf16 x, mma.sync.m16n8k16 with float32 accumulators
// ---------------------------------------------------------------------------

constexpr int kMmaBK = 128;                  // k a stage: eight k16 steps
constexpr int kMmaStages = 4;                // cp.async ring depth
constexpr int kXPitch = kMmaBK + 8;          // bf16 a staged x row: 272 bytes, ldmatrix rows on distinct banks
constexpr int kScaleRows = kMmaBK / 16 + 1;  // int4 group rows one stage can touch (G >= 16)
constexpr int kMaxSplits = 8;                // a K split is one cluster of blocks, at most the portable size

// A block of kWarps warps, each one m16 tile: 16 output columns, all the
// block's 8 NT tokens and every k16 step of each stage.
template <int NT>
struct MmaShape {
  static constexpr int kWarps = NT <= 2 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBN = 16 * kWarps;   // output columns a block
  static constexpr int kTT = 8 * NT;        // tokens a block
};

// Byte offsets inside one ring slot, and the dynamic shared memory a block
// takes: the ring, or after the k loop its (token, column) tile of sums.
template <bool kInt4, int NT>
struct Smem {
  using M = MmaShape<NT>;
  static constexpr int kQRows = kInt4 ? kMmaBK / 2 : kMmaBK;  // q rows a stage
  // bytes a staged q row: the block's columns and 16 more, so that the four
  // q rows a warp reads at once (2 tig apart for int8, tig apart for int4)
  // start 32 or 16 bytes apart modulo the 128 bytes of the banks
  static constexpr int kQPitch = M::kBN + 16;
  static constexpr int kX = kQRows * kQPitch;
  static constexpr int kS = kX + M::kTT * kXPitch * 2;
  static constexpr int kStage = kS + (kInt4 ? kScaleRows * M::kBN * 4 : 0);
  static constexpr int kRing = kMmaStages * kStage;
  static constexpr int kRedPitch = M::kBN + 4;   // floats a row of the tile of sums
  static constexpr int kRed = M::kTT * kRedPitch * 4;
  static constexpr int kBytes = kRing > kRed ? kRing : kRed;
};

// -- PTX wrappers --
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kN (2 or 4) 8x8 b16 matrices: lane l gives the address of row l % 8 of
// matrix l / 8, and gets word l % 4 of row l / 4 of each matrix.
template <int kN>
__device__ __forceinline__ void ldmatrix(uint32_t (&r)[kN], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if constexpr (kN == 4)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
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

// a * b + c on two bf16 lanes, rounded once
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
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

// bf16x2 {q[k], q[k + 1]} of column byte j, from the words of rows k and
// k + 1 with every byte biased to q + 128: each byte goes under the exponent
// of 2^23, a subtraction removes the bias, and the upper halves of the two
// exact floats are their bf16 values (|q| <= 128 needs 8 significant bits).
__device__ __forceinline__ uint32_t int8_pair(uint32_t row_k, uint32_t row_k1, uint32_t j) {
  const float lo = __uint_as_float(__byte_perm(row_k, 0x4B000000u, 0x7440u | j)) - kInt8Bias;
  const float hi = __uint_as_float(__byte_perm(row_k1, 0x4B000000u, 0x7440u | j)) - kInt8Bias;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// bf16x2 {q4[k], q4[k + 1]} of column byte j of a packed row whose nibbles
// are biased to q4 + 8 (`hi` is the same word shifted right by 4, so its
// byte j holds byte j's high nibble low): both nibbles under 0x43 are
// 128 + nibble in bf16, and one bf16x2 FMA by {1, 1} plus {-136, -136}
// gives both values exactly.
__device__ __forceinline__ uint32_t int4_pair(uint32_t lo, uint32_t hi, uint32_t j) {
  const uint32_t t = (__byte_perm(lo, hi, j | ((j + 4) << 8)) & 0x000F000Fu) | 0x43004300u;
  return fma_bf16x2(t, 0x3F803F80u, 0xC308C308u);
}

// The A operand of the warp's m16 tile at stage-local k step kk: tile row g
// is the column at byte `col` = 16 warp + 2 g and row g + 8 the next one, so
// lane (g, tig) reads both columns as one 2-byte word per q row.
template <bool kInt4, int NT>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* qs, int kk, int col,
                                       int tig) {
  constexpr int P = Smem<kInt4, NT>::kQPitch;
  if constexpr (kInt4) {
    const uint8_t* p = qs + (kk / 2 + tig) * P + col;      // packed rows: k, k + 1
    const uint32_t w0 = *reinterpret_cast<const uint16_t*>(p) ^ 0x8888u;
    const uint32_t w4 = *reinterpret_cast<const uint16_t*>(p + 4 * P) ^ 0x8888u;  // k + 8, k + 9
    a[0] = int4_pair(w0, w0 >> 4, 0);
    a[1] = int4_pair(w0, w0 >> 4, 1);
    a[2] = int4_pair(w4, w4 >> 4, 0);
    a[3] = int4_pair(w4, w4 >> 4, 1);
  } else {
    const uint8_t* p = qs + (kk + 2 * tig) * P + col;
    const uint32_t r0 = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
    const uint32_t r1 = *reinterpret_cast<const uint16_t*>(p + P) ^ 0x8080u;
    const uint32_t r8 = *reinterpret_cast<const uint16_t*>(p + 8 * P) ^ 0x8080u;
    const uint32_t r9 = *reinterpret_cast<const uint16_t*>(p + 9 * P) ^ 0x8080u;
    a[0] = int8_pair(r0, r1, 0);
    a[1] = int8_pair(r0, r1, 1);
    a[2] = int8_pair(r8, r9, 0);
    a[3] = int8_pair(r8, r9, 1);
  }
}

// The B operand of the NT token tiles at stage-local k step kk: the staged x
// rows are tokens with k contiguous, ldmatrix's non-transposed layout.
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2], const __nv_bfloat16* xs, int kk,
                                       int lane) {
  const int r = lane & 7, m = (lane >> 3) & 3;
  if constexpr (NT == 1) {
    uint32_t v[2];
    ldmatrix<2>(v, xs + r * kXPitch + kk + (m & 1) * 8);
    b[0][0] = v[0];
    b[0][1] = v[1];
  } else {
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t v[4];
      ldmatrix<4>(v, xs + ((2 * p + (m >> 1)) * 8 + r) * kXPitch + kk + (m & 1) * 8);
      b[2 * p][0] = v[0];
      b[2 * p][1] = v[1];
      b[2 * p + 1][0] = v[2];
      b[2 * p + 1][1] = v[3];
    }
  }
}

// Queue the block's operands for k in [kb, ke) into one ring slot: q rows
// (packed rows for int4), x rows t0 .. t0 + 8 NT - 1 and, for int4, the
// group rows of scale the stage touches. Copies past T, N or ke are zero
// filled. Without `vec` (N % 16 != 0, or q or scale not 16-byte aligned) q
// and scale are copied a byte or a float at a time.
template <bool kInt4, int NT>
__device__ __forceinline__ void load_stage(uint8_t* slot, const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ q,
                                           const float* __restrict__ scale, int T, int K, int N,
                                           int G, int t0, int n0, int kb, int ke, bool vec,
                                           int tid) {
  using M = MmaShape<NT>;
  using S = Smem<kInt4, NT>;
  constexpr int R = kInt4 ? 2 : 1;
  constexpr int BN = M::kBN;
  const int row0 = kb / R;
  const int rows = (ke - kb) / R;
  if (vec) {
    for (int c = tid; c < S::kQRows * (BN / 16); c += M::kThreads) {
      const int r = c / (BN / 16), j = c % (BN / 16);
      const bool ok = r < rows && n0 + 16 * j < N;
      cp_async16(slot + r * S::kQPitch + 16 * j,
                 ok ? q + static_cast<size_t>(row0 + r) * N + n0 + 16 * j : q, ok);
    }
  } else {
    for (int c = tid; c < S::kQRows * BN; c += M::kThreads) {
      const int r = c / BN, j = c % BN;
      slot[r * S::kQPitch + j] =
          r < rows && n0 + j < N ? static_cast<uint8_t>(q[static_cast<size_t>(row0 + r) * N + n0 + j])
                                 : 0;
    }
  }
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(slot + S::kX);
  for (int c = tid; c < M::kTT * (kMmaBK / 8); c += M::kThreads) {
    const int t = c / (kMmaBK / 8), j = c % (kMmaBK / 8);
    const bool ok = t0 + t < T && kb + 8 * j < ke;
    cp_async16(xs + t * kXPitch + 8 * j,
               ok ? x + static_cast<size_t>(t0 + t) * K + kb + 8 * j : x, ok);
  }
  if constexpr (kInt4) {
    float* ss = reinterpret_cast<float*>(slot + S::kS);
    const int g0 = kb / G;
    const int groups = (ke - 1) / G - g0 + 1;
    if (vec) {
      for (int c = tid; c < kScaleRows * (BN / 4); c += M::kThreads) {
        const int r = c / (BN / 4), j = c % (BN / 4);
        const bool ok = r < groups && n0 + 4 * j < N;
        cp_async16(ss + r * BN + 4 * j,
                   ok ? scale + static_cast<size_t>(g0 + r) * N + n0 + 4 * j : scale, ok);
      }
    } else {
      for (int c = tid; c < kScaleRows * BN; c += M::kThreads) {
        const int r = c / BN, j = c % BN;
        ss[r * BN + j] =
            r < groups && n0 + j < N ? scale[static_cast<size_t>(g0 + r) * N + n0 + j] : 0.0f;
      }
    }
  }
}

// acc += part (int8), or acc += scale[group, column] * part (int4), the
// scales of the lane's two columns from the slot's row of the group.
template <bool kInt4, int NT>
__device__ __forceinline__ void fold(float (&acc)[NT][4], const float (&part)[NT][4],
                                     const float* scale_row, int col) {
  if constexpr (kInt4) {
    const float2 s = *reinterpret_cast<const float2*>(scale_row + col);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] = fmaf(s.x, part[nt][0], acc[nt][0]);
      acc[nt][1] = fmaf(s.x, part[nt][1], acc[nt][1]);
      acc[nt][2] = fmaf(s.y, part[nt][2], acc[nt][2]);
      acc[nt][3] = fmaf(s.y, part[nt][3], acc[nt][3]);
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += part[nt][e];
  }
}

// The warp's eight k16 steps of the stage at kb held in `slot`: each one
// MMA per token tile into a fresh fragment that is folded into acc after
// every two steps, or after each step when an int4 group can end between
// them (G % 32 != 0). Steps past the end of K run on the zero-filled tail of
// the slot and add exact zeros.
template <bool kInt4, int NT>
__device__ __forceinline__ void compute_stage(float (&acc)[NT][4], const uint8_t* slot, int kb,
                                              int G, int col, int lane) {
  using S = Smem<kInt4, NT>;
  const int tig = lane & 3;
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(slot + S::kX);
  const float* ss = reinterpret_cast<const float*>(slot + S::kS);
  const bool fold_each = kInt4 && G % 32 != 0;
  float part[NT][4];
#pragma unroll
  for (int step = 0; step < kMmaBK / 16; ++step) {
    const int kk = 16 * step;
    if (step % 2 == 0 || fold_each) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nt][e] = 0.0f;
    }
    uint32_t b[NT][2];
    load_b<NT>(b, xs, kk, lane);
    uint32_t a[4];
    load_a<kInt4, NT>(a, slot, kk, col, tig);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(part[nt], a, b[nt][0], b[nt][1]);
    if (fold_each || step % 2 == 1) {
      const int row = kInt4 ? (kb + kk) / G - kb / G : 0;
      fold<kInt4, NT>(acc, part, ss + row * MmaShape<NT>::kBN, col);
    }
  }
}

// The epilogue of one output: the int8 scale, then for a bf16 y the cast
// and the bias, each rounded to nearest even as y.to(bf16) + bias rounds.
template <bool kInt4>
__device__ __forceinline__ void store_y(void* y, size_t idx, int n, float v,
                                        const float* __restrict__ scale,
                                        const __nv_bfloat16* __restrict__ bias, int out_bf16) {
  if constexpr (!kInt4) v *= scale[n];
  if (!out_bf16) {
    static_cast<float*>(y)[idx] = v;
    return;
  }
  __nv_bfloat16 r = __float2bfloat16_rn(v);
  if (bias != nullptr) r = __float2bfloat16_rn(__bfloat162float(r) + __bfloat162float(bias[n]));
  static_cast<__nv_bfloat16*>(y)[idx] = r;
}

// One block per (kBN columns, 8 NT tokens, K split): k in [split * per,
// min(K, (split + 1) * per)). The blocks of one (column, token) tile form a
// cluster along the splits: each leaves its sums in its shared memory, and
// each then finishes a slice of the tile, adding the splits' sums in split
// (cluster rank) order from the cluster's shared memory.
template <bool kInt4, int NT>
__global__ void __launch_bounds__(MmaShape<NT>::kThreads)
quant_mma_kernel(const __nv_bfloat16* __restrict__ x,     // (T, K)
                 const int8_t* __restrict__ q,            // (K, N) | (K/2, N)
                 const float* __restrict__ scale,         // (N,) | (K/G, N)
                 const __nv_bfloat16* __restrict__ bias,  // (N,) or null
                 void* __restrict__ y,                    // (T, N) float32 or bf16
                 int T, int K, int N, int G, int per, int out_bf16, int vec) {
  using M = MmaShape<NT>;
  using S = Smem<kInt4, NT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int col = 16 * warp + 2 * g;   // the lane's two columns in the block
  const int n0 = blockIdx.x * M::kBN, t0 = blockIdx.y * M::kTT;
  const int split = blockIdx.z, splits = gridDim.z;
  const int k0 = split * per, k1 = min(K, k0 + per);
  const int stages = (k1 - k0 + kMmaBK - 1) / kMmaBK;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < stages)
      load_stage<kInt4, NT>(smem + s * S::kStage, x, q, scale, T, K, N, G, t0, n0,
                            k0 + s * kMmaBK, min(k1, k0 + (s + 1) * kMmaBK), vec, tid);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();   // stage s has landed, and slot (s - 1) % kMmaStages is free
    const int next = s + kMmaStages - 1;
    if (next < stages)
      load_stage<kInt4, NT>(smem + (next % kMmaStages) * S::kStage, x, q, scale, T, K, N, G, t0,
                            n0, k0 + next * kMmaBK, min(k1, k0 + (next + 1) * kMmaBK), vec, tid);
    cp_async_commit();
    const int kb = k0 + s * kMmaBK;
    compute_stage<kInt4, NT>(acc, smem + (s % kMmaStages) * S::kStage, kb, G, col, lane);
  }
  cp_async_wait<0>();
  __syncthreads();

  // this split's sums for the tile, left in shared memory
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(nt * 8 + 2 * tig + (e & 1)) * S::kRedPitch + col + (e >> 1)] = acc[nt][e];
  if (splits > 1)
    cluster_sync();
  else
    __syncthreads();

  // this block's slice of the tile: the splits' sums in split order
  constexpr int E = M::kTT * M::kBN;
  const int lo = split * E / splits, hi = (split + 1) * E / splits;
  for (int e = lo + tid; e < hi; e += M::kThreads) {
    const int t = e / M::kBN, c = e % M::kBN;
    if (t0 + t >= T || n0 + c >= N) continue;
    const int at = t * S::kRedPitch + c;
    float v;
    if (splits == 1) {
      v = red[at];
    } else {
      float p[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) p[r] = r < splits ? cluster_smem(red, r)[at] : 0.0f;
      v = p[0];
#pragma unroll
      for (int r = 1; r < kMaxSplits; ++r)
        if (r < splits) v += p[r];
    }
    store_y<kInt4>(y, static_cast<size_t>(t0 + t) * N + n0 + c, n0 + c, v, scale, bias,
                   out_bf16);
  }
  if (splits > 1) cluster_sync();   // every block's sums stay until the last slice is read
}

template <bool kInt4, int NT>
int launch_mma(const void* x, const void* q, const void* scale, const void* bias, void* y,
               int T, int K, int N, int G, int splits, int per, int out_bf16,
               cudaStream_t stream) {
  using M = MmaShape<NT>;
  using S = Smem<kInt4, NT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool sized[64] = {};   // the shared-memory limit raised, per device
  if (dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(quant_mma_kernel<kInt4, NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) sized[dev] = true;
  }
  const int vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + M::kBN - 1) / M::kBN, (T + M::kTT - 1) / M::kTT, splits);
  cfg.blockDim = dim3(M::kThreads, 1, 1);
  cfg.dynamicSmemBytes = S::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, quant_mma_kernel<kInt4, NT>,
                           static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
                           static_cast<const float*>(scale),
                           static_cast<const __nv_bfloat16*>(bias), y, T, K, N, G, per,
                           out_bf16, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInt4>
int dispatch_mma(const void* x, const void* q, const void* scale, const void* bias, void* y,
                 int T, int K, int N, int G, int splits, int per, int out_bf16,
                 cudaStream_t stream) {
  if (T < 1 || N < 1 || K < 16 || K % 16 || splits < 1 || splits > kMaxSplits || per < 1 ||
      static_cast<long long>(splits) * per < K ||
      static_cast<long long>(splits - 1) * per >= K || (splits > 1 && per % kMmaBK) ||
      reinterpret_cast<uintptr_t>(x) % 16 || (bias != nullptr && !out_bf16) ||
      (kInt4 && (G < 16 || G % 16 || K % G)))
    return static_cast<int>(cudaErrorInvalidValue);
  // token tile: 8, 16, 32 or 64 (mma_token_tile in quant/matmul.py)
  if (T <= 8)
    return launch_mma<kInt4, 1>(x, q, scale, bias, y, T, K, N, G, splits, per, out_bf16, stream);
  if (T <= 16)
    return launch_mma<kInt4, 2>(x, q, scale, bias, y, T, K, N, G, splits, per, out_bf16, stream);
  if (T <= 32)
    return launch_mma<kInt4, 4>(x, q, scale, bias, y, T, K, N, G, splits, per, out_bf16, stream);
  return launch_mma<kInt4, 8>(x, q, scale, bias, y, T, K, N, G, splits, per, out_bf16, stream);
}

}  // namespace

// One entry point per (weight format, x dtype), all with the same
// arguments: x (T, K), q, scale, the split workspace (splits, T, N) float32
// (null with one split), y (T, N) float32; G is the int4 group (ignored for
// int8); `per` the q rows of one K split. Returns the launches'
// cudaError_t: 0 when the kernels were queued on `stream`.
#define QUANT_MATMUL_ENTRY(NAME, XT, INT4)                                          \
  extern "C" int NAME(const void* x, const void* q, const void* scale, void* ws,    \
                      void* y, int T, int K, int N, int G, int splits, int per,     \
                      void* stream) {                                               \
    return dispatch<XT, INT4>(x, q, scale, ws, y, T, K, N, G, splits, per,          \
                              static_cast<cudaStream_t>(stream));                   \
  }

QUANT_MATMUL_ENTRY(quant_matmul_int8_f32, float, false)
QUANT_MATMUL_ENTRY(quant_matmul_int8_bf16, __nv_bfloat16, false)
QUANT_MATMUL_ENTRY(quant_matmul_int4_f32, float, true)
QUANT_MATMUL_ENTRY(quant_matmul_int4_bf16, __nv_bfloat16, true)

// The tensor-core route's entry points, bf16 x: x (T, K), q, scale, bias
// (N,) bf16 or null, y (T, N) float32, or bf16 when out_bf16 (then with
// the bias, if any); G is the int4 group (ignored for int8), `splits` (at
// most 8) the K splits and `per` the k rows of one (a multiple of 128 when
// there are several). Returns the launch's cudaError_t: 0 when the kernel
// was queued on `stream`.
#define QUANT_MMA_ENTRY(NAME, INT4)                                                        \
  extern "C" int NAME(const void* x, const void* q, const void* scale, const void* bias,   \
                      void* y, int T, int K, int N, int G, int splits, int per,            \
                      int out_bf16, void* stream) {                                        \
    return dispatch_mma<INT4>(x, q, scale, bias, y, T, K, N, G, splits, per, out_bf16,     \
                              static_cast<cudaStream_t>(stream));                          \
  }

QUANT_MMA_ENTRY(quant_mma_int8, false)
QUANT_MMA_ENTRY(quant_mma_int4, true)
