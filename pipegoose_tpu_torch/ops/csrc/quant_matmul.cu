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
//   sum_k x[t, k] * (q4[k, n] * scale[k / G, n]), the scale applied to each
//   weight before its product. G is even, so a byte's two rows share a
//   group.
// x (T, K) is float32 or bf16, widened to float32 in registers (the values
// of JAX's x.astype(f32)); y (T, N) is float32; every sum is a float32 FMA.
//
// What bounds it on the card: at the decode shape (T = 8 tokens, K x N of
// 1-4 M weights) each weight byte feeds 2 T = 16 operations, against the
// ~20 float32 operations per byte at which the H100's CUDA cores, not its
// 3.35 TB/s of device memory, become the limit: the kernel is bound by the
// bytes of q it reads, and at these sizes (1-4 MB, 0.3-1.2 us of device
// memory time) by latency. So the design reads every byte of q exactly once
// per token tile, as 16-byte loads along N (N is q's contiguous axis:
// neighbouring threads read neighbouring bytes), keeps several loads in
// flight per thread, converts in registers (never writing a float weight
// back), and splits K over blocks until there are ~2 blocks per SM. At the
// prefill shapes (T = 128 chunks, up to 1024 for a monolithic prefill) the
// float32 FMAs on the CUDA cores bound it; tiles of 8 tokens reuse each
// converted weight 8 times from registers.
//
// Design (simple first; W8A16 on the tensor cores with int8 -> bf16 in
// registers, mma.sync / wgmma for the prefill shapes and a fused bias are
// later work):
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
// Any T >= 1 and any N are masked at the edge; N % 16 != 0, or a pointer
// not 16-byte aligned, takes byte loads instead of 16-byte loads.

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
