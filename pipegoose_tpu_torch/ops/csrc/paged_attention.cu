// Paged attention for Hopper (sm_90a): a ragged C-query attention that
// walks the page table directly.
//
// Replaces the Pallas TPU kernel pipegoose_tpu/ops/paged_attention.py:
// paged_attention (kernel body :256-320, pallas_call :354) and computes the
// same function. Row b's query c sits at global position start[b] + c; a key
// at LOGICAL position w*ps + o (whatever physical page holds it) is kept iff
// key_pos <= q_pos; the score is q.k * hd^-0.5 + slope[h] * key_pos plus the
// additive mask 0 or -1e9; the softmax is online, in float32; the output is
// acc / max(l, 1e-30) as float32 (B, C, nh, hd). Pages are float32, bf16, or
// int8 {q (P, ps, nh, hd), scale f32 (P, ps, nh)} dequantized in registers.
//
// What bounds it on the card: decode (C = 1) is memory-bound. For each K/V
// value pair it reads (4 bytes in bf16) it does two FMAs, q.k and p.v: about
// one operation per byte, far below the ~20 float32 operations per byte at
// which the H100's CUDA cores, not its 3.35 TB/s of device memory, become
// the limit. So the design reads every visible K/V byte exactly once, at the
// pool's own precision (1 byte a value for int8, dequantized in registers,
// never written back), skips every page past the block's last query (the
// TPU kernel's skip at :278), and keeps the score rows, the running max and
// sum, and the accumulator on chip: nothing but the output is written to
// device memory. Chunked prefill (C up to 64 per block) reuses each staged
// page across the tile's queries.
//
// Design (simple first; wgmma, TMA and double buffering are later work):
// one block of 128 threads per (tile of up to 64 queries, head, row). The
// block reads its own page-table entries (the TPU's scalar prefetch) and
// loops over logical pages in order, staging one (ps, hd) K and V tile in
// shared memory as float32. m and l live in registers of the thread that
// owns the query row, acc in registers spread over the block, and every
// sum is a float32 FMA. A page id outside [0, P) traps: a corrupt table
// fails loudly instead of reading another allocation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQTile = 64;
constexpr float kNegInf = -1e9f;  // finite, as NEG_INF in the JAX package

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// T: page element type. kScaled: int8 pages with a per-(position, head)
// float32 scale plane. HD: head_dim.
template <typename T, bool kScaled, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,         // (B, C, nh, HD)
                       const T* __restrict__ k_pages,       // (P, ps, nh, HD)
                       const T* __restrict__ v_pages,       // (P, ps, nh, HD)
                       const float* __restrict__ k_scale,   // (P, ps, nh) or null
                       const float* __restrict__ v_scale,   // (P, ps, nh) or null
                       const int* __restrict__ page_table,  // (B, W)
                       const int* __restrict__ start,       // (B,)
                       const float* __restrict__ slopes,    // (nh,)
                       float* __restrict__ out,             // (B, C, nh, HD)
                       int C, int nh, int ps, int W, int P, float scale) {
  constexpr int kAcc = kQTile * HD / kThreads;  // accumulators per thread
  constexpr int kLd = HD + 1;  // padded rows: column reads hit distinct banks
  const int tile0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qt = min(kQTile, C - tile0);
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* Qs = smem;             // [qt][kLd]  the tile's queries
  float* Ks = Qs + qt * kLd;    // [ps][kLd]  one K page
  float* Vs = Ks + ps * kLd;    // [ps][kLd]  one V page
  float* Ss = Vs + ps * kLd;    // [qt][ps]   scores, then probabilities
  float* Rs = Ss + qt * ps;     // [qt]       per-row rescale, then max(l, 1e-30)

  const int q0 = start[b] + tile0;  // global position of the tile's first query
  const float slope = slopes[h];
  for (int e = tid; e < qt * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    Qs[i * kLd + d] = q[(((int64_t)b * C + tile0 + i) * nh + h) * HD + d];
  }
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  float m = kNegInf, l = 0.f;  // row tid's running max and sum (tid < qt)

  // pages whose first key lies past the tile's last query are fully masked
  const int n_pages = min(W, (q0 + qt - 1) / ps + 1);
  const int* row_table = page_table + (int64_t)b * W;
  for (int w = 0; w < n_pages; ++w) {
    const int page = row_table[w];
    if (page < 0 || page >= P) __trap();
    __syncthreads();  // the previous page's tiles are consumed; Qs is staged
    for (int e = tid; e < ps * HD; e += kThreads) {
      const int o = e / HD, d = e % HD;
      const int64_t pos = ((int64_t)page * ps + o) * nh + h;
      float kv = to_f32(k_pages[pos * HD + d]);
      float vv = to_f32(v_pages[pos * HD + d]);
      if constexpr (kScaled) {
        kv *= k_scale[pos];
        vv *= v_scale[pos];
      }
      Ks[o * kLd + d] = kv;
      Vs[o * kLd + d] = vv;
    }
    __syncthreads();
    for (int p = tid; p < qt * ps; p += kThreads) {  // p = i * ps + j
      const int i = p / ps, j = p % ps;
      const float* qr = Qs + i * kLd;
      const float* kr = Ks + j * kLd;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int key_pos = w * ps + j;
      float s = dot * scale + slope * static_cast<float>(key_pos);
      s += (key_pos <= q0 + i) ? 0.f : kNegInf;
      Ss[p] = s;
    }
    __syncthreads();
    if (tid < qt) {  // online softmax over this page, row tid
      float* sr = Ss + tid * ps;
      float m_new = m;
      for (int j = 0; j < ps; ++j) m_new = fmaxf(m_new, sr[j]);
      float sum = 0.f;
      for (int j = 0; j < ps; ++j) {
        const float pj = expf(sr[j] - m_new);
        sr[j] = pj;
        sum += pj;
      }
      const float alpha = expf(m - m_new);
      l = l * alpha + sum;
      m = m_new;
      Rs[tid] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {  // acc[i][d] = acc * alpha_i + P[i] . V[:, d]
      const int e = tid + k * kThreads;
      const int i = e / HD, d = e % HD;
      if (i < qt) {
        const float* pr = Ss + i * ps;
        float pv = 0.f;
        for (int j = 0; j < ps; ++j) pv = fmaf(pr[j], Vs[j * kLd + d], pv);
        acc[k] = acc[k] * Rs[i] + pv;
      }
    }
  }
  __syncthreads();
  if (tid < qt) Rs[tid] = fmaxf(l, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int e = tid + k * kThreads;
    const int i = e / HD, d = e % HD;
    if (i < qt) out[(((int64_t)b * C + tile0 + i) * nh + h) * HD + d] = acc[k] / Rs[i];
  }
}

template <typename T, bool kScaled, int HD>
int launch(const float* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* table, const int* start,
           const float* slopes, float* out, int B, int C, int nh, int ps,
           int W, int P, float scale, cudaStream_t stream) {
  const int qt = C < kQTile ? C : kQTile;
  const size_t smem = sizeof(float) *
      ((size_t)qt * (HD + 1) + 2 * (size_t)ps * (HD + 1) + (size_t)qt * ps + qt);
  auto kernel = paged_attention_kernel<T, kScaled, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((C + kQTile - 1) / kQTile, nh, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), ks, vs, table,
      start, slopes, out, C, nh, ps, W, P, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool kScaled>
int dispatch(const float* q, const void* k, const void* v, const float* ks,
             const float* vs, const int* table, const int* start,
             const float* slopes, float* out, int B, int C, int nh, int hd,
             int ps, int W, int P, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, kScaled, 32>(q, k, v, ks, vs, table, start, slopes, out,
                                    B, C, nh, ps, W, P, scale, stream);
    case 64:
      return launch<T, kScaled, 64>(q, k, v, ks, vs, table, start, slopes, out,
                                    B, C, nh, ps, W, P, scale, stream);
    case 128:
      return launch<T, kScaled, 128>(q, k, v, ks, vs, table, start, slopes, out,
                                     B, C, nh, ps, W, P, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One entry point per page format, all with the same arguments. The scale
// pointers are ignored (pass null) for float32 and bf16 pages. Returns the
// launch's cudaError_t: 0 when the kernel was queued on `stream`.
#define PAGED_ATTENTION_ENTRY(NAME, T, SCALED)                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v,              \
                      const void* ks, const void* vs, const void* table,        \
                      const void* start, const void* slopes, void* out, int B,  \
                      int C, int nh, int hd, int ps, int W, int P, float scale, \
                      void* stream) {                                           \
    return dispatch<T, SCALED>(                                                 \
        static_cast<const float*>(q), k, v, static_cast<const float*>(ks),      \
        static_cast<const float*>(vs), static_cast<const int*>(table),          \
        static_cast<const int*>(start), static_cast<const float*>(slopes),      \
        static_cast<float*>(out), B, C, nh, hd, ps, W, P, scale,                \
        static_cast<cudaStream_t>(stream));                                     \
  }

PAGED_ATTENTION_ENTRY(paged_attention_f32, float, false)
PAGED_ATTENTION_ENTRY(paged_attention_bf16, __nv_bfloat16, false)
PAGED_ATTENTION_ENTRY(paged_attention_int8, int8_t, true)
