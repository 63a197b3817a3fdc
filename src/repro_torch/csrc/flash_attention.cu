// Flash-attention forward: GQA, causal or not, sliding window, f32 online
// softmax (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _flash_kernel).  The TPU kernel runs a grid of (batch·head, q tile,
// kv tile) in order on one core and carries the online-softmax state
// (m, l, acc) of a q tile in VMEM scratch from one kv grid step to the next;
// it pads S to its tile and masks the padded key columns, and skips kv tiles
// that are wholly masked (pl.when(live)).
//
// What bounds it on an H100: operations.  A causal call does about
// 2·B·H·S²·D multiply-adds against (2·B·H + 2·B·KH)·S·D elements moved, so
// at the training shapes (S = 1,024, D = 64) it is far above the ~295 flops
// a byte where the tensor cores, and not the memory, become the limit.  This
// first kernel runs on the CUDA cores in f32, so its own limit is the f32
// rate and the shared-memory traffic of its inner loops, not the tensor
// cores' peak.
//
// Design: CUDA blocks run in no order, so no state crosses blocks.  One
// block of 256 threads owns one (query tile of 64 rows, batch·head) and
// walks, in a loop of its own, the 64-column key tiles its rows can see:
// under causality it stops at the tile holding its last row, under a window
// it starts at the first tile a row's window reaches, and it never goes past
// S.  Q, K and V tiles are staged in shared memory as f32 (dynamic shared
// memory, above 48 KB at D = 128; rows padded by one word so the score loop's
// reads hit distinct banks).  Thread (ty, tx) of the 16 x 16 grid owns score
// rows 4·ty .. 4·ty+3 and columns tx, tx+16, tx+32, tx+48 of a tile; the 16
// threads of a row are one half-warp, so the row's max and sum are taken
// with shuffles.  The weights go through shared memory for the product with
// V, where the same thread owns output columns tx + 16·c of its four rows
// (D / 16 accumulators a row: D is a multiple of 16).  Key rows at or past S
// are never read (they are staged as zeros and masked), masked entries carry
// no weight, and a row that no column reaches is written as 0.  GQA reads
// kv head h / (H / KH).  No wgmma and no TMA yet: a plain, correct kernel
// first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key columns per tile
constexpr int THREADS = 256;
constexpr int RPT = 4;   // score rows per thread
constexpr int CPT = 4;   // score columns per thread
constexpr int PP = BK + 1;  // padded row of the weight tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) { *out = __float2bfloat16(x); }

// max / sum over the 16 lanes of a half-warp
__device__ __forceinline__ float half_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
                          (size_t)BQ * PP);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q,  // (B, H, S, D)
    const T* __restrict__ k,  // (B, KH, S, D)
    const T* __restrict__ v,  // (B, KH, S, D)
    T* __restrict__ out,      // (B, H, S, D)
    int H, int KH, int S, int causal, int window, float sm_scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;  // output columns per thread and row
  extern __shared__ float smem[];
  float* qs = smem;            // BQ * DP
  float* ks = qs + BQ * DP;    // BK * DP
  float* vs = ks + BK * DP;    // BK * D
  float* ps = vs + BK * D;     // BQ * PP

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_lo = qt * BQ;
  const int q_last = min(q_lo + BQ, S) - 1;  // last real row of the tile

  const T* qp = q + (long long)bh * S * D;
  const long long kv_base = ((long long)b * KH + kvh) * (long long)S * D;
  const T* kp = k + kv_base;
  const T* vp = v + kv_base;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    const int row = q_lo + r;
    qs[r * DP + c] = row < S ? to_f(qp[(long long)row * D + c]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // the key columns any row of this tile can see: [k_begin, k_end)
  int k_end = S;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int k_lo = t * BK;
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      const int col = k_lo + r;
      float kx = 0.f, vx = 0.f;
      if (col < S) {
        const long long off = (long long)col * D + c;
        kx = to_f(kp[off]);
        vx = to_f(vp[off]);
      }
      ks[r * DP + c] = kx;
      vs[r * D + c] = vx;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty * RPT + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
      const int row = q_lo + r;
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k_lo + tx + 16 * j;
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        s[i][j] = ok ? s[i][j] * sm_scale : -CUDART_INF_F;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = half_max(mt);
      const float m_new = fmaxf(m[i], mt);
      // no column seen yet: nothing to rescale, and every weight is 0
      const float alpha = m_new == -CUDART_INF_F ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = s[i][j] == -CUDART_INF_F ? 0.f : expf(s[i][j] - m_new);
        ps[r * PP + tx + 16 * j] = p;
        sum += p;
      }
      sum = half_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = ps[(ty * RPT + i) * PP + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += p * vv[c];
      }
    }
    __syncthreads();
  }

  T* op = out + (long long)bh * S * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q_lo + ty * RPT + i;
    if (row < S) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float o = l[i] == 0.f ? 0.f : acc[i][c] / l[i];
        from_f(o, op + (long long)row * D + tx + 16 * c);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KH,
           int S, int causal, int window, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block's shared memory must be asked for; done once per
  // instance, before any launch (and so outside any graph capture)
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, KH, S, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B, int H,
               int KH, int S, int D, int causal, int window, float sm_scale,
               cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, H, KH, S, causal, window, sm_scale, st);
    case 64: return launch<T, 64>(q, k, v, out, B, H, KH, S, causal, window, sm_scale, st);
    case 80: return launch<T, 80>(q, k, v, out, B, H, KH, S, causal, window, sm_scale, st);
    case 128: return launch<T, 128>(q, k, v, out, B, H, KH, S, causal, window, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The caller guarantees D in
// {32, 64, 80, 128}, H % KH == 0, S >= 1, window >= 0 (0 = no window) and
// contiguous (B, H, S, D) / (B, KH, S, D) tensors of that dtype.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int H, int KH, int S, int D,
                                      int causal, int window, int dtype, float sm_scale,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, B, H, KH, S, D, causal, window, sm_scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, B, H, KH, S, D, causal, window, sm_scale,
                                     st);
  return (int)cudaErrorInvalidValue;
}
