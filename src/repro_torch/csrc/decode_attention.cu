// GQA decode attention: one query token per sequence over a KV cache masked
// at a host-side kv_len, f32 online softmax (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
// (body _decode_kernel).  The TPU kernel walks the KV tiles of one
// (batch, kv head) in order on one core, carrying the online-softmax state
// of the G = H / KH query heads in VMEM scratch from grid step to grid step.
//
// What bounds it on an H100: bytes.  Each cached key and value row below
// kv_len is read once and used by G query heads, so the work is 4·G flops a
// cached element against 2 or 4 bytes of it: far below the ~295 flops a
// byte where the tensor cores would become the limit.  At the serving
// shapes (B·KH = 16) one block per (batch, kv head) would leave 116 of the
// 132 SMs idle.
//
// Design: split-KV flash-decoding.  decode_partial_kernel runs one block per
// (split, kv head, batch); a split is a contiguous range of at most `chunk`
// cached columns below kv_len, and the host sizes `chunk` so that no split
// is empty and the grid holds about two blocks per SM.  A block holds the G
// query rows of its kv head in shared memory, walks its range in tiles of
// 32 columns (K and V tiles staged in shared memory as f32; the K tile's
// rows are padded by one word so that the score loop's column reads hit
// distinct banks), and keeps the online softmax per query row: one warp per
// row takes the tile's max and sum with shuffles, and each thread keeps up
// to 8 of the G·D output accumulators in registers.  It writes its
// (m, l, acc) partial to a workspace.  decode_combine_kernel then merges the
// partials of each (batch, head) with the usual rescaling and writes the
// output in q's dtype.  Columns at or past kv_len are never read; a split
// with no column (not produced by the host's sizing) would write m = -inf,
// l = 0 and carry no weight in the combine.  No wgmma and no TMA yet: a
// plain, correct kernel first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;     // cached columns per tile (one warp lane each)
constexpr int THREADS = 256;
constexpr int MAXA = 8;      // accumulators per thread: G·D <= THREADS·MAXA

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) { *out = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_partial_kernel(
    const T* __restrict__ q,     // (B, H, D)
    const T* __restrict__ k,     // (B, KH, S, D)
    const T* __restrict__ v,     // (B, KH, S, D)
    float* __restrict__ part_m,  // (B, KH, n_split, G)
    float* __restrict__ part_l,  // (B, KH, n_split, G)
    float* __restrict__ part_acc,  // (B, KH, n_split, G, D)
    int H, int KH, int S, int G, int kv_len, int chunk, float sm_scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // G * D
  float* ks = qs + G * D;                 // TILE * (D + 1)
  float* vs = ks + TILE * (D + 1);        // TILE * D
  float* ps = vs + TILE * D;              // G * TILE scores, then weights
  float* m_s = ps + G * TILE;             // G running maxima
  float* l_s = m_s + G;                   // G running sums
  float* a_s = l_s + G;                   // G rescale factors of this tile

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = split * chunk;
  const int end = min(start + chunk, kv_len);

  const T* qp = q + ((long long)b * H + (long long)kh * G) * D;
  for (int i = tid; i < G * D; i += THREADS) qs[i] = to_f(qp[i]);
  if (tid < G) {
    m_s[tid] = -CUDART_INF_F;
    l_s[tid] = 0.f;
  }
  const long long kv_base = ((long long)b * KH + kh) * (long long)S * D;
  const T* kp = k + kv_base;
  const T* vp = v + kv_base;

  float acc[MAXA];
#pragma unroll
  for (int j = 0; j < MAXA; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int t0 = start; t0 < end; t0 += TILE) {
    const int n = min(TILE, end - t0);
    for (int i = tid; i < TILE * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      float kx = 0.f, vx = 0.f;
      if (r < n) {
        const long long off = (long long)(t0 + r) * D + c;
        kx = to_f(kp[off]);
        vx = to_f(vp[off]);
      }
      ks[r * (D + 1) + c] = kx;
      vs[r * D + c] = vx;
    }
    __syncthreads();

    for (int e = tid; e < G * TILE; e += THREADS) {
      const int g = e / TILE, t = e - g * TILE;
      const float* qr = qs + g * D;
      const float* kr = ks + t * (D + 1);
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
      ps[e] = t < n ? s * sm_scale : -CUDART_INF_F;
    }
    __syncthreads();

    for (int g = warp; g < G; g += THREADS / 32) {
      const float s = ps[g * TILE + lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      ps[g * TILE + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < MAXA; ++j) {
      const int idx = tid + j * THREADS;
      if (idx < G * D) {
        const int g = idx / D, d = idx - g * D;
        const float* pr = ps + g * TILE;
        float a = acc[j] * a_s[g];
        for (int t = 0; t < n; ++t) a += pr[t] * vs[t * D + d];
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  const long long part = ((long long)b * KH + kh) * n_split + split;
  if (tid < G) {
    part_m[part * G + tid] = m_s[tid];
    part_l[part * G + tid] = l_s[tid];
  }
#pragma unroll
  for (int j = 0; j < MAXA; ++j) {
    const int idx = tid + j * THREADS;
    if (idx < G * D) part_acc[part * G * D + idx] = acc[j];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D) decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, T* __restrict__ out,  // (B, H, D)
    int H, int KH, int G, int n_split) {
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kh = h / G, g = h - kh * G;
  const int d = threadIdx.x;
  const long long base = ((long long)b * KH + kh) * n_split;
  float m = -CUDART_INF_F;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, part_m[(base + s) * G + g]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ms = part_m[(base + s) * G + g];
    const float w = ms == -CUDART_INF_F ? 0.f : expf(ms - m);
    l += part_l[(base + s) * G + g] * w;
    o += part_acc[((base + s) * G + g) * D + d] * w;
  }
  from_f(l == 0.f ? 0.f : o / l, out + (long long)bh * D + d);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* part_m,
           void* part_l, void* part_acc, int B, int H, int KH, int S, int kv_len,
           int n_split, int chunk, float sm_scale, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + TILE * (D + 1) + TILE * D + (size_t)G * TILE + 3 * G);
  dim3 grid(n_split, KH, B);
  decode_partial_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (float*)part_m, (float*)part_l,
      (float*)part_acc, H, KH, S, G, kv_len, chunk, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, D><<<B * H, D, 0, stream>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc, (T*)out,
      H, KH, G, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The caller guarantees D in {32, 64, 128},
// H % KH == 0, (H / KH) * D <= 2048, 1 <= kv_len <= S, and
// (n_split - 1) * chunk < kv_len (no empty split).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* part_m,
    void* part_l, void* part_acc, int B, int H, int KH, int S, int D, int kv_len,
    int n_split, int chunk, int dtype, float sm_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && D == 32)
    return launch<float, 32>(q, k, v, out, part_m, part_l, part_acc, B, H, KH, S,
                             kv_len, n_split, chunk, sm_scale, st);
  if (dtype == 1 && D == 32)
    return launch<__nv_bfloat16, 32>(q, k, v, out, part_m, part_l, part_acc, B, H,
                                     KH, S, kv_len, n_split, chunk, sm_scale, st);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, part_m, part_l, part_acc, B, H, KH, S,
                             kv_len, n_split, chunk, sm_scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, part_m, part_l, part_acc, B, H, KH, S,
                              kv_len, n_split, chunk, sm_scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, part_m, part_l, part_acc, B, H,
                                     KH, S, kv_len, n_split, chunk, sm_scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, part_m, part_l, part_acc, B, H,
                                      KH, S, kv_len, n_split, chunk, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
