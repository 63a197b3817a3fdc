// Range-scan gather: per row, the <= cap smallest candidate keys in
// [lo, hi) (EMPTY excluded), ascending, with their values, int64 keys
// (sm_90a).
//
// Replaces: src/repro/kernels/range_scan/kernel.py::range_scan_pallas
// (bodies _range_scan_kernel, pairwise, and _range_scan_kernel_tiled).  The
// TPU kernel ranks every match by an O(n^2) pairwise compare and selects
// rank c by a one-hot masked sum, because the TPU has no sort or scatter;
// its rank assumes the keys of a row are unique.
//
// What bounds it on an H100: bytes.  A row reads n = f*b candidate keys
// (8 bytes each) and writes cap keys and values; the sort below runs in
// shared memory and never touches HBM again.
//
// Design: one block per row.  Shared memory holds 2C (key, candidate index)
// pairs, C = the power of two >= max(cap, 32): the first C are the best
// matches so far, ascending.  Each step loads the next C candidates into the
// second half (a non-match becomes (EMPTY, INT_MAX)), bitonic-sorts all 2C
// pairs on (key, index) and keeps the first C.  Sorting on the candidate
// index as the second key makes the result the reference's stable argsort
// even when a row holds a key twice.  The match count is a per-thread count
// reduced through shared memory.  Values are read only for the emitted pairs.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr long long kEmpty = LLONG_MAX;

__device__ __forceinline__ bool greater(long long ka, int ia, long long kb, int ib) {
  return ka > kb || (ka == kb && ia > ib);
}

__global__ void __launch_bounds__(1024) range_scan_kernel(
    const long long* __restrict__ cand_keys,  // (B, n)
    const long long* __restrict__ cand_vals,  // (B, n)
    const long long* __restrict__ lo,         // (B,)
    const long long* __restrict__ hi,         // (B,)
    long long* __restrict__ out_keys,         // (B, cap)
    long long* __restrict__ out_vals,         // (B, cap)
    int* __restrict__ count,                  // (B,)
    unsigned char* __restrict__ truncated,    // (B,)
    int n, int cap, int C) {
  extern __shared__ long long smem[];
  long long* sk = smem;               // 2C keys
  int* si = (int*)(smem + 2 * C);     // 2C candidate indices
  __shared__ int warp_cnt[32];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int P = 2 * C;
  const long long in_base = (long long)row * n;
  const long long l = lo[row];
  const long long h = hi[row];
  for (int t = tid; t < C; t += T) {
    sk[t] = kEmpty;
    si[t] = INT_MAX;
  }
  int matches = 0;
  for (int start = 0; start < n; start += C) {
    for (int t = tid; t < C; t += T) {
      const int j = start + t;
      long long k = kEmpty;
      int idx = INT_MAX;
      if (j < n) {
        const long long key = cand_keys[in_base + j];
        if (key >= l && key < h && key != kEmpty) {
          k = key;
          idx = j;
          ++matches;
        }
      }
      sk[C + t] = k;
      si[C + t] = idx;
    }
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int p = tid; p < P / 2; p += T) {
          const int a = 2 * j * (p / j) + (p % j);
          const int c = a + j;
          const bool ascending = (a & k) == 0;
          const long long ka = sk[a], kc = sk[c];
          const int ia = si[a], ic = si[c];
          if (greater(ka, ia, kc, ic) == ascending) {
            sk[a] = kc;
            sk[c] = ka;
            si[a] = ic;
            si[c] = ia;
          }
        }
        __syncthreads();
      }
    }
  }
  // block reduction of the per-thread match counts
  int x = matches;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
  if ((tid & 31) == 0) warp_cnt[tid >> 5] = x;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < (T + 31) / 32; ++w) total += warp_cnt[w];
    count[row] = total < cap ? total : cap;
    truncated[row] = total > cap ? 1 : 0;
  }
  const long long out_base = (long long)row * cap;
  for (int t = tid; t < cap; t += T) {
    const int idx = si[t];
    const bool emitted = idx != INT_MAX;
    out_keys[out_base + t] = emitted ? sk[t] : kEmpty;
    out_vals[out_base + t] = emitted ? cand_vals[in_base + idx] : 0;
  }
}

int smem_bytes(int C) { return 2 * C * (int)(sizeof(long long) + sizeof(int)); }

}  // namespace

extern "C" int range_scan_launch(
    const void* cand_keys, const void* cand_vals, const void* lo,
    const void* hi, void* out_keys, void* out_vals, void* count,
    void* truncated, int B, int n, int cap, int C, void* stream) {
  // The dynamic shared-memory ceiling is raised once per size (not per
  // launch), so a launch captured into a CUDA graph makes no such call.
  static int smem_allowed = 48 * 1024;
  if (B > 0) {
    const int smem = smem_bytes(C);
    if (smem > smem_allowed) {
      cudaError_t err = cudaFuncSetAttribute(
          range_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      smem_allowed = smem;
    }
    const int threads = C < 1024 ? C : 1024;
    range_scan_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        (const long long*)cand_keys, (const long long*)cand_vals,
        (const long long*)lo, (const long long*)hi, (long long*)out_keys,
        (long long*)out_vals, (int*)count, (unsigned char*)truncated, n, cap,
        C);
  }
  return (int)cudaGetLastError();
}
