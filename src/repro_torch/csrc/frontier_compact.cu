// Row-stable compaction of valid candidate node ids into a width-f frontier
// (sm_90a).
//
// Replaces: src/repro/kernels/tree_descend/kernel.py::frontier_compact_pallas
// (body _frontier_compact_kernel).  The TPU kernel ranks candidates with a
// cumsum and then selects output slot c by a chunked one-hot masked sum,
// because the TPU has no scatter.
//
// What bounds it on an H100: bytes and launch latency.  A row is
// f*(b+1) candidates (96 at f=8, b=11) of 5 bytes each; the whole call moves
// well under a megabyte, so at main-path sizes it is dominated by the fixed
// cost of a launch.
//
// Design: one block per row.  The block walks the row in chunks of
// blockDim candidates; a warp-shuffle scan plus a shared-memory scan of the
// warp totals gives each candidate its exclusive rank among the valid ones,
// and a running offset carries the rank across chunks.  A valid candidate
// with rank < f is written straight to its slot (the scatter the TPU lacked);
// the row's valid count goes to total.  Slots at or past total are left
// unwritten: the wrapper masks them with the scratch id.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) frontier_compact_kernel(
    const int* __restrict__ cand,            // (B, M)
    const unsigned char* __restrict__ valid,  // (B, M)
    int* __restrict__ frontier,              // (B, f)
    int* __restrict__ total,                 // (B,)
    int M, int f) {
  __shared__ int warp_sum[kWarps];
  __shared__ int running;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long in_base = (long long)row * M;
  if (tid == 0) running = 0;
  __syncthreads();
  for (int start = 0; start < M; start += kThreads) {
    const int j = start + tid;
    const int v = (j < M && valid[in_base + j]) ? 1 : 0;
    int x = v;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    int before = running;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
    const int rank = before + x - v;
    if (v && rank < f) frontier[(long long)row * f + rank] = cand[in_base + j];
    __syncthreads();  // every thread has read running and warp_sum
    if (tid == 0) {
      int chunk = 0;
      for (int w = 0; w < kWarps; ++w) chunk += warp_sum[w];
      running += chunk;
    }
    __syncthreads();
  }
  if (tid == 0) total[row] = running;
}

}  // namespace

extern "C" int frontier_compact_launch(
    const void* cand, const void* valid, void* frontier, void* total,
    int B, int M, int f, void* stream) {
  if (B > 0) {
    frontier_compact_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)cand, (const unsigned char*)valid, (int*)frontier,
        (int*)total, M, f);
  }
  return (int)cudaGetLastError();
}
