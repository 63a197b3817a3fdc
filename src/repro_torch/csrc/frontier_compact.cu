// Row-stable compaction of valid candidate node ids into a width-f frontier,
// finished in one launch (sm_90a).
//
// Replaces: src/repro/kernels/tree_descend/kernel.py::frontier_compact_pallas
// (body _frontier_compact_kernel) together with the two elementwise lines of
// its wrapper (src/repro/kernels/tree_descend/ops.py, frontier_compact): the
// kernel writes the finished (frontier, valid, overflow), with the scratch id
// in every slot at or past the row's valid count and overflow = count > f.
// The TPU kernel ranks candidates with a cumsum and then selects output slot
// c by a chunked one-hot masked sum, because the TPU has no scatter.
//
// What bounds it on an H100: launch latency.  A row is f*(b+1) candidates
// (96 at f = 8, b = 11): its valid bytes, the ids of at most f of them and
// f*5 + 1 bytes of output.  The whole main-path call moves well under a
// megabyte, so what counts is the chain of dependent steps after a launch.
//
// Design: a warp ranks 32 candidates with one __ballot_sync of their valid
// bits: a valid candidate's rank is the running count plus the __popc of
// the bits below its lane, and one of rank < f stores its id straight to its
// slot (the scatter the TPU lacked).  There is no barrier and no shared
// memory.  Four such steps load their valid bytes and ids together (the ids
// with the bytes, not after the ballot, so that a row costs one dependent
// trip to memory), and a warp stops once its count passes f (the rest of
// the row changes no output).
//   - Rows of at most kWarpRowMax candidates (every row the paths have
//     until a wide scan doubles the frontier): one warp a row, eight rows a
//     block.  At M = 96 a row is one group of three ballots.
//   - Longer rows (the frontier doubles on overflow and stays doubled, so M
//     reaches tens of thousands after one wide scan): one block a row, each
//     warp taking one contiguous segment.  The warps count their segments'
//     valid bytes, the block adds the counts before each warp in shared
//     memory, then each warp whose segment starts below f ranks it from
//     there.
// Then the row's threads write scratch / valid = false into the slots at or
// past the count (disjoint from the slots the ranks filled) and valid = true
// below it, and one thread writes overflow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;         // warp mode: one warp a row
constexpr int kUnroll = 4;               // 32-candidate steps loaded together
constexpr int kWarpRowMax = 1024;        // longer rows take the block mode
constexpr int kSegmentMin = 512;         // block mode: candidates a warp at least takes

// Stable compaction of candidates [begin, end) of a row by one warp, the
// first valid one of the range taking rank `rank`: a valid candidate of
// rank < f goes to frontier[rank].  Returns `rank` plus the range's valid
// count, or any value > f once that is passed.
__device__ __forceinline__ int compact_range(const int* __restrict__ cand,
                                             const unsigned char* __restrict__ valid,
                                             int begin, int end, int rank, int f,
                                             int* __restrict__ frontier, int lane) {
  const unsigned below = (1u << lane) - 1u;
  for (int j0 = begin; j0 < end && rank <= f; j0 += 32 * kUnroll) {
    bool v[kUnroll];
    int id[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + 32 * u + lane;
      v[u] = j < end && valid[j] != 0;
      id[u] = j < end ? cand[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned bits = __ballot_sync(kFull, v[u]);
      const int r = rank + __popc(bits & below);
      if (v[u] && r < f) frontier[r] = id[u];
      rank += __popc(bits);
    }
  }
  return rank;
}

// Slots [count, f) get the scratch id; valid = slot < count; overflow from
// thread 0 of the row (t is the thread's index among `stride` threads).
__device__ __forceinline__ void finish_row(int count, int f, int scratch,
                                           int* __restrict__ frontier,
                                           unsigned char* __restrict__ fvalid,
                                           unsigned char* __restrict__ overflow, int t,
                                           int stride) {
  for (int s = t; s < f; s += stride) {
    const bool ok = s < count;
    if (!ok) frontier[s] = scratch;
    fvalid[s] = ok ? 1 : 0;
  }
  if (t == 0) *overflow = count > f ? 1 : 0;
}

__global__ void __launch_bounds__(32 * kRowsPerBlock) compact_warp_rows(
    const int* __restrict__ cand,            // (B, M)
    const unsigned char* __restrict__ valid,  // (B, M)
    int* __restrict__ frontier,              // (B, f)
    unsigned char* __restrict__ fvalid,      // (B, f)
    unsigned char* __restrict__ overflow,    // (B,)
    int B, int M, int f, int scratch) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves together
  const long long in = (long long)row * M;
  const long long out = (long long)row * f;
  const int count = compact_range(cand + in, valid + in, 0, M, 0, f, frontier + out, lane);
  finish_row(count, f, scratch, frontier + out, fvalid + out, overflow + row, lane, 32);
}

__global__ void __launch_bounds__(1024) compact_block_row(
    const int* __restrict__ cand, const unsigned char* __restrict__ valid,
    int* __restrict__ frontier, unsigned char* __restrict__ fvalid,
    unsigned char* __restrict__ overflow, int M, int f, int scratch) {
  __shared__ int warp_count[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x;
  const long long in = (long long)row * M;
  const long long out = (long long)row * f;
  const int seg = ((M + warps - 1) / warps + 31) & ~31;
  const int begin = min(M, warp * seg);
  const int end = min(M, begin + seg);
  int n = 0;
  for (int j = begin + lane; j < end; j += 32) n += valid[in + j] != 0;
  n = __reduce_add_sync(kFull, n);
  if (lane == 0) warp_count[warp] = n;
  __syncthreads();
  int before = 0, count = 0;
  for (int w = 0; w < warps; ++w) {
    const int c = warp_count[w];
    before += w < warp ? c : 0;
    count += c;
  }
  if (before < f) compact_range(cand + in, valid + in, begin, end, before, f, frontier + out, lane);
  finish_row(count, f, scratch, frontier + out, fvalid + out, overflow + row, threadIdx.x,
             blockDim.x);
}

}  // namespace

extern "C" int frontier_compact_launch(
    const void* cand, const void* valid, void* frontier, void* fvalid, void* overflow,
    int B, int M, int f, int scratch, void* stream) {
  if (B > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (M <= kWarpRowMax) {
      compact_warp_rows<<<(B + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
          (const int*)cand, (const unsigned char*)valid, (int*)frontier,
          (unsigned char*)fvalid, (unsigned char*)overflow, B, M, f, scratch);
    } else {
      const int want = (M + kSegmentMin - 1) / kSegmentMin;
      const int warps = want < 32 ? want : 32;
      compact_block_row<<<B, 32 * warps, 0, s>>>(
          (const int*)cand, (const unsigned char*)valid, (int*)frontier,
          (unsigned char*)fvalid, (unsigned char*)overflow, M, f, scratch);
    }
  }
  return (int)cudaGetLastError();
}
