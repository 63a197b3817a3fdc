// Fused root-to-leaf descent + unsorted-leaf probe on int64 keys (sm_90a).
//
// Replaces: src/repro/kernels/tree_descend/kernel.py::descend_probe_pallas
// (body _descend_probe_kernel).  The TPU kernel pins the whole node pool in
// VMEM and walks all max_height levels for a tile of int32 queries.
//
// What bounds it on an H100: the chain of dependent loads.  A level's row
// is known only once the previous level's child id has arrived, so a query
// costs one round trip to L2 (or HBM) a level; the bytes are small (the
// rows a round's queries touch stay in the 50 MB L2).  A thread per query
// that reads the leaf flag, then the b-1 routers, then the child id pays
// three dependent trips a level and two more at the leaf (keys, then the
// value at the hit): about 3·height + 2 trips.
//
// Design: a group of G lanes per query, G the next power of two >= b (at
// least 2, at most the warp), so 16 lanes at the paper's b = 11 and 8 at
// the serving indexes' b = 8.  In one step lane j loads keys[row, j] and
// children[row, j], and every lane loads is_leaf[row] (one address, one
// transaction); all go out together, so a level is one dependent trip.
// Routing: a ballot over keys[row, j] <= q for j < b-1, counted with popc,
// is the reference's #routers <= q (an EMPTY query counts all b-1 routers,
// as the reference does), and the child comes from lane idx by a shuffle.
// At a leaf the same step's keys are the probe's: the first set bit of the
// equality ballot is the slot, and the value there is one more load, so
// the chain is height + 2 trips (the root id, one a level, the value).
// Loading the row's values in every step instead (no last trip) measured
// slower on the card: the internal levels never use them, and the round's
// rows are read from L2 a sector at a time.  Where b > 32 the group is the
// warp and each lane takes ceil(b/32) slots; the child is then one more
// load (no register array is indexed at run time).  At the round's 16,384
// queries and b = 11 the grid is 256 blocks of 1,024 threads, so every SM
// has work; blocks of 1,024 keep 64 neighbouring key-sorted queries on one
// SM's L1 and measured a little faster than 128-512.  A cache of the top
// levels in shared memory measured slower (the block must still walk those
// levels to fill it, and the key-sorted neighbours already share the upper
// rows in L1), so there is none; PERF.md keeps the A/B.
//
// Kept bit for bit from the reference: the walk stops at the first leaf or
// after max_height levels (leaves map to themselves in the reference's
// fixed-length loop, so stopping early returns the same node); a NULL child
// (-1) stays the lane's reported node id and its row is read as the scratch
// row N-1 (the reference's gathers wrap negative indices; here the wrap is
// explicit); a miss gives slot 0 and `notfound`; an EMPTY query may match a
// free slot of the leaf it reaches.
//
// Layout: the pool is the stacked (S, N, b) form; query i of the (S, B)
// block belongs to shard i / B.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int wrap_row(int node, int N) { return node < 0 ? node + N : node; }

template <int G>
__global__ void __launch_bounds__(kThreads) descend_probe_kernel(
    const long long* __restrict__ keys,      // (S, N, b)
    const long long* __restrict__ vals,      // (S, N, b)
    const int* __restrict__ children,        // (S, N, b)
    const unsigned char* __restrict__ is_leaf,  // (S, N)
    const int* __restrict__ root,            // (S,)
    const long long* __restrict__ queries,   // (S, B)
    int* __restrict__ leaf_out,              // (S, B)
    unsigned char* __restrict__ found_out,   // (S, B)
    int* __restrict__ slot_out,              // (S, B)
    long long* __restrict__ val_out,         // (S, B)
    int S, int N, int b, int B, int max_height, long long notfound) {
  const long long total = (long long)S * B;
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;  // the group's query
  const int j = threadIdx.x & (G - 1);  // the lane's first slot
  const int shift = threadIdx.x & 31 & ~(G - 1);  // the group's first lane in the warp
  const unsigned gmask = (0xffffffffu >> (32 - G)) << shift;

  if (i >= total) return;  // whole groups: G divides the block

  const int s = (int)(i / B);
  const long long q = queries[i];
  int node = __ldg(root + s);  // the id reported (-1 after a NULL child)
  int row = wrap_row(node, N);  // the row read: node, or N-1 for -1
  const long long base = (long long)s * N;
  for (int level = 0;; ++level) {
    const long long off = (base + row) * b;
    const bool leaf = __ldg(is_leaf + base + row) != 0;
    const bool stop = leaf || level >= max_height;
    if (G < 32 || b <= 32) {
      long long k = 0;
      int c = 0;
      if (j < b) {
        k = __ldg(keys + off + j);
        c = __ldg(children + off + j);
      }
      if (stop) {
        const unsigned eq = (__ballot_sync(gmask, j < b && k == q) & gmask) >> shift;
        const int slot = eq ? __ffs((int)eq) - 1 : 0;
        if (j == 0) {
          leaf_out[i] = node;
          found_out[i] = eq ? 1 : 0;
          slot_out[i] = slot;
          val_out[i] = eq ? __ldg(vals + off + slot) : notfound;
        }
        return;
      }
      const int idx = __popc(__ballot_sync(gmask, j < b - 1 && k <= q) & gmask);
      node = __shfl_sync(gmask, c, idx, G);
    } else {  // b > 32: the warp is the group, ceil(b/32) slots a lane
      int idx = 0, slot = -1;
      for (int c0 = 0; c0 < b; c0 += 32) {
        const int js = c0 + j;
        const long long k = js < b ? __ldg(keys + off + js) : 0;
        idx += __popc(__ballot_sync(gmask, js < b - 1 && k <= q));
        const unsigned eq = __ballot_sync(gmask, js < b && k == q);
        if (slot < 0 && eq) slot = c0 + __ffs((int)eq) - 1;
      }
      if (stop) {
        if (j == 0) {
          leaf_out[i] = node;
          found_out[i] = slot >= 0 ? 1 : 0;
          slot_out[i] = slot >= 0 ? slot : 0;
          val_out[i] = slot >= 0 ? __ldg(vals + off + slot) : notfound;
        }
        return;
      }
      node = __ldg(children + off + idx);
    }
    row = wrap_row(node, N);
  }
}

template <int G>
int launch(const void* keys, const void* vals, const void* children, const void* is_leaf,
           const void* root, const void* queries, void* leaf_out, void* found_out,
           void* slot_out, void* val_out, int S, int N, int b, int B, int max_height,
           long long notfound, cudaStream_t stream) {
  const long long lanes = (long long)S * B * G;
  const unsigned int blocks = (unsigned int)((lanes + kThreads - 1) / kThreads);
  descend_probe_kernel<G><<<blocks, kThreads, 0, stream>>>(
      (const long long*)keys, (const long long*)vals, (const int*)children,
      (const unsigned char*)is_leaf, (const int*)root, (const long long*)queries,
      (int*)leaf_out, (unsigned char*)found_out, (int*)slot_out, (long long*)val_out, S, N, b,
      B, max_height, notfound);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int descend_probe_launch(
    const void* keys, const void* vals, const void* children,
    const void* is_leaf, const void* root, const void* queries,
    void* leaf_out, void* found_out, void* slot_out, void* val_out,
    int S, int N, int b, int B, int max_height, long long notfound,
    void* stream) {
  if ((long long)S * B <= 0) return (int)cudaGetLastError();
  int g = 2;
  while (g < b && g < 32) g <<= 1;
  cudaStream_t st = (cudaStream_t)stream;
#define DESCEND_PROBE_LAUNCH(G)                                                             \
  launch<G>(keys, vals, children, is_leaf, root, queries, leaf_out, found_out, slot_out,   \
            val_out, S, N, b, B, max_height, notfound, st)
  switch (g) {
    case 2: return DESCEND_PROBE_LAUNCH(2);
    case 4: return DESCEND_PROBE_LAUNCH(4);
    case 8: return DESCEND_PROBE_LAUNCH(8);
    case 16: return DESCEND_PROBE_LAUNCH(16);
    default: return DESCEND_PROBE_LAUNCH(32);
  }
#undef DESCEND_PROBE_LAUNCH
}
