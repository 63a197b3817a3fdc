// Fused root-to-leaf descent + unsorted-leaf probe on int64 keys (sm_90a).
//
// Replaces: src/repro/kernels/tree_descend/kernel.py::descend_probe_pallas
// (body _descend_probe_kernel).  The TPU kernel pins the whole node pool in
// VMEM and walks all max_height levels for a tile of int32 queries.
//
// What bounds it on an H100: dependent gathers.  Each level reads one
// node's b-1 routers and one child id, and the next level's address depends
// on that read, so a query is a chain of height-many round trips to L2 or
// device memory; the bytes moved are small.  The pool's keys, values and
// children take 220 B a row (87 MB at the 393,681 rows of the b = 11 main
// path), so the upper levels stay in the 50 MB L2 while leaf rows may come
// from HBM.
//
// Design: one thread per query, so a warp keeps 32 independent chains in
// flight and the SM hides latency across many resident warps.  Router and
// child reads go through the read-only path (__ldg).  The loop stops at the
// first leaf: leaves map to themselves in the reference's fixed-length
// max_height loop, so stopping early returns the same node.  A NULL child
// (-1) is sent to the scratch row N-1 explicitly (the JAX reference relies
// on negative gather indices wrapping).  An EMPTY query (a NOP lane) counts
// all b-1 routers and may match a free slot in the leaf it reaches; that is
// the reference's behaviour and is kept bit for bit.
//
// Layout: the pool is the stacked (S, N, b) form; lane i of the (S, B)
// query block belongs to shard i / B.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256) descend_probe_kernel(
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
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * B) return;
  const int s = (int)(i / B);
  const long long base = (long long)s * N;
  const long long q = queries[i];
  int node = __ldg(root + s);
  for (int level = 0; level < max_height; ++level) {
    if (__ldg(is_leaf + base + node)) break;
    const long long* routers = keys + (base + node) * b;
    int idx = 0;
    for (int j = 0; j < b - 1; ++j) idx += (__ldg(routers + j) <= q) ? 1 : 0;
    const int child = __ldg(children + (base + node) * b + idx);
    node = child < 0 ? N - 1 : child;
  }
  const long long* row = keys + (base + node) * b;
  int slot = -1;
  for (int j = 0; j < b; ++j) {
    if (__ldg(row + j) == q) {
      slot = j;
      break;
    }
  }
  leaf_out[i] = node;
  found_out[i] = slot >= 0 ? 1 : 0;
  slot_out[i] = slot >= 0 ? slot : 0;
  val_out[i] = slot >= 0 ? __ldg(vals + (base + node) * b + slot) : notfound;
}

}  // namespace

extern "C" int descend_probe_launch(
    const void* keys, const void* vals, const void* children,
    const void* is_leaf, const void* root, const void* queries,
    void* leaf_out, void* found_out, void* slot_out, void* val_out,
    int S, int N, int b, int B, int max_height, long long notfound,
    void* stream) {
  const long long total = (long long)S * B;
  if (total > 0) {
    const int threads = 256;
    const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
    descend_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, (const long long*)vals, (const int*)children,
        (const unsigned char*)is_leaf, (const int*)root,
        (const long long*)queries, (int*)leaf_out, (unsigned char*)found_out,
        (int*)slot_out, (long long*)val_out, S, N, b, B, max_height, notfound);
  }
  return (int)cudaGetLastError();
}
