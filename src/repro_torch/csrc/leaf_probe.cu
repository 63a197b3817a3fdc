// Batched unsorted-leaf probe: the slot of the first key equal to the query
// in each gathered leaf row, and the value there (sm_90a).
//
// Replaces: src/repro/kernels/leaf_probe/kernel.py::leaf_probe_pallas (body
// _probe_kernel), and the hi/lo split of ops.py::leaf_probe_i64.  The TPU
// kernel compares a (TB, b) tile of int32 key rows against its queries in
// one vector op, takes the first match with a masked min over the slots and
// selects the value with a masked sum (no gather on the TPU); 64-bit keys
// are split into two int32 planes because the TPU has no int64 vectors.
//
// What bounds it on an H100: bytes, and below them the latency of one trip
// to memory.  A row costs b compares against b keys of 4 or 8 bytes, one
// value and a few bytes of output: well under one operation a byte.  At the
// tree path's 16,384 rows of 11 int64 keys the bytes take ~0.4 us, under
// the ~1.2 us launch floor, so what a design can still win is the number of
// dependent trips a row waits for.
//
// Design: a group of G lanes takes a row, G the power of two at or above
// min(b, 32) (16 lanes at b = 11: two rows a warp).  Lane j loads key j; all
// lanes of the group compare at once, and one __ballot_sync over the warp
// masked to the group's bits and one __ffs give the first matching slot;
// the group's leader writes the slot and the value.  The lanes of a group
// read one row's contiguous keys, so a warp's load covers 32 / G whole rows
// in a few sectors (the first design's thread-a-row loads used 8 bytes of
// every 32-byte sector and issued each row's loads one after another).
// Rows wider than 32 slots take a whole warp and are walked in 32-slot
// steps that stop at the first step with a match.  The value: lane j also
// loads value j in the key's trip and a shuffle brings the hit's to the
// leader (no dependent load, twice the bytes).  The alternative, the leader
// loading it after the ballot (one dependent load), was the slower on an
// H100 at both the tree path's and a serving index's rows (PERF.md, A/B 8).
// int64 keys are compared as they are (the card has 64-bit integer
// compares).  Absent: slot -1 and value 0.  Rows are
// contiguous (B, b) arrays; empty slots hold whatever the caller put there
// (the tree's EMPTY key), so no size mask is needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename K, typename V, int G>
__global__ void __launch_bounds__(kThreads) leaf_probe_groups(
    const K* __restrict__ keys,     // (B, b)
    const V* __restrict__ vals,     // (B, b)
    const K* __restrict__ queries,  // (B,)
    int* __restrict__ slot_out,     // (B,)
    V* __restrict__ val_out,        // (B,)
    int B, int b) {
  constexpr int kRowsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int sub = lane / G;  // the group's row within the warp
  const int j = lane % G;    // the lane's slot within a step
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long first_row = warp * kRowsPerWarp;
  if (first_row >= B) return;  // warp-uniform: every lane of the warp leaves
  const long long row = first_row + sub;
  const bool live = row < B;
  const unsigned group = G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1u) << (sub * G);
  const K q = live ? __ldg(queries + row) : K(0);
  const K* rk = keys + row * b;
  const V* rv = vals + row * b;
  int slot = -1;
  V val = V(0);
  // one step when b <= 32 (G >= b), so the trip count is the same for every
  // group of the warp; past 32 the group is the warp
  for (int base = 0; base < b; base += G) {
    const int s = base + j;
    const bool in = live && s < b;
    const K k = in ? __ldg(rk + s) : K(0);
    const V v = in ? __ldg(rv + s) : V(0);
    const unsigned hits = __ballot_sync(0xffffffffu, in && k == q) & group;
    const int src = hits ? __ffs(hits) - 1 : lane;
    const V at = __shfl_sync(0xffffffffu, v, src);
    if (hits) {
      slot = base + src - sub * G;
      val = at;
      break;
    }
  }
  if (live && j == 0) {
    slot_out[row] = slot;
    val_out[row] = val;
  }
}

template <typename K, typename V, int G>
void launch_g(const void* keys, const void* vals, const void* queries, void* slot_out,
              void* val_out, int B, int b, cudaStream_t stream) {
  constexpr long long kRowsPerBlock = (kThreads / 32) * (32 / G);
  const unsigned int blocks = (unsigned int)((B + kRowsPerBlock - 1) / kRowsPerBlock);
  leaf_probe_groups<K, V, G><<<blocks, kThreads, 0, stream>>>(
      (const K*)keys, (const V*)vals, (const K*)queries, (int*)slot_out, (V*)val_out, B, b);
}

template <typename K, typename V>
int launch(const void* keys, const void* vals, const void* queries, void* slot_out,
           void* val_out, int B, int b, cudaStream_t stream) {
  if (B > 0) {
    int g = 1;  // the power of two at or above min(b, 32)
    while (g < b && g < 32) g *= 2;
    switch (g) {
      case 1: launch_g<K, V, 1>(keys, vals, queries, slot_out, val_out, B, b, stream); break;
      case 2: launch_g<K, V, 2>(keys, vals, queries, slot_out, val_out, B, b, stream); break;
      case 4: launch_g<K, V, 4>(keys, vals, queries, slot_out, val_out, B, b, stream); break;
      case 8: launch_g<K, V, 8>(keys, vals, queries, slot_out, val_out, B, b, stream); break;
      case 16: launch_g<K, V, 16>(keys, vals, queries, slot_out, val_out, B, b, stream); break;
      default: launch_g<K, V, 32>(keys, vals, queries, slot_out, val_out, B, b, stream); break;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// key_bits, val_bits: 32 or 64 (int32 / int64).  The caller guarantees
// contiguous (B, b) key and value rows and (B,) queries and outputs.
extern "C" int leaf_probe_launch(const void* keys, const void* vals, const void* queries,
                                 void* slot_out, void* val_out, int B, int b, int key_bits,
                                 int val_bits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (key_bits == 64 && val_bits == 64)
    return launch<long long, long long>(keys, vals, queries, slot_out, val_out, B, b, st);
  if (key_bits == 64 && val_bits == 32)
    return launch<long long, int>(keys, vals, queries, slot_out, val_out, B, b, st);
  if (key_bits == 32 && val_bits == 64)
    return launch<int, long long>(keys, vals, queries, slot_out, val_out, B, b, st);
  if (key_bits == 32 && val_bits == 32)
    return launch<int, int>(keys, vals, queries, slot_out, val_out, B, b, st);
  return (int)cudaErrorInvalidValue;
}
