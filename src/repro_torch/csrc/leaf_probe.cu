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
// What bounds it on an H100: bytes.  A row costs b compares against b keys
// of 4 or 8 bytes, one value and a few bytes of output: well under one
// operation a byte.
//
// Design: one thread per row.  The thread reads the row's keys in slot
// order and stops at the first match, so a hit reads only the slots up to
// it; the value is read directly at that slot.  int64 keys are compared as
// they are (the card has 64-bit integer compares).  Absent: slot -1 and
// value 0.  Rows are contiguous (B, b) arrays; empty slots hold whatever the
// caller put there (the tree's EMPTY key), so no size mask is needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename K, typename V>
__global__ void __launch_bounds__(256) leaf_probe_kernel(
    const K* __restrict__ keys,     // (B, b)
    const V* __restrict__ vals,     // (B, b)
    const K* __restrict__ queries,  // (B,)
    int* __restrict__ slot_out,     // (B,)
    V* __restrict__ val_out,        // (B,)
    int B, int b) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const K q = queries[i];
  const K* row = keys + i * b;
  int slot = -1;
  for (int j = 0; j < b; ++j) {
    if (__ldg(row + j) == q) {
      slot = j;
      break;
    }
  }
  slot_out[i] = slot;
  val_out[i] = slot >= 0 ? __ldg(vals + i * b + slot) : (V)0;
}

template <typename K, typename V>
int launch(const void* keys, const void* vals, const void* queries, void* slot_out,
           void* val_out, int B, int b, cudaStream_t stream) {
  if (B > 0) {
    const int threads = 256;
    const unsigned int blocks = (unsigned int)((B + threads - 1) / threads);
    leaf_probe_kernel<K, V><<<blocks, threads, 0, stream>>>(
        (const K*)keys, (const V*)vals, (const K*)queries, (int*)slot_out, (V*)val_out, B,
        b);
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
