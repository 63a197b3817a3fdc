// Range-scan gather: per row, the <= cap smallest candidate keys in
// [lo, hi) (EMPTY excluded), ascending, with their values, int64 keys, any
// cap (sm_90a).
//
// Replaces: src/repro/kernels/range_scan/kernel.py::range_scan_pallas
// (bodies _range_scan_kernel, pairwise, and _range_scan_kernel_tiled).  The
// TPU kernel ranks every match by an O(n^2) pairwise compare and selects
// rank c by a one-hot masked sum, because the TPU has no sort or scatter;
// its rank assumes the keys of a row are unique.
//
// What bounds it on an H100: bytes.  A row reads n = f*b candidate keys
// (8 bytes each) and the values of the keys it emits, and writes cap keys
// and values: at cap 128 the EMPTY / 0 padding of the outputs is most of
// the call's bytes.  Only the matches of [lo, hi) need ordering, and a span
// of at most 64 keys in a half-full key range matches a few dozen of a row's
// 88 candidates.
//
// Design: filter first, then order only the matches.  The order is the
// plain version's stable argsort: by key, then by candidate index.
//   - Warp mode, rows of n <= kWarpRowMax candidates (the tree path's and
//     the serving indexes' rows): one warp a row, eight rows a block.  The
//     warp loads the row's keys coalesced and compacts the matches' (key,
//     candidate index) pairs into its slice of shared memory in candidate
//     order (a __ballot_sync and a __popc give each match its slot).  A
//     match's rank is the count of matches with a smaller key plus those
//     with an equal key earlier in the slice: every lane reads the same
//     slot at once (a broadcast), and no barrier is needed.  Ranks below
//     cap write the key and the value read at the match's index; the rest
//     of the row is filled with EMPTY / 0 in coalesced stores.
//   - Block mode, longer rows: any n and any cap, in two launches over a
//     block per (row, tile).  The row is cut into tiles of T candidates
//     (T = the power of two >= n, at most kTile).  The first kernel
//     bitonic-sorts each tile's pairs on (key, index) in shared memory and
//     writes the sorted run to a scratch buffer in device memory that the
//     wrapper allocates for the call.  The second ranks each match by its
//     place in its run plus a binary search of every other run, staged in
//     shared memory.  No array of pow2(cap) pairs is ever held, so the cap
//     has no limit, and the tiles of a row run on as many SMs.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr long long kEmpty = LLONG_MAX;
constexpr int kWarpRowMax = 256;  // longer rows take the block mode
constexpr int kRowsPerBlock = 8;  // warp mode: one warp a row
constexpr int kUnroll = 4;        // 32-key steps loaded together
constexpr int kTile = 2048;       // block mode: pairs a block sorts at once

__device__ __forceinline__ bool in_range(long long k, long long l, long long h) {
  return k >= l && k < h && k != kEmpty;
}

// Slots [from, cap) of an output row: EMPTY keys, 0 values.
__device__ __forceinline__ void pad_row(long long* __restrict__ keys, long long* __restrict__ vals,
                                        int from, int cap, int t, int stride) {
  for (int s = from + t; s < cap; s += stride) {
    keys[s] = kEmpty;
    vals[s] = 0;
  }
}

__global__ void __launch_bounds__(32 * kRowsPerBlock) range_scan_warp_rows(
    const long long* __restrict__ cand_keys,  // (B, n)
    const long long* __restrict__ cand_vals,  // (B, n)
    const long long* __restrict__ lo,         // (B,)
    const long long* __restrict__ hi,         // (B,)
    long long* __restrict__ out_keys,         // (B, cap)
    long long* __restrict__ out_vals,         // (B, cap)
    int* __restrict__ count,                  // (B,)
    unsigned char* __restrict__ truncated,    // (B,)
    int B, int n, int cap) {
  __shared__ long long match_key[kRowsPerBlock][kWarpRowMax];
  __shared__ int match_idx[kRowsPerBlock][kWarpRowMax];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int row = blockIdx.x * kRowsPerBlock + w;
  if (row >= B) return;  // the whole warp leaves together
  const long long* keys = cand_keys + (long long)row * n;
  const long long l = lo[row];
  const long long h = hi[row];
  long long* mk = match_key[w];
  int* mi = match_idx[w];
  const unsigned below = (1u << lane) - 1u;
  int m = 0;
  for (int j0 = 0; j0 < n; j0 += 32 * kUnroll) {
    long long k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + 32 * u + lane;
      k[u] = j < n ? keys[j] : kEmpty;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool hit = in_range(k[u], l, h);
      const unsigned bits = __ballot_sync(kFull, hit);
      if (hit) {
        const int p = m + __popc(bits & below);
        mk[p] = k[u];
        mi[p] = j0 + 32 * u + lane;
      }
      m += __popc(bits);
    }
  }
  __syncwarp();
  const long long* vals = cand_vals + (long long)row * n;
  long long* ok = out_keys + (long long)row * cap;
  long long* ov = out_vals + (long long)row * cap;
  for (int i = lane; i < m; i += 32) {
    const long long key = mk[i];
    int r = 0;
    for (int j = 0; j < m; ++j) {
      const long long kj = mk[j];
      r += (kj < key) | ((kj == key) & (j < i));
    }
    if (r < cap) {
      ok[r] = key;
      ov[r] = vals[mi[i]];
    }
  }
  const int emitted = m < cap ? m : cap;
  pad_row(ok, ov, emitted, cap, lane, 32);
  if (lane == 0) {
    count[row] = emitted;
    truncated[row] = m > cap ? 1 : 0;
  }
}

// Block mode, pass 1: block (row, t) bitonic-sorts tile t of the row, its
// candidates [t*T, (t+1)*T), as (key, index) pairs in shared memory (a
// non-match is (EMPTY, INT_MAX)) and writes the sorted run to the scratch.
__global__ void __launch_bounds__(kTile / 2) range_scan_sort_runs(
    const long long* __restrict__ cand_keys, const long long* __restrict__ lo,
    const long long* __restrict__ hi,
    long long* __restrict__ run_keys,  // (B, tiles*T) scratch: the sorted runs
    int* __restrict__ run_idx,         // (B, tiles*T)
    int n, int T) {
  __shared__ long long sk[kTile];
  __shared__ int si[kTile];
  const int row = blockIdx.x;
  const int t = blockIdx.y;
  const int tid = threadIdx.x;  // blockDim.x == T / 2: one pair a thread per stage
  const long long* keys = cand_keys + (long long)row * n;
  const long long l = lo[row];
  const long long h = hi[row];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = tid + half * (T / 2);
    const int j = t * T + p;
    const long long k = j < n ? keys[j] : kEmpty;
    const bool hit = in_range(k, l, h);
    sk[p] = hit ? k : kEmpty;
    si[p] = hit ? j : INT_MAX;
  }
  __syncthreads();
  for (int k = 2; k <= T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int a = 2 * j * (tid / j) + (tid % j);
      const int c = a + j;
      const bool ascending = (a & k) == 0;
      const long long ka = sk[a], kc = sk[c];
      const int ia = si[a], ic = si[c];
      if ((ka > kc || (ka == kc && ia > ic)) == ascending) {
        sk[a] = kc;
        sk[c] = ka;
        si[a] = ic;
        si[c] = ia;
      }
      __syncthreads();
    }
  }
  const long long base = ((long long)row * gridDim.y + t) * T;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = tid + half * (T / 2);
    run_keys[base + p] = sk[p];
    run_idx[base + p] = si[p];
  }
}

// Keys of run[0, T) below `key` (or not above it, with `inclusive`).
__device__ __forceinline__ int count_before(const long long* run, int T, long long key,
                                            bool inclusive) {
  int a = 0, b = T;
  while (a < b) {
    const int mid = (a + b) >> 1;
    const long long x = run[mid];
    if (inclusive ? x <= key : x < key) a = mid + 1; else b = mid;
  }
  return a;
}

// Block mode, pass 2: block (row, t) ranks the matches of run t.  Tiles are
// contiguous in candidate index, so a match's rank is its place in its own
// run, plus the keys <= its key in every earlier run and the keys < its key
// in every later run (EMPTY padding is never either: a match's key is below
// EMPTY).  The block stages each run in shared memory in turn and binary-
// searches it there.  Block t = 0 also writes the row's count, flag and
// padding; the match count is the keys below EMPTY summed over the runs.
__global__ void __launch_bounds__(kTile / 2) range_scan_rank_runs(
    const long long* __restrict__ cand_vals, long long* __restrict__ out_keys,
    long long* __restrict__ out_vals, int* __restrict__ count,
    unsigned char* __restrict__ truncated, const long long* __restrict__ run_keys,
    const int* __restrict__ run_idx, int n, int cap, int T) {
  __shared__ long long other[kTile];
  const int row = blockIdx.x;
  const int t = blockIdx.y;
  const int tiles = gridDim.y;
  const int tid = threadIdx.x;
  const long long* rk = run_keys + (long long)row * tiles * T;
  const int* ri = run_idx + (long long)row * tiles * T;
  long long key[2];
  int idx[2], r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = tid + half * (T / 2);
    key[half] = rk[(long long)t * T + p];
    idx[half] = ri[(long long)t * T + p];
    r[half] = p;
  }
  int m = 0;
  for (int u = 0; u < tiles; ++u) {
    __syncthreads();  // the previous run is read
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = tid + half * (T / 2);
      other[p] = rk[(long long)u * T + p];
    }
    __syncthreads();
    m += count_before(other, T, kEmpty, false);
    if (u == t) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (idx[half] != INT_MAX && r[half] < cap) r[half] += count_before(other, T, key[half], u < t);
    }
  }
  const long long* vals = cand_vals + (long long)row * n;
  long long* ok = out_keys + (long long)row * cap;
  long long* ov = out_vals + (long long)row * cap;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (idx[half] != INT_MAX && r[half] < cap) {
      ok[r[half]] = key[half];
      ov[r[half]] = vals[idx[half]];
    }
  }
  if (t == 0) {
    const int emitted = m < cap ? m : cap;
    pad_row(ok, ov, emitted, cap, tid, blockDim.x);
    if (tid == 0) {
      count[row] = emitted;
      truncated[row] = m > cap ? 1 : 0;
    }
  }
}

// Tile width of the block mode for rows of n candidates; 0 in warp mode.
int tile_width(int n) {
  if (n <= kWarpRowMax) return 0;
  int t = 2 * kWarpRowMax;
  while (t < n && t < kTile) t <<= 1;
  return t;
}

}  // namespace

// Pairs of the block mode's scratch a row needs (0: warp mode, no scratch).
extern "C" long long range_scan_scratch_pairs(int n) {
  const int t = tile_width(n);
  return t == 0 ? 0 : (long long)((n + t - 1) / t) * t;
}

extern "C" int range_scan_launch(
    const void* cand_keys, const void* cand_vals, const void* lo, const void* hi,
    void* out_keys, void* out_vals, void* count, void* truncated, void* run_keys,
    void* run_idx, int B, int n, int cap, void* stream) {
  if (B > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int t = tile_width(n);
    if (t == 0) {
      range_scan_warp_rows<<<(B + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
          (const long long*)cand_keys, (const long long*)cand_vals, (const long long*)lo,
          (const long long*)hi, (long long*)out_keys, (long long*)out_vals, (int*)count,
          (unsigned char*)truncated, B, n, cap);
    } else {
      const dim3 grid(B, (n + t - 1) / t);
      range_scan_sort_runs<<<grid, t / 2, 0, s>>>(
          (const long long*)cand_keys, (const long long*)lo, (const long long*)hi,
          (long long*)run_keys, (int*)run_idx, n, t);
      range_scan_rank_runs<<<grid, t / 2, 0, s>>>(
          (const long long*)cand_vals, (long long*)out_keys, (long long*)out_vals, (int*)count,
          (unsigned char*)truncated, (const long long*)run_keys, (const int*)run_idx, n, cap, t);
    }
  }
  return (int)cudaGetLastError();
}
