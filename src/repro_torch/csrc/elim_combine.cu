// Publishing-elimination combine: segmented inclusive scan of
// {absent, present(v)} transitions over key-sorted ops, int64 values
// (sm_90a).
//
// Replaces: src/repro/kernels/elim_combine/kernel.py::elim_combine_pallas
// (body _combine_kernel).  The TPU kernel runs a Hillis-Steele scan inside a
// 256-lane tile and carries the running transition from tile to tile in a
// VMEM scratch, which works only because the TPU grid visits tiles in order.
//
// What bounds it on an H100: one pass over 22 input and 18 output bytes per
// op, so bytes in principle; at a round's width (16k-64k ops per shard row)
// that is well under a microsecond of HBM time, and the sequential walk over
// tiles inside one block is what the run actually waits for.
//
// Design: one block per shard row.  A loop over tiles of blockDim ops takes
// the place of the TPU's ordered grid: each tile is scanned with warp
// shuffles (32-lane Kogge-Stone over the 5-tuple compose), then across the
// warps through shared memory, and the block's running transition (the
// inclusive transition of the previous tile's last op) is composed in front
// and carried in shared memory to the next tile.  The segment-start flag
// makes the carry drop out at every key boundary, as in the TPU kernel.
// A decoupled look-back across several blocks per row is left for later.
//
// Outputs per op, as the TPU kernel: after = T_incl(present0, val0);
// before = (present0, val0) at a segment head, else T_incl[i-1](present0,
// val0).  present0/val0 must be broadcast from each segment's head.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_INSERT = 2;
constexpr int OP_DELETE = 3;
constexpr int K_ABSENT = 0;
constexpr int K_CONST = 1;
constexpr int K_KEEP = 2;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct Tr {
  long long av;  // value of the absent leg (meaningful iff ak == K_CONST)
  long long pv;  // value of the present leg (meaningful iff pk == K_CONST)
  int ak;        // action on absent:  K_ABSENT | K_CONST
  int pk;        // action on present: K_ABSENT | K_CONST | K_KEEP
  int fl;        // 1 at segment starts
};

__device__ __forceinline__ Tr identity() { return Tr{0, 0, K_ABSENT, K_KEEP, 0}; }

// h = g o f (f first); g's segment flag discards f.  Same algebra as
// core/elimination.py compose().
__device__ __forceinline__ Tr compose(const Tr& f, const Tr& g) {
  if (g.fl) return Tr{g.av, g.pv, g.ak, g.pk, 1};
  Tr h;
  if (f.ak != K_ABSENT) {
    h.ak = g.pk == K_KEEP ? K_CONST : g.pk;
    h.av = g.pk == K_KEEP ? f.av : g.pv;
  } else {
    h.ak = g.ak;
    h.av = g.av;
  }
  if (f.pk != K_ABSENT) {
    if (g.pk == K_KEEP) {
      h.pk = f.pk == K_KEEP ? K_KEEP : K_CONST;
      h.pv = f.pv;
    } else {
      h.pk = g.pk;
      h.pv = g.pv;
    }
  } else {
    h.pk = g.ak;
    h.pv = g.av;
  }
  h.fl = f.fl;
  return h;
}

__device__ __forceinline__ Tr shfl_up(const Tr& t, int d) {
  Tr o;
  o.av = __shfl_up_sync(0xffffffffu, t.av, d);
  o.pv = __shfl_up_sync(0xffffffffu, t.pv, d);
  o.ak = __shfl_up_sync(0xffffffffu, t.ak, d);
  o.pk = __shfl_up_sync(0xffffffffu, t.pk, d);
  o.fl = __shfl_up_sync(0xffffffffu, t.fl, d);
  return o;
}

__device__ __forceinline__ Tr warp_scan(Tr t, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Tr o = shfl_up(t, d);
    if (lane >= d) t = compose(o, t);
  }
  return t;
}

__device__ __forceinline__ void apply(const Tr& t, bool p0, long long v0,
                                      bool* p, long long* v) {
  if (p0) {
    *p = t.pk != K_ABSENT;
    *v = t.pk == K_CONST ? t.pv : v0;
  } else {
    *p = t.ak != K_ABSENT;
    *v = t.ak == K_CONST ? t.av : v0;
  }
}

__global__ void __launch_bounds__(kThreads) elim_combine_kernel(
    const int* __restrict__ ops,               // (S, B)
    const long long* __restrict__ vals,        // (S, B)
    const unsigned char* __restrict__ head,    // (S, B)
    const unsigned char* __restrict__ p0,      // (S, B)
    const long long* __restrict__ v0,          // (S, B)
    unsigned char* __restrict__ before_p, long long* __restrict__ before_v,
    unsigned char* __restrict__ after_p, long long* __restrict__ after_v,
    int B) {
  __shared__ Tr warp_tot[kWarps];
  __shared__ Tr incl[kThreads];
  __shared__ Tr carry;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = (long long)blockIdx.x * B;
  if (tid == 0) carry = identity();
  __syncthreads();
  for (int start = 0; start < B; start += kThreads) {
    const int j = start + tid;
    const bool live = j < B;
    Tr t = identity();
    if (live) {
      const int op = ops[base + j];
      t.ak = op == OP_INSERT ? K_CONST : K_ABSENT;
      t.av = op == OP_INSERT ? vals[base + j] : 0;
      t.pk = op == OP_DELETE ? K_ABSENT : K_KEEP;
      t.pv = 0;
      t.fl = head[base + j] ? 1 : 0;
    }
    t = warp_scan(t, lane);
    if (lane == 31) warp_tot[warp] = t;
    __syncthreads();
    if (warp == 0) {
      Tr w = warp_tot[lane];
      w = warp_scan(w, lane);
      warp_tot[lane] = w;  // inclusive over warps 0..lane
    }
    __syncthreads();
    if (warp > 0) t = compose(warp_tot[warp - 1], t);
    const Tr c = carry;
    t = compose(c, t);
    incl[tid] = t;
    __syncthreads();
    if (live) {
      const bool pp = p0[base + j] != 0;
      const long long vv = v0[base + j];
      bool ap, bp;
      long long av, bv;
      apply(t, pp, vv, &ap, &av);
      if (head[base + j]) {
        bp = pp;
        bv = vv;
      } else {
        apply(tid > 0 ? incl[tid - 1] : c, pp, vv, &bp, &bv);
      }
      after_p[base + j] = ap ? 1 : 0;
      after_v[base + j] = av;
      before_p[base + j] = bp ? 1 : 0;
      before_v[base + j] = bv;
    }
    __syncthreads();  // all reads of carry and incl are done
    if (tid == 0) carry = incl[kThreads - 1];
    __syncthreads();
  }
}

}  // namespace

extern "C" int elim_combine_launch(
    const void* ops, const void* vals, const void* head, const void* p0,
    const void* v0, void* before_p, void* before_v, void* after_p,
    void* after_v, int S, int B, void* stream) {
  if (S > 0 && B > 0) {
    elim_combine_kernel<<<S, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)ops, (const long long*)vals, (const unsigned char*)head,
        (const unsigned char*)p0, (const long long*)v0,
        (unsigned char*)before_p, (long long*)before_v,
        (unsigned char*)after_p, (long long*)after_v, B);
  }
  return (int)cudaGetLastError();
}
