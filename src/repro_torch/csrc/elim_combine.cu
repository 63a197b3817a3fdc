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
// that is well under a microsecond of HBM time.  What a call waits for is
// the carry from tile to tile and a few dependent trips to L2 (the ticket,
// the loads, a predecessor's status): one block walking a row's tiles in
// order ran the whole round on one SM, five barriers a tile.
//
// Design: a single-pass scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA, 2016) across one block per tile of kThreads x kItems ops (128 x 4:
// the shape that measured fastest at the round's 16,384 ops and at B = 1).
// - A block takes its tile id from an atomic ticket, not blockIdx, so every
//   tile before it has started; the tiles of all S rows share one grid,
//   tile t being tile t % tiles_per_row of row t / tiles_per_row.  Rows of
//   one tile need no look-back, so such a call takes no ticket and touches
//   no scratch.
// - Each thread owns kItems consecutive ops, loaded and stored in 16-byte
//   vectors where B and the pointers allow, and composes them serially in
//   registers; a warp shuffle scan and one pass over the warp totals in
//   shared memory follow.  A transition is two int64 values and one word
//   that packs the two kinds and the segment flag (ak 1 bit, pk 2 bits,
//   fl 1 bit): five 32-bit shuffles a step.
// - Thread 0 publishes the tile's aggregate, then its inclusive prefix: the
//   values first, then a status word with release semantics (st.release.gpu);
//   a reader loads the status with acquire and then the values from L2.  A
//   tile that is a row's first, or that holds a segment head, publishes its
//   inclusive prefix at once: compose() discards everything before a head,
//   so such an aggregate equals its inclusive prefix.
// - Look-back composes the predecessors' aggregates back to the first
//   inclusive prefix, or to the first aggregate whose segment flag is set;
//   a tile whose first op is a head needs no look-back at all.  With Zipf
//   keys nearly every tile holds a head, so a look-back is about one step;
//   one key spanning every tile costs one step a tile.
// - The tile states and the two counters live in a scratch buffer that the
//   wrapper keeps per device and stream (zeroed once, when it is allocated
//   or grown).
//   Each block counts itself done on a second counter right after its
//   look-back (acq_rel, awaited only at the end), and the last one clears
//   the states and both counters for the next call: a call is one kernel
//   and no memset, and a CUDA-graph replay equals an eager call.  Calls
//   that share a scratch buffer must not overlap in time: calls on one
//   stream never do.
//
// Outputs per op, as the TPU kernel: after = T_incl(present0, val0);
// before = (present0, val0) at a segment head, else T_incl[i-1](present0,
// val0).  present0/val0 must be broadcast from each segment's head.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int OP_INSERT = 2;
constexpr int OP_DELETE = 3;
constexpr unsigned K_ABSENT = 0;
constexpr unsigned K_CONST = 1;
constexpr unsigned K_KEEP = 2;
constexpr unsigned FLAG = 8;  // kinds word: ak | pk << 1 | fl << 3
constexpr int kThreads = 128;  // a tile: kThreads x kItems ops
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned ST_AGG = 1;     // status word: state | agg kinds << 8 | prefix kinds << 16
constexpr unsigned ST_PREFIX = 2;  // (0: nothing published yet)

struct Tr {
  long long av;  // value of the absent leg (meaningful iff ak == K_CONST)
  long long pv;  // value of the present leg (meaningful iff pk == K_CONST)
  unsigned k;    // ak | pk << 1 | fl << 3
};

struct TileState {  // one tile's published aggregate and inclusive prefix
  unsigned status;
  unsigned pad;
  long long agg_av, agg_pv, pre_av, pre_pv;
};

__device__ __forceinline__ unsigned ak(unsigned k) { return k & 1u; }
__device__ __forceinline__ unsigned pk(unsigned k) { return (k >> 1) & 3u; }

__device__ __forceinline__ Tr identity() { return Tr{0, 0, K_KEEP << 1}; }

// One op lifted to a transition (find / nop: the identity).
__device__ __forceinline__ Tr lift(int op, long long val, bool head) {
  const bool ins = op == OP_INSERT;
  return Tr{ins ? val : 0, 0,
            (ins ? K_CONST : K_ABSENT) | (op == OP_DELETE ? K_ABSENT : K_KEEP) << 1 |
                (head ? FLAG : 0u)};
}

// h = g o f (f first); g's segment flag discards f.  Same algebra as
// core/elimination.py compose().
__device__ __forceinline__ Tr compose(const Tr& f, const Tr& g) {
  if (g.k & FLAG) return g;
  const unsigned gp = pk(g.k), fp = pk(f.k);
  Tr h;
  unsigned hak, hpk;
  if (ak(f.k) != K_ABSENT) {
    hak = gp == K_KEEP ? K_CONST : gp;
    h.av = gp == K_KEEP ? f.av : g.pv;
  } else {
    hak = ak(g.k);
    h.av = g.av;
  }
  if (fp != K_ABSENT) {
    if (gp == K_KEEP) {
      hpk = fp == K_KEEP ? K_KEEP : K_CONST;
      h.pv = f.pv;
    } else {
      hpk = gp;
      h.pv = g.pv;
    }
  } else {
    hpk = ak(g.k);
    h.pv = g.av;
  }
  h.k = hak | hpk << 1 | (f.k & FLAG);
  return h;
}

__device__ __forceinline__ Tr shfl_up(const Tr& t, int d) {
  return Tr{__shfl_up_sync(0xffffffffu, t.av, d), __shfl_up_sync(0xffffffffu, t.pv, d),
            __shfl_up_sync(0xffffffffu, t.k, d)};
}

__device__ __forceinline__ void apply(const Tr& t, bool p0, long long v0, unsigned char* p,
                                      long long* v) {
  const unsigned kind = p0 ? pk(t.k) : ak(t.k);
  *p = kind != K_ABSENT ? 1 : 0;
  *v = kind == K_CONST ? (p0 ? t.pv : t.av) : v0;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Thread 0 of a tile: publish the aggregate, look back, publish the
// inclusive prefix.  Returns the tile's exclusive prefix.
__device__ Tr publish_and_look_back(TileState* st, int tile, int lt, const Tr& agg,
                                    bool first_is_head) {
  TileState* me = st + tile;
  if (lt == 0 || (agg.k & FLAG)) {  // the aggregate is the inclusive prefix
    me->pre_av = agg.av;
    me->pre_pv = agg.pv;
    st_release(&me->status, ST_PREFIX | agg.k << 8 | agg.k << 16);
    if (lt == 0 || first_is_head) return identity();
  } else {
    me->agg_av = agg.av;
    me->agg_pv = agg.pv;
    st_release(&me->status, ST_AGG | agg.k << 8);
  }
  Tr acc = identity();  // tiles j+1 .. tile-1, composed
  for (int j = tile - 1;; --j) {
    unsigned w;
    while (((w = ld_acquire(&st[j].status)) & 3u) == 0) {
    }
    const bool prefix = (w & 3u) == ST_PREFIX;
    const Tr p = prefix ? Tr{__ldcg(&st[j].pre_av), __ldcg(&st[j].pre_pv), (w >> 16) & 0xffu}
                        : Tr{__ldcg(&st[j].agg_av), __ldcg(&st[j].agg_pv), (w >> 8) & 0xffu};
    acc = compose(p, acc);
    if (prefix || (p.k & FLAG)) break;
  }
  if (!(agg.k & FLAG)) {
    const Tr incl = compose(acc, agg);
    me->pre_av = incl.av;
    me->pre_pv = incl.pv;
    st_release(&me->status, ST_PREFIX | agg.k << 8 | incl.k << 16);
  }
  return acc;
}

template <int BYTES> struct Vec;
template <> struct Vec<16> { using type = int4; };
template <> struct Vec<8> { using type = int2; };
template <> struct Vec<4> { using type = int; };
template <> struct Vec<2> { using type = short; };
template <> struct Vec<1> { using type = char; };

// A thread's run of kItems consecutive elements, moved between memory and
// registers in the widest vectors that the run's bytes allow.
template <typename T>
__device__ __forceinline__ void load_run(T (&dst)[kItems], const T* src) {
  constexpr int bytes = kItems * (int)sizeof(T), vb = bytes < 16 ? bytes : 16;
  using V = typename Vec<vb>::type;
#pragma unroll
  for (int c = 0; c < bytes / vb; ++c) reinterpret_cast<V*>(dst)[c] = reinterpret_cast<const V*>(src)[c];
}

template <typename T>
__device__ __forceinline__ void store_run(T* dst, const T (&src)[kItems]) {
  constexpr int bytes = kItems * (int)sizeof(T), vb = bytes < 16 ? bytes : 16;
  using V = typename Vec<vb>::type;
#pragma unroll
  for (int c = 0; c < bytes / vb; ++c) reinterpret_cast<V*>(dst)[c] = reinterpret_cast<const V*>(src)[c];
}

struct Args {
  const int* ops;
  const long long* vals;
  const unsigned char* head;
  const unsigned char* p0;
  const long long* v0;
  unsigned char* before_p;
  long long* before_v;
  unsigned char* after_p;
  long long* after_v;
  int B, tiles_per_row, n_tiles;
  bool vec;  // B is a multiple of kItems and every pointer is 16-byte aligned
};

struct Run {  // one thread's ops: key-sorted, consecutive
  alignas(16) int op[kItems];
  alignas(16) long long val[kItems];
  alignas(16) long long v0[kItems];
  alignas(16) unsigned char head[kItems];
  alignas(16) unsigned char p0[kItems];
};

// Loads the run of tile `tile` that thread `tid` owns; ops past B are NOPs
// (the identity).  Returns the run's first index in the flat (S, B) block.
__device__ __forceinline__ long long load_tile(Run& r, const Args& a, int tile, int tid,
                                               int* first) {
  const int row = tile / a.tiles_per_row;
  const int start = (tile - row * a.tiles_per_row) * kTile + tid * kItems;
  const long long at = (long long)row * a.B + start;
  *first = start;
  if (a.vec && start < a.B) {
    load_run(r.op, a.ops + at);
    load_run(r.val, a.vals + at);
    load_run(r.head, a.head + at);
    load_run(r.p0, a.p0 + at);
    load_run(r.v0, a.v0 + at);
  } else {
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const bool live = start + u < a.B;
      r.op[u] = live ? a.ops[at + u] : 0;
      r.val[u] = live ? a.vals[at + u] : 0;
      r.head[u] = live ? a.head[at + u] : 0;
      r.p0[u] = live ? a.p0[at + u] : 0;
      r.v0[u] = live ? a.v0[at + u] : 0;
    }
  }
  return at;
}

__global__ void __launch_bounds__(kThreads) elim_combine_kernel(Args a, unsigned* counters,
                                                                  TileState* st) {
  __shared__ int s_tile;
  __shared__ Tr s_warp[kWarps];
  __shared__ Tr s_excl;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // Rows of one tile need no look-back: such a call takes no ticket,
  // publishes nothing and leaves the scratch untouched.
  const bool look_back = a.tiles_per_row > 1;
  int tile = blockIdx.x;
  if (look_back) {
    if (tid == 0) s_tile = (int)atomicAdd(counters, 1u);
    __syncthreads();
    tile = s_tile;
  }
  Run r;
  int start;
  const long long at = load_tile(r, a, tile, tid, &start);
  const int lt = tile % a.tiles_per_row;

  Tr agg = lift(r.op[0], r.val[0], r.head[0]);
#pragma unroll
  for (int u = 1; u < kItems; ++u) agg = compose(agg, lift(r.op[u], r.val[u], r.head[u]));

  Tr incl = agg;  // inclusive over the warp's threads 0..lane
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Tr o = shfl_up(incl, d);
    if (lane >= d) incl = compose(o, incl);
  }
  Tr run = shfl_up(incl, 1);  // exclusive over the warp's threads
  if (lane == 0) run = identity();
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  Tr warp_excl = identity();
  for (int w = 0; w < warp; ++w) warp_excl = compose(warp_excl, s_warp[w]);
  unsigned done = 0;  // thread 0: blocks done with their look-back before this one
  if (tid == 0) {
    s_excl = identity();
    if (look_back) {
      Tr tile_agg = s_warp[0];
      for (int w = 1; w < kWarps; ++w) tile_agg = compose(tile_agg, s_warp[w]);
      s_excl = publish_and_look_back(st, tile, lt, tile_agg, r.head[0] != 0);
      done = add_acq_rel(counters + 1, 1u);  // awaited only at the end
    }
  }
  __syncthreads();
  run = compose(compose(s_excl, warp_excl), run);

  alignas(16) unsigned char bp[kItems], ap[kItems];
  alignas(16) long long bv[kItems], av[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    if (r.head[u]) {
      bp[u] = r.p0[u] ? 1 : 0;
      bv[u] = r.v0[u];
    } else {
      apply(run, r.p0[u], r.v0[u], &bp[u], &bv[u]);
    }
    run = compose(run, lift(r.op[u], r.val[u], r.head[u]));
    apply(run, r.p0[u], r.v0[u], &ap[u], &av[u]);
  }
  if (a.vec && start < a.B) {
    store_run(a.before_p + at, bp);
    store_run(a.before_v + at, bv);
    store_run(a.after_p + at, ap);
    store_run(a.after_v + at, av);
  } else {
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (start + u < a.B) {
        a.before_p[at + u] = bp[u];
        a.before_v[at + u] = bv[u];
        a.after_p[at + u] = ap[u];
        a.after_v[at + u] = av[u];
      }
    }
  }

  // The last block done with its look-back (its reads of other tiles'
  // states, and its own publishing, come before its count) clears the tile
  // states and the counters for the next call.
  if (look_back && warp == 0) {
    if (__shfl_sync(0xffffffffu, done == (unsigned)(a.n_tiles - 1) && lane == 0, 0)) {
      for (int t = lane; t < a.n_tiles; t += 32) st[t].status = 0;
      if (lane == 0) {
        counters[0] = 0;
        counters[1] = 0;
      }
    }
  }
}

int tiles_of(int S, int B) {
  return B > 0 ? S * ((B + kTile - 1) / kTile) : 0;
}

}  // namespace

// Ops a block takes: the tile.
extern "C" int elim_combine_tile_ops() { return kTile; }

// int64 words of scratch one call over (S, B) needs: the two counters,
// then one TileState a tile.
extern "C" long long elim_combine_scratch_words(int S, int B) {
  return 1 + (long long)tiles_of(S, B) * (long long)(sizeof(TileState) / 8);
}

extern "C" int elim_combine_launch(
    const void* ops, const void* vals, const void* head, const void* p0,
    const void* v0, void* before_p, void* before_v, void* after_p,
    void* after_v, int S, int B, void* scratch, long long scratch_words, void* stream) {
  if (S > 0 && B > 0) {
    if (elim_combine_scratch_words(S, B) > scratch_words) return (int)cudaErrorInvalidValue;
    Args a{(const int*)ops, (const long long*)vals, (const unsigned char*)head,
           (const unsigned char*)p0, (const long long*)v0, (unsigned char*)before_p,
           (long long*)before_v, (unsigned char*)after_p, (long long*)after_v, B,
           (B + kTile - 1) / kTile, tiles_of(S, B), false};
    bool aligned = B % kItems == 0;
    for (const void* ptr : {ops, vals, head, p0, v0, (const void*)before_p,
                            (const void*)before_v, (const void*)after_p, (const void*)after_v})
      aligned = aligned && (uintptr_t)ptr % 16 == 0;
    a.vec = aligned;
    elim_combine_kernel<<<a.n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        a, (unsigned*)scratch, (TileState*)((long long*)scratch + 1));
  }
  return (int)cudaGetLastError();
}
