// GQA decode attention: one query token per sequence over a KV cache masked
// at a host-side kv_len, f32 online softmax (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
// (body _decode_kernel).  The TPU kernel walks the KV tiles of one
// (batch, kv head) in order on one core, carrying the online-softmax state
// of the G = H / KH query heads in VMEM scratch from grid step to grid step.
//
// What bounds it on an H100: bytes, and at the serving shapes latency.  Each
// cached key and value row below kv_len is read once and used by G query
// heads, so the work is 4·G flops a cached element against 2 or 4 bytes of
// it: far below the ~295 flops a byte where the tensor cores would become
// the limit.  At the serving shapes (B·KH = 16, kv_len ~550, 2.25 MB) the
// whole call is a few microseconds of reading, so what costs is the number
// of launches and of dependent steps inside one.
//
// Design: one launch, a thread-block cluster per (batch, kv head).  Its
// C <= 8 blocks split the first kv_len columns into contiguous ranges of
// `chunk`.  The host's cluster_plan sizes C and `chunk` so that no block is
// empty and all B·KH clusters are on the card at once: a cluster's blocks
// share one GPC, so an H100 holds 15 clusters of 8 but 17 of 6, and a 16th
// cluster of 8 would run as a second wave.  A block walks its range in tiles
// of 128 columns, in three phases with an exact softmax over the tile and an
// online one from tile to tile:
//   1. scores: two threads a column, each with half the column's K row in
//      registers from 16-byte loads (q in shared memory as f32), one shuffle
//      to add the halves, for up to 8 query rows a pass (G > 8 takes more
//      passes over the same columns; a row past G repeats row G - 1 and is
//      dropped, so every loop has a fixed trip count and unrolls);
//   2. softmax: one warp a row, the tile's max and sum with shuffles, the
//      weights back into shared memory, the row's (m, l) moved on;
//   3. weighted sum: warp w takes columns w, w + 8, ... of the tile, a lane
//      D / 32 elements of their V rows (one load each), and adds weight
//      times value into its accumulators.
// The first tile's K and V loads all go out before q is staged; the next
// tile's K loads go out after phase 1, its V loads after phase 3.  The warps'
// accumulators add up in shared memory into the block's (m, l, acc) partial
// for the G rows.  After cluster.sync() block r reads every block's partial
// of its slice of the G·D outputs through distributed shared memory (all
// reads in flight at once), rescales, divides by l and writes the output in
// q's dtype.  No global workspace, no second kernel.  Columns at or past
// kv_len are never read.  kv_len is a host int shared by every row, as in
// the reference.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;  // warps a block
constexpr int GC = 8;             // query rows a pass (one warp each in the softmax)
constexpr int TILE = 128;         // columns a tile: two threads a column for the scores
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_GROUP_WIDTH = 2048;  // G·D
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) { *out = __float2bfloat16(x); }

// `BYTES` bytes of a row, loaded as one access (2, 4, 8 or 16 bytes)
template <int BYTES>
struct Raw;
template <>
struct Raw<2> { using type = unsigned short; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<16> { using type = uint4; };

// N consecutive elements of a row, one load, as floats
template <typename T, int N>
struct Piece {
  using R = typename Raw<N * sizeof(T)>::type;
  R raw;
  __device__ __forceinline__ void load(const T* p) { raw = __ldg(reinterpret_cast<const R*>(p)); }
  __device__ __forceinline__ void zero() { memset(&raw, 0, sizeof(R)); }
  __device__ __forceinline__ void get(float (&f)[N]) const {
    T e[N];
    memcpy(e, &raw, sizeof(R));
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f(e[i]);
  }
};

// floats of dynamic shared memory for G query rows of D
template <int D>
__host__ __device__ constexpr int smem_floats(int G) {
  return 2 * G * D + 2 * G            // q; the block's partial (acc, m, l)
         + GC * TILE + 3 * GC         // a tile's scores, then weights; (m, l, alpha) of a pass
         + NW * GC * D;               // the warps' acc of a pass
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_cluster_kernel(
    const T* __restrict__ q,  // (B, H, D)
    const T* __restrict__ k,  // (B, KH, S, D)
    const T* __restrict__ v,  // (B, KH, S, D)
    T* __restrict__ out,      // (B, H, D)
    int H, int KH, int S, int G, int kv_len, int chunk, float scale_log2) {
  constexpr int KV = 16 / sizeof(T);     // elements of one 16-byte K load
  constexpr int KL = D / 2 / KV;         // K loads a thread: half a row
  constexpr int DL = D / 32;             // V elements a lane
  constexpr int VC = TILE / NW;          // V columns a warp, a tile
  extern __shared__ float smem[];
  float* qs = smem;              // G·D, q as f32
  float* bacc = qs + G * D;      // G·D   the block's partial
  float* bm = bacc + G * D;      // G
  float* bl = bm + G;            // G
  float* ps = bl + G;            // GC·TILE scores, then weights
  float* pm = ps + GC * TILE;    // GC running max of a pass's rows
  float* pl = pm + GC;           // GC running sum
  float* pa = pl + GC;           // GC rescale of the tile
  float* wacc = pa + GC;         // NW·GC·D

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_blocks = (int)cluster.num_blocks();
  const int bkh = blockIdx.y;  // b·KH + kh
  const int b = bkh / KH, kh = bkh - b * KH;
  const int c0 = rank * chunk;
  const int c1 = min(c0 + chunk, kv_len);
  const int n_tiles = (c1 - c0 + TILE - 1) / TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* kv_k = k + (long long)bkh * S * D;
  const T* kv_v = v + (long long)bkh * S * D;

  // scores: thread t takes column t / 2 of a tile and the 16-byte pieces
  // t % 2, t % 2 + 2, ... of its K row (the two threads of a column read
  // q at addresses 8 floats apart: no bank conflict)
  const int s_col = tid / 2, s_half = tid % 2;
  Piece<T, KV> kr[KL];
  auto load_k = [&](int tile) {
    const int c = c0 + tile * TILE + s_col;
#pragma unroll
    for (int i = 0; i < KL; ++i) {
      kr[i].zero();
      if (c < c1) kr[i].load(kv_k + (long long)c * D + (2 * i + s_half) * KV);
    }
  };
  // weighted sum: warp w takes columns w, w + NW, ... of a tile, lane l
  // elements l·DL .. l·DL + DL - 1 of their V rows
  Piece<T, DL> vr[VC];
  auto load_v = [&](int tile) {
#pragma unroll
    for (int i = 0; i < VC; ++i) {
      const int c = c0 + tile * TILE + warp + NW * i;
      vr[i].zero();
      if (c < c1) vr[i].load(kv_v + (long long)c * D + lane * DL);
    }
  };
  // every load of the first tile goes out before q is staged
  load_k(0);
  load_v(0);
  const T* qp = q + ((long long)b * H + (long long)kh * G) * D;
  for (int i = tid; i < G * D; i += THREADS) qs[i] = to_f(qp[i]);

  for (int g0 = 0; g0 < G; g0 += GC) {
    if (g0 > 0) {
      load_k(0);
      load_v(0);
    }
    if (tid < GC) {
      pm[tid] = -CUDART_INF_F;
      pl[tid] = 0.f;
    }
    float acc[GC][DL];
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[g][e] = 0.f;

    for (int tile = 0; tile < n_tiles; ++tile) {
      __syncthreads();  // q staged; the previous tile's weights used
      // 1. scores of the tile's columns for rows g0 .. g0+GC-1 (a row past G
      //    repeats row G - 1, so that every loop has a fixed trip count)
      {
        const bool live = c0 + tile * TILE + s_col < c1;
        float sc[GC];
#pragma unroll
        for (int g = 0; g < GC; ++g) sc[g] = 0.f;
#pragma unroll
        for (int i = 0; i < KL; ++i) {
          float kf[KV];
          kr[i].get(kf);
          const int d0 = (2 * i + s_half) * KV;
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            const float* qr = qs + min(g0 + g, G - 1) * D + d0;
#pragma unroll
            for (int e = 0; e < KV; ++e) sc[g] = fmaf(qr[e], kf[e], sc[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], 1);
          if (s_half == 0) ps[g * TILE + s_col] = live ? sc[g] * scale_log2 : -CUDART_INF_F;
        }
      }
      if (tile + 1 < n_tiles) load_k(tile + 1);
      __syncthreads();
      // 2. softmax over the tile, online across tiles: warp w owns row w
      if (warp < GC) {
        const int g = warp;
        float x[TILE / 32];
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < TILE / 32; ++i) {
          x[i] = ps[g * TILE + lane + 32 * i];
          mx = fmaxf(mx, x[i]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = pm[g];
        const float mn = fmaxf(m_old, mx);
        const float base = mn == -CUDART_INF_F ? 0.f : mn;  // no column yet: weights 0
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < TILE / 32; ++i) {
          const float p = exp2f(x[i] - base);
          ps[g * TILE + lane + 32 * i] = p;
          sum += p;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        __syncwarp();
        if (lane == 0) {
          const float alpha = exp2f(m_old - base);
          pa[g] = alpha;
          pl[g] = pl[g] * alpha + sum;
          pm[g] = mn;
        }
      }
      __syncthreads();
      // 3. acc = acc · alpha + Σ p · V over the warp's columns
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float alpha = pa[g];
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < VC; ++i) {
        float vf[DL];
        vr[i].get(vf);
        const int cc = warp + NW * i;
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float p = ps[g * TILE + cc];
#pragma unroll
          for (int e = 0; e < DL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
      if (tile + 1 < n_tiles) load_v(tile + 1);
    }

    // the warps' acc into the block's partial for rows g0 .. g0+GC-1
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < DL; ++e) wacc[(warp * GC + g) * D + lane * DL + e] = acc[g][e];
    __syncthreads();
    const int rows = min(GC, G - g0);
    for (int i = tid; i < rows * D; i += THREADS) {
      const int g = i / D, d = i - g * D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) a += wacc[(w * GC + g) * D + d];
      bacc[(g0 + g) * D + d] = a;
      if (d == 0) {
        bm[g0 + g] = pm[g];
        bl[g0 + g] = pl[g];
      }
    }
    __syncthreads();  // pm / pl / wacc are the next pass's
  }

  // every block's partial is in its shared memory: block r merges its slice
  // of the G·D outputs across the cluster through distributed shared memory
  cluster.sync();
  const int n_out = G * D;
  const int lo = (int)((long long)rank * n_out / n_blocks);
  const int hi = (int)((long long)(rank + 1) * n_out / n_blocks);
  T* op = out + ((long long)b * H + (long long)kh * G) * D;
  for (int i = lo + tid; i < hi; i += THREADS) {
    const int g = i / D;
    float mr[MAX_CLUSTER], lr[MAX_CLUSTER], ar[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {  // every remote read in flight at once
      mr[r] = -CUDART_INF_F;
      lr[r] = ar[r] = 0.f;
      if (r < n_blocks) {
        mr[r] = cluster.map_shared_rank(bm, r)[g];
        lr[r] = cluster.map_shared_rank(bl, r)[g];
        ar[r] = cluster.map_shared_rank(bacc, r)[i];
      }
    }
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) mx = fmaxf(mx, mr[r]);
    const float base = mx == -CUDART_INF_F ? 0.f : mx;
    float a = 0.f, sum = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      const float f = exp2f(mr[r] - base);
      a = fmaf(ar[r], f, a);
      sum = fmaf(lr[r], f, sum);
    }
    from_f(sum == 0.f ? 0.f : a / sum, op + i);
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// the most shared memory any call of an instance asks for (G·D <= 2048),
// above the default 48 KB at D = 128: asked for once, before any launch
template <typename T, int D>
cudaError_t prepare() {
  static const cudaError_t err = cudaFuncSetAttribute(
      decode_cluster_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * smem_floats<D>(MAX_GROUP_WIDTH / D)));
  return err;
}

struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int n_blocks, int n_clusters, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(n_blocks, n_clusters, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KH, int S,
           int kv_len, int n_blocks, int chunk, float sm_scale, cudaStream_t stream) {
  cudaError_t err = prepare<T, D>();
  if (err != cudaSuccess) return (int)err;
  const int G = H / KH;
  ClusterLaunch l(n_blocks, B * KH, sizeof(float) * smem_floats<D>(G), stream);
  err = cudaLaunchKernelEx(&l.cfg, decode_cluster_kernel<T, D>, (const T*)q, (const T*)k,
                           (const T*)v, (T*)out, H, KH, S, G, kv_len, chunk,
                           sm_scale * LOG2E);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// how many clusters of n_blocks blocks the card holds at once (a cluster's
// blocks must share one GPC: an H100 holds 132 clusters of 1 but 15 of 8)
template <typename T, int D>
int capacity(int G, int n_blocks, int* out) {
  cudaError_t err = prepare<T, D>();
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l(n_blocks, 1, sizeof(float) * smem_floats<D>(G), 0);
  return (int)cudaOccupancyMaxActiveClusters(out, (void*)decode_cluster_kernel<T, D>, &l.cfg);
}

}  // namespace

#define DECODE_DISPATCH(CALL)                  \
  if (dtype == 0) {                            \
    switch (D) {                               \
      case 32: { using T = float; CALL(32); }  \
      case 64: { using T = float; CALL(64); }  \
      case 128: { using T = float; CALL(128); } \
    }                                          \
  } else if (dtype == 1) {                     \
    switch (D) {                               \
      case 32: { using T = __nv_bfloat16; CALL(32); }  \
      case 64: { using T = __nv_bfloat16; CALL(64); }  \
      case 128: { using T = __nv_bfloat16; CALL(128); } \
    }                                          \
  }                                            \
  return (int)cudaErrorInvalidValue;

// dtype: 0 = float32, 1 = bfloat16.  The caller guarantees D in {32, 64, 128},
// H % KH == 0, (H / KH) * D <= 2048, 1 <= kv_len <= S, 1 <= n_blocks <= 8,
// (n_blocks - 1) * chunk < kv_len <= n_blocks * chunk (no empty block, every
// column covered) and contiguous, 16-byte-aligned tensors.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, void* out,
                                       int B, int H, int KH, int S, int D, int kv_len,
                                       int n_blocks, int chunk, int dtype, float sm_scale,
                                       void* stream) {
#define LAUNCH(DD)                                                               \
  return launch<T, DD>(q, k, v, out, B, H, KH, S, kv_len, n_blocks, chunk, sm_scale, \
                       (cudaStream_t)stream)
  DECODE_DISPATCH(LAUNCH)
#undef LAUNCH
}

// *out = the clusters of n_blocks blocks of the (dtype, D) instance for G
// query rows a kv head that the card holds at once
extern "C" int decode_attention_capacity(int D, int dtype, int G, int n_blocks, int* out) {
#define CAPACITY(DD) return capacity<T, DD>(G, n_blocks, out)
  DECODE_DISPATCH(CAPACITY)
#undef CAPACITY
}
