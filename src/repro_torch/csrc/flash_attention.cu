// Flash-attention forward: GQA, causal or not, sliding window, f32 online
// softmax (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _flash_kernel).  The TPU kernel runs a grid of (batch·head, q tile,
// kv tile) in order on one core and carries the online-softmax state
// (m, l, acc) of a q tile in VMEM scratch from one kv grid step to the next;
// it pads S to its tile and masks the padded key columns, and skips kv tiles
// that are wholly masked (pl.when(live)).
//
// What bounds it on an H100: operations.  A causal call does about
// 2·B·H·S²·D multiply-adds against (2·B·H + 2·B·KH)·S·D elements moved, so
// at the training shapes (S = 1,024, D = 64) it is far above the ~295 flops
// a byte where the tensor cores, and not the memory, become the limit.
//
// bf16 (the only type a model runs attention in on the card): the tensor
// cores, fed by TMA, with warp specialisation.  The work is cut into items of
// 128 query rows of one (batch, head), numbered longest first (the last q
// tile has the most kv tiles under causality).  The kernel is persistent:
// one block of 384 threads per SM walks every gridDim.x-th item, so that a
// block's loads for its next item overlap the end of its current one, and
// the causal triangle balances over the 132 SMs.  For an item, the block
// walks in a loop of its own the 128-column kv tiles its rows can see (under
// causality up to the tile of its last row, under a window from the first
// tile a row's window reaches, never past S; the TPU's pl.when(live) skip
// becomes the loop's bounds).
//   * Warpgroup 2 is the producer: it gives its registers away (setmaxnreg)
//     and one of its threads issues TMA loads.  An item's Q is loaded once,
//     into one of two buffers (the next item's Q loads while this one's is
//     in use); K and V tiles go through a ring of 2-4 stages in shared
//     memory that runs on from item to item, each with a "full" mbarrier for
//     K, one for V (so S = Q·Kᵀ starts before V lands) and an "empty" one
//     the consumers release it on.  The tensor maps are 3-D over
//     (batch·heads, S, D) with 64-element (128-byte) boxes and 128-byte
//     swizzle; rows at or past S, and columns past D (D = 32, and the
//     second box of D = 80), arrive as zeros from TMA, so no memory past the
//     tensors is ever read.
//   * Warpgroups 0 and 1 are the consumers, 64 rows each.  S = Q·Kᵀ is
//     wgmma m64n128k16 with both operands in shared memory (Q as A, K as the
//     K-major B).  The online softmax runs on the accumulator fragment in
//     registers (a thread holds two rows; a row's max is taken over the four
//     threads of a quad): scale, mask (only on tiles that cross S, the
//     diagonal or a window edge), running max and sum, in base 2 with one
//     ex2 instruction a weight.  The row's l sums the f32 weights; the
//     weights are then rounded to bf16 and fed, with no trip through shared
//     memory, as the register A operand of the second wgmma, O += P·V
//     (m64nDk16), whose B operand is V read in its row-major (kv, D) layout
//     through the descriptor's transpose bit.  A consumer issues S of tile t
//     together with O += P·V of tile t - 1 and runs the softmax of tile t
//     while that product is still on the tensor cores; only then does it
//     wait for the product, rescale O and release tile t - 1's stage.
//   * The epilogue divides by l, writes bf16, and writes 0 for a row that no
//     column reaches.
// D ∈ {32, 64, 80, 128} and any GQA group (the kv head is h / (H / KH)).
// Rounding P to bf16 costs about 2^-9 relative per weight, inside the 2-ulp
// limit the tests and chip_smoke.py hold the kernel to.
//
// float32: the CUDA-core loop of the first port (16 x 16 threads over a
// 64-row tile, f32 tiles in shared memory) stays for f32 only: TF32 wgmma
// would miss the 1e-5 limit, and no model runs attention in f32 on the card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ============================================================================
// float32: CUDA cores
// ============================================================================

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key columns per tile
constexpr int THREADS = 256;
constexpr int RPT = 4;   // score rows per thread
constexpr int CPT = 4;   // score columns per thread
constexpr int PP = BK + 1;  // padded row of the weight tile

// max / sum over the 16 lanes of a half-warp
__device__ __forceinline__ float half_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
                          (size_t)BQ * PP);
}

// One block of 256 threads owns one (64-row query tile, batch·head); thread
// (ty, tx) owns score rows 4·ty .. 4·ty+3 and columns tx + 16j of a tile and
// output columns tx + 16c of its rows.  Key rows at or past S are staged as
// zeros and masked.
template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32(
    const float* __restrict__ q,  // (B, H, S, D)
    const float* __restrict__ k,  // (B, KH, S, D)
    const float* __restrict__ v,  // (B, KH, S, D)
    float* __restrict__ out,      // (B, H, S, D)
    int H, int KH, int S, int causal, int window, float sm_scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;  // output columns per thread and row
  extern __shared__ float smem[];
  float* qs = smem;            // BQ * DP
  float* ks = qs + BQ * DP;    // BK * DP
  float* vs = ks + BK * DP;    // BK * D
  float* ps = vs + BK * D;     // BQ * PP

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_lo = qt * BQ;
  const int q_last = min(q_lo + BQ, S) - 1;  // last real row of the tile

  const float* qp = q + (long long)bh * S * D;
  const long long kv_base = ((long long)b * KH + kvh) * (long long)S * D;
  const float* kp = k + kv_base;
  const float* vp = v + kv_base;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    const int row = q_lo + r;
    qs[r * DP + c] = row < S ? qp[(long long)row * D + c] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // the key columns any row of this tile can see: [k_begin, k_end)
  int k_end = S;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int k_lo = t * BK;
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      const int col = k_lo + r;
      float kx = 0.f, vx = 0.f;
      if (col < S) {
        const long long off = (long long)col * D + c;
        kx = kp[off];
        vx = vp[off];
      }
      ks[r * DP + c] = kx;
      vs[r * D + c] = vx;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty * RPT + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
      const int row = q_lo + r;
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k_lo + tx + 16 * j;
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        s[i][j] = ok ? s[i][j] * sm_scale : -CUDART_INF_F;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = half_max(mt);
      const float m_new = fmaxf(m[i], mt);
      // no column seen yet: nothing to rescale, and every weight is 0
      const float alpha = m_new == -CUDART_INF_F ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = s[i][j] == -CUDART_INF_F ? 0.f : expf(s[i][j] - m_new);
        ps[r * PP + tx + 16 * j] = p;
        sum += p;
      }
      sum = half_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = ps[(ty * RPT + i) * PP + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += p * vv[c];
      }
    }
    __syncthreads();
  }

  float* op = out + (long long)bh * S * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q_lo + ty * RPT + i;
    if (row < S) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        op[(long long)row * D + tx + 16 * c] = l[i] == 0.f ? 0.f : acc[i][c] / l[i];
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int H, int KH,
               int S, int causal, int window, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  // above 48 KB a block's shared memory must be asked for; done once per
  // instance, before any launch (and so outside any graph capture)
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_f32<D><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, H, KH, S, causal, window,
      sm_scale);
  return (int)cudaGetLastError();
}

// ============================================================================
// bf16: wgmma + TMA, one producer and two consumer warpgroups
// ============================================================================

constexpr int TC_WG_ROWS = 64;              // query rows per consumer warpgroup
constexpr int TC_BQ = 2 * TC_WG_ROWS;       // query rows per block
constexpr int TC_BK = 128;                  // kv columns per tile
constexpr int TC_THREADS = 3 * 128;         // two consumer warpgroups, one producer
constexpr int LINE = 128;                   // bytes of one 64-wide bf16 box row
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct TcShape {
  static constexpr int R = (D + 63) / 64;          // 64-column boxes per row
  static constexpr uint32_t Q_BYTES = R * TC_BQ * LINE;  // one of two Q buffers
  static constexpr uint32_t KV_BYTES = R * TC_BK * LINE;  // one K (or V) tile
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;
  // K/V ring depth: up to 4 stages in about 200 KB of shared memory
  static constexpr int STAGES_FIT = (200 * 1024 - 2 * Q_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
  static constexpr uint32_t RING_OFF = 2 * Q_BYTES;
  static constexpr uint32_t BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
  // Q full and empty for each buffer; K full, V full and empty for each stage
  static constexpr uint32_t N_BARS = 4 + 3 * STAGES;
  // + 1,024 to align the base: the 128-byte swizzle repeats every 1,024 bytes
  static constexpr size_t SMEM = BAR_OFF + 8 * N_BARS + 1024;
};

// the kv tiles [t0, t1) that query rows [r0, r1) can see (r0 < r1 <= S)
__device__ __forceinline__ void tile_range(int r0, int r1, int S, int causal, int window,
                                           int& t0, int& t1) {
  const int k_end = causal ? min(S, r1) : S;
  const int k_begin = window > 0 ? max(0, r0 - window + 1) : 0;
  t0 = k_begin / TC_BK;
  t1 = (k_end + TC_BK - 1) / TC_BK;
}

// a work item: one 128-row q tile of one (batch, head).  Items are numbered
// longest first: item i is q tile n_qt - 1 - i / BH of batch·head i % BH,
// so that under causality every block starts on the longest tiles
struct Item {
  int bh, q_lo, q_hi, t_begin, n_tiles;
};

__device__ __forceinline__ Item item_of(int i, int BH, int n_qt, int S, int causal, int window) {
  Item w;
  w.bh = i % BH;
  w.q_lo = (n_qt - 1 - i / BH) * TC_BQ;
  w.q_hi = min(w.q_lo + TC_BQ, S);
  int t_end;
  tile_range(w.q_lo, w.q_hi, S, causal, window, w.t_begin, t_end);
  w.n_tiles = t_end - w.t_begin;
  return w;
}

// 2^x in one instruction (exp2f adds a few to keep denormal results, which a
// softmax weight below 2^-126 next to a weight of 1 does not need)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_fwd_tc(
    const __grid_constant__ CUtensorMap tm_q,  // (B·H, S, D)
    const __grid_constant__ CUtensorMap tm_k,  // (B·KH, S, D)
    const __grid_constant__ CUtensorMap tm_v,  // (B·KH, S, D)
    __nv_bfloat16* __restrict__ out,           // (B, H, S, D)
    int H, int KH, int S, int BH, int n_qt, int causal, int window, float scale_log2) {
  using Sh = TcShape<D>;
  constexpr int R = Sh::R, STAGES = Sh::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + Sh::BAR_OFF;
  auto q_buf = [&](int qb) { return base + qb * Sh::Q_BYTES; };
  auto k_tile = [&](int s) { return base + Sh::RING_OFF + s * Sh::STAGE_BYTES; };
  auto v_tile = [&](int s) { return k_tile(s) + Sh::KV_BYTES; };
  auto q_full = [&](int qb) { return bars + 8 * qb; };
  auto q_empty = [&](int qb) { return bars + 8 * (2 + qb); };
  auto full_k = [&](int s) { return bars + 8 * (4 + s); };
  auto full_v = [&](int s) { return bars + 8 * (4 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (4 + 2 * STAGES + s); };
  const int n_items = BH * n_qt;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      hopper::mbar_init(q_full(qb), 1);
      hopper::mbar_init(q_empty(qb), 8);  // one arrival from each consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full_k(s), 1);
      hopper::mbar_init(full_v(s), 1);
      hopper::mbar_init(empty(s), 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // Both roles walk the same items, this block's every gridDim.x-th, and
  // count the kv tiles they have passed (`ring`): tile `ring` sits in stage
  // ring % STAGES, in its (ring / STAGES)-th use; the n-th item's Q in
  // buffer n % 2, in its (n / 2)-th use.
  if (wg == 2) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int ring = 0;
      for (int i = blockIdx.x, n = 0; i < n_items; i += gridDim.x, ++n) {
        const Item w = item_of(i, BH, n_qt, S, causal, window);
        const int b = w.bh / H, h = w.bh - b * H;
        const int kv_idx = b * KH + h / (H / KH);
        const int qb = n & 1;
        hopper::mbar_wait(q_empty(qb), ((n >> 1) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(q_full(qb), Sh::Q_BYTES);
        for (int r = 0; r < R; ++r)
          hopper::tma_load_3d(q_buf(qb) + r * TC_BQ * LINE, &tm_q, q_full(qb), 64 * r, w.q_lo,
                              w.bh);
        for (int it = 0; it < w.n_tiles; ++it, ++ring) {
          const int s = ring % STAGES;
          hopper::mbar_wait(empty(s), ((ring / STAGES) & 1) ^ 1);
          const int k_lo = (w.t_begin + it) * TC_BK;
          hopper::mbar_arrive_expect_tx(full_k(s), Sh::KV_BYTES);
          for (int r = 0; r < R; ++r)
            hopper::tma_load_3d(k_tile(s) + r * TC_BK * LINE, &tm_k, full_k(s), 64 * r, k_lo,
                                kv_idx);
          hopper::mbar_arrive_expect_tx(full_v(s), Sh::KV_BYTES);
          for (int r = 0; r < R; ++r)
            hopper::tma_load_3d(v_tile(s) + r * TC_BK * LINE, &tm_v, full_v(s), 64 * r, k_lo,
                                kv_idx);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    constexpr int NK = D / 16;   // k16 steps of Q·Kᵀ
    constexpr int NO = D / 2;    // O accumulators a thread
    constexpr int NS = TC_BK / 2;  // S accumulators a thread
    const int warp = tid / 32, lane = tid % 32;
    const int col_off = 2 * (lane % 4);
    int ring = 0;
    for (int i = blockIdx.x, n = 0; i < n_items; i += gridDim.x, ++n) {
      const Item w = item_of(i, BH, n_qt, S, causal, window);
      const int qb = n & 1;
      const int wg_lo = w.q_lo + wg * TC_WG_ROWS;       // first row of this warpgroup
      const int wg_hi = min(wg_lo + TC_WG_ROWS, S);     // one past its last real row
      const bool has_rows = wg_lo < S;
      int wt0 = 0, wt1 = 0;
      if (has_rows) tile_range(wg_lo, wg_hi, S, causal, window, wt0, wt1);
      const int row_a = wg_lo + warp * 16 + lane / 4;  // this thread's rows: row_a, row_a + 8
      const int row_b = row_a + 8;

      float o[NO];
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] = 0.f;
      float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F;  // running max, scaled to base 2
      float l_a = 0.f, l_b = 0.f;                      // this thread's part of the row sums

      const uint32_t q_wg = q_buf(qb) + wg * TC_WG_ROWS * LINE;
      // tile it of the item is the block's tile ring + it
      auto wait_k = [&](int it) {
        hopper::mbar_wait(full_k((ring + it) % STAGES), ((ring + it) / STAGES) & 1);
      };
      auto wait_v = [&](int it) {
        hopper::mbar_wait(full_v((ring + it) % STAGES), ((ring + it) / STAGES) & 1);
      };
      auto release = [&](int it) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty((ring + it) % STAGES));
      };
      // S = Q · Kᵀ of tile it, issued and committed, not waited for (the
      // first k step overwrites sc: its old values are never read)
      auto issue_s = [&](float (&sc)[NS], int it) {
        const uint32_t kt = k_tile((ring + it) % STAGES);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into the box row
          const uint64_t da = hopper::desc_sw128(q_wg + (kk / 4) * TC_BQ * LINE + off, 16);
          const uint64_t db = hopper::desc_sw128(kt + (kk / 4) * TC_BK * LINE + off, 16);
          hopper::SS<TC_BK>::mma(sc, da, db, kk > 0);
        }
        hopper::wgmma_commit();
      };
      // O += P · V of tile it, issued and committed, not waited for
      uint32_t pa[TC_BK / 16][4];
      auto issue_pv = [&](int it) {
        const uint32_t vt = v_tile((ring + it) % STAGES);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk)
          hopper::RS<D>::mma(o, pa[kk], hopper::desc_sw128(vt + kk * 16 * LINE, TC_BK * LINE));
        hopper::wgmma_commit();
      };
      // online softmax of tile it's scores, in place: weights in sc, (m, l)
      // moved on, the factors O must be rescaled by in alpha
      auto softmax = [&](float (&sc)[NS], int it, float& alpha_a, float& alpha_b) {
        // mask only where the tile crosses S, the diagonal or a window edge
        const int k_lo = (w.t_begin + it) * TC_BK;
        const bool need_mask = k_lo + TC_BK > S || (causal && k_lo + TC_BK - 1 > wg_lo) ||
                               (window > 0 && k_lo <= wg_hi - 1 - window);
        if (need_mask) {
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const int col = k_lo + 8 * (j / 4) + col_off + (j & 1);
            const int row = (j & 2) ? row_b : row_a;
            bool ok = col < S;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && col > row - window;
            if (!ok) sc[j] = -CUDART_INF_F;
          }
        }
        float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int o_ = 1; o_ < 4; o_ <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
        }
        const float mn_a = fmaxf(m_a, mx_a * scale_log2);
        const float mn_b = fmaxf(m_b, mx_b * scale_log2);
        // a row with no column seen yet keeps weight 0 everywhere
        const float base_a = mn_a == -CUDART_INF_F ? 0.f : mn_a;
        const float base_b = mn_b == -CUDART_INF_F ? 0.f : mn_b;
        alpha_a = ex2(m_a - base_a);
        alpha_b = ex2(m_b - base_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
          sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -base_a));
          sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -base_a));
          sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -base_b));
          sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -base_b));
          sum_a += sc[4 * j] + sc[4 * j + 1];
          sum_b += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l_a = l_a * alpha_a + sum_a;  // the f32 weights, not the rounded ones
        l_b = l_b * alpha_b + sum_b;
      };
      // rescale O, and the weights into the A fragment of P · V: the
      // accumulator's layout is the fragment's, columns 16kk .. 16kk+15 of
      // the tile being sc[8kk .. 8kk+7]
      auto rescale_pack = [&](const float (&sc)[NS], float alpha_a, float alpha_b) {
#pragma unroll
        for (int j = 0; j < NO / 4; ++j) {
          o[4 * j] *= alpha_a;
          o[4 * j + 1] *= alpha_a;
          o[4 * j + 2] *= alpha_b;
          o[4 * j + 3] *= alpha_b;
        }
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
      };

      hopper::mbar_wait(q_full(qb), (n >> 1) & 1);
      // tiles only the other warpgroup sees are waited for all the same, so
      // that a stage is released only once its loads have landed
      const int it0 = has_rows ? wt0 - w.t_begin : w.n_tiles;
      const int it1 = has_rows ? wt1 - w.t_begin : w.n_tiles;
      for (int it = 0; it < it0; ++it) {
        wait_k(it);
        wait_v(it);
        release(it);
      }
      if (it0 < it1) {
        // the first tile alone; then each step issues S of tile it and
        // O += P·V of tile it - 1 together, runs the softmax of tile it while
        // the product of tile it - 1 is still on the tensor cores, and only
        // then waits for it, rescales O and packs the new weights
        float sc[NS];
        float alpha_a, alpha_b;
        wait_k(it0);
        issue_s(sc, it0);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        softmax(sc, it0, alpha_a, alpha_b);
        rescale_pack(sc, alpha_a, alpha_b);
        for (int it = it0 + 1; it < it1; ++it) {
          wait_k(it);
          issue_s(sc, it);
          wait_v(it - 1);
          issue_pv(it - 1);
          hopper::wgmma_wait<1>();  // S of tile it
          hopper::fence_regs(sc);
          softmax(sc, it, alpha_a, alpha_b);
          hopper::wgmma_wait<0>();  // P·V of tile it - 1
          hopper::fence_regs(o);
          release(it - 1);
          rescale_pack(sc, alpha_a, alpha_b);
        }
        wait_v(it1 - 1);
        issue_pv(it1 - 1);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        release(it1 - 1);
      }
      for (int it = it1; it < w.n_tiles; ++it) {
        wait_k(it);
        wait_v(it);
        release(it);
      }
      // Q is read by no wgmma of this item any more: the producer may load
      // the item after next into its buffer
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(q_empty(qb));
      ring += w.n_tiles;

      if (has_rows) {
#pragma unroll
        for (int o_ = 1; o_ < 4; o_ <<= 1) {
          l_a += __shfl_xor_sync(0xffffffffu, l_a, o_);
          l_b += __shfl_xor_sync(0xffffffffu, l_b, o_);
        }
        const float inv_a = l_a == 0.f ? 0.f : 1.f / l_a;
        const float inv_b = l_b == 0.f ? 0.f : 1.f / l_b;
        __nv_bfloat16* op = out + (long long)w.bh * S * D;
#pragma unroll
        for (int j = 0; j < NO / 4; ++j) {
          const int col = 8 * j + col_off;
          if (row_a < S)
            *reinterpret_cast<uint32_t*>(op + (long long)row_a * D + col) =
                pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
          if (row_b < S)
            *reinterpret_cast<uint32_t*>(op + (long long)row_b * D + col) =
                pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so that the library links against nothing new
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// a 3-D map over (outer, S, D) bf16 with boxes of 64 columns x `box_rows`
// rows x 1, 128-byte swizzle, zeros outside the tensor
bool make_map(CUtensorMap* map, const void* ptr, int outer, int S, int D, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B, int H, int KH,
              int S, int causal, int window, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = TcShape<D>::SMEM;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  // persistent: one block per SM, each walking every gridDim.x-th item
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B * H, S, D, TC_BQ) || !make_map(&tk, k, B * KH, S, D, TC_BK) ||
      !make_map(&tv, v, B * KH, S, D, TC_BK))
    return (int)cudaErrorInvalidValue;
  const int n_qt = (S + TC_BQ - 1) / TC_BQ;
  const int grid = min(B * H * n_qt, n_sm);
  flash_fwd_tc<D><<<grid, TC_THREADS, smem, stream>>>(tq, tk, tv, (__nv_bfloat16*)out, H, KH, S,
                                                      B * H, n_qt, causal, window,
                                                      sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  The caller
// guarantees D in {32, 64, 80, 128}, H % KH == 0, S >= 1, window >= 0
// (0 = no window) and contiguous, 16-byte-aligned (B, H, S, D) /
// (B, KH, S, D) tensors of that dtype.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int H, int KH, int S, int D,
                                      int causal, int window, int dtype, float sm_scale,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_f32<32>(q, k, v, out, B, H, KH, S, causal, window, sm_scale, st);
      case 64: return launch_f32<64>(q, k, v, out, B, H, KH, S, causal, window, sm_scale, st);
      case 80: return launch_f32<80>(q, k, v, out, B, H, KH, S, causal, window, sm_scale, st);
      case 128: return launch_f32<128>(q, k, v, out, B, H, KH, S, causal, window, sm_scale, st);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return launch_tc<32>(q, k, v, out, B, H, KH, S, causal, window, sm_scale, st);
      case 64: return launch_tc<64>(q, k, v, out, B, H, KH, S, causal, window, sm_scale, st);
      case 80: return launch_tc<80>(q, k, v, out, B, H, KH, S, causal, window, sm_scale, st);
      case 128: return launch_tc<128>(q, k, v, out, B, H, KH, S, causal, window, sm_scale, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
