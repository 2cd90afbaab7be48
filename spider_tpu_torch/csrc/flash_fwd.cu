// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C entry point (loaded with ctypes by spider_tpu_torch/ops/attention.py).
//
// Replaces the TPU kernel spider_tpu/ops/attention.py::_flash_kernel (driven
// by _flash_forward). It computes the same function: blocked online-softmax
// attention with grouped-query heads, an optional causal mask, per-batch
// kv_len and q_offset, fp32 softmax state and accumulation, and the row
// logsumexp.
//
//   q [B, T, Hq, D], k/v [B, S, Hkv, D]  (contiguous, bf16 or fp32)
//   o [B, T, Hq, D] in q's dtype, lse [B, Hq, T] fp32
//   kv_len [B], q_offset [B] int32 on the device
//
// Key position s of batch b is live when s < kv_len[b] and, if causal,
// s <= t + q_offset[b] for query row t.
//
// What bounds it on an H100: at the shapes this port runs (the 8B prefill,
// T ~ 1.5k, D = 128; the SD-1.5 level-0 self-attention, T = S = 4096,
// D = 40) the work is 4*B*H*T*S*D FLOPs against (2T + 2S)*H*D*2 bytes, about
// 2000 FLOP/byte at SD level 0 -- far above the card's ~295 FLOP/byte ridge,
// so it is bound by the tensor cores, not by HBM.
//
// Two kernels compute it; ops/attention.py::flash_route names the one a call
// takes, by dtype and head dim alone.
//
// "wgmma" (spider_flash_fwd_wgmma; bf16, D a multiple of 8), the Hopper form:
//  * A work item is (128 query rows, q head, batch). One persistent block
//    per SM takes items w, 2G - 1 - w, 2G + w, ... (G blocks): two consumer
//    warpgroups of 64 rows each and one producer warpgroup that hands most of
//    its registers to them (setmaxnreg) and whose first thread issues every
//    load. Items are
//    numbered with the q tile slowest and, under a causal mask, descending:
//    the heavy tiles start first, every block gets a like mix of heavy and
//    light ones, and neighbouring blocks share a KV head's tiles in L2. The
//    producer runs ahead into the next item (Q has a ring of 2), so an
//    item's epilogue and the next one's first loads overlap: short items
//    (S = 1 or 77, T = 128) no longer pay a block's start-up each.
//  * Loads are TMA boxes of 64 columns x 128 rows under the 128-byte swizzle
//    (hopper.cuh), from 4-d tensor maps (D, H, T or S, B) passed as
//    __grid_constant__ arguments; what a box reads past T, S or D arrives as
//    zeros, so D = 16, 40 or 80 is padded in shared memory only. K and V
//    tiles of 128 keys (32 where S <= 32: one-key cross-attention) go through
//    a ring of 2 (D > 64) or 4 stages with a full and an empty mbarrier each,
//    so the loads of the next tiles run under the products of this one and no
//    __syncthreads is left in the loop.
//  * S = Q K^T is wgmma m64n128k16 (n32 on the short tile) with both
//    operands from shared memory, one k-step per 16 of D (three at D = 40,
//    not four). O += P V takes P
//    from registers (the accumulator fragment of S, rounded to bf16, is the
//    A operand) and V from shared memory as it lies, [keys][D], in the
//    instruction's transposed-B form; its width is D rounded up to 16. fp32
//    accumulation. While one warpgroup is in its softmax the other's
//    products keep the tensor cores busy.
//  * Online softmax in fp32 registers in the log2 domain: the logits are
//    scaled by sm_scale * log2(e) once and exp2 is the bare instruction.
//    Masks are applied only on tiles that cross kv_len, S or the diagonal.
//  * KV tiles entirely past kv_len, or entirely above the causal diagonal of
//    the block's q tile, are skipped.
//
// "mma" (spider_flash_fwd), the general form, takes what the other does not:
// fp32 inputs and head dims that are no multiple of 8.
//  * One thread block of 4 warps per (q tile of 64 rows, q head, batch).
//    Each warp owns 16 query rows. GQA maps q head h to kv head
//    h / (Hq / Hkv). A loop inside the block walks the KV tiles of 64 keys
//    (on the TPU the sequential grid axis did this).
//  * Q, K and V tiles are staged in shared memory as bf16, zero-filled past
//    the ragged T/S edges and from D up to DP, the next multiple of 16 (the
//    depth of one mma). fp32 inputs are rounded to bf16 there: the tensor
//    cores take bf16 operands; softmax and accumulation stay fp32.
//  * S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 in, fp32 out).
//    P stays in registers: the accumulator layout of S is exactly the
//    A-operand layout of P V, so P never touches shared memory.
//  * Online softmax in fp32 registers; each thread holds two rows and the
//    row max is reduced across the 4 threads of a quad with shuffles.
//  * KV tiles entirely past kv_len, or entirely above the causal diagonal of
//    the q tile, are skipped.
//
// Rows with no live key, both forms: masked (in-range) keys take a finite
// mask value (-0.7 * FLT_MAX; the wgmma form holds it in the log2 domain);
// keys past S are out of range and take -inf. Such a row therefore returns
// the mean of V over the keys of the tiles its block visited (at least the
// first tile), with a finite lse; mha_reference_with_lse gives -inf there
// instead. The two forms visit tiles of other widths (128 or 32 keys, and
// 64), so on such rows they differ from each other too: compare live rows
// only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b for one 16x8x16 tile (A row-major 16x16, B column-major 16x8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage rows [row0, row0 + 64) of one head into dst [64][LD] as bf16; rows
// past n_rows and columns past D are zero.
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const T* src, int row0,
                                          int n_rows, int64_t row_stride, int D) {
  for (int i = threadIdx.x; i < 64 * DP; i += NTHREADS) {
    const int r = i / DP;
    const int c = i % DP;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < n_rows && c < D) x = to_float(src[(int64_t)gr * row_stride + c]);
    dst[r * LD + c] = __float2bfloat16(x);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse,
                 const int* __restrict__ kv_len, const int* __restrict__ q_offset,
                 int T_len, int S, int Hq, int Hkv, int D, float sm_scale, int causal) {
  constexpr int LD = DP + 8;  // row pitch in bf16; the +8 spreads rows over banks
  constexpr int NT_S = BK / 8;  // 8-key column tiles of S
  constexpr int NT_O = DP / 8;  // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LD;
  __nv_bfloat16* sV = sK + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the mma tile
  const int t = lane % 4;  // column pair within the mma tile

  const int live = max(0, min(kv_len[b], S));
  const int qoff = q_offset[b];
  int kv_hi = live;
  if (causal) kv_hi = min(kv_hi, min(q0 + BQ, T_len) + qoff);
  const int n_tiles = max(1, (kv_hi + BK - 1) / BK);

  const T* qb = q + ((int64_t)b * T_len * Hq + h) * D;
  const T* kb = k + ((int64_t)b * S * Hkv + hk) * D;
  const T* vb = v + ((int64_t)b * S * Hkv + hk) * D;
  load_tile<T, DP, LD>(sQ, qb, q0, T_len, (int64_t)Hq * D, D);

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int qpos0 = q0 + r0 + qoff;
  const int qpos1 = qpos0 + 8;

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, DP, LD>(sK, kb, k0, S, (int64_t)Hkv * D, D);
    load_tile<T, DP, LD>(sV, vb, k0, S, (int64_t)Hkv * D, D);
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const __nv_bfloat16* qr = sQ + r0 * LD + kk * 16 + 2 * t;
      uint32_t a[4];
      a[0] = load_u32(qr);
      a[1] = load_u32(qr + 8 * LD);
      a[2] = load_u32(qr + 8);
      a[3] = load_u32(qr + 8 * LD + 8);
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const __nv_bfloat16* kr = sK + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[j], a, load_u32(kr), load_u32(kr + 8));
      }
    }

    // ---- scale, mask, and the online-softmax update.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const int qpos = (e < 2) ? qpos0 : qpos1;
        float x = s[j][e] * sm_scale;
        if (kpos >= S) {
          x = -INFINITY;
        } else if (kpos >= live || (causal && qpos < kpos)) {
          x = MASK_VALUE;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - m[e >> 1]) * LOG2E);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }

    // ---- O += P V. Two adjacent 8-key S tiles form one 16-deep A operand.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vr = sV + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const __nv_bfloat16* vp = vr + n * 8;
        const uint32_t b0 = pack_bf16(vp[0], vp[LD]);
        const uint32_t b1 = pack_bf16(vp[8 * LD], vp[9 * LD]);
        mma_bf16(acc[n], a, b0, b1);
      }
    }
  }

  // ---- epilogue: normalise, drop the D padding and the ragged rows.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);  // >= 1: the row max contributes exp(0)
    inv[r] = 1.f / l[r];
  }
  const int row0 = q0 + r0;
  const int row1 = row0 + 8;
  T* ob = o + ((int64_t)b * T_len * Hq + h) * D;
  const int64_t o_stride = (int64_t)Hq * D;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * t + (e & 1);
      const int row = (e < 2) ? row0 : row1;
      if (row < T_len && col < D) store_out(ob + row * o_stride + col, acc[n][e] * inv[e >> 1]);
    }
  }
  if (t == 0) {
    float* lb = lse + ((int64_t)b * Hq + h) * T_len;
    if (row0 < T_len) lb[row0] = m[0] + logf(l[0]);
    if (row1 < T_len) lb[row1] = m[1] + logf(l[1]);
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   const void* kv_len, const void* q_offset, int B, int T_len, int S, int Hq,
                   int Hkv, int D, float sm_scale, int causal, cudaStream_t stream) {
  constexpr int LD = DP + 8;
  const size_t smem = (size_t)(BQ + 2 * BK) * LD * sizeof(__nv_bfloat16);
  auto kernel = flash_fwd_kernel<T, DP>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((T_len + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<const int*>(kv_len),
      static_cast<const int*>(q_offset), T_len, S, Hq, Hkv, D, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, void* o, void* lse,
                         const void* kv_len, const void* q_offset, int B, int T_len, int S,
                         int Hq, int Hkv, int D, float sm_scale, int causal,
                         cudaStream_t stream) {
#define SPIDER_FLASH_CASE(DP_)                                                          \
  case DP_ / 16:                                                                        \
    return launch<T, DP_>(q, k, v, o, lse, kv_len, q_offset, B, T_len, S, Hq, Hkv, D, \
                          sm_scale, causal, stream);
  switch ((D + 15) / 16) {
    SPIDER_FLASH_CASE(16)
    SPIDER_FLASH_CASE(32)
    SPIDER_FLASH_CASE(48)
    SPIDER_FLASH_CASE(64)
    SPIDER_FLASH_CASE(80)
    SPIDER_FLASH_CASE(96)
    SPIDER_FLASH_CASE(112)
    SPIDER_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef SPIDER_FLASH_CASE
}

// ---------------------------------------------------------------------------
// The wgmma form
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int BQ = 128;                        // query rows a block: 64 a consumer warpgroup
// Keys a tile (the template parameter BK): 128, or 32 where the whole of S
// fits (AudioLDM's one-key cross-attention), which spares the softmax of
// three quarters of an empty tile.
constexpr int NTHREADS = 384;                  // two consumer warpgroups and the producer's
constexpr int CONSUMER_WARPS = 8;
constexpr int TILE_BYTES = BQ * ROW_BYTES;     // one box of Q: 128 rows of 64 bf16
constexpr float LN2 = 0.6931471805599453f;

template <int DP, int BK>
struct Cfg {
  static constexpr int NBOX = (DP + BOX_COLS - 1) / BOX_COLS;
  static constexpr int STAGES = NBOX == 1 ? 4 : 2;  // K/V ring
  static constexpr int QSTAGES = 2;                 // Q ring: the next work item's Q
  static constexpr int Q_BYTES = NBOX * TILE_BYTES;
  static constexpr int KV_TILE_BYTES = BK * ROW_BYTES;          // one box of K or V
  static constexpr int STAGE_BYTES = 2 * NBOX * KV_TILE_BYTES;  // K boxes, then V boxes
  // + 1024 to align the tiles, + 128 for the barriers
  static constexpr int SMEM = QSTAGES * Q_BYTES + STAGES * STAGE_BYTES + 1024 + 128;
};

template <int DP, int BK>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, const int* __restrict__ kv_len,
                       const int* __restrict__ q_offset, int B, int T_len, int S, int Hq,
                       int Hkv, int D, float scale_log2, int causal, int n_q_tiles) {
  using C = Cfg<DP, BK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + C::QSTAGES * C::Q_BYTES;
  const uint32_t bar_q_full = sKV + C::STAGES * C::STAGE_BYTES;
  const uint32_t bar_q_empty = bar_q_full + 8 * C::QSTAGES;
  const uint32_t bar_full = bar_q_empty + 8 * C::QSTAGES;
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;
  const int n_items = n_q_tiles * Hq * B;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::QSTAGES; ++i) {
      mbar_init(bar_q_full + 8 * i, 1);
      mbar_init(bar_q_empty + 8 * i, CONSUMER_WARPS);
    }
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wgid = threadIdx.x / 128;
  if (wgid == 2) {
    // ---- producer: one thread keeps both rings full, running ahead of the
    // consumers into the next work items.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int kv_count = 0;  // K/V tiles issued so far, over all items
      int local = 0;     // items issued so far
      int next_len = kv_len[item_batch(blockIdx.x, B, Hq)];
      int next_off = q_offset[item_batch(blockIdx.x, B, Hq)];
      for (int item = blockIdx.x; item < n_items; item = item_of_round(++local)) {
        const Item w = decode_item<BQ, BK, 1>(item, n_q_tiles, B, T_len, S, Hq, Hkv, causal,
                                              next_len, next_off);
        if (item_of_round(local + 1) < n_items) {
          next_len = kv_len[item_batch(item_of_round(local + 1), B, Hq)];
          next_off = q_offset[item_batch(item_of_round(local + 1), B, Hq)];
        }
        const int qs = local % C::QSTAGES;
        const int q_round = local / C::QSTAGES;
        if (q_round > 0) mbar_wait(bar_q_empty + 8 * qs, (q_round - 1) & 1);
        mbar_arrive_expect_tx(bar_q_full + 8 * qs, C::Q_BYTES);
        for (int box = 0; box < C::NBOX; ++box)
          tma_load_4d(sQ + qs * C::Q_BYTES + box * TILE_BYTES, &map_q, bar_q_full + 8 * qs,
                      box * BOX_COLS, w.h, w.q0, w.b);
        for (int it = 0; it < w.n_tiles; ++it, ++kv_count) {
          const int stage = kv_count % C::STAGES;
          const int round = kv_count / C::STAGES;
          if (round > 0) mbar_wait(bar_empty + 8 * stage, (round - 1) & 1);
          const uint32_t full = bar_full + 8 * stage;
          const uint32_t dst = sKV + stage * C::STAGE_BYTES;
          mbar_arrive_expect_tx(full, C::STAGE_BYTES);
          for (int box = 0; box < C::NBOX; ++box) {
            tma_load_4d(dst + box * C::KV_TILE_BYTES, &map_k, full, box * BOX_COLS, w.hk,
                        it * BK, w.b);
            tma_load_4d(dst + (C::NBOX + box) * C::KV_TILE_BYTES, &map_v, full,
                        box * BOX_COLS, w.hk, it * BK, w.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup, 16 a warp, two a thread.
    setmaxnreg_inc<240>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;  // row within the warp's 16
    const int t = lane % 4;  // column pair within each 8 columns
    const int r0 = wgid * 64 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
    int kv_count = 0;
    int local = 0;
    int next_len = kv_len[item_batch(blockIdx.x, B, Hq)];
    int next_off = q_offset[item_batch(blockIdx.x, B, Hq)];
    for (int item = blockIdx.x; item < n_items; item = item_of_round(++local)) {
      const Item w = decode_item<BQ, BK, 1>(item, n_q_tiles, B, T_len, S, Hq, Hkv, causal,
                                            next_len, next_off);
      if (item_of_round(local + 1) < n_items) {
        next_len = kv_len[item_batch(item_of_round(local + 1), B, Hq)];
        next_off = q_offset[item_batch(item_of_round(local + 1), B, Hq)];
      }
      const int qs = local % C::QSTAGES;
      const int qpos0 = w.q0 + r0 + w.qoff;
      const int wg_qpos_min = w.q0 + wgid * 64 + w.qoff;
      const uint32_t sQw = sQ + qs * C::Q_BYTES + wgid * 64 * ROW_BYTES;

      float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
      float l[2] = {0.f, 0.f};
      float acc[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

      mbar_wait(bar_q_full + 8 * qs, (local / C::QSTAGES) & 1);
      for (int it = 0; it < w.n_tiles; ++it, ++kv_count) {
        const int stage = kv_count % C::STAGES;
        const int k0 = it * BK;
        const uint32_t sK = sKV + stage * C::STAGE_BYTES;
        const uint32_t sV = sK + C::NBOX * C::KV_TILE_BYTES;
        mbar_wait(bar_full + 8 * stage, (kv_count / C::STAGES) & 1);

        // ---- S = Q K^T: 64 rows x BK keys, one k-step per 16 of D.
        float s[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wgmma_ss<BK>(s, smem_desc(sQw + (kk / 4) * TILE_BYTES + (kk % 4) * 32, 16, GROUP_BYTES),
                       smem_desc(sK + (kk / 4) * C::KV_TILE_BYTES + (kk % 4) * 32, 16,
                                 GROUP_BYTES),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // ---- scale into the log2 domain, mask the tiles that need it.
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] *= scale_log2;
        if (k0 + BK > w.live || (causal && wg_qpos_min < k0 + BK - 1)) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int kpos = k0 + (i / 4) * 8 + 2 * t + (i & 1);
            const int qpos = qpos0 + ((i & 2) ? 8 : 0);
            if (kpos >= S) {
              s[i] = -INFINITY;
            } else if (kpos >= w.live || (causal && qpos < kpos)) {
              s[i] = MASK_VALUE;
            }
          }
        }

        // ---- online softmax.
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = quad_max(mx[r]);
          alpha[r] = fast_exp2(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const float p = fast_exp2(s[i] - m[(i >> 1) & 1]);
          s[i] = p;
          l[(i >> 1) & 1] += p;
        }
        uint32_t pa[BK / 16][4];  // P as the A operand of each k-step
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(pa[kk], s, kk);
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

        // ---- O += P V, V as it lies: [keys][D], the transposed-B form.
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<DP>(acc, pa[kk],
                       smem_desc(sV + kk * 16 * ROW_BYTES, C::KV_TILE_BYTES, GROUP_BYTES), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(pa[kk][e]));  // live until here
        }
        if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
      }
      if (lane == 0) mbar_arrive(bar_q_empty + 8 * qs);  // this item's Q is read

      // ---- epilogue: normalise, drop the D padding and the ragged rows. The
      // producer is already loading the next item.
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);  // >= 1: the row max contributes exp2(0)
        inv[r] = 1.f / l[r];
      }
      const int row0 = w.q0 + r0;
      const int row1 = row0 + 8;
      const int64_t o_stride = (int64_t)Hq * D;
      __nv_bfloat16* ob = o + ((int64_t)w.b * T_len * Hq + w.h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = j * 8 + 2 * t;
        if (col < D) {  // D is a multiple of 8: col + 1 < D too
          if (row0 < T_len)
            *reinterpret_cast<__nv_bfloat162*>(ob + row0 * o_stride + col) =
                __floats2bfloat162_rn(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
          if (row1 < T_len)
            *reinterpret_cast<__nv_bfloat162*>(ob + row1 * o_stride + col) =
                __floats2bfloat162_rn(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
        }
      }
      if (t == 0) {
        float* lb = lse + ((int64_t)w.b * Hq + w.h) * T_len;
        if (row0 < T_len) lb[row0] = m[0] * LN2 + logf(l[0]);
        if (row1 < T_len) lb[row1] = m[1] * LN2 + logf(l[1]);
      }
    }
  }
}

template <int DP, int BK>
int launch_tiles(const void* q, const void* k, const void* v, void* o, void* lse,
                 const void* kv_len, const void* q_offset, int B, int T_len, int S, int Hq,
                 int Hkv, int D, float sm_scale, int causal, cudaStream_t stream) {
  using C = Cfg<DP, BK>;
  CUtensorMap map_q, map_k, map_v;
  CUresult r = make_map_4d(&map_q, q, B, T_len, Hq, D, BQ);
  if (r == CUDA_SUCCESS) r = make_map_4d(&map_k, k, B, S, Hkv, D, BK);
  if (r == CUDA_SUCCESS) r = make_map_4d(&map_v, v, B, S, Hkv, D, BK);
  if (r != CUDA_SUCCESS) return map_error(r);
  auto kernel = flash_fwd_wgmma_kernel<DP, BK>;
  static bool allowed = false;  // once per instance
  if (!allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const int n_q_tiles = (T_len + BQ - 1) / BQ;
  const int64_t n_items = (int64_t)n_q_tiles * Hq * B;
  const int sms = sm_count();
  if (n_items > INT32_MAX || sms <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_items < sms ? n_items : sms);
  kernel<<<grid, NTHREADS, C::SMEM, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_offset), B, T_len, S, Hq, Hkv,
      D, sm_scale * LOG2E, causal, n_q_tiles);
  return (int)cudaGetLastError();
}

// The key-tile width: 32 where one such tile holds all of S, else 128.
template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const void* kv_len,
           const void* q_offset, int B, int T_len, int S, int Hq, int Hkv, int D,
           float sm_scale, int causal, cudaStream_t stream) {
  return S <= 32 ? launch_tiles<DP, 32>(q, k, v, o, lse, kv_len, q_offset, B, T_len, S, Hq, Hkv,
                                        D, sm_scale, causal, stream)
                 : launch_tiles<DP, 128>(q, k, v, o, lse, kv_len, q_offset, B, T_len, S, Hq,
                                         Hkv, D, sm_scale, causal, stream);
}

}  // namespace wg

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on `stream`
// and does not synchronise; o and lse are allocated by the caller.
extern "C" int spider_flash_fwd(const void* q, const void* k, const void* v, void* o,
                                void* lse, const void* kv_len, const void* q_offset, int B,
                                int T_len, int S, int Hq, int Hkv, int D, float sm_scale,
                                int causal, int is_fp32, void* stream) {
  if (B <= 0 || T_len <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_fp32 ? dispatch_dim<float>(q, k, v, o, lse, kv_len, q_offset, B, T_len, S, Hq, Hkv,
                                    D, sm_scale, causal, st)
              : dispatch_dim<__nv_bfloat16>(q, k, v, o, lse, kv_len, q_offset, B, T_len, S,
                                            Hq, Hkv, D, sm_scale, causal, st);
  return (int)err;
}

// The wgmma form: bf16 only, D a multiple of 8 up to 128, q/k/v 16-byte
// aligned. Returns 0, the cudaError_t of the launch, or -(1000 + CUresult)
// when a tensor map cannot be encoded.
extern "C" int spider_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                                      void* lse, const void* kv_len, const void* q_offset,
                                      int B, int T_len, int S, int Hq, int Hkv, int D,
                                      float sm_scale, int causal, void* stream) {
  if (B <= 0 || T_len <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 128 ||
      D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPIDER_FLASH_CASE(DP_)                                                               \
  case DP_ / 16:                                                                             \
    return wg::launch<DP_>(q, k, v, o, lse, kv_len, q_offset, B, T_len, S, Hq, Hkv, D, \
                           sm_scale, causal, st);
  switch ((D + 15) / 16) {
    SPIDER_FLASH_CASE(16)
    SPIDER_FLASH_CASE(32)
    SPIDER_FLASH_CASE(48)
    SPIDER_FLASH_CASE(64)
    SPIDER_FLASH_CASE(80)
    SPIDER_FLASH_CASE(96)
    SPIDER_FLASH_CASE(112)
    SPIDER_FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPIDER_FLASH_CASE
}
