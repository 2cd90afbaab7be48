// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// bound to Python through plain C entry points (loaded with ctypes by
// spider_tpu_torch/ops/attention.py).
//
// Replaces the TPU kernels spider_tpu/ops/attention.py::_flash_bwd_dq_kernel
// and ::_flash_bwd_dkv_kernel (driven by _flash_backward). They compute the
// same function: with P recomputed from q, k and the forward's row logsumexp,
//
//   s  = q k^T * sm_scale
//   p  = live ? exp(s - lse) : 0
//   dp = dO v^T
//   ds = p * (dp - delta) * sm_scale
//   dq = ds k        dv = p^T dO        dk = ds^T q
//
//   q, dO, dq [B, T, Hq, D]; k, v, dk, dv [B, S, Hkv, D] (contiguous, bf16 or
//   fp32, one dtype); lse, delta [B, Hq, T] fp32; kv_len, q_offset [B] int32.
//
// delta = rowsum(dO * O) - g_lse is computed by the caller (the TPU form left
// it to XLA too). Key s of batch b is live for query row t when s < kv_len[b]
// and, if causal, s <= t + q_offset[b]: the forward's three position
// conventions arrive as kv_len and q_offset. A query row with no live key has
// p = 0 everywhere and so takes and gives zero gradient, whatever lse holds.
//
// What bounds it on an H100: 10*B*Hq*T*S*D FLOPs (five products per block
// pair; half of that under a causal mask) against q, dO, dq, k, v, dk, dv
// moved once: at the training shape (B 4, T = S = 512, 32/8 heads, D 128)
// 21.5 GFLOP causal against 67 MB, ~320 FLOP/byte, just above the card's
// ~295 FLOP/byte ridge, and further above it as T grows: bound by the tensor
// cores. (The two kernels each recompute S and dP, so they execute 14
// products' worth where the function needs 10.)
//
// Design. Each kernel has two forms; ops/attention.py::flash_route names the
// one a call takes, by dtype and head dim alone: "wgmma" for bf16 with D a
// multiple of 8, "mma" for the rest (fp32 inputs, other head dims).
//  * dq "wgmma" (spider_flash_bwd_dq_wgmma), the forward's structure with the
//    roles of dk/dv swapped. A work item is (128 query rows, q head, batch):
//    two consumer warpgroups of 64 rows each and a producer warpgroup that
//    hands most of its registers over (setmaxnreg) and whose first thread
//    starts every load. Q and dO of the item land once by TMA and stay; each
//    thread keeps its two rows' lse (log2 units) and delta in registers. K
//    and V tiles of 64 keys (the card's times chose 64 over 128) stream
//    through a ring of TMA boxes with a full and an empty mbarrier per
//    stage, so no __syncthreads is left in the loop;
//    only tiles below kv_len and the item's causal diagonal are walked, and
//    the low warpgroup skips a tile wholly above its own rows. S = Q K^T and
//    dP = dO V^T are wgmma from shared memory (K-major, 64-column boxes under
//    the 128-byte swizzle), committed as two groups so that P = exp2(..) is
//    formed while dP is still in flight. dS goes from the accumulators,
//    rounded to bf16, straight into dq += dS K as a register A operand; K is
//    read a second time from the same tile as it lies, [keys][D], in the
//    transposed-B form. Masks run only on tiles that cross kv_len or the
//    diagonal; D < 128 takes padded k-steps (zeros from the TMA fill);
//    sm_scale multiplies dq once at the end. One persistent block an SM walks
//    the items to and fro, heavy causal items first (hopper.cuh), and asks for
//    an item's first K/V tiles before its Q and dO, so they arrive while the
//    item before finishes. One block owns its dq rows: no atomics, the same
//    bits every run.
//  * dq "mma" (spider_flash_bwd_dq): one block of 4 warps per (64 query rows,
//    q head, batch); a loop inside the block walks the 64-key tiles up to the
//    causal diagonal and kv_len (the TPU's sequential grid axis). Each warp
//    owns 16 query rows,
//    computes S and dP on mma.sync.m16n8k16 (bf16 in, fp32 out), forms dS in
//    registers (the accumulator layout of S is the A-operand layout of the
//    next product) and adds dS K into its fp32 dq accumulator.
//  * dk/dv, both forms: one block owns a tile of keys of one (KV head,
//    batch). It loops over the q heads of the GQA group and over the q tiles
//    from the causal diagonal down, so dk and dv are summed in registers and
//    written once: no atomics, no [B, Hq, S, D] intermediate, the same sum
//    order and so the same bits every run. It works on the transposed
//    problem: S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out in the
//    A-operand layout for dv += P^T dO and dk += dS^T Q.
//  * dk/dv "wgmma" (spider_flash_bwd_dkv_wgmma): 128 keys a block, 64 per
//    consumer warpgroup, plus a producer warpgroup that hands its registers
//    over (setmaxnreg). K and V land once by TMA and stay; Q and dO tiles of
//    64 rows stream through a ring of 3 (D > 64) or 4 stages of TMA boxes
//    (hopper.cuh: 64 columns under the 128-byte swizzle, zero fill past T, S
//    and D) with a full and an empty mbarrier each, so no __syncthreads is
//    left in the loop; the producer warp also brings each tile's lse (in log2
//    units) and delta rows. S^T and dP^T are wgmma m64n64k16 from shared
//    memory; P^T and dS^T go from the accumulators, rounded to bf16, straight
//    into the second products as register A operands, with dO and Q read as
//    they lie in the instruction's transposed-B form. A whole q tile is taken
//    at once: a warpgroup's registers hold both 64 x D accumulators beside
//    S^T and dP^T. sm_scale multiplies dk once at the end. The grid is
//    (KV head, batch, key tile), key tiles last and ascending: under a causal
//    mask the heavy tiles start first. Masks run only on tiles that cross T,
//    kv_len or the diagonal.
//  * dk/dv "mma" (spider_flash_bwd_dkv): 64 keys a block, 16 a warp, on
//    mma.sync. A q tile is taken in two halves of 32 rows to keep the four
//    accumulators within the register file.
//  * The mma.sync kernels stage tiles in shared memory as bf16, zero-filled
//    past the ragged T/S edges and from D up to DP (the next multiple of 16);
//    fp32 inputs are rounded to bf16 there. All forms round P and dS to bf16
//    for the second products, as the forward rounds P: the tensor cores take
//    bf16 operands. Accumulation, exp and the dS arithmetic stay fp32.

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

// A operand (16 rows x 16 deep) of rows r0, r0 + 8 at depth kk * 16 of a
// row-major [rows][LD] tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0,
                                       int kk, int t) {
  const __nv_bfloat16* p = tile + r0 * LD + kk * 16 + 2 * t;
  a[0] = load_u32(p);
  a[1] = load_u32(p + 8 * LD);
  a[2] = load_u32(p + 8);
  a[3] = load_u32(p + 8 * LD + 8);
}

// acc += X Y^T, X given as an A operand, Y row `row` of a row-major tile
// (the contraction runs along the tile's rows' depth, as in q k^T).
template <int LD>
__device__ __forceinline__ void mma_nt(float (&acc)[4], const uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int row, int kk, int t) {
  const __nv_bfloat16* p = tile + row * LD + kk * 16 + 2 * t;
  mma_bf16(acc, a, load_u32(p), load_u32(p + 8));
}

// acc += X Y, X given as an A operand over 16 rows of Y starting at row
// `krow0`, output columns col0 .. col0 + 7 of the row-major tile Y.
template <int LD>
__device__ __forceinline__ void mma_nn(float (&acc)[4], const uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int krow0, int col0, int g,
                                       int t) {
  const __nv_bfloat16* p = tile + (krow0 + 2 * t) * LD + col0 + g;
  mma_bf16(acc, a, pack_bf16(p[0], p[LD]), pack_bf16(p[8 * LD], p[9 * LD]));
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const int* __restrict__ kv_len, const int* __restrict__ q_offset,
                    int T_len, int S, int Hq, int Hkv, int D, float sm_scale, int causal) {
  constexpr int LD = DP + 8;  // row pitch in bf16; the +8 spreads rows over banks
  constexpr int NT_S = BK / 8;
  constexpr int NT_O = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + BQ * LD;
  __nv_bfloat16* sK = sDO + BQ * LD;
  __nv_bfloat16* sV = sK + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const int live = max(0, min(kv_len[b], S));
  const int qoff = q_offset[b];
  int kv_hi = live;
  if (causal) kv_hi = min(kv_hi, min(q0 + BQ, T_len) + qoff);
  const int n_tiles = kv_hi > 0 ? (kv_hi + BK - 1) / BK : 0;

  const int64_t q_stride = (int64_t)Hq * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const T* qb = q + ((int64_t)b * T_len * Hq + h) * D;
  const T* dob = dout + ((int64_t)b * T_len * Hq + h) * D;
  const T* kb = k + ((int64_t)b * S * Hkv + hk) * D;
  const T* vb = v + ((int64_t)b * S * Hkv + hk) * D;
  load_tile<T, DP, LD>(sQ, qb, q0, T_len, q_stride, D);
  load_tile<T, DP, LD>(sDO, dob, q0, T_len, q_stride, D);

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int row0 = q0 + r0;
  const int row1 = row0 + 8;
  const float* lse_b = lse + ((int64_t)b * Hq + h) * T_len;
  const float* delta_b = delta + ((int64_t)b * Hq + h) * T_len;
  float lse2[2], dlt[2];  // lse in log2 units
  lse2[0] = row0 < T_len ? lse_b[row0] * LOG2E : 0.f;
  lse2[1] = row1 < T_len ? lse_b[row1] * LOG2E : 0.f;
  dlt[0] = row0 < T_len ? delta_b[row0] : 0.f;
  dlt[1] = row1 < T_len ? delta_b[row1] : 0.f;
  const float scale2 = sm_scale * LOG2E;

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, DP, LD>(sK, kb, k0, S, kv_stride, D);
    load_tile<T, DP, LD>(sV, vb, k0, S, kv_stride, D);
    __syncthreads();

    // ---- S = Q K^T and dP = dO V^T for this warp's 16 rows, 64 keys.
    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4], ad[4];
      load_a<LD>(aq, sQ, r0, kk, t);
      load_a<LD>(ad, sDO, r0, kk, t);
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        mma_nt<LD>(s[j], aq, sK, j * 8 + g, kk, t);
        mma_nt<LD>(dp[j], ad, sV, j * 8 + g, kk, t);
      }
    }

    // ---- dS = P * (dP - delta) * scale, P recomputed from lse.
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const int qpos = (r ? row1 : row0) + qoff;
        const bool on = kpos < live && (!causal || qpos >= kpos);
        const float p = on ? exp2f(s[j][e] * scale2 - lse2[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - dlt[r]) * sm_scale;
      }
    }

    // ---- dq += dS K. Two adjacent 8-key tiles form one 16-deep A operand.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NT_O; ++n) mma_nn<LD>(acc[n], a, sK, kk * 16, n * 8, g, t);
    }
  }

  T* dqb = dq + ((int64_t)b * T_len * Hq + h) * D;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * t + (e & 1);
      const int row = (e < 2) ? row0 : row1;
      if (row < T_len && col < D) store_out(dqb + row * q_stride + col, acc[n][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     const int* __restrict__ kv_len, const int* __restrict__ q_offset,
                     int T_len, int S, int Hq, int Hkv, int D, float sm_scale, int causal) {
  constexpr int LD = DP + 8;
  constexpr int HALF = BQ / 2;       // query rows taken at once
  constexpr int NT_H = HALF / 8;     // 8-row column tiles of S^T in one half
  constexpr int NT_O = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BK * LD;
  __nv_bfloat16* sQ = sV + BK * LD;
  __nv_bfloat16* sDO = sQ + BQ * LD;
  float* sLse = reinterpret_cast<float*>(sDO + BQ * LD);  // log2 units
  float* sDelta = sLse + BQ;

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const int live = max(0, min(kv_len[b], S));
  const int qoff = q_offset[b];
  const int n_q_tiles = (T_len + BQ - 1) / BQ;
  // First q tile with a row on or below the diagonal of this key tile; none
  // when every key of the tile is past kv_len.
  int qt_lo = 0;
  if (causal) qt_lo = max(0, k0 - qoff) / BQ;
  if (k0 >= live) qt_lo = n_q_tiles;

  const int64_t q_stride = (int64_t)Hq * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const T* kb = k + ((int64_t)b * S * Hkv + hk) * D;
  const T* vb = v + ((int64_t)b * S * Hkv + hk) * D;
  load_tile<T, DP, LD>(sK, kb, k0, S, kv_stride, D);
  load_tile<T, DP, LD>(sV, vb, k0, S, kv_stride, D);

  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8
  const int kpos0 = k0 + r0;
  const int kpos1 = kpos0 + 8;
  const float scale2 = sm_scale * LOG2E;

  float acc_k[NT_O][4], acc_v[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[n][e] = 0.f;
      acc_v[n][e] = 0.f;
    }
  }

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const T* qb = q + ((int64_t)b * T_len * Hq + h) * D;
    const T* dob = dout + ((int64_t)b * T_len * Hq + h) * D;
    const float* lse_b = lse + ((int64_t)b * Hq + h) * T_len;
    const float* delta_b = delta + ((int64_t)b * Hq + h) * T_len;
    for (int qt = qt_lo; qt < n_q_tiles; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<T, DP, LD>(sQ, qb, q0, T_len, q_stride, D);
      load_tile<T, DP, LD>(sDO, dob, q0, T_len, q_stride, D);
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        sLse[threadIdx.x] = row < T_len ? lse_b[row] * LOG2E : 0.f;
        sDelta[threadIdx.x] = row < T_len ? delta_b[row] : 0.f;
      }
      __syncthreads();

#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const int c0 = half * HALF;  // first query row of this half in the tile
        // ---- S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 query rows.
        float st[NT_H][4], dpt[NT_H][4];
#pragma unroll
        for (int j = 0; j < NT_H; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[j][e] = 0.f;
            dpt[j][e] = 0.f;
          }
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          uint32_t ak[4], av[4];
          load_a<LD>(ak, sK, r0, kk, t);
          load_a<LD>(av, sV, r0, kk, t);
#pragma unroll
          for (int j = 0; j < NT_H; ++j) {
            mma_nt<LD>(st[j], ak, sQ, c0 + j * 8 + g, kk, t);
            mma_nt<LD>(dpt[j], av, sDO, c0 + j * 8 + g, kk, t);
          }
        }

        // ---- P^T into st, dS^T into dpt.
#pragma unroll
        for (int j = 0; j < NT_H; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + j * 8 + 2 * t + (e & 1);
            const int qrow = q0 + col;
            const int kpos = (e < 2) ? kpos0 : kpos1;
            const bool on =
                qrow < T_len && kpos < live && (!causal || qrow + qoff >= kpos);
            const float p = on ? exp2f(st[j][e] * scale2 - sLse[col]) : 0.f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - sDelta[col]) * sm_scale;
          }
        }

        // ---- dv += P^T dO, dk += dS^T Q over this half's 32 query rows.
#pragma unroll
        for (int kk = 0; kk < HALF / 16; ++kk) {
          uint32_t ap[4], ads[4];
          ap[0] = pack_f32(st[2 * kk][0], st[2 * kk][1]);
          ap[1] = pack_f32(st[2 * kk][2], st[2 * kk][3]);
          ap[2] = pack_f32(st[2 * kk + 1][0], st[2 * kk + 1][1]);
          ap[3] = pack_f32(st[2 * kk + 1][2], st[2 * kk + 1][3]);
          ads[0] = pack_f32(dpt[2 * kk][0], dpt[2 * kk][1]);
          ads[1] = pack_f32(dpt[2 * kk][2], dpt[2 * kk][3]);
          ads[2] = pack_f32(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
          ads[3] = pack_f32(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
          for (int n = 0; n < NT_O; ++n) {
            mma_nn<LD>(acc_v[n], ap, sDO, c0 + kk * 16, n * 8, g, t);
            mma_nn<LD>(acc_k[n], ads, sQ, c0 + kk * 16, n * 8, g, t);
          }
        }
      }
    }
  }

  T* dkb = dk + ((int64_t)b * S * Hkv + hk) * D;
  T* dvb = dv + ((int64_t)b * S * Hkv + hk) * D;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * t + (e & 1);
      const int row = (e < 2) ? kpos0 : kpos1;
      if (row < S && col < D) {
        store_out(dkb + row * kv_stride + col, acc_k[n][e]);
        store_out(dvb + row * kv_stride + col, acc_v[n][e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  const void *kv_len, *q_offset;
  int B, T_len, S, Hq, Hkv, D;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DP>
cudaError_t launch_dq(const Args& a) {
  constexpr int LD = DP + 8;
  const size_t smem = (size_t)(2 * BQ + 2 * BK) * LD * sizeof(__nv_bfloat16);
  auto kernel = flash_bwd_dq_kernel<T, DP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.T_len + BQ - 1) / BQ, a.Hq, a.B);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq),
      static_cast<const int*>(a.kv_len), static_cast<const int*>(a.q_offset), a.T_len, a.S,
      a.Hq, a.Hkv, a.D, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const Args& a) {
  constexpr int LD = DP + 8;
  const size_t smem =
      (size_t)(2 * BQ + 2 * BK) * LD * sizeof(__nv_bfloat16) + 2 * BQ * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, DP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + BK - 1) / BK, a.Hkv, a.B);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<const int*>(a.kv_len), static_cast<const int*>(a.q_offset), a.T_len, a.S,
      a.Hq, a.Hkv, a.D, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const Args& a, bool dkv) {
#define SPIDER_FLASH_CASE(DP_) \
  case DP_ / 16:               \
    return dkv ? launch_dkv<T, DP_>(a) : launch_dq<T, DP_>(a);
  switch ((a.D + 15) / 16) {
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

int run(const Args& a, int is_fp32, bool dkv) {
  if (a.B <= 0 || a.T_len <= 0 || a.S <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.D <= 0 ||
      a.D > 128)
    return (int)cudaErrorInvalidValue;
  return (int)(is_fp32 ? dispatch_dim<float>(a, dkv) : dispatch_dim<__nv_bfloat16>(a, dkv));
}

// ---------------------------------------------------------------------------
// dk, dv: the wgmma form
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int BKV = 128;                        // keys a block: 64 a consumer warpgroup
constexpr int BQ = 64;                          // query rows a tile
constexpr int NTHREADS = 384;                   // two consumer warpgroups and the producer's
constexpr int CONSUMER_WARPS = 8;
constexpr int KV_TILE_BYTES = BKV * ROW_BYTES;  // one box of K or V
constexpr int Q_TILE_BYTES = BQ * ROW_BYTES;    // one box of Q or dO

template <int DP>
struct Cfg {
  static constexpr int NBOX = (DP + BOX_COLS - 1) / BOX_COLS;
  static constexpr int STAGES = NBOX == 1 ? 4 : 3;
  static constexpr int KV_BYTES = 2 * NBOX * KV_TILE_BYTES;    // K boxes, then V boxes
  static constexpr int STAGE_BYTES = 2 * NBOX * Q_TILE_BYTES;  // Q boxes, then dO boxes
  static constexpr int ROWS_BYTES = 2 * BQ * 4;                // lse (log2 units), delta
  // + 1024 to align the tiles, + 128 for the barriers
  static constexpr int SMEM = KV_BYTES + STAGES * (STAGE_BYTES + ROWS_BYTES) + 1024 + 128;
};

template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_do,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           const int* __restrict__ kv_len, const int* __restrict__ q_offset,
                           int T_len, int S, int Hq, int Hkv, int D, float sm_scale,
                           int causal) {
  using C = Cfg<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + C::NBOX * KV_TILE_BYTES;
  const uint32_t sQ = sK + C::KV_BYTES;  // the ring: stage i at sQ + i * STAGE_BYTES
  const uint32_t rows_off = (sQ - raw) + C::STAGES * C::STAGE_BYTES;
  float* rows = reinterpret_cast<float*>(smem_raw + rows_off);  // [STAGES][2][BQ]
  const uint32_t bar_kv = raw + rows_off + C::STAGES * C::ROWS_BYTES;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;  // low key tiles, the heavy ones under a causal mask, first
  const int group = Hq / Hkv;

  const int live = max(0, min(kv_len[b], S));
  const int qoff = q_offset[b];
  const int n_q_tiles = (T_len + BQ - 1) / BQ;
  // First q tile with a row on or below the diagonal of this key tile; none
  // when every key of the tile is past kv_len.
  int qt_lo = 0;
  if (causal) qt_lo = max(0, k0 - qoff) / BQ;
  if (k0 >= live) qt_lo = n_q_tiles;
  const int nq = max(0, n_q_tiles - qt_lo);
  const int n_iter = group * nq;  // (q head of the group, q tile) pairs, heads outermost

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wgid = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wgid == 2) {
    // ---- producer: one warp. Its lanes bring each tile's lse and delta rows,
    // its first lane issues the TMA loads.
    setmaxnreg_dec<40>();
    if (threadIdx.x / 32 == 8) {
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_kv, C::KV_BYTES);
        for (int box = 0; box < C::NBOX; ++box) {
          tma_load_4d(sK + box * KV_TILE_BYTES, &map_k, bar_kv, box * BOX_COLS, hk, k0, b);
          tma_load_4d(sV + box * KV_TILE_BYTES, &map_v, bar_kv, box * BOX_COLS, hk, k0, b);
        }
      }
      for (int idx = 0; idx < n_iter; ++idx) {
        const int h = hk * group + idx / nq;
        const int q0 = (qt_lo + idx % nq) * BQ;
        const int stage = idx % C::STAGES;
        const int round = idx / C::STAGES;
        if (round > 0) mbar_wait(bar_empty + 8 * stage, (round - 1) & 1);
        const float* lse_b = lse + ((int64_t)b * Hq + h) * T_len;
        const float* delta_b = delta + ((int64_t)b * Hq + h) * T_len;
        float* sl = rows + stage * 2 * BQ;
#pragma unroll
        for (int r = lane; r < BQ; r += 32) {
          const int row = q0 + r;
          sl[r] = row < T_len ? lse_b[row] * LOG2E : 0.f;
          sl[BQ + r] = row < T_len ? delta_b[row] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          const uint32_t full = bar_full + 8 * stage;
          const uint32_t dst = sQ + stage * C::STAGE_BYTES;
          mbar_arrive_expect_tx(full, C::STAGE_BYTES);
          for (int box = 0; box < C::NBOX; ++box) {
            tma_load_4d(dst + box * Q_TILE_BYTES, &map_q, full, box * BOX_COLS, h, q0, b);
            tma_load_4d(dst + (C::NBOX + box) * Q_TILE_BYTES, &map_do, full, box * BOX_COLS, h,
                        q0, b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 keys a warpgroup, 16 a warp, two a thread, on the
    // transposed problem.
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int kpos0 = k0 + wgid * 64 + warp * 16 + g;  // this thread's keys
    const int kpos1 = kpos0 + 8;
    const int wg_kpos_max = k0 + wgid * 64 + 63;
    const uint32_t sKw = sK + wgid * 64 * ROW_BYTES;
    const uint32_t sVw = sV + wgid * 64 * ROW_BYTES;
    const float scale2 = sm_scale * LOG2E;

    float acc_k[DP / 2], acc_v[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      acc_k[i] = 0.f;
      acc_v[i] = 0.f;
    }

    mbar_wait(bar_kv, 0);
    for (int idx = 0; idx < n_iter; ++idx) {
      const int q0 = (qt_lo + idx % nq) * BQ;
      const int stage = idx % C::STAGES;
      const uint32_t sQs = sQ + stage * C::STAGE_BYTES;
      const uint32_t sDO = sQs + C::NBOX * Q_TILE_BYTES;
      mbar_wait(bar_full + 8 * stage, (idx / C::STAGES) & 1);

      // ---- S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 query rows.
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off_kv = (kk / 4) * KV_TILE_BYTES + (kk % 4) * 32;
        const uint32_t off_q = (kk / 4) * Q_TILE_BYTES + (kk % 4) * 32;
        wgmma_ss<BQ>(st, smem_desc(sKw + off_kv, 16, GROUP_BYTES),
                     smem_desc(sQs + off_q, 16, GROUP_BYTES), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off_kv = (kk / 4) * KV_TILE_BYTES + (kk % 4) * 32;
        const uint32_t off_q = (kk / 4) * Q_TILE_BYTES + (kk % 4) * 32;
        wgmma_ss<BQ>(dpt, smem_desc(sVw + off_kv, 16, GROUP_BYTES),
                     smem_desc(sDO + off_q, 16, GROUP_BYTES), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // ---- P^T into st, dS^T / sm_scale into dpt. P is selected to zero on
      // dead pairs, never multiplied: exp2 may overflow there.
      const float* sl = rows + stage * 2 * BQ;
      const bool edge = q0 + BQ > T_len || k0 + BKV > live || (causal && q0 + qoff < wg_kpos_max);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int col = (i / 4) * 8 + 2 * t + (i & 1);
        float p = fast_exp2(st[i] * scale2 - sl[col]);
        if (edge) {
          const int qrow = q0 + col;
          const int kpos = (i & 2) ? kpos1 : kpos0;
          const bool on = qrow < T_len && kpos < live && (!causal || qrow + qoff >= kpos);
          p = on ? p : 0.f;
        }
        st[i] = p;
        dpt[i] = p * (dpt[i] - sl[BQ + col]);
      }
      uint32_t ap[BQ / 16][4], ads[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        acc_to_a(ap[kk], st, kk);
        acc_to_a(ads[kk], dpt, kk);
      }

      // ---- dv += P^T dO, dk += dS^T Q; dO and Q as they lie, [rows][D], in
      // the transposed-B form.
      fence_regs(acc_v);
      fence_regs(acc_k);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wgmma_rs<DP>(acc_v, ap[kk],
                     smem_desc(sDO + kk * 16 * ROW_BYTES, Q_TILE_BYTES, GROUP_BYTES), 1);
        wgmma_rs<DP>(acc_k, ads[kk],
                     smem_desc(sQs + kk * 16 * ROW_BYTES, Q_TILE_BYTES, GROUP_BYTES), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          asm volatile("" ::"r"(ap[kk][e]), "r"(ads[kk][e]));  // live until here
        }
      }
      if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
    }

    // ---- this block owns its dk and dv rows: written once, summed over the
    // group in a fixed order.
    const int64_t kv_stride = (int64_t)Hkv * D;
    __nv_bfloat16* dkb = dk + ((int64_t)b * S * Hkv + hk) * D;
    __nv_bfloat16* dvb = dv + ((int64_t)b * S * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < D) {  // D is a multiple of 8: col + 1 < D too
        if (kpos0 < S) {
          *reinterpret_cast<__nv_bfloat162*>(dkb + kpos0 * kv_stride + col) =
              __floats2bfloat162_rn(acc_k[4 * j] * sm_scale, acc_k[4 * j + 1] * sm_scale);
          *reinterpret_cast<__nv_bfloat162*>(dvb + kpos0 * kv_stride + col) =
              __floats2bfloat162_rn(acc_v[4 * j], acc_v[4 * j + 1]);
        }
        if (kpos1 < S) {
          *reinterpret_cast<__nv_bfloat162*>(dkb + kpos1 * kv_stride + col) =
              __floats2bfloat162_rn(acc_k[4 * j + 2] * sm_scale, acc_k[4 * j + 3] * sm_scale);
          *reinterpret_cast<__nv_bfloat162*>(dvb + kpos1 * kv_stride + col) =
              __floats2bfloat162_rn(acc_v[4 * j + 2], acc_v[4 * j + 3]);
        }
      }
    }
  }
}

template <int DP>
int launch_dkv(const Args& a) {
  using C = Cfg<DP>;
  CUtensorMap map_q, map_do, map_k, map_v;
  CUresult r = make_map_4d(&map_q, a.q, a.B, a.T_len, a.Hq, a.D, BQ);
  if (r == CUDA_SUCCESS) r = make_map_4d(&map_do, a.dout, a.B, a.T_len, a.Hq, a.D, BQ);
  if (r == CUDA_SUCCESS) r = make_map_4d(&map_k, a.k, a.B, a.S, a.Hkv, a.D, BKV);
  if (r == CUDA_SUCCESS) r = make_map_4d(&map_v, a.v, a.B, a.S, a.Hkv, a.D, BKV);
  if (r != CUDA_SUCCESS) return map_error(r);
  auto kernel = flash_bwd_dkv_wgmma_kernel<DP>;
  static bool allowed = false;  // once per instance
  if (!allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const int n_key_tiles = (a.S + BKV - 1) / BKV;
  if (a.B > 65535 || n_key_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(a.Hkv, a.B, n_key_tiles);
  kernel<<<grid, NTHREADS, C::SMEM, a.stream>>>(
      map_q, map_do, map_k, map_v, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), static_cast<const int*>(a.kv_len),
      static_cast<const int*>(a.q_offset), a.T_len, a.S, a.Hq, a.Hkv, a.D, a.sm_scale, a.causal);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// dq: the wgmma form
// ---------------------------------------------------------------------------

namespace wgq {

using namespace hopper;

constexpr int BQ = 128;                       // query rows an item: 64 a consumer warpgroup
constexpr int BK = 64;                        // keys a K/V tile
constexpr int NTHREADS = 384;                 // two consumer warpgroups and the producer's
constexpr int CONSUMER_WARPS = 8;
constexpr int Q_TILE_BYTES = BQ * ROW_BYTES;  // one box of Q or dO

// Q and dO of an item land once and stay; two such pairs fit beside two K/V
// stages at every head dim, so the producer runs a whole item ahead.
template <int DP>
struct Cfg {
  static constexpr int NBOX = (DP + BOX_COLS - 1) / BOX_COLS;
  static constexpr int QDO_BYTES = 2 * NBOX * Q_TILE_BYTES;     // Q boxes, then dO boxes
  static constexpr int KV_TILE_BYTES = BK * ROW_BYTES;          // one box of K or V
  static constexpr int STAGE_BYTES = 2 * NBOX * KV_TILE_BYTES;  // K boxes, then V boxes
  static constexpr int BUDGET = 220 * 1024;
  static constexpr int QSTAGES = 2;
  static_assert(QSTAGES * QDO_BYTES + 2 * STAGE_BYTES <= BUDGET, "the rings must fit");
  static constexpr int FIT = (BUDGET - QSTAGES * QDO_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;  // K/V ring
  // + 1024 to align the tiles, + 128 for the barriers
  static constexpr int SMEM = QSTAGES * QDO_BYTES + STAGES * STAGE_BYTES + 1024 + 128;
};

template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, const int* __restrict__ kv_len,
                          const int* __restrict__ q_offset, int B, int T_len, int S, int Hq,
                          int Hkv, int D, float sm_scale, int causal, int n_q_tiles) {
  using C = Cfg<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // Q ring: Q boxes, dO boxes
  const uint32_t sKV = sQ + C::QSTAGES * C::QDO_BYTES;        // K/V ring: K boxes, V boxes
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
    // ---- producer: one thread keeps both rings full. The first K/V tiles of
    // an item are asked for before its Q and dO, so that they arrive while the
    // consumers finish the item before.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int kv_count = 0;  // K/V tiles asked for so far, over all items
      int local = 0;     // items begun so far
      int next_len = kv_len[item_batch(blockIdx.x, B, Hq)];
      int next_off = q_offset[item_batch(blockIdx.x, B, Hq)];
      for (int item = blockIdx.x; item < n_items; item = item_of_round(++local)) {
        const Item w = decode_item<BQ, BK, 0>(item, n_q_tiles, B, T_len, S, Hq, Hkv, causal,
                                              next_len, next_off);
        if (item_of_round(local + 1) < n_items) {
          next_len = kv_len[item_batch(item_of_round(local + 1), B, Hq)];
          next_off = q_offset[item_batch(item_of_round(local + 1), B, Hq)];
        }
        const int ahead = min(w.n_tiles, C::STAGES);
        for (int it = 0; it <= w.n_tiles; ++it) {
          if (it == ahead) {
            const int qs = local % C::QSTAGES;
            const int q_round = local / C::QSTAGES;
            if (q_round > 0) mbar_wait(bar_q_empty + 8 * qs, (q_round - 1) & 1);
            const uint32_t full = bar_q_full + 8 * qs;
            const uint32_t dst = sQ + qs * C::QDO_BYTES;
            mbar_arrive_expect_tx(full, C::QDO_BYTES);
            for (int box = 0; box < C::NBOX; ++box) {
              tma_load_4d(dst + box * Q_TILE_BYTES, &map_q, full, box * BOX_COLS, w.h, w.q0, w.b);
              tma_load_4d(dst + (C::NBOX + box) * Q_TILE_BYTES, &map_do, full, box * BOX_COLS,
                          w.h, w.q0, w.b);
            }
          }
          if (it == w.n_tiles) break;
          const int stage = kv_count % C::STAGES;
          const int round = kv_count / C::STAGES;
          if (round > 0) mbar_wait(bar_empty + 8 * stage, (round - 1) & 1);
          const uint32_t full = bar_full + 8 * stage;
          const uint32_t dst = sKV + stage * C::STAGE_BYTES;
          mbar_arrive_expect_tx(full, C::STAGE_BYTES);
          for (int box = 0; box < C::NBOX; ++box) {
            tma_load_4d(dst + box * C::KV_TILE_BYTES, &map_k, full, box * BOX_COLS, w.hk,
                        it * BK, w.b);
            tma_load_4d(dst + (C::NBOX + box) * C::KV_TILE_BYTES, &map_v, full, box * BOX_COLS,
                        w.hk, it * BK, w.b);
          }
          ++kv_count;
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
    const float scale2 = sm_scale * LOG2E;
    int kv_count = 0;
    int local = 0;
    int next_len = kv_len[item_batch(blockIdx.x, B, Hq)];
    int next_off = q_offset[item_batch(blockIdx.x, B, Hq)];
    for (int item = blockIdx.x; item < n_items; item = item_of_round(++local)) {
      const Item w = decode_item<BQ, BK, 0>(item, n_q_tiles, B, T_len, S, Hq, Hkv, causal,
                                            next_len, next_off);
      if (item_of_round(local + 1) < n_items) {
        next_len = kv_len[item_batch(item_of_round(local + 1), B, Hq)];
        next_off = q_offset[item_batch(item_of_round(local + 1), B, Hq)];
      }
      const int qs = local % C::QSTAGES;
      const int row0 = w.q0 + r0;
      const int row1 = row0 + 8;
      const int qpos0 = row0 + w.qoff;
      const int wg_qpos_min = w.q0 + wgid * 64 + w.qoff;
      const uint32_t sQw = sQ + qs * C::QDO_BYTES + wgid * 64 * ROW_BYTES;
      const uint32_t sDOw = sQw + C::NBOX * Q_TILE_BYTES;

      // This thread's two rows of lse (log2 units) and delta stay in
      // registers for the item; the loads run under the wait for Q.
      const float* lse_b = lse + ((int64_t)w.b * Hq + w.h) * T_len;
      const float* delta_b = delta + ((int64_t)w.b * Hq + w.h) * T_len;
      float lse2[2], dlt[2];
      lse2[0] = row0 < T_len ? lse_b[row0] * LOG2E : 0.f;
      lse2[1] = row1 < T_len ? lse_b[row1] * LOG2E : 0.f;
      dlt[0] = row0 < T_len ? delta_b[row0] : 0.f;
      dlt[1] = row1 < T_len ? delta_b[row1] : 0.f;

      float acc[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

      mbar_wait(bar_q_full + 8 * qs, (local / C::QSTAGES) & 1);
      for (int it = 0; it < w.n_tiles; ++it, ++kv_count) {
        const int stage = kv_count % C::STAGES;
        const int k0 = it * BK;
        if (causal && k0 > wg_qpos_min + 63) {
          // Every key of the tile lies above this warpgroup's rows. It still
          // waits for the tile, so that it sees every phase of the stage.
          mbar_wait(bar_full + 8 * stage, (kv_count / C::STAGES) & 1);
          if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
          continue;
        }
        const uint32_t sK = sKV + stage * C::STAGE_BYTES;
        const uint32_t sV = sK + C::NBOX * C::KV_TILE_BYTES;
        mbar_wait(bar_full + 8 * stage, (kv_count / C::STAGES) & 1);

        // ---- S = Q K^T, then dP = dO V^T: 64 rows x BK keys each, one
        // k-step per 16 of D. P is formed while dP is still in flight.
        float s[BK / 2], dp[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wgmma_ss<BK>(s, smem_desc(sQw + (kk / 4) * Q_TILE_BYTES + (kk % 4) * 32, 16, GROUP_BYTES),
                       smem_desc(sK + (kk / 4) * C::KV_TILE_BYTES + (kk % 4) * 32, 16,
                                 GROUP_BYTES),
                       kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wgmma_ss<BK>(dp,
                       smem_desc(sDOw + (kk / 4) * Q_TILE_BYTES + (kk % 4) * 32, 16, GROUP_BYTES),
                       smem_desc(sV + (kk / 4) * C::KV_TILE_BYTES + (kk % 4) * 32, 16,
                                 GROUP_BYTES),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);

        // ---- P into s. On the tiles that cross kv_len or the diagonal P is
        // selected to zero on dead pairs, never multiplied: exp2 may overflow
        // there.
        const bool edge = k0 + BK > w.live || (causal && wg_qpos_min < k0 + BK - 1);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float p = fast_exp2(s[i] * scale2 - lse2[(i >> 1) & 1]);
          if (edge) {
            const int kpos = k0 + (i / 4) * 8 + 2 * t + (i & 1);
            const int qpos = qpos0 + ((i & 2) ? 8 : 0);
            p = (kpos < w.live && (!causal || qpos >= kpos)) ? p : 0.f;
          }
          s[i] = p;
        }
        wgmma_wait<0>();
        fence_regs(dp);

        // ---- dS / sm_scale = P (dP - delta), rounded to bf16 as the A
        // operand of each k-step of dq += dS K.
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] *= dp[i] - dlt[(i >> 1) & 1];
        uint32_t ads[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(ads[kk], s, kk);

        // K a second time, as it lies: [keys][D], the transposed-B form.
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<DP>(acc, ads[kk],
                       smem_desc(sK + kk * 16 * ROW_BYTES, C::KV_TILE_BYTES, GROUP_BYTES), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(ads[kk][e]));  // live until here
        }
        if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
      }
      if (lane == 0) mbar_arrive(bar_q_empty + 8 * qs);  // this item's Q and dO are read

      // ---- this block owns its dq rows: written once, sm_scale folded in
      // here. The producer is already loading the next item.
      const int64_t q_stride = (int64_t)Hq * D;
      __nv_bfloat16* dqb = dq + ((int64_t)w.b * T_len * Hq + w.h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = j * 8 + 2 * t;
        if (col < D) {  // D is a multiple of 8: col + 1 < D too
          if (row0 < T_len)
            *reinterpret_cast<__nv_bfloat162*>(dqb + row0 * q_stride + col) =
                __floats2bfloat162_rn(acc[4 * j] * sm_scale, acc[4 * j + 1] * sm_scale);
          if (row1 < T_len)
            *reinterpret_cast<__nv_bfloat162*>(dqb + row1 * q_stride + col) =
                __floats2bfloat162_rn(acc[4 * j + 2] * sm_scale, acc[4 * j + 3] * sm_scale);
        }
      }
    }
  }
}

template <int DP>
int launch_dq(const Args& a) {
  using C = Cfg<DP>;
  CUtensorMap map_q, map_do, map_k, map_v;
  CUresult r = make_map_4d(&map_q, a.q, a.B, a.T_len, a.Hq, a.D, BQ);
  if (r == CUDA_SUCCESS) r = make_map_4d(&map_do, a.dout, a.B, a.T_len, a.Hq, a.D, BQ);
  if (r == CUDA_SUCCESS) r = make_map_4d(&map_k, a.k, a.B, a.S, a.Hkv, a.D, BK);
  if (r == CUDA_SUCCESS) r = make_map_4d(&map_v, a.v, a.B, a.S, a.Hkv, a.D, BK);
  if (r != CUDA_SUCCESS) return map_error(r);
  auto kernel = flash_bwd_dq_wgmma_kernel<DP>;
  static bool allowed = false;  // once per instance
  if (!allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const int n_q_tiles = (a.T_len + BQ - 1) / BQ;
  const int64_t n_items = (int64_t)n_q_tiles * a.Hq * a.B;
  const int sms = sm_count();
  if (n_items > INT32_MAX || sms <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_items < sms ? n_items : sms);
  kernel<<<grid, NTHREADS, C::SMEM, a.stream>>>(
      map_q, map_do, map_k, map_v, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.dq),
      static_cast<const int*>(a.kv_len), static_cast<const int*>(a.q_offset), a.B, a.T_len, a.S,
      a.Hq, a.Hkv, a.D, a.sm_scale, a.causal, n_q_tiles);
  return (int)cudaGetLastError();
}

}  // namespace wgq

}  // namespace

// Each returns the cudaError_t of the launch (0 on success), launches on
// `stream` and does not synchronise; the outputs are allocated by the caller.
extern "C" int spider_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, const void* kv_len, const void* q_offset, int B,
                                   int T_len, int S, int Hq, int Hkv, int D, float sm_scale,
                                   int causal, int is_fp32, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, kv_len, q_offset, B, T_len, S,
         Hq, Hkv, D, sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return run(a, is_fp32, false);
}

extern "C" int spider_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, const void* kv_len,
                                    const void* q_offset, int B, int T_len, int S, int Hq,
                                    int Hkv, int D, float sm_scale, int causal, int is_fp32,
                                    void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, kv_len, q_offset, B, T_len, S,
         Hq, Hkv, D, sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return run(a, is_fp32, true);
}

// dk, dv in the wgmma form: bf16 only, D a multiple of 8 up to 128, q, k, v
// and dout 16-byte aligned. Returns 0, the cudaError_t of the launch, or
// -(1000 + CUresult) when a tensor map cannot be encoded.
extern "C" int spider_flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dk, void* dv, const void* kv_len,
                                          const void* q_offset, int B, int T_len, int S, int Hq,
                                          int Hkv, int D, float sm_scale, int causal,
                                          void* stream) {
  if (B <= 0 || T_len <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 128 ||
      D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, kv_len, q_offset, B, T_len, S,
         Hq, Hkv, D, sm_scale, causal, static_cast<cudaStream_t>(stream)};
#define SPIDER_FLASH_CASE(DP_) \
  case DP_ / 16:               \
    return wg::launch_dkv<DP_>(a);
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

// dq in the wgmma form: bf16 only, D a multiple of 8 up to 128, q, k, v and
// dout 16-byte aligned. Returns as spider_flash_bwd_dkv_wgmma does.
extern "C" int spider_flash_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dq, const void* kv_len, const void* q_offset,
                                         int B, int T_len, int S, int Hq, int Hkv, int D,
                                         float sm_scale, int causal, void* stream) {
  if (B <= 0 || T_len <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 128 ||
      D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, kv_len, q_offset, B, T_len, S,
         Hq, Hkv, D, sm_scale, causal, static_cast<cudaStream_t>(stream)};
#define SPIDER_FLASH_CASE(DP_) \
  case DP_ / 16:               \
    return wgq::launch_dq<DP_>(a);
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
