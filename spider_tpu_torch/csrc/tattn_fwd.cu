// Temporal (frame-axis) attention forward for Hopper (sm_90a), bound to
// Python through a plain C entry point (loaded with ctypes by
// spider_tpu_torch/ops/temporal_attention.py).
//
// Replaces the TPU kernel spider_tpu/ops/temporal_attention.py::_tattn_kernel
// (driven by _tattn_pallas_fwd). It computes the same function: at every
// (batch, pixel, head) softmax attention over the F frames,
//   logits [F, F] = q k^T * scale in fp32, softmax over the keys,
//   the probabilities cast to v's dtype, then probs . v accumulated in fp32
//   and written in q's dtype.
// The Pallas kernel's (head, frame) fold and block-diagonal mask exist only
// to fill the TPU's 128x128 matrix tile; this kernel does not need them.
//
//   q, k, v [B, F, P, C] ("bfpc") or [B, P, F, C] ("bpfc"), C = H * D,
//   bf16 or fp32, read straight from their strides: element (b, f, p, c)
//   lies at b*sb + f*sf + p*sp + c. The output has its own strides.
//   F <= 32, D a multiple of 8 up to 256.
//
// What bounds it on an H100: at ZeroScope's level 0 (B = 2 with CFG,
// F = 16, P = 2880, C = 320, H = 8, D = 40) one call moves
// 4 x 2*16*2880*320 x 2 bytes ~ 236 MB (q, k, v read, o written) for
// 4*B*P*H*F^2*D ~ 1.9 GFLOP: about 8 FLOP/byte, far below the card's
// ~295 FLOP/byte ridge, so it is bound by HBM: what counts is bytes in flight,
// with the arithmetic kept out of their way.
//
// Two kernels compute it; ops/temporal_attention.py::tattn_route names the
// one a call takes, by dtype alone.
//
// "ring" (spider_tattn_fwd_ring; bf16), loads, arithmetic and stores
// overlapped:
//  * Persistent blocks, three an SM, each walk (batch, tile of TP pixels,
//    group of HG heads) items through a ring of 2 stages of shared memory. HG
//    heads are adjacent channels, so a (pixel, frame) row of an item is HG*D
//    contiguous elements (up to 320; 640 bytes), and a stage holds TP*F = 16
//    such rows (one pixel's where F > 8) of each of q, k and v: ~31 KB, so
//    ~190 KB of loads in flight an SM. The card's times chose this split: one
//    block an SM with three stages of 32 rows holds as many bytes but has one
//    copy warp to ask for them, and was a third slower.
//  * A copy warp brings item n + 1, one cp.async.bulk per row, onto the
//    stage's full mbarrier while 4 consumer warps compute item n; rows past P
//    are not asked for. Rows sit at a pitch of an odd count of 16 bytes, so
//    the 8 rows of an ldmatrix fall in distinct banks.
//  * A consumer warp takes one (pixel, head) unit at a time on the tensor
//    cores: S = Q K^T and P V are mma.sync.m16n8k16 fed by ldmatrix (V through
//    its .trans form), frames padded to 8, 16 or 32 (rows F.. stay zero, their
//    logits are masked), D in steps of 16 with the odd half step of D = 40
//    zeroed in both operands. The softmax runs in fp32 registers; the
//    probabilities are rounded to bf16 as the next product's A operand.
//  * The output overwrites the unit's q rows. When the 4 warps have arrived
//    on the stage's done mbarrier the copy warp sends those rows back with
//    cp.async.bulk stores, waits until they have been read, and refills the
//    stage: the store of item n - 1, the arithmetic of item n and the loads
//    of item n + 1 run together.
//
// "simple" (spider_tattn_fwd), the first form, takes fp32 inputs (exact for
// them: the arithmetic is fp32 on the CUDA cores) and bf16 when named:
//  * One block of 4 warps per (batch, tile of TP pixels, group of HG heads).
//  * The block stages its q/k/v tile in shared memory in one pass of 16-byte
//    loads along the channels (zero rows past P), then each warp takes one
//    (pixel, head) unit at a time: F query rows over 32 lanes, L = 32 / FP
//    lanes per row (FP = F rounded up to 8, 16 or 32) splitting D into
//    8-element chunks. Partial dots are summed across the row's lanes with
//    shuffles, so every lane holds its row's F logits in registers; the
//    softmax and the probs . v pass run there too.
//  * The output overwrites the unit's q tile in shared memory and leaves
//    in one pass of 16-byte stores. Nothing overlaps inside a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int VEC = 8;             // elements per chunk: 16 bytes of bf16
constexpr int MAX_ROW = 320;       // channels a block reads per (pixel, frame) row
constexpr int SMEM_TARGET = 96 * 1024;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);            // the low half is element 2i
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[VEC]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store8(float* p, const float (&x)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// Copy (or zero) 8 elements, 16 bytes at a time.
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src) {
#pragma unroll
  for (int i = 0; i < (int)(VEC * sizeof(T) / 16); ++i)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

template <typename T>
__device__ __forceinline__ void zero8(T* dst) {
#pragma unroll
  for (int i = 0; i < (int)(VEC * sizeof(T) / 16); ++i)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The probabilities are cast to v's dtype before probs . v, as the
// reference does.
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_like(float x, const float*) { return x; }

template <typename T, int FP>
__global__ void __launch_bounds__(NTHREADS)
tattn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int F, int P, int D, int HG, int TP, int64_t sb,
                 int64_t sf, int64_t sp, int64_t osb, int64_t osf, int64_t osp, float scale) {
  constexpr int L = 32 / FP;  // lanes per query row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int unit = F * D;      // elements of one (pixel, head) tile
  const int n_units = TP * HG;
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + n_units * unit;
  T* sV = sK + n_units * unit;

  const int p0 = blockIdx.x * TP;
  const int c0 = blockIdx.y * HG * D;   // first channel of this block's heads
  const int b = blockIdx.z;
  const int row_chunks = HG * D / VEC;  // chunks of one (pixel, frame) row
  const int per_tensor = TP * F * row_chunks;

  // ---- stage q, k, v: 16-byte loads along the channels; pixels past P are 0.
  for (int i = threadIdx.x; i < 3 * per_tensor; i += NTHREADS) {
    const int t = i / per_tensor;
    int r = i - t * per_tensor;
    const int ch = r % row_chunks;
    r /= row_chunks;
    const int f = r % F;
    const int pl = r / F;
    const int cc = ch * VEC;
    const int hl = cc / D;
    T* dst = (t == 0 ? sQ : t == 1 ? sK : sV) + ((pl * HG + hl) * F + f) * D + (cc - hl * D);
    const int p = p0 + pl;
    if (p < P) {
      const T* src = (t == 0 ? q : t == 1 ? k : v) + b * sb + f * sf + p * sp + c0 + cc;
      copy8(dst, src);
    } else {
      zero8(dst);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = lane / L;          // this lane's query frame
  const int part = lane % L;         // which of the row's D chunks it takes
  const int rq = min(row, F - 1);    // lanes past F compute a copy of row F-1 and store nothing
  const int nc = D / VEC;
  for (int u = warp; u < n_units; u += NWARPS) {
    T* uq = sQ + u * unit;
    const T* uk = sK + u * unit;
    const T* uv = sV + u * unit;

    // ---- logits: this lane's partial dots of row rq with every key frame.
    float s[FP];
#pragma unroll
    for (int g = 0; g < FP; ++g) s[g] = 0.f;
    for (int c = part; c < nc; c += L) {
      float qv[VEC];
      load8(uq + rq * D + c * VEC, qv);
#pragma unroll
      for (int g = 0; g < FP; ++g) {
        if (g < F) {
          float kv[VEC];
          load8(uk + g * D + c * VEC, kv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[g] = fmaf(qv[e], kv[e], s[g]);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < L; off <<= 1) {
#pragma unroll
      for (int g = 0; g < FP; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
    }

    // ---- softmax over the F keys, in fp32; probs rounded to v's dtype.
    float m = -INFINITY;
#pragma unroll
    for (int g = 0; g < FP; ++g) {
      if (g < F) {
        s[g] *= scale;
        m = fmaxf(m, s[g]);
      }
    }
    float l = 0.f;
#pragma unroll
    for (int g = 0; g < FP; ++g) {
      if (g < F) {
        s[g] = expf(s[g] - m);
        l += s[g];
      }
    }
#pragma unroll
    for (int g = 0; g < FP; ++g) s[g] = round_like(s[g] / l, uv);

    // ---- out = probs . v, written over this unit's q (no lane reads it now).
    __syncwarp();
    for (int c = part; c < nc; c += L) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
      for (int g = 0; g < FP; ++g) {
        if (g < F) {
          float vv[VEC];
          load8(uv + g * D + c * VEC, vv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(s[g], vv[e], acc[e]);
        }
      }
      if (row < F) store8(uq + row * D + c * VEC, acc);
    }
  }
  __syncthreads();

  // ---- write the block's output tile: 16-byte stores along the channels.
  for (int i = threadIdx.x; i < per_tensor; i += NTHREADS) {
    int r = i;
    const int ch = r % row_chunks;
    r /= row_chunks;
    const int f = r % F;
    const int pl = r / F;
    const int p = p0 + pl;
    if (p >= P) continue;
    const int cc = ch * VEC;
    const int hl = cc / D;
    copy8(o + b * osb + f * osf + p * osp + c0 + cc,
          sQ + ((pl * HG + hl) * F + f) * D + (cc - hl * D));
  }
}

template <typename T, int FP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int F, int P,
                   int H, int D, int HG, int TP, int64_t sb, int64_t sf, int64_t sp,
                   int64_t osb, int64_t osf, int64_t osp, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)3 * TP * HG * F * D * sizeof(T);
  auto kernel = tattn_fwd_kernel<T, FP>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((P + TP - 1) / TP, H / HG, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), F, P, D, HG, TP, sb, sf, sp, osb, osf, osp, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_frames(const void* q, const void* k, const void* v, void* o, int B, int F,
                            int P, int H, int D, int64_t sb, int64_t sf, int64_t sp,
                            int64_t osb, int64_t osf, int64_t osp, float scale,
                            cudaStream_t stream) {
  // Heads per block: the most whose channels fit one MAX_ROW row. Pixels per
  // block: enough for two units per warp, within the shared-memory target.
  int HG = 1;
  for (int g = H; g >= 1; --g) {
    if (H % g == 0 && g * D <= MAX_ROW) {
      HG = g;
      break;
    }
  }
  int TP = 2 * NWARPS / HG > 1 ? 2 * NWARPS / HG : 1;
  while (TP > 1 && (size_t)3 * TP * HG * F * D * sizeof(T) > SMEM_TARGET) TP /= 2;
  if (F <= 8)
    return launch<T, 8>(q, k, v, o, B, F, P, H, D, HG, TP, sb, sf, sp, osb, osf, osp, scale,
                        stream);
  if (F <= 16)
    return launch<T, 16>(q, k, v, o, B, F, P, H, D, HG, TP, sb, sf, sp, osb, osf, osp, scale,
                         stream);
  return launch<T, 32>(q, k, v, o, B, F, P, H, D, HG, TP, sb, sf, sp, osb, osf, osp, scale,
                       stream);
}

// ---------------------------------------------------------------------------
// The ring form (bf16)
// ---------------------------------------------------------------------------

namespace ring {

using namespace hopper;

constexpr int STAGES = 2;
constexpr int STAGE_ROWS = 16;      // (pixel, frame) rows of one tensor in a stage, at least
constexpr int BLOCKS_PER_SM = 3;    // each with its own copy warp
constexpr int CONSUMER_WARPS = 4;
constexpr int NTHREADS = (CONSUMER_WARPS + 1) * 32;  // and the copy warp

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b for one 16x8x16 tile (A row-major 16x16, B column-major 16x8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
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

__device__ __forceinline__ void store_u32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}

struct Params {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  int F, P, D, HG, TP;
  int n_ptiles, n_hgroups, n_items;
  int row_bytes;     // HG * D channels of one (pixel, frame) row
  int pitch;         // row pitch in shared memory: an odd count of 16 bytes
  int tensor_bytes;  // TP * FP * pitch
  int64_t sb, sf, sp, osb, osf, osp;
  float scale;
};

// One (pixel, head) unit on one warp: S = Q K^T and P V on mma.sync, frames
// padded to FP, head dim D in steps of 16 (the odd half step of D = 40 is
// zeroed in both operands). q_u, k_u, v_u: the unit's first row in shared
// memory; the output overwrites the unit's q rows.
template <int FP>
__device__ __forceinline__ void attend_unit(uint32_t q_u, uint32_t k_u, uint32_t v_u, int F,
                                            int D, int pitch, float scale, int lane) {
  constexpr int MT = FP > 16 ? 2 : 1;   // 16-row tiles of query frames
  constexpr int NT = FP / 8;            // 8-wide tiles of key frames
  constexpr int KS = (FP + 15) / 16;    // 16-deep steps of P V
  const int g = lane / 4;
  const int t = lane % 4;
  const int lrow = (lane % 8) + 8 * ((lane / 8) & 1);  // ldmatrix: row of a 16-row pair
  const int lhalf = lane / 16;                         // and which 8-column half
  const int KD = (D + 15) / 16;
  const int ND = D / 8;
  const bool odd = (D & 8) != 0;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    const uint32_t q_row = q_u + min(mt * 16 + lrow, FP - 1) * pitch;
    for (int kd = 0; kd < KD; ++kd) {
      const bool tail = odd && kd == KD - 1;
      uint32_t a[4];
      ldmatrix_x4(a, q_row + (kd * 16 + 8 * lhalf) * 2);
      if (tail) a[2] = a[3] = 0u;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // matrices: (keys j, d low), (keys j, d high), (keys j + 1, d low), (.., d high)
        const int frame = min((j + lhalf) * 8 + (lane % 8), FP - 1);
        uint32_t b[4];
        ldmatrix_x4(b, k_u + frame * pitch + (kd * 16 + 8 * ((lane / 8) & 1)) * 2);
        if (tail) b[1] = b[3] = 0u;
        mma_bf16(s[j], a, b[0], b[1]);
        if (j + 1 < NT) mma_bf16(s[min(j + 1, NT - 1)], a, b[2], b[3]);
      }
    }

    // ---- softmax over the F keys in fp32; this thread holds rows g and
    // g + 8 of the tile, two keys of every 8.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t + (e & 1);
        s[j][e] = key < F ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
    // the probabilities rounded to bf16, as the A operand of each 16 keys
    uint32_t pa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      pa[ks][0] = pack_bf16x2(s[2 * ks][0] / l[0], s[2 * ks][1] / l[0]);
      pa[ks][1] = pack_bf16x2(s[2 * ks][2] / l[1], s[2 * ks][3] / l[1]);
      if (2 * ks + 1 < NT) {
        const int j = min(2 * ks + 1, NT - 1);  // = 2 * ks + 1; in range for NT = 1 too
        pa[ks][2] = pack_bf16x2(s[j][0] / l[0], s[j][1] / l[0]);
        pa[ks][3] = pack_bf16x2(s[j][2] / l[1], s[j][3] / l[1]);
      } else {
        pa[ks][2] = pa[ks][3] = 0u;
      }
    }

    // ---- out = P V, 16 columns of D at a time, written over the unit's q
    // rows (every lane has read its q by now).
    __syncwarp();
    const int row0 = mt * 16 + g;
    const uint32_t o_row = q_u + row0 * pitch + 2 * t * 2;
    for (int nd = 0; nd < ND; nd += 2) {
      float o[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // matrices, transposed: (keys low, d nd), (keys high, d nd), (.., d nd + 1) twice
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_u + min(ks * 16 + lrow, FP - 1) * pitch + (nd + lhalf) * 8 * 2);
        if (FP == 8) b[1] = b[3] = 0u;  // no keys 8..15
        mma_bf16(o[0], pa[ks], b[0], b[1]);
        mma_bf16(o[1], pa[ks], b[2], b[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (nd + i < ND) {
          if (row0 < F) store_u32(o_row + (nd + i) * 16, pack_bf16x2(o[i][0], o[i][1]));
          if (row0 + 8 < F)
            store_u32(o_row + 8 * pitch + (nd + i) * 16, pack_bf16x2(o[i][2], o[i][3]));
        }
      }
    }
  }
}

template <int FP>
__global__ void __launch_bounds__(NTHREADS, BLOCKS_PER_SM) tattn_ring_kernel(const Params a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t smem = smem_u32(smem_raw);
  const int stage_bytes = 3 * a.tensor_bytes;   // q, k, v tiles: [TP][FP][pitch]
  const uint32_t bar_full = smem + STAGES * stage_bytes + 16;
  const uint32_t bar_done = bar_full + 8 * STAGES;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // Rows of frames F..FP-1 are never copied into: zero once, they stay zero.
  for (int i = threadIdx.x; i < (STAGES * stage_bytes + 16) / 16; i += NTHREADS)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_done + 8 * i, CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // This block's items: blockIdx.x, + gridDim.x, ...; item n lives in stage
  // n % STAGES. An item is (batch, tile of TP pixels, group of HG heads),
  // head groups fastest.
  const int n_local = a.n_items > (int)blockIdx.x
                          ? (a.n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  auto decode = [&](int n, int& b, int& p0, int& c0, int& np) {
    const int item = blockIdx.x + n * gridDim.x;
    const int hg = item % a.n_hgroups;
    const int rest = item / a.n_hgroups;
    b = rest / a.n_ptiles;
    p0 = (rest - b * a.n_ptiles) * a.TP;
    c0 = hg * a.HG * a.D;
    np = min(a.TP, a.P - p0);
  };

  if (warp == CONSUMER_WARPS) {
    // ---- the copy warp: sends item n - STAGES's output (it lies over that
    // item's q tile) back to global memory, waits until the copy has read
    // it, then asks for item n into the same stage. Its lanes share the rows.
    for (int n = 0; n < n_local + STAGES; ++n) {
      const int stage = n % STAGES;
      const uint32_t tile = smem + stage * stage_bytes;
      int b, p0, c0, np;
      if (n >= STAGES) {
        decode(n - STAGES, b, p0, c0, np);
        mbar_wait(bar_done + 8 * stage, (n / STAGES - 1) & 1);
        for (int r = lane; r < np * a.F; r += 32) {
          const int pl = r / a.F;
          const int f = r - pl * a.F;
          bulk_store(a.o + b * a.osb + f * a.osf + (p0 + pl) * a.osp + c0,
                     tile + (pl * FP + f) * a.pitch, a.row_bytes);
        }
        bulk_commit();
        bulk_wait_read<0>();
        __syncwarp();
      }
      if (n < n_local) {
        decode(n, b, p0, c0, np);
        const uint32_t full = bar_full + 8 * stage;
        const int rows = np * a.F;
        if (lane == 0) mbar_arrive_expect_tx(full, 3 * rows * a.row_bytes);
        __syncwarp();
        for (int i = lane; i < 3 * rows; i += 32) {
          const int which = i / rows;
          const int r = i - which * rows;
          const int pl = r / a.F;
          const int f = r - pl * a.F;
          const __nv_bfloat16* src = which == 0 ? a.q : which == 1 ? a.k : a.v;
          bulk_load(tile + which * a.tensor_bytes + (pl * FP + f) * a.pitch,
                    src + b * a.sb + f * a.sf + (p0 + pl) * a.sp + c0, a.row_bytes, full);
        }
      }
    }
    bulk_wait<0>();
  } else {
    // ---- consumers: a warp takes one (pixel, head) unit at a time.
    for (int n = 0; n < n_local; ++n) {
      const int stage = n % STAGES;
      const uint32_t tile = smem + stage * stage_bytes;
      int b, p0, c0, np;
      decode(n, b, p0, c0, np);
      mbar_wait(bar_full + 8 * stage, (n / STAGES) & 1);
      for (int u = warp; u < np * a.HG; u += CONSUMER_WARPS) {
        const int pl = u / a.HG;
        const uint32_t q_u = tile + pl * FP * a.pitch + (u - pl * a.HG) * a.D * 2;
        attend_unit<FP>(q_u, q_u + a.tensor_bytes, q_u + 2 * a.tensor_bytes, a.F, a.D, a.pitch,
                        a.scale, lane);
      }
      fence_proxy_async();  // the outputs, before the copy warp's bulk store reads them
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_done + 8 * stage);
    }
  }
}

template <int FP>
int launch(const Params& base, int B, int H, cudaStream_t stream) {
  Params a = base;
  // Heads an item: the most whose channels fit one MAX_ROW row. Pixels an
  // item: STAGE_ROWS rows of FP frames, one pixel where FP is as many or more.
  constexpr int ROWS = FP > STAGE_ROWS ? FP : STAGE_ROWS;
  a.HG = 1;
  for (int g = H; g >= 1; --g) {
    if (H % g == 0 && g * a.D <= MAX_ROW) {
      a.HG = g;
      break;
    }
  }
  a.TP = ROWS / FP;
  a.n_ptiles = (a.P + a.TP - 1) / a.TP;
  a.n_hgroups = H / a.HG;
  const int64_t n_items = (int64_t)B * a.n_ptiles * a.n_hgroups;
  a.row_bytes = a.HG * a.D * 2;
  a.pitch = a.row_bytes + ((a.row_bytes / 16) % 2 == 0 ? 16 : 0);
  a.tensor_bytes = a.TP * FP * a.pitch;
  const int smem = STAGES * 3 * a.tensor_bytes + 16 + 2 * 8 * STAGES;
  const int sms = sm_count();
  if (n_items > INT32_MAX || sms <= 0) return (int)cudaErrorInvalidValue;
  a.n_items = (int)n_items;
  auto kernel = tattn_ring_kernel<FP>;
  static bool allowed = false;  // once per instance
  if (!allowed) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           STAGES * 3 * ROWS * (MAX_ROW * 2 + 16) + 64);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const int resident = sms * BLOCKS_PER_SM;
  const int grid = (int)(n_items < resident ? n_items : resident);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace ring

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on `stream`
// and does not synchronise; o is allocated by the caller. Strides are in
// elements, for the (b, f, p) axes; the channel stride is 1.
extern "C" int spider_tattn_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                int F, int P, int H, int D, long long sb, long long sf,
                                long long sp, long long osb, long long osf, long long osp,
                                float scale, int is_fp32, void* stream) {
  if (B <= 0 || F <= 0 || F > 32 || P <= 0 || H <= 0 || D <= 0 || D > 256 || D % VEC != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_fp32 ? dispatch_frames<float>(q, k, v, o, B, F, P, H, D, sb, sf, sp, osb, osf, osp,
                                       scale, st)
              : dispatch_frames<__nv_bfloat16>(q, k, v, o, B, F, P, H, D, sb, sf, sp, osb, osf,
                                               osp, scale, st);
  return (int)err;
}

// The ring form: bf16 only, F <= 32, D a multiple of 8 with some count of heads
// filling a row of at most 320 channels. Same arguments and return value.
extern "C" int spider_tattn_fwd_ring(const void* q, const void* k, const void* v, void* o, int B,
                                     int F, int P, int H, int D, long long sb, long long sf,
                                     long long sp, long long osb, long long osf, long long osp,
                                     float scale, void* stream) {
  if (B <= 0 || F <= 0 || F > 32 || P <= 0 || H <= 0 || D <= 0 || D > MAX_ROW || D % VEC != 0)
    return (int)cudaErrorInvalidValue;
  ring::Params a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.F = F; a.P = P; a.D = D;
  a.sb = sb; a.sf = sf; a.sp = sp; a.osb = osb; a.osf = osf; a.osp = osp;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F <= 8) return ring::launch<8>(a, B, H, st);
  if (F <= 16) return ring::launch<16>(a, B, H, st);
  return ring::launch<32>(a, B, H, st);
}
