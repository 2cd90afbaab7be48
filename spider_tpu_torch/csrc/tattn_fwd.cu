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
// ~295 FLOP/byte ridge, so it is bound by HBM. The design is one coalesced
// pass over the bytes, with the arithmetic on the CUDA cores in fp32 (exact
// for fp32 inputs too); tensor cores would not move an HBM-bound kernel.
//
// Design (a first, simple form):
//  * One block of 4 warps per (batch, tile of TP pixels, group of HG heads).
//    HG heads are adjacent channels, so each (pixel, frame) row the block
//    reads is HG*D contiguous elements (up to 320; 640 bytes in bf16).
//  * The block stages its q/k/v tile in shared memory in one pass of 16-byte
//    loads along the channels (zero rows past P), then each warp takes one
//    (pixel, head) unit at a time: F query rows over 32 lanes, L = 32 / FP
//    lanes per row (FP = F rounded up to 8, 16 or 32) splitting D into
//    8-element chunks. Partial dots are summed across the row's lanes with
//    shuffles, so every lane holds its row's F logits in registers; the
//    softmax and the probs . v pass run there too.
//  * The output overwrites the unit's q tile in shared memory and leaves
//    in one pass of 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
