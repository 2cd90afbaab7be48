// Weight-only int4 matmul for Hopper (sm_90a), bound to Python through a
// plain C entry point (loaded with ctypes by spider_tpu_torch/ops/quant.py).
//
// Replaces the TPU kernel spider_tpu/ops/quant.py::_int4_matmul_kernel
// (quant.py:65, driven by int4_matmul). It computes the same function:
//   out[m, n] = (sum_k x[m, k] * W[k, n]) * scale[n], cast to out's dtype,
// where W[i, n] is the signed low nibble of packed byte (n, i) for i < K/2
// and W[i + K/2, n] its signed high nibble (the split-half layout of
// quant.py:12-17, with the port's [N, K/2] row order). The nibbles become
// bf16 (exact: they are small integers) and the products accumulate in
// fp32, as the Pallas kernel does; the scale multiplies the fp32 sum.
//
//   x [M, K] bf16 or fp32 (contiguous), 1 <= M <= 1024, K = 2 * K2 even
//   packed [N, K2] int8, scale [N] fp32, out [M, N] bf16 or fp32
//   any N and any K2: the ragged edges are masked here, and a K2 that is
//   not a multiple of 16 (or an unaligned pointer) takes scalar loads.
//
// What bounds it on an H100: decode (M = 16 slots, or M = 1 for the chat)
// reads each packed weight once per call: 4096 x 14336 / 2 = 29 MB for
// gate/up, 4096 x 128256 / 2 = 263 MB for the lm_head, against at most
// 2*16 x 2 = 64 FLOP per packed byte, far below the ~295 FLOP/byte ridge:
// the packed bytes, through HBM at 3.35 TB/s, bound it. At M = 128..1024
// (prefill buckets) the work grows with M while the bytes do not, and the
// tensor cores become the limit.
//
// Design (a first, simple form; wgmma, TMA and a pipelined ring of tiles are
// later work):
//  * The products run on mma.sync.m16n8k16 (bf16 in, fp32 accumulate), so
//    one kernel serves decode and the 128-token prefill bucket. fp32 x is
//    split as x = hi + lo with hi = bf16(x) and lo = bf16(x - hi), two mmas
//    each, so fp32 inputs keep about 16 bits of mantissa.
//  * One block of 8 warps per (32 output columns, 16 or 32 rows of x). The
//    8 warps split K: each takes 64-byte chunks of the packed rows in turn,
//    so a block has 8 x 32 x 4 x 16 bytes of weights in flight, and sums
//    its partial tiles through shared memory at the end.
//  * Each lane loads 16 packed bytes of one weight row (one uint4); the 4
//    lanes of a quad cover 64 contiguous bytes of that row. The k index of
//    an mma is only a label, so k slots {2t, 2t+1, 2t+8, 2t+9} of lane t
//    are mapped to the 4 contiguous bytes 16t + 4s .. 16t + 4s + 3 of the
//    chunk at step s: the weight word unpacks straight into the B fragment
//    (the low nibbles for the x columns of the first half of K, the high
//    nibbles for the second half), and the A fragment reads the same 4
//    contiguous columns of x. No shared-memory staging and no shuffles.
//  * A nibble becomes bf16 without a conversion instruction: in offset
//    binary (v + 8 = nibble ^ 8) it is the mantissa of 0x4300 | u = 128 + u,
//    and subtracting 136 leaves v exactly.
//  * Rows of x are read from L1/L2 by every block (x is at most 8 MB here):
//    the x bytes a block reads equal its weight bytes at M = 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BN = 32;          // output columns per block
constexpr int NT = BN / 8;      // mma n-tiles per warp
constexpr int CHUNK = 64;       // packed bytes of a row per warp step (16 per lane of a quad)

// d += a * b for one 16x8x16 tile (A row-major 16x16, B column-major 16x8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two offset-binary nibbles, in bits 0-3 and 16-19, -> their signed values
// as a bf16 pair (low half first).
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t u) {
  uint32_t r = u | 0x43004300u;  // bf16 128 + u in each half
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&r);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// One packed word (bytes c..c+3 of a row) -> B fragments: lo[0..1] holds
// the low nibbles (W rows c..c+3), hi[0..1] the high nibbles (rows K2+c..).
__device__ __forceinline__ void unpack_word(uint32_t w, uint32_t (&lo)[2], uint32_t (&hi)[2]) {
  const uint32_t l = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t h = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  lo[0] = nibbles_to_bf16x2(__byte_perm(l, 0u, 0x4140));  // bytes 0, 1
  lo[1] = nibbles_to_bf16x2(__byte_perm(l, 0u, 0x4342));  // bytes 2, 3
  hi[0] = nibbles_to_bf16x2(__byte_perm(h, 0u, 0x4140));
  hi[1] = nibbles_to_bf16x2(__byte_perm(h, 0u, 0x4342));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// 16 packed bytes of row n at byte c (zero past N or K2).
template <bool ALIGNED>
__device__ __forceinline__ void load_w16(const int8_t* __restrict__ w, int n, int N, int K2, int c,
                                         uint32_t (&out)[4]) {
  if (ALIGNED) {
    if (n < N && c < K2) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(w + (int64_t)n * K2 + c));
      out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
    } else {
      out[0] = out[1] = out[2] = out[3] = 0u;
    }
    return;
  }
  const uint8_t* row = reinterpret_cast<const uint8_t*>(w) + (int64_t)n * K2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t word = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cc = c + 4 * i + e;
      const uint32_t byte = (n < N && cc < K2) ? row[cc] : 0u;
      word |= byte << (8 * e);
    }
    out[i] = word;
  }
}

// x[r, off + c .. off + c + 3] as two bf16 pairs (hi), and for fp32 x the
// pairs of the rounding remainder (lo). Zero past M or K2.
template <bool ALIGNED>
__device__ __forceinline__ void load_x4(const __nv_bfloat16* __restrict__ x, int r, int M,
                                        int64_t K, int off, int c, int K2, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  lo[0] = lo[1] = 0u;
  if (ALIGNED) {
    if (r < M && c < K2) {
      const uint2 u = *reinterpret_cast<const uint2*>(x + r * K + off + c);
      hi[0] = u.x; hi[1] = u.y;
    } else {
      hi[0] = hi[1] = 0u;
    }
    return;
  }
  const uint16_t* p = reinterpret_cast<const uint16_t*>(x) + r * K + off + c;
  uint32_t h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = (r < M && c + e < K2) ? p[e] : 0u;
  hi[0] = h[0] | (h[1] << 16);
  hi[1] = h[2] | (h[3] << 16);
}

template <bool ALIGNED>
__device__ __forceinline__ void load_x4(const float* __restrict__ x, int r, int M, int64_t K,
                                        int off, int c, int K2, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  float f[4];
  if (ALIGNED) {
    if (r < M && c < K2) {
      const float4 u = *reinterpret_cast<const float4*>(x + r * K + off + c);
      f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
    } else {
      f[0] = f[1] = f[2] = f[3] = 0.f;
    }
  } else {
    const float* p = x + r * K + off + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = (r < M && c + e < K2) ? p[e] : 0.f;
  }
  hi[0] = pack2(f[0], f[1]);
  hi[1] = pack2(f[2], f[3]);
  lo[0] = pack2(f[0] - bf16_round(f[0]), f[1] - bf16_round(f[1]));
  lo[1] = pack2(f[2] - bf16_round(f[2]), f[3] - bf16_round(f[3]));
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

template <typename TX, typename TO, int MT, bool ALIGNED>
__global__ void __launch_bounds__(NTHREADS)
int4_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, TO* __restrict__ out, int M, int N, int K2) {
  constexpr bool SPLIT = sizeof(TX) == 4;  // fp32 x: hi and lo mmas
  __shared__ float red[NWARPS][MT * 16][BN];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row of the A/C fragment, column of the B fragment
  const int t = lane % 4;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * MT * 16;
  const int64_t K = 2 * (int64_t)K2;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  const int n_chunks = (K2 + CHUNK - 1) / CHUNK;
  for (int ch = warp; ch < n_chunks; ch += NWARPS) {
    const int c = ch * CHUNK + 16 * t;  // this lane's first byte of the chunk
    uint32_t wv[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) load_w16<ALIGNED>(w, n0 + 8 * j + g, N, K2, c, wv[j]);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t b[2][NT][2];  // [half of K][n-tile][register]
#pragma unroll
      for (int j = 0; j < NT; ++j) unpack_word(wv[j][s], b[0][j], b[1][j]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = m0 + mt * 16 + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t r0h[2], r0l[2], r1h[2], r1l[2];
          load_x4<ALIGNED>(x, r, M, K, h * K2, c + 4 * s, K2, r0h, r0l);
          load_x4<ALIGNED>(x, r + 8, M, K, h * K2, c + 4 * s, K2, r1h, r1l);
          const uint32_t a[4] = {r0h[0], r1h[0], r0h[1], r1h[1]};
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[mt][j], a, b[h][j][0], b[h][j][1]);
          if (SPLIT) {
            const uint32_t al[4] = {r0l[0], r1l[0], r0l[1], r1l[1]};
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_bf16(acc[mt][j], al, b[h][j][0], b[h][j][1]);
          }
        }
      }
    }
  }

  // ---- sum the 8 warps' partial tiles, scale, cast, store.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = mt * 16 + g;
      const int col = 8 * j + 2 * t;
      red[warp][row][col] = acc[mt][j][0];
      red[warp][row][col + 1] = acc[mt][j][1];
      red[warp][row + 8][col] = acc[mt][j][2];
      red[warp][row + 8][col + 1] = acc[mt][j][3];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < MT * 16 * BN; i += NTHREADS) {
    const int row = i / BN;
    const int col = i % BN;
    const int m = m0 + row;
    const int n = n0 + col;
    if (m >= M || n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < NWARPS; ++wp) sum += red[wp][row][col];
    store_out(out + (int64_t)m * N + n, sum * scale[n]);
  }
}

template <typename TX, typename TO, int MT>
cudaError_t launch(const void* x, const void* w, const float* scale, void* out, int M, int N,
                   int K2, bool aligned, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + MT * 16 - 1) / (MT * 16));
  if (aligned)
    int4_matmul_kernel<TX, TO, MT, true><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const int8_t*>(w), scale, static_cast<TO*>(out),
        M, N, K2);
  else
    int4_matmul_kernel<TX, TO, MT, false><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const int8_t*>(w), scale, static_cast<TO*>(out),
        M, N, K2);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t dispatch_rows(const void* x, const void* w, const float* scale, void* out, int M,
                          int N, int K2, cudaStream_t stream) {
  const bool aligned = K2 % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (M <= 16) return launch<TX, TO, 1>(x, w, scale, out, M, N, K2, aligned, stream);
  return launch<TX, TO, 2>(x, w, scale, out, M, N, K2, aligned, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on `stream`
// and does not synchronise; out is allocated by the caller.
extern "C" int spider_int4_matmul(const void* x, const void* packed, const void* scale, void* out,
                                  int M, int N, int K2, int x_fp32, int out_fp32, void* stream) {
  if (M <= 0 || M > 1024 || N <= 0 || K2 <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  cudaError_t err;
  if (x_fp32)
    err = out_fp32 ? dispatch_rows<float, float>(x, packed, s, out, M, N, K2, st)
                   : dispatch_rows<float, __nv_bfloat16>(x, packed, s, out, M, N, K2, st);
  else
    err = out_fp32 ? dispatch_rows<__nv_bfloat16, float>(x, packed, s, out, M, N, K2, st)
                   : dispatch_rows<__nv_bfloat16, __nv_bfloat16>(x, packed, s, out, M, N, K2, st);
  return (int)err;
}
