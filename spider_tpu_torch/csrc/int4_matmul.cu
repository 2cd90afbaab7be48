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
// Three kernels, chosen by ops/quant.py::int4_route: "stream" (bf16 x, M <= 16,
// K/2 <= 2048: decode) and "wgmma" (bf16 x, M >= 48: prefill), both below with
// their own notes, and the first form, "mma", which takes what they do not:
// fp32 x, a K/2 that is not a multiple of 16, unaligned pointers, 17 to 47
// rows, and M <= 16 with K/2 over 2048.
//
// Design of the first form ("mma"):
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

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// Shared by the two Hopper forms
// ---------------------------------------------------------------------------

namespace {

using namespace hopper;

// Two's-complement nibbles in bits 0-3 and 16-19 of r -> their values as a
// bf16 pair: 0x4300 | (nibble ^ 8) is 128 + (v + 8), and 136 = 0x4308 goes off.
__device__ __forceinline__ uint32_t nib2(uint32_t r) {
  uint32_t v;   // (r & 0x000F000F) ^ 0x43084308 in one instruction: the constants in registers
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(v) : "r"(r), "r"(0x000F000Fu), "r"(0x43084308u));
  const uint32_t c = 0x43084308u;
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&h);
}

// The same without the subtraction: each nibble's value plus 136. A product
// that takes these owes 136 times the sum of the other operand's row.
__device__ __forceinline__ uint32_t nib2_plus136(uint32_t r) {
  uint32_t v;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(v) : "r"(r), "r"(0x000F000Fu), "r"(0x43084308u));
  return v;
}

template <int COUNT>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(COUNT) : "memory");
}

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

// The K slices of one output tile meet here: every block has written its
// partial tile to `part`; the block that arrives last at the tile's counter
// (and only it) returns true, after which it may read every slice's partial.
// It leaves the counter at 0 for the next launch. Called by all `COUNT`
// threads of the barrier `id`; `flag` is one int of shared memory.
template <int COUNT>
__device__ __forceinline__ bool last_arrival(int* counter, int expected, int* flag, int id,
                                             bool leader) {
  __threadfence();
  named_sync<COUNT>(id);
  if (leader) {
    const int old = atomicAdd(counter, 1);
    const int last = old == expected - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  named_sync<COUNT>(id);
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

}  // namespace

// ---------------------------------------------------------------------------
// Route "stream": bf16 x, M <= 16, K/2 a multiple of 16 up to 2048. Bound by
// the packed bytes through HBM.
//
// What held the first kernel back there: one block per 32 columns over all of
// K (32 blocks for k/v), 16 KB of loads in flight an SM issued only after the
// previous chunk's mmas, and x re-read from L1/L2 inside the inner loop.
//
// Design (what the card taught while it was written is marked "measured"; all
// on an NVIDIA H100 80GB HBM3 at 700 W):
//  * One block an SM: 16 consumer warps and a producer warp, on a contiguous
//    share of the tiles of 16 output columns. A tile is 16 whole rows of
//    `packed [N, K/2]`. Measured, with the arithmetic switched off: blocks
//    that read K slices of 512 bytes a row (pieces of 512 bytes at a 2 KB
//    pitch from every block at once) stream at about half the rate of whole
//    rows; the width of the pieces is what the memory system sees. So K is
//    not cut: K/2 over 2048 (down) stays on the first kernel by the rule.
//    Measured: with four K slices meeting through fp32 scratch and counters,
//    down took 1.5 times the first kernel's time.
//  * Consumer warp w owns bytes [128 w, 128 w + 128) of every row, so the x it
//    multiplies with never changes: its A fragments (16 rows x 256 columns of
//    x, 64 registers a lane) are loaded once a block, 16 bytes a load, and
//    live in registers. No x in shared memory, no x loads in the loop.
//  * That leaves shared memory to the ring: 6 stages of 32 KB (16 rows x 2048
//    bytes, eight TMA boxes), 192 KB in flight an SM. Measured: with x staged
//    in 128 KB of shared memory and 64 KB of ring the kernel stayed at the
//    first kernel's time whatever else changed.
//  * A stage is one tile. Since the k index of an mma is only a label, k slots
//    {2t, 2t+1, 2t+8, 2t+9} of lane t take bytes {0, 2, 1, 3} of a packed
//    word, which one lop3 turns two at a time into bf16 values of v + 136
//    (nib2_plus136); the 136 times the row sums of x that every output then
//    owes is taken off once a tile, from one pass of the x fragments against
//    ones (fp32, exact products; the sums stay within the accumulator's
//    precision: ~3e-5 of an output of order 1 at K = 4096). The x fragments
//    are built in the same order. A stage goes back
//    to the producer once mmas that need the last word of every 16-byte load
//    have issued. Measured: an arrival right after the loads were issued let
//    the next box land before every lane had its bytes (wrong tiles, a few in
//    a thousand, only with the weights warm in L2).
//  * The 16 warps' partial tiles meet in shared memory (two buffers by the
//    tile's parity, one barrier a tile); 256 threads add them in warp order,
//    scale, cast and store: the same bits every run.
//  * What bounds it now: not bytes. Every form tried (4 to 16 warps a block, x
//    in shared memory or registers, 48 to 192 KB in flight) ends near 2 TB/s,
//    as the first kernel does; with the unpack or the mmas compiled out the
//    time barely moves, so it is neither pipe alone. The next step is the
//    product on wgmma at n = 16 with the unpacked nibbles as the register
//    operand: an eighth of the mma instructions.
// ---------------------------------------------------------------------------

namespace stream {

using namespace hopper;

constexpr int CWARPS = 16;
constexpr int CTHREADS = CWARPS * 32;
constexpr int THREADS = CTHREADS + 32;    // and the producer warp
constexpr int ROWS = 16;                  // rows of x: one mma row tile
constexpr int BN = 16;                    // output columns of a tile
constexpr int WB = 128;                   // packed bytes of a row a warp owns
constexpr int SLICE = CWARPS * WB;        // packed bytes of a row a slice covers: 2048
constexpr int BOX = 256;                  // packed bytes of a row in one TMA box
constexpr int BOXES = SLICE / BOX;
constexpr int STAGE_BYTES = BN * SLICE;   // 32 KB
constexpr int STAGES = 6;
constexpr int TILE_FLOATS = ROWS * BN;    // 256: one a reducing thread
constexpr int RTHREADS = TILE_FLOATS;
constexpr int RED_BYTES = 2 * CWARPS * TILE_FLOATS * 4;
constexpr int SMEM = 128 + STAGES * STAGE_BYTES + RED_BYTES + 2 * STAGES * 8;

struct Params {
  const __nv_bfloat16* x;
  const float* scale;
  void* out;
  int M, N, K2;
  int tiles;     // column tiles
};

__device__ __forceinline__ void store_one(float* out, float v) { *out = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16(v);
}

// Element r of a tile in the order the warps write it: ((j * 4 + i) * 32 + lane)
// for accumulator acc[j][i] of lane (g, t), which is row g + 8 (i / 2), column
// 8 j + 2 t + i % 2.
template <typename TO>
__device__ __forceinline__ void store_element(const Params& p, int tile, int r, float v) {
  const int ji = r / 32, ln = r % 32;
  const int m = ln / 4 + 8 * ((ji % 4) / 2);
  const int n = tile * BN + 8 * (ji / 4) + 2 * (ln % 4) + (ji % 2);
  if (m < p.M && n < p.N) store_one(static_cast<TO*>(p.out) + (int64_t)m * p.N + n, v * p.scale[n]);
}

template <typename TO>
__global__ void __launch_bounds__(THREADS, 1)
int4_stream_kernel(const __grid_constant__ CUtensorMap map_w, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 127u) & ~127u;
  unsigned char* ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
  float* red = reinterpret_cast<float*>(ring_ptr + STAGES * STAGE_BYTES);
  const uint32_t bars = ring + STAGES * STAGE_BYTES + RED_BYTES;   // full[s], empty[s]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 16 * s, 1);
      mbar_init(bars + 16 * s + 8, CWARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The block's run of column tiles.
  const int t0 = (int)((int64_t)p.tiles * blockIdx.x / gridDim.x);
  const int t1 = (int)((int64_t)p.tiles * (blockIdx.x + 1) / gridDim.x);

  if (warp == CWARPS) {
    // ---- producer: one lane, a tile a stage, eight boxes [BN][BOX]
    if (lane == 0) {
      for (int tile = t0; tile < t1; ++tile) {
        const int it = tile - t0;
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(bars + 16 * st + 8, ((it / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(bars + 16 * st, STAGE_BYTES);
#pragma unroll
        for (int bx = 0; bx < BOXES; ++bx)
          tma_load_2d(ring + st * STAGE_BYTES + bx * BN * BOX, &map_w, bars + 16 * st,
                      bx * BOX, tile * BN);
      }
    }
    return;
  }

  // ---- consumers. This warp's x: columns 128 w + [0, 128) of both halves of K,
  // as A fragments: xa[q][s][h] for the 64-byte chunk q, the word s of a lane's
  // 16 bytes and the half h; within 4 columns the order is 0, 2, 1, 3. A lane
  // reads its 16 columns of a row as two 16-byte loads: a warp's loads cover
  // whole 128-byte lines.
  const int g = lane / 4;
  const int t = lane % 4;
  uint32_t xa[2][4][2][4];
  {
    const int64_t K = 2 * (int64_t)p.K2;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kb = WB * warp + 64 * q + 16 * t;   // 16 columns from here
        uint32_t w0[8], w1[8];                        // rows g and g + 8, two columns a word
#pragma unroll
        for (int e = 0; e < 8; ++e) w0[e] = w1[e] = 0u;
        if (kb < p.K2) {
          const __nv_bfloat16* src = p.x + (int64_t)h * p.K2 + kb;
          if (g < p.M) {
            const uint4 a = __ldg(reinterpret_cast<const uint4*>(src + g * K));
            const uint4 b = __ldg(reinterpret_cast<const uint4*>(src + g * K + 8));
            w0[0] = a.x; w0[1] = a.y; w0[2] = a.z; w0[3] = a.w;
            w0[4] = b.x; w0[5] = b.y; w0[6] = b.z; w0[7] = b.w;
          }
          if (g + 8 < p.M) {
            const uint4 a = __ldg(reinterpret_cast<const uint4*>(src + (g + 8) * K));
            const uint4 b = __ldg(reinterpret_cast<const uint4*>(src + (g + 8) * K + 8));
            w1[0] = a.x; w1[1] = a.y; w1[2] = a.z; w1[3] = a.w;
            w1[4] = b.x; w1[5] = b.y; w1[6] = b.z; w1[7] = b.w;
          }
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          xa[q][s][h][0] = __byte_perm(w0[2 * s], w0[2 * s + 1], 0x5410);
          xa[q][s][h][1] = __byte_perm(w1[2 * s], w1[2 * s + 1], 0x5410);
          xa[q][s][h][2] = __byte_perm(w0[2 * s], w0[2 * s + 1], 0x7632);
          xa[q][s][h][3] = __byte_perm(w1[2 * s], w1[2 * s + 1], 0x7632);
        }
      }
  }

  // The nibbles go into the products as v + 136 (nib2_plus136: no subtraction
  // in the loop), so every tile owes 136 times the sum of this warp's x over
  // its columns, row by row: one pass of the same fragments against ones,
  // once a block, in the accumulator's own layout (rows g and g + 8).
  float owed[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) mma_bf16(owed, xa[q][s][h], 0x3F803F80u, 0x3F803F80u);
  const float owed_lo = -136.f * owed[0];
  const float owed_hi = -136.f * owed[2];

  for (int tile = t0; tile < t1; ++tile) {
    const int it = tile - t0;
    const int st = it % STAGES;
    float acc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[j][0] = acc[j][1] = owed_lo;
      acc[j][2] = acc[j][3] = owed_hi;
    }

    mbar_wait(bars + 16 * st, (it / STAGES) & 1);
    // this warp's 128 bytes: box w / 2, bytes 128 (w % 2) of its rows; lane
    // (g, t) takes 16 bytes of rows g and 8 + g in each 64-byte chunk
    const unsigned char* wrow = ring_ptr + st * STAGE_BYTES + (warp / 2) * BN * BOX + g * BOX +
                                WB * (warp % 2) + 16 * t;
    uint32_t wv[2][2][4];   // [chunk][n-tile][word]
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint4 v = *reinterpret_cast<const uint4*>(wrow + 64 * q + 8 * j * BOX);
        wv[q][j][0] = v.x; wv[q][j][1] = v.y; wv[q][j][2] = v.z; wv[q][j][3] = v.w;
      }
    // The last word of every 16-byte load first: once those mmas have issued,
    // every lane has its bytes in registers and the stage goes back to the
    // producer with most of its arithmetic still to do.
#pragma unroll
    for (int s = 3; s >= 0; --s) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            mma_bf16(acc[j], xa[q][s][h], nib2_plus136(wv[q][j][s] >> (4 * h)),
                     nib2_plus136(wv[q][j][s] >> (8 + 4 * h)));
      if (s == 3) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 16 * st + 8);
      }
    }

    // ---- the 16 warps' partial tiles: written to the buffer of this tile's
    // parity; after the barrier 256 threads add them in warp order. A warp
    // that writes this buffer again two tiles on has passed the next tile's
    // barrier, which every reader reaches only after reading.
    float* buf = red + (it & 1) * CWARPS * TILE_FLOATS;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) buf[warp * TILE_FLOATS + (j * 4 + e) * 32 + lane] = acc[j][e];
    named_sync<CTHREADS>(1);
    if (threadIdx.x >= RTHREADS) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) sum += buf[w * TILE_FLOATS + threadIdx.x];
    store_element<TO>(p, tile, threadIdx.x, sum);
  }
}

template <typename TO>
int launch(const void* packed, const Params& p, int grid, cudaStream_t stream) {
  CUtensorMap map_w;
  CUresult r = make_map_2d_u8(&map_w, packed, p.N, p.K2, BN, BOX);
  if (r != CUDA_SUCCESS) return map_error(r);
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(int4_stream_kernel<TO>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  int4_stream_kernel<TO><<<grid, THREADS, SMEM, stream>>>(map_w, p);
  return (int)cudaGetLastError();
}

}  // namespace stream

// ---------------------------------------------------------------------------
// Route "wgmma": bf16 x, M up to 1024, K/2 a multiple of 16. At M = 128 the
// packed bytes and the operations weigh about the same; above, the tensor
// cores bound it (2 M K N operations at 989 TFLOP/s).
//
// What held the first kernel back there: mma.sync fed by per-lane global
// loads, nothing staged, x re-read by every column block: 150-160 TFLOP/s.
//
// Design: out tile [128 rows of x][128 output channels] a block, on wgmma
// with both operands from shared memory, the forms csrc/wgmma_probe.cu holds
// to torch.matmul (K-major tiles of 64 bf16 columns under the 128-byte
// swizzle). Chosen over the transposed product with the unpacked nibbles as a
// register A operand: there the fragment wants k = {2t, 2t+1, 2t+8, 2t+9} of a
// row, so either x's tile is permuted in shared memory or every lane reads
// four times the packed bytes it uses, and the output tile leaves transposed;
// here x arrives by TMA as it lies, the output is written as it lies, and the
// unpack costs one shared-memory round trip, amortised over the 128 rows.
//  * A producer thread keeps a ring of 3 stages ahead: the packed tile
//    [128 channels][64 bytes] (one TMA box, 8 KB) and the two x tiles it pairs
//    with, [128 rows][64 columns] at column c (low nibbles) and K/2 + c (high
//    nibbles), 16 KB each.
//  * The two consumer warpgroups (64 rows of x each) unpack the packed tile
//    into two bf16 tiles in the swizzled layout a TMA box would have (8 bytes
//    a thread a task: two 16-byte chunks), double-buffered, so the unpack of
//    tile i runs under the products of tile i - 1; then 8 wgmma k-steps.
//  * Where the output tiles are too few for the card (M = 128: 32 tiles for
//    N = 4096) K is cut in slices, one block each; partial tiles meet in fp32
//    scratch as in the stream form, summed in slice order by the last block.
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BKB = 64;                       // packed bytes a row a k tile
constexpr int STAGES = 3;
constexpr int X_BYTES = BM * ROW_BYTES;       // 16 KB
constexpr int W_BYTES = BN * BKB;             // 8 KB
constexpr int STAGE_BYTES = 2 * X_BYTES + W_BYTES;
constexpr int U_BYTES = BN * ROW_BYTES;       // one unpacked tile
constexpr int CTHREADS = 256;
constexpr int THREADS = CTHREADS + 128;       // and the producer's warpgroup
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 4 * U_BYTES + 16 * STAGES + 16;

struct Params {
  const float* scale;
  void* out;
  float* part;
  int* counters;
  int M, N, K2;
  int kt_total;    // k tiles of 64 packed bytes across K/2
  int kt_slice;    // k tiles a slice
  int slices;
};

template <typename TO>
__device__ __forceinline__ void store_pair(TO* out, float a, float b, bool both, bool aligned);
template <>
__device__ __forceinline__ void store_pair<float>(float* out, float a, float b, bool both,
                                                  bool aligned) {
  out[0] = a;
  if (both) out[1] = b;
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* out, float a, float b,
                                                          bool both, bool aligned) {
  if (both && aligned) {
    *reinterpret_cast<uint32_t*>(out) = pack_bf16x2(a, b);
  } else {
    out[0] = __float2bfloat16(a);
    if (both) out[1] = __float2bfloat16(b);
  }
}

template <typename TO>
__global__ void __launch_bounds__(THREADS)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_x, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int flag;
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ubuf = ring + STAGES * STAGE_BYTES;     // [2][low, high]
  const uint32_t bars = ubuf + 4 * U_BYTES;              // full[STAGES], empty[STAGES]
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int slice = blockIdx.z;
  const int kt0 = slice * p.kt_slice;
  const int n_kt = min(p.kt_total, kt0 + p.kt_slice) - kt0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), CTHREADS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(bars + 8 * (STAGES + st), ((i / STAGES) - 1) & 1);
        const uint32_t dst = ring + st * STAGE_BYTES;
        const int c = (kt0 + i) * BKB;
        mbar_arrive_expect_tx(bars + 8 * st, STAGE_BYTES);
        tma_load_4d(dst, &map_x, bars + 8 * st, c, 0, m0, 0);
        tma_load_4d(dst + X_BYTES, &map_x, bars + 8 * st, p.K2 + c, 0, m0, 0);
        tma_load_2d(dst + 2 * X_BYTES, &map_w, bars + 8 * st, c, n0);
      }
    }
    return;
  }

  const int ctid = threadIdx.x - 128;
  const int wgi = ctid / 128;             // which 64 rows of x
  const int warp = (ctid % 128) / 32;
  const int lane = ctid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_kt; ++i) {
    const int st = i % STAGES;
    const uint32_t stage = ring + st * STAGE_BYTES;
    const uint32_t ulo = ubuf + (i & 1) * 2 * U_BYTES;
    mbar_wait(bars + 8 * st, (i / STAGES) & 1);
    // ---- unpack: a task is 8 packed bytes of one channel's row: one 16-byte
    // chunk of the low tile and one of the high tile
#pragma unroll
    for (int q = 0; q < BN * 8 / CTHREADS; ++q) {
      const int task = ctid + q * CTHREADS;
      const int row = task / 8;
      const int ch = task % 8;
      const uint2 w = lds64(stage + 2 * X_BYTES + row * BKB + ch * 8);
      const uint32_t p01 = __byte_perm(w.x, 0u, 0x4140), p23 = __byte_perm(w.x, 0u, 0x4342);
      const uint32_t p45 = __byte_perm(w.y, 0u, 0x4140), p67 = __byte_perm(w.y, 0u, 0x4342);
      const uint32_t dst = ulo + row * ROW_BYTES + ((ch ^ (row & 7)) * 16);
      sts128(dst, nib2(p01), nib2(p23), nib2(p45), nib2(p67));
      sts128(dst + U_BYTES, nib2(p01 >> 4), nib2(p23 >> 4), nib2(p45 >> 4), nib2(p67 >> 4));
    }
    fence_proxy_async();
    // the products of tile i - 1 are done: its stage is free, and after the
    // barrier no warpgroup still reads the other unpacked pair
    wgmma_wait<0>();
    fence_regs(acc);
    if (i > 0 && lane == 0) mbar_arrive(bars + 8 * (STAGES + (i - 1) % STAGES));
    named_sync<CTHREADS>(2);
    wgmma_fence();
    const uint32_t xa = stage + wgi * 64 * ROW_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<128>(acc, smem_desc(xa + kk * 32, 16, GROUP_BYTES),
                    smem_desc(ulo + kk * 32, 16, GROUP_BYTES), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<128>(acc, smem_desc(xa + X_BYTES + kk * 32, 16, GROUP_BYTES),
                    smem_desc(ulo + U_BYTES + kk * 32, 16, GROUP_BYTES), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue: acc[i] is row (warp * 16 + g + 8 * bit 1 of i), column
  // (i / 4) * 8 + 2 t + bit 0 of i of the warpgroup's 64 x 128 tile
  if (p.slices > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const int64_t n_tiles = (int64_t)gridDim.x * gridDim.y;
    float* mine = p.part + ((int64_t)slice * n_tiles + tile) * (BM * BN) + ctid;
#pragma unroll
    for (int i = 0; i < 64; ++i) mine[i * CTHREADS] = acc[i];
    if (!last_arrival<CTHREADS>(p.counters + tile, p.slices, &flag, 2, ctid == 0)) return;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int sl = 0; sl < p.slices; ++sl) {
      const float* theirs = p.part + ((int64_t)sl * n_tiles + tile) * (BM * BN) + ctid;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += __ldcg(theirs + i * CTHREADS);
    }
  }
  TO* out = static_cast<TO*>(p.out);
  const bool aligned = (p.N & 1) == 0;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int m = m0 + wgi * 64 + warp * 16 + g + ((i & 2) ? 8 : 0);
    const int n = n0 + (i / 4) * 8 + 2 * t;
    if (m < p.M && n < p.N) {
      const bool both = n + 1 < p.N;
      store_pair(out + (int64_t)m * p.N + n, acc[i] * p.scale[n],
                 both ? acc[i + 1] * p.scale[n + 1] : 0.f, both, aligned);
    }
  }
}

template <typename TO>
int launch(const void* x, const void* packed, Params p, cudaStream_t stream) {
  CUtensorMap map_w, map_x;
  CUresult r = make_map_2d_u8(&map_w, packed, p.N, p.K2, BN, BKB);
  if (r == CUDA_SUCCESS) r = make_map_4d(&map_x, x, 1, p.M, 1, 2 * p.K2, BM);
  if (r != CUDA_SUCCESS) return map_error(r);
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(int4_wgmma_kernel<TO>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.slices);
  int4_wgmma_kernel<TO><<<grid, THREADS, SMEM, stream>>>(map_w, map_x, p);
  return (int)cudaGetLastError();
}

}  // namespace wg

// Route "stream": K/2 up to 2048, a multiple of 16; M up to 16. `grid` (blocks,
// at most one a column tile) comes from ops/quant.py::stream_plan. Returns 0,
// a cudaError_t, or -(1000 + CUresult).
extern "C" int spider_int4_matmul_stream(const void* x, const void* packed, const void* scale,
                                         void* out, int M, int N, int K2, int grid,
                                         int out_fp32, void* stream) {
  if (M <= 0 || M > stream::ROWS || N <= 0 || K2 <= 0 || K2 % 16 || K2 > stream::SLICE ||
      grid < 1 || grid > (N + stream::BN - 1) / stream::BN)
    return (int)cudaErrorInvalidValue;
  stream::Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.M = M; p.N = N; p.K2 = K2;
  p.tiles = (N + stream::BN - 1) / stream::BN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_fp32 ? stream::launch<float>(packed, p, grid, st)
                  : stream::launch<__nv_bfloat16>(packed, p, grid, st);
}

// Route "wgmma". `slices` comes from ops/quant.py::wgmma_plan; `part` holds
// slices x tiles x 128 x 128 floats when there is more than one slice,
// `counters` one zeroed int an output tile (left zeroed).
extern "C" int spider_int4_matmul_wgmma(const void* x, const void* packed, const void* scale,
                                        void* out, void* part, void* counters, int M, int N,
                                        int K2, int slices, int out_fp32, void* stream) {
  if (M <= 0 || M > 1024 || N <= 0 || K2 <= 0 || K2 % 16 || slices < 1)
    return (int)cudaErrorInvalidValue;
  wg::Params p;
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.M = M; p.N = N; p.K2 = K2;
  p.kt_total = (K2 + wg::BKB - 1) / wg::BKB;
  p.kt_slice = (p.kt_total + slices - 1) / slices;
  p.slices = (p.kt_total + p.kt_slice - 1) / p.kt_slice;
  if (p.slices != slices || (slices > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_fp32 ? wg::launch<float>(x, packed, p, st)
                  : wg::launch<__nv_bfloat16>(x, packed, p, st);
}

// The first kernel (route "mma"). Returns the cudaError_t of the launch (0 on
// success). Launches on `stream` and does not synchronise; out is allocated
// by the caller.
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
