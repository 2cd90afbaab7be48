// Single-token decode attention over a block-paged KV pool, for Hopper
// (sm_90a), bound to Python through a plain C entry point (loaded with
// ctypes by spider_tpu_torch/ops/paged_attention.py).
//
// Replaces the TPU kernel spider_tpu/ops/paged_attention.py::_kernel
// (paged_attention.py:31, driven by paged_decode_attention). It computes
// the same function: for every slot b and query head,
//   walk the slot's page-table row over its live keys, logits = q . k *
//   sm_scale in fp32, positions >= kv_len[b] masked with -0.7 * f32max, an
//   online softmax with its max, sum and accumulator in fp32, probs . v,
//   and the output in q's dtype.
// A slot with kv_len = 0 gets 0, as the TPU kernel gives (the gather route
// of the reference, mha_reference over the gathered window, gives the mean
// of V there; the batcher never asks for such a row).
// When kv_len > MP * page the walk stops after the MP pages of the table,
// so every key of the window is live, as in the gather route.
//
//   q [B, Hq, D]; pool_k, pool_v [N, page, Hkv, D], q and the pools of one
//   dtype, bf16 or fp32, contiguous; table [B, MP] int32; kv_len [B] int32;
//   out [B, Hq, D] in q's dtype. Hq a multiple of Hkv (grouped-query
//   attention, G = Hq / Hkv query heads share each K/V row), D a multiple of
//   8 up to 256, any page size. Every table entry the walk reads must name
//   a block of the pool.
//
// What bounds it on an H100: each step reads every live K/V byte once,
// 2 * kv_len * Hkv * D * 2 bytes a slot in bf16 (1 MB for the 8B decoder
// at kv_len = 512), for 4 * G FLOP per K/V element pair: about 2 FLOP/byte,
// far below the ~295 FLOP/byte ridge, so HBM bandwidth and the latency of
// the dependent loads bound it. The arithmetic runs on the CUDA cores in
// fp32; tensor cores would not move it.
//
// Design (a first, simple form):
//  * One block of 8 warps per (KV head, slot): the G query heads of the KV
//    head share every K/V row the block reads. The 8B decoder at 16 slots
//    launches 8 x 16 = 128 blocks on the 132 SMs.
//  * The block loads the slot's table row into shared memory once, then
//    walks its keys in tiles of 32 (a tile may straddle pages): each key's
//    row is found from its page and offset, so any page size works.
//  * Per tile: every K and V load of the tile is issued first, 16 bytes a
//    load, so one memory latency serves the tile. The K rows stay in
//    registers, 8 elements a lane, a power of two of lanes per key summing
//    the partial dot products with shuffles; the V rows go to shared
//    memory. The softmax update runs one warp per query head, one lane per
//    key; then one thread per (head, channel) folds probs . v into the fp32
//    accumulator in shared memory.
//  * Not done yet: splitting one slot's pages over several blocks
//    (flash-decoding), and loading the next tile while computing this one.
//    With one slot and a long context (the chat at kv_len ~1800), only
//    Hkv = 8 blocks run and walk 55 tiles each, one after another.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TILE = 32;   // keys per tile: one per lane in the softmax update
constexpr int VEC = 8;     // elements per chunk: 16 bytes of bf16
constexpr float MASK_VALUE = -0.7f * 3.402823466e+38f;
// Most 8-element chunks a thread loads per tile, for K and for V alike:
// TILE * D / 8 chunks over NTHREADS threads, at D = 256.
constexpr int MAX_LOADS = TILE * 32 / NTHREADS;

// 8 elements as raw 16-byte words: one for bf16, two for fp32.
template <typename T>
struct Chunk {
  static constexpr int N = VEC * sizeof(T) / 16;
  uint4 w[N];
};

template <typename T>
__device__ __forceinline__ void load_chunk(Chunk<T>& c, const T* src, bool live) {
#pragma unroll
  for (int i = 0; i < Chunk<T>::N; ++i)
    c.w[i] = live ? reinterpret_cast<const uint4*>(src)[i] : make_uint4(0u, 0u, 0u, 0u);
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* dst, const Chunk<T>& c) {
#pragma unroll
  for (int i = 0; i < Chunk<T>::N; ++i) reinterpret_cast<uint4*>(dst)[i] = c.w[i];
}

__device__ __forceinline__ void unpack8(const Chunk<__nv_bfloat16>& c, float (&x)[VEC]) {
  const uint32_t w[4] = {c.w[0].x, c.w[0].y, c.w[0].z, c.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);            // the low half is element 2i
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack8(const Chunk<float>& c, float (&x)[VEC]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    x[4 * i] = __uint_as_float(c.w[i].x);
    x[4 * i + 1] = __uint_as_float(c.w[i].y);
    x[4 * i + 2] = __uint_as_float(c.w[i].z);
    x[4 * i + 3] = __uint_as_float(c.w[i].w);
  }
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Bytes of the fp32 part of shared memory (q, accumulator, probabilities,
// softmax state, table row), rounded up to 16; the V tile follows it.
__host__ __device__ inline size_t f32_bytes(int G, int D, int MP) {
  const size_t b = (size_t)(2 * G * D + G * TILE + 3 * G + MP) * 4;
  return (b + 15) & ~(size_t)15;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v, const int* __restrict__ table,
                    const int* __restrict__ kv_len, T* __restrict__ out, int Hq, int Hkv,
                    int D, int page, int MP, int lpk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = Hq / Hkv;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [G, D], times sm_scale
  float* acc_s = q_s + G * D;                        // [G, D]
  float* p_s = acc_s + G * D;                        // [G, TILE] logits, then probs
  float* m_s = p_s + G * TILE;                       // [G] running max
  float* l_s = m_s + G;                              // [G] running sum
  float* alpha_s = l_s + G;                          // [G] this tile's rescale
  int* tbl_s = reinterpret_cast<int*>(alpha_s + G);  // [MP]
  T* v_s = reinterpret_cast<T*>(smem_raw + f32_bytes(G, D, MP));  // [TILE, D]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_keys = max(0, min(kv_len[b], MP * page));
  const int n_pages = (n_keys + page - 1) / page;

  const T* qb = q + ((int64_t)b * Hq + (int64_t)h * G) * D;
  for (int i = tid; i < G * D; i += NTHREADS) {
    q_s[i] = to_float(qb[i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += NTHREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  for (int i = tid; i < n_pages; i += NTHREADS) tbl_s[i] = table[(int64_t)b * MP + i];
  __syncthreads();

  const int c8 = D / VEC;        // 8-element chunks of a row
  const int kpw = 32 / lpk;      // keys a warp takes per pass (lpk lanes each)
  const int sub = lane / lpk;
  const int cl = lane % lpk;
  const int64_t pos_stride = (int64_t)Hkv * D;  // elements between positions of a block
  // Element offset of key j's row for this KV head.
  auto row_of = [&](int j) -> int64_t {
    return ((int64_t)tbl_s[j / page] * page + j % page) * pos_stride + (int64_t)h * D;
  };

  for (int base = 0; base < n_keys; base += TILE) {
    // ---- issue every K and V load of the tile before any arithmetic, so
    // one memory latency serves the whole tile. K: lpk lanes per key, kpw
    // keys per warp per pass; TILE is a multiple of kpw, so each pass's
    // bound is uniform across a warp and every shuffle below is full.
    Chunk<T> kc[MAX_LOADS], vc[MAX_LOADS];
#pragma unroll
    for (int p = 0; p < MAX_LOADS; ++p) {
      const int kk = warp * kpw + sub + p * NWARPS * kpw;
      const int j = base + kk;
      const bool live = kk < TILE && j < n_keys && cl < c8;
      load_chunk(kc[p], pool_k + (live ? row_of(j) + cl * VEC : 0), live);
    }
#pragma unroll
    for (int p = 0; p < MAX_LOADS; ++p) {
      const int i = tid + p * NTHREADS;         // chunk i of the V tile
      const int j = base + i / c8;
      const bool live = i < TILE * c8 && j < n_keys;
      load_chunk(vc[p], pool_v + (live ? row_of(j) + (i % c8) * VEC : 0), live);
    }
    // ---- stage the V tile (zeros past the live keys)
#pragma unroll
    for (int p = 0; p < MAX_LOADS; ++p) {
      const int i = tid + p * NTHREADS;
      if (i < TILE * c8) store_chunk(v_s + (i / c8) * D + (i % c8) * VEC, vc[p]);
    }
    // ---- logits, masked past kv_len
#pragma unroll
    for (int p = 0; p < MAX_LOADS; ++p) {
      const int kk = warp * kpw + sub + p * NWARPS * kpw;
      if (kk >= TILE) break;                    // uniform across the warp
      const bool live = base + kk < n_keys;
      float kf[VEC];
      unpack8(kc[p], kf);
      // four heads at a time, so their shuffle chains run side by side
      for (int g0 = 0; g0 < G; g0 += 4) {
        float s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s[u] = 0.f;
          if (g0 + u < G && cl < c8) {
            const float4* qg = reinterpret_cast<const float4*>(q_s + (g0 + u) * D + cl * VEC);
            const float4 a = qg[0], b = qg[1];
            s[u] = a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] + b.x * kf[4] +
                   b.y * kf[5] + b.z * kf[6] + b.w * kf[7];
          }
        }
        for (int o = lpk / 2; o > 0; o /= 2) {
#pragma unroll
          for (int u = 0; u < 4; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
        }
        if (cl == 0) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (g0 + u < G) p_s[(g0 + u) * TILE + kk] = live ? s[u] : MASK_VALUE;
        }
      }
    }
    __syncthreads();
    // ---- online softmax: one warp per query head, one lane per key. Key
    // `base` is live, so the tile's max is finite and masked keys get 0.
    for (int g = warp; g < G; g += NWARPS) {
      const float s = p_s[g * TILE + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[g * TILE + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);  // 0 on the first tile
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // ---- acc = acc * alpha + probs . v, one thread per (head, channel);
    // keys past kv_len have probability 0 and zero V rows, so every tile
    // sums all TILE keys, in four independent chains.
    for (int i = tid; i < G * D; i += NTHREADS) {
      const int g = i / D;
      const int d = i % D;
      const float* pg = p_s + g * TILE;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < TILE; ++kk) a[kk % 4] = fmaf(pg[kk], to_float(v_s[kk * D + d]), a[kk % 4]);
      acc_s[i] = acc_s[i] * alpha_s[g] + ((a[0] + a[1]) + (a[2] + a[3]));
    }
    __syncthreads();
  }

  T* ob = out + ((int64_t)b * Hq + (int64_t)h * G) * D;
  for (int i = tid; i < G * D; i += NTHREADS) {
    const float l = l_s[i / D];
    store(ob + i, l > 0.f ? acc_s[i] / l : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v, const void* table,
                   const void* kv_len, void* out, int B, int Hq, int Hkv, int D, int page,
                   int MP, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = f32_bytes(G, D, MP) + (size_t)TILE * D * sizeof(T);
  auto kernel = paged_decode_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int lpk = 1;  // lanes per key: a power of two covering D / 8 chunks
  while (lpk < D / VEC) lpk *= 2;
  dim3 grid(Hkv, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k), static_cast<const T*>(pool_v),
      static_cast<const int*>(table), static_cast<const int*>(kv_len), static_cast<T*>(out), Hq,
      Hkv, D, page, MP, lpk, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on `stream`
// and does not synchronise; out is allocated by the caller.
extern "C" int spider_paged_decode(const void* q, const void* pool_k, const void* pool_v,
                                   const void* table, const void* kv_len, void* out, int B,
                                   int Hq, int Hkv, int D, int page, int MP, float sm_scale,
                                   int is_fp32, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || D % VEC != 0 ||
      page <= 0 || MP <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_fp32)
    return (int)launch<float>(q, pool_k, pool_v, table, kv_len, out, B, Hq, Hkv, D, page, MP,
                              sm_scale, st);
  return (int)launch<__nv_bfloat16>(q, pool_k, pool_v, table, kv_len, out, B, Hq, Hkv, D, page,
                                    MP, sm_scale, st);
}
