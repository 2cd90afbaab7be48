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
// the dependent loads bound it.
//
// Two kernels, chosen by ops/paged_attention.py::paged_route: "split" (bf16, a
// page that is a multiple of 16 keys, D a multiple of 16 up to 128: what the
// batcher and the chat give it), below with its own note, and the first form,
// "simple", which takes what that does not: fp32 pools, any page size, any D
// that is a multiple of 8 up to 256.
//
// Design of the first form ("simple"):
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
//  * One slot's keys are not split over blocks and the next tile is not
//    loaded under this one's arithmetic: with one slot and a long context (the
//    chat at kv_len ~1800) only Hkv = 8 blocks run and walk 55 tiles each.
//    The split form does both.

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

// ---------------------------------------------------------------------------
// Route "split": bf16, a page that is a multiple of 16 keys, D a multiple of 16
// up to 128. Bound by the live K/V bytes through HBM.
//
// What held the first kernel back: one block per (KV head, slot) walked all of
// a slot's keys; every 32-key tile cost three block barriers, shuffle chains
// for q . k and a serial probs . v chain a thread, and the next tile's loads
// waited for this tile's arithmetic: latency, not bytes, bounded it, and one
// slot with a long context ran on 8 of 132 SMs.
//
// Design:
//  * Grid (KV head x groups of 16 query heads, slot, split): a slot's keys are
//    cut in `n_split` ranges of `keys_per_split` keys (ops/paged_attention.py
//    ::split_plan, from max_pages * page and the card's SM count, never from
//    kv_len on the host). A block whose range starts at or past kv_len leaves
//    at once.
//  * Inside a block each of 4 warps owns every fourth 16-key tile of the range
//    and its own online softmax; no block barrier until the range is done. A
//    tile lies inside one page, so one table entry finds it.
//  * K and V tiles come by cp.async, 16 bytes a copy, two stages a warp: tile
//    i + 1 is in flight under tile i's arithmetic. Keys past kv_len are zeroed
//    in shared memory, not read.
//  * q . k^T and probs . v run on mma.sync.m16n8k16 fed by ldmatrix (V through
//    its transposing form); the G query heads of the KV head are the rows of
//    the tile, padded to 16 with zeros. Logits, max, sum and accumulator are
//    fp32; the probabilities are rounded to bf16 for the second product.
//  * The 4 warps' (max, sum, accumulator) merge through shared memory; with
//    more than one live split the block's partial goes to fp32 scratch and the
//    block that arrives last at the (slot, head group) counter merges the live
//    splits in split order: the same bits every run. The counter is left at 0.
// ---------------------------------------------------------------------------

namespace split {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int KEYS = 16;     // keys of a tile: the depth of one probs . v mma
constexpr int STAGES = 2;
constexpr int ROWS = 16;     // query heads of a block, padded: the rows of an mma
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void zero16(uint32_t dst) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst), "r"(0u) : "memory");
}

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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The weight of a part whose running max is m in a merge whose max is m_all.
__device__ __forceinline__ float part_weight(float m, float m_all) {
  return m == -INFINITY ? 0.f : exp2f(m - m_all);
}

struct Params {
  const __nv_bfloat16 *q, *pool_k, *pool_v;
  const int *table, *kv_len;
  __nv_bfloat16* out;
  float* part;      // [slot][head group][split][ROWS][D + 2]: accumulator, max, sum
  int* counters;    // [slot][head group], zero between launches
  int Hq, Hkv, page, MP, n_split, keys_per_split;
  float scale_log2;  // sm_scale * log2(e): the softmax runs on exp2
};

template <int D>
__global__ void __launch_bounds__(THREADS) paged_split_kernel(const Params p) {
  constexpr int KD = D / 16;            // 16-deep steps of q . k
  constexpr int ND = D / 8;             // 8-wide tiles of the output
  constexpr int PITCH = D * 2 + 16;     // an odd count of 16 bytes: ldmatrix rows in distinct banks
  constexpr int TILE_BYTES = KEYS * PITCH;
  constexpr int WARP_BYTES = STAGES * 2 * TILE_BYTES;
  constexpr int REC = D + 2;            // floats of one row of a partial
  static_assert(WARP_BYTES >= ROWS * REC * 4, "a warp's partial fits its tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int flag;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int G = p.Hq / p.Hkv;
  const int chunks = (G + ROWS - 1) / ROWS;
  const int h = blockIdx.x / chunks;                 // KV head
  const int chunk = blockIdx.x % chunks;
  const int rows = min(ROWS, G - chunk * ROWS);      // live query heads of the block
  const int head0 = h * G + chunk * ROWS;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int n_keys = max(0, min(p.kv_len[b], p.MP * p.page));
  const int k_lo = s * p.keys_per_split;
  __nv_bfloat16* ob = p.out + ((int64_t)b * p.Hq + head0) * D;
  if (k_lo >= n_keys) {
    if (s == 0)   // kv_len = 0: the row is 0
      for (int i = threadIdx.x; i < rows * D; i += THREADS) ob[i] = __float2bfloat16(0.f);
    return;
  }
  const int k_hi = min(n_keys, k_lo + p.keys_per_split);
  const int n_tiles = (k_hi - k_lo + KEYS - 1) / KEYS;
  const int live_splits = (n_keys + p.keys_per_split - 1) / p.keys_per_split;

  // ---- q as A fragments (rows past the group are zero)
  uint32_t qa[KD][4];
  {
    const __nv_bfloat16* qb = p.q + ((int64_t)b * p.Hq + head0) * D;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int d0 = kd * 16 + 2 * t;
      const uint32_t* r0 = reinterpret_cast<const uint32_t*>(qb + g * D + d0);
      const uint32_t* r1 = reinterpret_cast<const uint32_t*>(qb + (g + 8) * D + d0);
      qa[kd][0] = g < rows ? r0[0] : 0u;
      qa[kd][1] = g + 8 < rows ? r1[0] : 0u;
      qa[kd][2] = g < rows ? r0[4] : 0u;
      qa[kd][3] = g + 8 < rows ? r1[4] : 0u;
    }
  }

  const uint32_t mine = smem_u32(smem_raw) + warp * WARP_BYTES;
  const int my_tiles = warp < n_tiles ? (n_tiles - warp + WARPS - 1) / WARPS : 0;
  // The warp's i-th tile into stage i % STAGES: K, then V, [KEYS][PITCH].
  auto issue = [&](int i) {
    if (i < my_tiles) {
      const int key0 = k_lo + (warp + i * WARPS) * KEYS;
      const int blk = __ldg(p.table + (int64_t)b * p.MP + key0 / p.page);
      const int64_t row0 = ((int64_t)blk * p.page + key0 % p.page) * p.Hkv + h;
      const uint32_t dst = mine + (i % STAGES) * 2 * TILE_BYTES;
      for (int c = lane; c < KEYS * ND; c += 32) {
        const int r = c / ND;
        const int cc = c % ND;
        const uint32_t d = dst + r * PITCH + cc * 16;
        if (key0 + r < n_keys) {
          const int64_t off = (row0 + (int64_t)r * p.Hkv) * D + cc * 8;
          cp_async16(d, p.pool_k + off);
          cp_async16(d + TILE_BYTES, p.pool_v + off);
        } else {
          zero16(d);
          zero16(d + TILE_BYTES);
        }
      }
    }
    cp_async_commit();
  };

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  issue(0);
  for (int i = 0; i < my_tiles; ++i) {
    issue(i + 1);
    cp_async_wait<1>();
    __syncwarp();
    const int key0 = k_lo + (warp + i * WARPS) * KEYS;
    const uint32_t k_s = mine + (i % STAGES) * 2 * TILE_BYTES;
    const uint32_t v_s = k_s + TILE_BYTES;
    // ---- logits [16 heads][16 keys]: matrices (keys 0-7, d low), (keys 0-7,
    // d high), (keys 8-15, d low), (keys 8-15, d high)
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t bk[4];
      ldmatrix_x4(bk, k_s + ((lane / 16) * 8 + lane % 8) * PITCH +
                          (kd * 16 + 8 * ((lane / 8) & 1)) * 2);
      mma_bf16(sc[0], qa[kd], bk[0], bk[1]);
      mma_bf16(sc[1], qa[kd], bk[2], bk[3]);
    }
    // ---- online softmax; this thread holds rows g and g + 8, keys 8 j + 2 t
    // and + 1. The tile's first key is live, so every row's max is finite.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + 2 * t + (e & 1);
        sc[j][e] = key < n_keys ? sc[j][e] * p.scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = exp2f(m_run[r] - m_new);   // 0 on the first tile
      m_run[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2f(sc[j][e] - m_run[e >> 1]);
        sum[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];   // this thread's keys
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    const uint32_t pa[4] = {pack_bf16x2(sc[0][0], sc[0][1]), pack_bf16x2(sc[0][2], sc[0][3]),
                            pack_bf16x2(sc[1][0], sc[1][1]), pack_bf16x2(sc[1][2], sc[1][3])};
    // ---- acc += probs . v: matrices, transposed: (keys 0-7, d j), (keys 8-15,
    // d j), (keys 0-7, d j + 1), (keys 8-15, d j + 1)
#pragma unroll
    for (int j = 0; j < ND; j += 2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, v_s + ((lane % 8) + 8 * ((lane / 8) & 1)) * PITCH +
                                (j + lane / 16) * 16);
      mma_bf16(acc[j], pa, bv[0], bv[1]);
      mma_bf16(acc[j + 1], pa, bv[2], bv[3]);
    }
    __syncwarp();   // the stage is read before the tile after next lands in it
  }
  cp_async_wait<0>();
  __syncwarp();

  // ---- the warp's partial into its own tile memory: [ROWS][D] acc, max, sum
  float* wp = reinterpret_cast<float*>(smem_raw + warp * WARP_BYTES);
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = quad_sum(l_run[r]);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    float* r0 = wp + g * REC + 8 * j + 2 * t;
    r0[0] = acc[j][0];
    r0[1] = acc[j][1];
    r0[8 * REC] = acc[j][2];
    r0[8 * REC + 1] = acc[j][3];
  }
  if (t == 0) {
    wp[g * REC + D] = m_run[0];
    wp[g * REC + D + 1] = l_run[0];
    wp[(g + 8) * REC + D] = m_run[1];
    wp[(g + 8) * REC + D + 1] = l_run[1];
  }
  __syncthreads();

  // ---- merge the 4 warps, in warp order
  const float* w0 = reinterpret_cast<const float*>(smem_raw);
  constexpr int WSTRIDE = WARP_BYTES / 4;
  const int unit = b * gridDim.x + blockIdx.x;
  float* rec = p.part + ((int64_t)unit * p.n_split + s) * (ROWS * REC);
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int row = i / D;
    const int d = i % D;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m_all = fmaxf(m_all, w0[w * WSTRIDE + row * REC + D]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* r = w0 + w * WSTRIDE + row * REC;
      const float wt = part_weight(r[D], m_all);
      l += r[D + 1] * wt;
      a += r[d] * wt;
    }
    if (live_splits == 1) {
      ob[i] = __float2bfloat16(a / l);
    } else {
      rec[row * REC + d] = a;
      if (d == 0) {
        rec[row * REC + D] = m_all;
        rec[row * REC + D + 1] = l;
      }
    }
  }
  if (live_splits == 1) return;

  // ---- the live splits meet: the last block to arrive merges them in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int old = atomicAdd(p.counters + unit, 1);
    const int last = old == live_splits - 1;
    if (last) p.counters[unit] = 0;
    flag = last;
  }
  __syncthreads();
  if (!flag) return;
  __threadfence();
  const float* first = p.part + (int64_t)unit * p.n_split * (ROWS * REC);
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int row = i / D;
    const int d = i % D;
    float m_all = -INFINITY;
    for (int sp = 0; sp < live_splits; ++sp)
      m_all = fmaxf(m_all, __ldcg(first + sp * (ROWS * REC) + row * REC + D));
    float l = 0.f, a = 0.f;
    for (int sp = 0; sp < live_splits; ++sp) {
      const float* r = first + sp * (ROWS * REC) + row * REC;
      const float wt = part_weight(__ldcg(r + D), m_all);
      l += __ldcg(r + D + 1) * wt;
      a += __ldcg(r + d) * wt;
    }
    ob[i] = __float2bfloat16(a / l);
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = WARPS * STAGES * 2 * KEYS * (D * 2 + 16);
  static bool ready = false;
  if (!ready) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(paged_split_kernel<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    ready = true;
  }
  const int G = p.Hq / p.Hkv;
  dim3 grid(p.Hkv * ((G + ROWS - 1) / ROWS), B, p.n_split);
  paged_split_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace split

// Route "split": bf16 only. `n_split` and `keys_per_split` come from
// ops/paged_attention.py::split_plan; `part` holds B x head groups x n_split x
// 16 x (D + 2) floats, `counters` one zeroed int per (slot, head group), left
// zeroed. Returns the cudaError_t of the launch.
extern "C" int spider_paged_decode_split(const void* q, const void* pool_k, const void* pool_v,
                                         const void* table, const void* kv_len, void* out,
                                         void* part, void* counters, int B, int Hq, int Hkv,
                                         int D, int page, int MP, int n_split,
                                         int keys_per_split, float sm_scale, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || D <= 0 || D > 128 ||
      D % 16 != 0 || page <= 0 || page % split::KEYS != 0 || MP <= 0 || n_split <= 0 ||
      n_split > 65535 || keys_per_split <= 0 || keys_per_split % split::KEYS != 0 ||
      (int64_t)n_split * keys_per_split < (int64_t)MP * page || part == nullptr ||
      counters == nullptr)
    return (int)cudaErrorInvalidValue;
  split::Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.pool_k = static_cast<const __nv_bfloat16*>(pool_k);
  p.pool_v = static_cast<const __nv_bfloat16*>(pool_v);
  p.table = static_cast<const int*>(table);
  p.kv_len = static_cast<const int*>(kv_len);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.Hq = Hq; p.Hkv = Hkv; p.page = page; p.MP = MP;
  p.n_split = n_split; p.keys_per_split = keys_per_split;
  p.scale_log2 = sm_scale * split::LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)split::launch<16>(p, B, st);
    case 32: return (int)split::launch<32>(p, B, st);
    case 48: return (int)split::launch<48>(p, B, st);
    case 64: return (int)split::launch<64>(p, B, st);
    case 80: return (int)split::launch<80>(p, B, st);
    case 96: return (int)split::launch<96>(p, B, st);
    case 112: return (int)split::launch<112>(p, B, st);
    default: return (int)split::launch<128>(p, B, st);
  }
}

// The first kernel (route "simple"). Returns the cudaError_t of the launch (0
// on success). Launches on `stream` and does not synchronise; out is allocated
// by the caller.
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
