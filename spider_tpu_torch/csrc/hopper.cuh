// Hopper (sm_90a) primitives shared by the flash and int4 kernels: mbarriers, TMA tile
// loads, swizzled shared-memory descriptors, wgmma issue / fence / commit /
// wait, register reallocation, the work-item order of the persistent kernels,
// and the host side of a TMA tensor map.
//
// Shared-memory tiles are [rows][64 bf16] (128-byte rows) under the 128-byte
// swizzle, exactly as one TMA box of 64 columns lands: groups of 8 rows are
// 1024 bytes, and the 16-byte chunk c of row r sits at chunk c ^ (r % 8).
// Every tile base is 1024-byte aligned. A head dim above 64 takes two such
// tiles side by side ("boxes").
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace hopper {

constexpr int BOX_COLS = 64;          // bf16 columns of one TMA box: 128 bytes
constexpr int ROW_BYTES = 128;
constexpr int GROUP_BYTES = 8 * ROW_BYTES;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA --------------------------------------------------------------------

// One box of a 4-d tensor map into shared memory; completion is counted in
// bytes on `bar`. Coordinates innermost first. Elements outside the tensor
// arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-d tensor map (inner coordinate first).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One contiguous run of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global into shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The same from shared into global memory, as part of the thread's current
// bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until the thread's bulk stores have read their shared memory (the
// source may be overwritten), all but the newest `PENDING` groups.
template <int PENDING>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(PENDING) : "memory");
}

// The same, until they are complete.
template <int PENDING>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Orders this thread's ordinary shared-memory writes before bulk copies that
// read or overwrite the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor under the 128-byte swizzle. For a K-major
// operand ([rows][depth], depth contiguous) `sbo` is the distance between
// groups of 8 rows and `lbo` is unused; for an MN-major operand
// ([depth][cols], cols contiguous) `sbo` is the distance between groups of 8
// depth rows and `lbo` the distance between blocks of 64 columns.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---- arithmetic -------------------------------------------------------------

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment (16 deep) of one k-step from an fp32 accumulator: columns
// 16 * kk .. 16 * kk + 15 of the accumulator are its registers 8 * kk .. + 7.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&s)[N], int kk) {
  a[0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
}

// ---- persistent work items --------------------------------------------------

// One work item of a persistent attention kernel: a q tile of one (q head,
// batch). Items are numbered with the q tile slowest and, under a causal mask,
// descending, so the heavy items come first and neighbours share a KV head.
struct Item {
  int h, b, hk, q0, live, qoff, n_tiles;
};

__device__ __forceinline__ int item_batch(int item, int B, int Hq) {
  return (item % (Hq * B)) / Hq;
}

// The block's item of its round `local`: rounds run to and fro over the
// blocks (w, 2G - 1 - w, 2G + w, ...), so that with items sorted heavy to light
// every block's share weighs about the same. At or past n_items: no more.
__device__ __forceinline__ int item_of_round(int local) {
  const int w = (local & 1) ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  return local * (int)gridDim.x + w;
}

// BQ query rows an item, BK keys a tile; n_tiles is the count of key tiles
// below kv_len and the item's causal diagonal, at least MIN_TILES. kv_len_b
// and q_offset_b are the item's batch's entries, loaded by the caller one item
// ahead so that no item waits on them.
template <int BQ, int BK, int MIN_TILES>
__device__ __forceinline__ Item decode_item(int item, int n_q_tiles, int B, int T_len, int S,
                                            int Hq, int Hkv, int causal, int kv_len_b,
                                            int q_offset_b) {
  Item w;
  const int per_tile = Hq * B;
  const int qt = item / per_tile;
  const int rem = item - qt * per_tile;
  w.b = rem / Hq;
  w.h = rem - w.b * Hq;
  w.hk = w.h / (Hq / Hkv);
  w.q0 = (causal ? n_q_tiles - 1 - qt : qt) * BQ;
  w.live = max(0, min(kv_len_b, S));
  w.qoff = q_offset_b;
  int kv_hi = w.live;
  if (causal) kv_hi = min(kv_hi, min(w.q0 + BQ, T_len) + w.qoff);
  w.n_tiles = max(MIN_TILES, (kv_hi + BK - 1) / BK);
  return w;
}

// The card's SM count: one persistent block each.
inline int sm_count() {
  static int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
    return sms;
  }();
  return n;
}

// ---- host: tensor maps ------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library links without
// -lcuda. Null when the installed CUDA does not have it.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A bf16 tensor [B, L, H, D] (contiguous) seen as the 4-d tensor
// (D, H, L, B), cut into boxes of 64 columns x 1 head x `box_rows` rows x 1
// batch under the 128-byte swizzle. A box never crosses a batch or a head, and
// what it reads past D or L arrives as zeros. D must be a multiple of 8 and
// the base 16-byte aligned.
inline CUresult make_map_4d(CUtensorMap* map, const void* base, int B, int L, int H, int D,
                            int box_rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {BOX_COLS, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A byte matrix [rows, cols] (contiguous, cols a multiple of 16, the base
// 16-byte aligned) cut into boxes of `box_cols` x `box_rows` bytes that land
// as they lie, row after row, without a swizzle; what a box reads past an edge
// arrives as zeros.
inline CUresult make_map_2d_u8(CUtensorMap* map, const void* base, int rows, int cols,
                               int box_rows, int box_cols) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Error codes of the C entry points: a cudaError_t as it is, a CUresult of
// the tensor-map encoder as -(1000 + CUresult).
inline int map_error(CUresult r) { return -(1000 + (int)r); }

}  // namespace hopper
