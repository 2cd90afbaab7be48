// Single wgmma products through the primitives of hopper.cuh, for the card
// tests (tests/test_torch_flash_cuda.py holds them to torch.matmul): a wrong
// shared-memory descriptor or fragment layout gives plausible garbage inside
// an attention kernel, and a plain product shows it at once.
//
//   mode 0: d[64][128] = a[64][128] b[128][128]^T, both operands from shared
//           memory with the contraction contiguous (K-major), two TMA boxes
//           each, eight k-steps;
//   mode 1: d[64][128] = a[64][64] b[64][128], a from registers in the mma
//           A-fragment layout, b from shared memory as it lies (MN-major, the
//           transposed-B form), two boxes side by side, four k-steps.
// a, b bf16, d fp32, all contiguous.
//
// spider_wgmma_probe_dsk is the second product of the dq kernel at its own
// widths: d[64][D] = a[64][128] b[128][D] for D = 16, 40, 80 or 128, a from
// registers, b a tile of 128 keys as one or two TMA boxes (zeros past D) read
// as it lies at n = D rounded up to 16, eight k-steps.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE64 = 64 * ROW_BYTES;
constexpr int TILE128 = 128 * ROW_BYTES;

__global__ void __launch_bounds__(128)
probe_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
             const __nv_bfloat16* __restrict__ a, float* __restrict__ d, int mode) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sA = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sB = sA + 2 * TILE64;
  const uint32_t bar = sB + 2 * TILE128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = warp * 16 + g;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  float acc[64];
  if (mode == 0) {
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar, 2 * TILE64 + 2 * TILE128);
      for (int box = 0; box < 2; ++box) {
        tma_load_4d(sA + box * TILE64, &map_a, bar, box * BOX_COLS, 0, 0, 0);
        tma_load_4d(sB + box * TILE128, &map_b, bar, box * BOX_COLS, 0, 0, 0);
      }
    }
    mbar_wait(bar, 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off_a = (kk / 4) * TILE64 + (kk % 4) * 32;
      const uint32_t off_b = (kk / 4) * TILE128 + (kk % 4) * 32;
      wgmma_ss<128>(acc, smem_desc(sA + off_a, 16, GROUP_BYTES),
                    smem_desc(sB + off_b, 16, GROUP_BYTES), kk > 0);
    }
  } else {
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar, 2 * TILE64);
      for (int box = 0; box < 2; ++box)
        tma_load_4d(sB + box * TILE64, &map_b, bar, box * BOX_COLS, 0, 0, 0);
    }
    uint32_t fa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* p = a + r0 * 64 + kk * 16 + 2 * t;
      fa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
      fa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * 64);
      fa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      fa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * 64 + 8);
    }
    mbar_wait(bar, 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<128>(acc, fa[kk], smem_desc(sB + kk * 16 * ROW_BYTES, TILE64, GROUP_BYTES),
                    kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = (i / 4) * 8 + 2 * t + (i & 1);
    const int row = r0 + ((i & 2) ? 8 : 0);
    d[row * 128 + col] = acc[i];
  }
}

template <int DP>
__global__ void __launch_bounds__(128)
probe_dsk_kernel(const __grid_constant__ CUtensorMap map_b, const __nv_bfloat16* __restrict__ a,
                 float* __restrict__ d, int D) {
  constexpr int NBOX = (DP + BOX_COLS - 1) / BOX_COLS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sB = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = sB + 2 * TILE128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = warp * 16 + g;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, NBOX * TILE128);
    for (int box = 0; box < NBOX; ++box)
      tma_load_4d(sB + box * TILE128, &map_b, bar, box * BOX_COLS, 0, 0, 0);
  }
  uint32_t fa[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const __nv_bfloat16* p = a + r0 * 128 + kk * 16 + 2 * t;
    fa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    fa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * 128);
    fa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    fa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * 128 + 8);
  }
  float acc[DP / 2];
  mbar_wait(bar, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs<DP>(acc, fa[kk], smem_desc(sB + kk * 16 * ROW_BYTES, TILE128, GROUP_BYTES), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int col = (i / 4) * 8 + 2 * t + (i & 1);
    const int row = r0 + ((i & 2) ? 8 : 0);
    if (col < D) d[row * D + col] = acc[i];
  }
}

template <int DP>
int launch_dsk(const void* a, const void* b, void* d, int D, cudaStream_t stream) {
  CUtensorMap map_b;
  CUresult r = make_map_4d(&map_b, b, 1, 128, 1, D, 128);
  if (r != CUDA_SUCCESS) return map_error(r);
  const int smem = 2 * TILE128 + 1024 + 16;
  cudaError_t err = cudaFuncSetAttribute(probe_dsk_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  probe_dsk_kernel<DP><<<1, 128, smem, stream>>>(map_b, static_cast<const __nv_bfloat16*>(a),
                                                 static_cast<float*>(d), D);
  return (int)cudaGetLastError();
}

}  // namespace

// d[64][D] = a[64][128] b[128][D]; returns as spider_wgmma_probe does.
extern "C" int spider_wgmma_probe_dsk(const void* a, const void* b, void* d, int D,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_dsk<16>(a, b, d, D, st);
    case 40:
      return launch_dsk<48>(a, b, d, D, st);
    case 80:
      return launch_dsk<80>(a, b, d, D, st);
    case 128:
      return launch_dsk<128>(a, b, d, D, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Returns 0, the cudaError_t of the launch, or -(1000 + CUresult) when a
// tensor map cannot be encoded. Launches on `stream`, does not synchronise.
extern "C" int spider_wgmma_probe(int mode, const void* a, const void* b, void* d,
                                  void* stream) {
  CUtensorMap map_a, map_b;
  CUresult r = CUDA_SUCCESS;
  if (mode == 0) {
    r = make_map_4d(&map_a, a, 1, 64, 1, 128, 64);
    if (r == CUDA_SUCCESS) r = make_map_4d(&map_b, b, 1, 128, 1, 128, 128);
  } else if (mode == 1) {
    r = make_map_4d(&map_a, b, 1, 64, 1, 128, 64);  // unused by the kernel
    if (r == CUDA_SUCCESS) r = make_map_4d(&map_b, b, 1, 64, 1, 128, 64);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (r != CUDA_SUCCESS) return map_error(r);
  const int smem = 2 * TILE64 + 2 * TILE128 + 1024 + 16;
  cudaError_t err = cudaFuncSetAttribute(probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<const __nv_bfloat16*>(a), static_cast<float*>(d), mode);
  return (int)cudaGetLastError();
}
