// GroupNorm with an optional fused SiLU for Hopper (sm_90a), in bf16, bound to
// Python through a plain C entry point (loaded with ctypes by
// spider_tpu_torch/ops/group_norm.py).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which fuses
// it with its SiLU. On the card PyTorch's GroupNorm gives each (sample, group)
// row one thread block for its moments, then runs an apply pass, then the
// SiLU runs as a third pass. The UNet3D's per-video norms have 64 such rows
// of 0.23-0.92 M elements, so 64 blocks stream the whole tensor while most of
// the 132 SMs wait; this kernel splits each row over many blocks.
//
// It computes, for x [N, C, L] (L the product of the spatial sizes) and
// groups of Cg = C / G adjacent channels,
//   mean, var = the moments of row (n, g): its Cg * L elements, in fp32,
//   y = (x - mean) * (rsqrt(var + eps) * w[c]) + b[c] in fp32,
//   y = y * sigmoid(y) when asked, then rounded once to bf16.
// Two layouts are read where they lie:
//   contiguous     ([N, C, L] strides): row (n, g) is one span of Cg * L;
//   channels-last  ([N, L, C] storage): row (n, g) is L runs of Cg channels.
// y is written in x's layout. x and y are 16-byte aligned (the wrapper
// copies what is not); w and b are bf16 or absent.
//
// What bounds it on an H100: 2 FLOP-ish an element against 2 bytes read
// twice and written once, so HBM: one read and one write is the least
// traffic, 1.5x that is what two passes over a tensor larger than the 50 MB
// L2 move. At ZeroScope's (2, 320, 16, 2880) one call is 59 MB each way.
//
// Design:
//  * Pass 1 (statistics): one block per (row, chunk), the chunk count (and a
//    channels-last block's threads) chosen by the wrapper from the shape
//    (ops/group_norm.py::launch_plan) so that the card holds many blocks and
//    no chunk is small. Each thread reads 16-byte vectors, UNROLL of them in
//    flight before any arithmetic, and keeps Welford moments (count, mean,
//    M2) in fp32 per element slot of its vector; its slots and a scalar head
//    and tail are merged by Chan's formula, then the block's threads in a
//    fixed tree, and the block writes (count, mean, M2) to fp32 scratch
//    [rows, chunks, 3]. Channels-last: one block per (sample, chunk of
//    positions) covers every group; its `workers` threads are a multiple of
//    C / V, so each thread always sees the same V channels, and one warp per
//    group merges the slots of that group's channels.
//  * Pass 2 (apply): each block merges its row's chunk partials (one warp,
//    lanes over the chunks, then the same fixed tree) and writes its chunk in
//    16-byte stores. Blocks take the chunks in the reverse order of pass 1,
//    whose last chunks are the likeliest still in L2.
//  * No atomics and fixed merge orders: a call gives the same bits every
//    time on one card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using T = __nv_bfloat16;
constexpr int V = 8;                 // bf16 elements in a 16-byte vector
constexpr int CONTIG_THREADS = 256;  // contiguous layout: threads a block
constexpr int MAX_CL_THREADS = 512;  // channels-last: most threads a block
constexpr int UNROLL = 4;            // 16-byte loads a thread keeps in flight

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[V]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ uint4 pack(const float (&v)[V]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) e[j] = __float2bfloat16_rn(v[j]);
  return raw;
}

// Elements from p to the next 16-byte boundary (0 if p lies on one).
__device__ __forceinline__ long long to_aligned(const T* p) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
  return mis ? V - mis : 0;
}

struct Stat {
  float n, mean, m2;
};

// Chan's merge of two sets' moments; either may be empty.
__device__ __forceinline__ Stat chan(const Stat& a, const Stat& b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float d = b.mean - a.mean;
  const float wb = b.n / n;
  return {n, fmaf(d, wb, a.mean), a.m2 + b.m2 + d * d * a.n * wb};
}

// Lane 0 gets the merge of the warp's 32 stats, in a fixed tree.
__device__ __forceinline__ Stat warp_merge(Stat s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Stat o{__shfl_down_sync(0xffffffffu, s.n, off),
                 __shfl_down_sync(0xffffffffu, s.mean, off),
                 __shfl_down_sync(0xffffffffu, s.m2, off)};
    s = chan(s, o);
  }
  return s;
}

__device__ __forceinline__ Stat load_stat(const float* p) { return {p[0], p[1], p[2]}; }

__device__ __forceinline__ void store_stat(float* p, const Stat& s) {
  p[0] = s.n;
  p[1] = s.mean;
  p[2] = s.m2;
}

// One warp: the merge of `count` partials at p, p + 3, ... (lane 0 holds it).
__device__ __forceinline__ Stat merge_partials(const float* p, int count, int lane) {
  Stat s{0.f, 0.f, 0.f};
  for (int i = lane; i < count; i += 32) s = chan(s, load_stat(p + 3 * (long long)i));
  return warp_merge(s);
}

// Welford moments of each element slot of a thread's vectors; every slot has
// seen the same k elements.
struct Slots {
  float k, mean[V], m2[V];
  __device__ __forceinline__ void init() {
    k = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.f;
  }
  __device__ __forceinline__ void add(const float (&v)[V]) {
    k += 1.f;
    const float rk = __frcp_rn(k);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - mean[j];
      mean[j] = fmaf(d, rk, mean[j]);
      m2[j] = fmaf(d, v[j] - mean[j], m2[j]);
    }
  }
};

__device__ __forceinline__ void welford(Stat& s, float v) {
  s.n += 1.f;
  const float d = v - s.mean;
  s.mean += d / s.n;
  s.m2 = fmaf(d, v - s.mean, s.m2);
}

template <bool SILU>
__device__ __forceinline__ float finish(float v) {
  return SILU ? v * __frcp_rn(1.f + __expf(-v)) : v;
}

// Streams vectors [0, nvec) of p, `workers` threads apart, UNROLL loads in
// flight, into the thread's slots.
__device__ __forceinline__ void accumulate(const T* p, long long nvec, int t, int workers,
                                           Slots& acc) {
  for (long long v0 = t; v0 < nvec; v0 += (long long)workers * UNROLL) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + (long long)u * workers;
      if (v < nvec) raw[u] = *reinterpret_cast<const uint4*>(p + v * V);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (v0 + (long long)u * workers < nvec) {
        float f[V];
        unpack(raw[u], f);
        acc.add(f);
      }
    }
  }
}

// ---- contiguous layout: rows of R = Cg * L elements, one span each; blocks
// of CONTIG_THREADS, a compile-time stride (a runtime one and a 512-thread
// launch bound took 13-35% longer on an H100)

struct Span {
  long long row0, b, e, a0, nvec, a1;  // row start; chunk [b, e); vectors [a0, a1)
};

__device__ __forceinline__ Span chunk_span(const T* x, int row, int chunk, long long R,
                                           long long chunk_len) {
  Span s;
  s.row0 = (long long)row * R;
  s.b = s.row0 + (long long)chunk * chunk_len;
  s.e = min(s.b + chunk_len, s.row0 + R);
  s.a0 = min(s.e, s.b + to_aligned(x + s.b));
  s.nvec = (s.e - s.a0) / V;
  s.a1 = s.a0 + s.nvec * V;
  return s;
}

__global__ void __launch_bounds__(CONTIG_THREADS)
    stats_contig(const T* __restrict__ x, float* __restrict__ part, long long R, int chunks,
                 long long chunk_len) {
  constexpr int threads = CONTIG_THREADS;
  __shared__ Stat warp_stats[threads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const Span sp = chunk_span(x, blockIdx.x / chunks, blockIdx.x % chunks, R, chunk_len);
  Slots acc;
  acc.init();
  accumulate(x + sp.a0, sp.nvec, t, threads, acc);
  Stat s{0.f, 0.f, 0.f};
  if (sp.b + t < sp.a0) welford(s, __bfloat162float(x[sp.b + t]));   // head before the first vector
  if (sp.a1 + t < sp.e) welford(s, __bfloat162float(x[sp.a1 + t]));  // tail after the last
#pragma unroll
  for (int j = 0; j < V; ++j) s = chan(s, Stat{acc.k, acc.mean[j], acc.m2[j]});
  s = warp_merge(s);
  if (lane == 0) warp_stats[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < threads / 32 ? warp_stats[lane] : Stat{0.f, 0.f, 0.f};
    s = warp_merge(s);
    if (lane == 0) store_stat(part + 3 * (long long)blockIdx.x, s);
  }
}

// y = (x - mean) * A + B for channel c: the mean is taken off first, so a
// row far from zero keeps its digits.
__device__ __forceinline__ void affine(const T* w, const T* b, int c, float rstd, float& A,
                                       float& B) {
  A = rstd * (w ? __bfloat162float(w[c]) : 1.f);
  B = b ? __bfloat162float(b[c]) : 0.f;
}

template <bool SILU>
__global__ void __launch_bounds__(CONTIG_THREADS)
    apply_contig(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ part,
                 const T* __restrict__ w, const T* __restrict__ bias, int G, int Cg, long long L,
                 long long R, int chunks, long long chunk_len, float eps) {
  constexpr int threads = CONTIG_THREADS;
  __shared__ float s_mean, s_rstd;
  const int t = threadIdx.x;
  const int item = gridDim.x - 1 - blockIdx.x;
  const int row = item / chunks;
  if (t < 32) {
    const Stat s = merge_partials(part + 3 * (long long)row * chunks, chunks, t);
    if (t == 0) {
      s_mean = s.mean;
      s_rstd = rsqrtf(s.m2 / s.n + eps);
    }
  }
  __syncthreads();
  const float mean = s_mean, rstd = s_rstd;
  const int c0 = (row % G) * Cg;
  const Span sp = chunk_span(x, row, item % chunks, R, chunk_len);
  auto one = [&](long long i) {  // a head or tail element
    float A, B;
    affine(w, bias, c0 + (int)((i - sp.row0) / L), rstd, A, B);
    y[i] = __float2bfloat16_rn(finish<SILU>(fmaf(__bfloat162float(x[i]) - mean, A, B)));
  };
  if (sp.b + t < sp.a0) one(sp.b + t);
  if (sp.a1 + t < sp.e) one(sp.a1 + t);
  // The channel of the thread's next vector, (cl, r): its offset in the row
  // is cl * L + r; each step of the loop moves it threads * V further.
  const long long step = (long long)threads * V;
  const long long step_c = step / L, step_r = step % L;
  long long cl = (sp.a0 - sp.row0 + (long long)t * V) / L;
  long long r = (sp.a0 - sp.row0 + (long long)t * V) - cl * L;
  const T* xp = x + sp.a0;
  T* yp = y + sp.a0;
  for (long long v0 = t; v0 < sp.nvec; v0 += (long long)threads * UNROLL) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + (long long)u * threads;
      if (v < sp.nvec) raw[u] = *reinterpret_cast<const uint4*>(xp + v * V);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + (long long)u * threads;
      if (v < sp.nvec) {
        float f[V];
        unpack(raw[u], f);
        long long cc = cl, rr = r;
        float A, B;
        affine(w, bias, c0 + (int)cc, rstd, A, B);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (rr == L) {
            ++cc;
            rr = 0;
            affine(w, bias, c0 + (int)cc, rstd, A, B);
          }
          f[j] = finish<SILU>(fmaf(f[j] - mean, A, B));
          ++rr;
        }
        *reinterpret_cast<uint4*>(yp + v * V) = pack(f);
      }
      r += step_r;
      cl += step_c;
      if (r >= L) {
        r -= L;
        ++cl;
      }
    }
  }
}

// ---- channels-last layout: [N, L, C] storage, blocks over (sample, chunk
// of positions); `workers` = (C / V) * k threads, so thread t's vectors all
// hold channels (t % (C / V)) * V .. + V.

__global__ void __launch_bounds__(MAX_CL_THREADS)
    stats_cl(const T* __restrict__ x, float* __restrict__ part, int C, int G, long long L,
             int chunks, long long per_chunk, int workers) {
  __shared__ float slots[MAX_CL_THREADS * V * 2];  // (mean, M2) of each thread's slots
  __shared__ float counts[MAX_CL_THREADS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const int n = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const long long l0 = (long long)chunk * per_chunk, l1 = min(l0 + per_chunk, L);
  Slots acc;
  acc.init();
  if (t < workers) {
    accumulate(x + ((long long)n * L + l0) * C, (l1 - l0) * C / V, t, workers, acc);
    counts[t] = acc.k;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      slots[2 * (t * V + j)] = acc.mean[j];
      slots[2 * (t * V + j) + 1] = acc.m2[j];
    }
  }
  __syncthreads();
  const int Cg = C / G, cvec = C / V, share = workers / cvec;  // threads a channel
  for (int g = warp; g < G; g += nwarps) {
    Stat s{0.f, 0.f, 0.f};
    for (int e = lane; e < Cg * share; e += 32) {
      const int c = g * Cg + e / share;
      const int th = c / V + (e % share) * cvec;
      const float* q = slots + 2 * (th * V + c % V);
      s = chan(s, Stat{counts[th], q[0], q[1]});
    }
    s = warp_merge(s);
    if (lane == 0) store_stat(part + 3 * (((long long)n * G + g) * chunks + chunk), s);
  }
}

// Dynamic shared memory: 2 * G floats, each group's mean and rstd.
template <bool SILU>
__global__ void __launch_bounds__(MAX_CL_THREADS)
    apply_cl(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ part,
             const T* __restrict__ w, const T* __restrict__ bias, int C, int G, long long L,
             int chunks, long long per_chunk, int workers, float eps) {
  extern __shared__ float group_stats[];
  float* s_mean = group_stats;
  float* s_rstd = group_stats + G;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const int item = gridDim.x - 1 - blockIdx.x;
  const int n = item / chunks, chunk = item % chunks;
  for (int g = warp; g < G; g += nwarps) {
    const Stat s = merge_partials(part + 3 * ((long long)n * G + g) * chunks, chunks, lane);
    if (lane == 0) {
      s_mean[g] = s.mean;
      s_rstd[g] = rsqrtf(s.m2 / s.n + eps);
    }
  }
  __syncthreads();
  if (t >= workers) return;
  const int Cg = C / G, cb = (t % (C / V)) * V;
  float M[V], A[V], B[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = cb + j;
    M[j] = s_mean[c / Cg];
    affine(w, bias, c, s_rstd[c / Cg], A[j], B[j]);
  }
  const long long l0 = (long long)chunk * per_chunk, l1 = min(l0 + per_chunk, L);
  const long long off = ((long long)n * L + l0) * C, nvec = (l1 - l0) * C / V;
  const T* xp = x + off;
  T* yp = y + off;
  for (long long v0 = t; v0 < nvec; v0 += (long long)workers * UNROLL) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + (long long)u * workers;
      if (v < nvec) raw[u] = *reinterpret_cast<const uint4*>(xp + v * V);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + (long long)u * workers;
      if (v < nvec) {
        float f[V];
        unpack(raw[u], f);
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = finish<SILU>(fmaf(f[j] - M[j], A[j], B[j]));
        *reinterpret_cast<uint4*>(yp + v * V) = pack(f);
      }
    }
  }
}

}  // namespace

// The threads of a block that the wrapper plans with: the contiguous
// layout's (exactly), or the most a channels-last block may have.
extern "C" int spider_group_norm_threads(int channels_last) {
  return channels_last ? MAX_CL_THREADS : CONTIG_THREADS;
}

// Returns the cudaError_t of the two launches (0 on success). Launches on
// `stream` and does not synchronise; y and part ([N * G, chunks, 3] fp32) are
// allocated by the caller; w and b may be null (weight 1, bias 0). x, y, w
// and b are bf16. Each block has `threads` threads, as
// spider_group_norm_threads(channels_last) gives them.
//   channels_last 0: x is [N, C, L] contiguous, a chunk is per_chunk elements
//   of a row, `threads` == `workers` == CONTIG_THREADS;
//   1: x is [N, L, C] storage, a chunk is per_chunk positions of a sample, C
//   a multiple of 8, and `workers` (at most `threads`) a multiple of C / 8.
extern "C" int spider_group_norm(const void* xv, void* yv, const void* wv, const void* bv,
                                 void* part, int channels_last, long long N, int C, int G,
                                 long long L, int chunks, long long per_chunk, int threads,
                                 int workers, float eps, int silu, void* stream) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const T* w = static_cast<const T*>(wv);
  const T* b = static_cast<const T*>(bv);
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || C <= 0 || G <= 0 || C % G || L <= 0 || chunks <= 0 || per_chunk <= 0 ||
      threads < 32 || threads > MAX_CL_THREADS || threads % 32 || workers <= 0 ||
      workers > threads)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int Cg = C / G;
  // Each chunk holds some of its row, and the chunks cover it.
  const long long units = channels_last ? L : (long long)Cg * L;
  const long long blocks = channels_last ? N * chunks : N * G * chunks;
  if (blocks > INT32_MAX || (long long)(chunks - 1) * per_chunk >= units ||
      (long long)chunks * per_chunk < units)
    return (int)cudaErrorInvalidValue;
  if (!channels_last) {
    if (threads != CONTIG_THREADS || workers != threads) return (int)cudaErrorInvalidValue;
    const long long R = (long long)Cg * L;
    stats_contig<<<(int)blocks, threads, 0, st>>>(x, p, R, chunks, per_chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (silu)
      apply_contig<true><<<(int)blocks, threads, 0, st>>>(x, y, p, w, b, G, Cg, L, R, chunks,
                                                          per_chunk, eps);
    else
      apply_contig<false><<<(int)blocks, threads, 0, st>>>(x, y, p, w, b, G, Cg, L, R, chunks,
                                                           per_chunk, eps);
    return (int)cudaGetLastError();
  }
  if (C % V || workers % (C / V)) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)G * sizeof(float);  // G <= C <= 8 * MAX_CL_THREADS: 32 KB
  stats_cl<<<(int)blocks, threads, 0, st>>>(x, p, C, G, L, chunks, per_chunk, workers);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (silu)
    apply_cl<true><<<(int)blocks, threads, smem, st>>>(x, y, p, w, b, C, G, L, chunks,
                                                        per_chunk, workers, eps);
  else
    apply_cl<false><<<(int)blocks, threads, smem, st>>>(x, y, p, w, b, C, G, L, chunks,
                                                         per_chunk, workers, eps);
  return (int)cudaGetLastError();
}
