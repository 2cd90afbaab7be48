"""Write hopper_wgmma.cuh: one inline-PTX wrapper per wgmma shape the flash
kernels issue (m64nNk16, bf16 operands, fp32 accumulators).

    python spider_tpu_torch/csrc/gen_wgmma.py > spider_tpu_torch/csrc/hopper_wgmma.cuh

PTX wants every accumulator register named in the instruction, so the
operand lists are spelt out here rather than by hand.
"""

SS_WIDTHS = (32, 64, 128)                     # A and B from shared memory, both K-major
RS_WIDTHS = tuple(range(16, 129, 16))      # A from registers, B MN-major ("transposed")

HEADER = """\
// Generated by gen_wgmma.py; do not edit. wgmma.mma_async wrappers for
// m64nNk16 with bf16 operands and fp32 accumulators. Included by hopper.cuh.
//
//   wgmma_ss<N>(d, desc_a, desc_b, scale_d): D (+)= A B^T, A [64][16] and
//     B [N][16] in shared memory, both with the contraction contiguous
//     (K-major) under the 128-byte swizzle.
//   wgmma_rs<N>(d, a, desc_b, scale_d): D (+)= A B, A [64][16] as the four
//     bf16x2 registers of the mma A fragment, B [16][N] in shared memory with
//     N contiguous (MN-major, the instruction's transposed-B form).
// scale_d = 0 overwrites D, anything else accumulates into it.
#pragma once
#include <stdint.h>

namespace hopper {

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d);
"""


def regs(n, first=0):
    names = [f"%{first + i}" for i in range(n)]
    lines = [", ".join(names[i:i + 8]) for i in range(0, n, 8)]
    return ", \"\n      \"".join(lines)


def acc_operands(n):
    ops = [f"\"+f\"(d[{i}])" for i in range(n)]
    return ",\n        ".join(", ".join(ops[i:i + 4]) for i in range(0, n, 4))


def emit_ss(N):
    n = N // 2
    print(f"""
template <>
__device__ __forceinline__ void wgmma_ss<{N}>(float (&d)[{n}], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {{
  asm volatile(
      "{{\\n"
      ".reg .pred p;\\n"
      "setp.ne.b32 p, %{n + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{N}k16.f32.bf16.bf16 "
      "{{{regs(n)}}}, "
      "%{n}, %{n + 1}, p, 1, 1, 0, 0;\\n"
      "}}\\n"
      : {acc_operands(n)}
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}}""")


def emit_rs(N):
    n = N // 2
    print(f"""
template <>
__device__ __forceinline__ void wgmma_rs<{N}>(float (&d)[{n}], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {{
  asm volatile(
      "{{\\n"
      ".reg .pred p;\\n"
      "setp.ne.b32 p, %{n + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{N}k16.f32.bf16.bf16 "
      "{{{regs(n)}}}, "
      "{{%{n}, %{n + 1}, %{n + 2}, %{n + 3}}}, %{n + 4}, p, 1, 1, 1;\\n"
      "}}\\n"
      : {acc_operands(n)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}}""")


def main():
    print(HEADER, end="")
    for N in SS_WIDTHS:
        emit_ss(N)
    for N in RS_WIDTHS:
        emit_rs(N)
    print("\n}  // namespace hopper")


if __name__ == "__main__":
    main()
