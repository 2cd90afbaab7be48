"""Weight-only int4 matmul: the plain PyTorch version and the CUDA kernel.

Counterpart of spider_tpu/ops/quant.py, the int4 serving path of the 8B
decoder. Decode reads every weight once per token, so packing two 4-bit
weights per byte reads a quarter of the bf16 bytes, if the unpack happens
inside the matmul. ``int4_matmul`` launches a hand-written kernel
(csrc/int4_matmul.cu) on CUDA tensors and takes ``int4_matmul_reference`` on
CPU tensors. On a CUDA tensor it launches the kernel or raises; it never
falls back.

Packed layout (split-half, as in the JAX package): byte (i, n) of the JAX
array ``packed [K/2, N]`` holds W[i, n] in its low nibble and W[i + K/2, n]
in its high nibble, both signed. The port keeps each projection as
[out, in] (``convert.load_jax_params`` transposes ``kernel_q``), so here
``packed`` is [N, K/2]: row n holds output channel n, and every unpack puts
the low nibbles (rows 0..K/2-1 of W) before the high ones. W column n is
scaled by ``scale[n]`` on the fp32 accumulator.

Routing on CUDA follows the JAX wrapper's own rule (quant.py:114-122):
M = rows of x up to 4 * block_m = 1024 launch a kernel; longer inputs
(a long-prompt prefill) dequantise the weight and call ``torch.matmul``,
where the product is bound by the tensor cores and the unpack amortises
over thousands of rows. That is the reference's routing, not a fallback.
The JAX wrapper also sends a K/2 that no block divides to XLA; the first
CUDA kernel masks the ragged edge itself, so ragged K takes that kernel.

Three kernels share the source, and ``int4_route`` names one by a stated
rule: "stream" (bf16 x, up to 16 rows, K/2 up to 2048: the decode step),
"wgmma" (bf16 x, 48 to 1024 rows: the prefill, bound by the tensor cores)
and "mma", the first kernel, for everything else. ``route=`` on
``int4_matmul_kernel`` names one for tests and timings;
``int4_matmul.route_launches`` counts per route. Where the wgmma form cuts K
in slices, the slices' partial tiles meet in an fp32 scratch tensor and are
added in slice order by the block that arrives last at the tile's counter:
the same bits every run. Scratch and counters are cached per (device,
stream) and the counters are left zeroed by every launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from spider_tpu_torch.ops.launch import (count_launch, current_stream_handle, scoped_mode,
                                         sm_count, stream_buffers)

# Rows of x up to which the kernel runs (the JAX wrapper's M <= 4 * block_m).
MAX_KERNEL_M = 1024
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Routing override for A/B checks on the card: "auto" = the rule above;
# "plain" = int4_matmul_reference everywhere.
int4_matmul_config, _mode = scoped_mode("int4_matmul_mode", ("auto", "plain"), "auto")


def pack_int4(w: torch.Tensor) -> torch.Tensor:
    """[K, N] integers in [-8, 7] -> [K/2, N] int8 (split-half), bit-exact
    with the JAX ``pack_int4``."""
    K = w.shape[0]
    if K % 2:
        raise ValueError(f"K must be even, got {K}")
    lo = w[: K // 2].to(torch.int8)
    hi = w[K // 2:].to(torch.int8)
    return (lo & 0x0F) | (hi << 4)


def unpack_int4(packed: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of pack_int4 along dim 0: [K/2, ...] -> [K, ...] in `dtype`.
    (For the port's [N, K/2] layout, unpack the transpose.)"""
    p = packed.to(torch.int8)
    lo = (p << 4) >> 4       # arithmetic shifts sign-extend each nibble
    hi = p >> 4
    return torch.cat([lo, hi], dim=0).to(dtype)


def quantize_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp weights [K, N] -> (packed [K/2, N] int8, scale [N] fp32), symmetric
    per output channel: s = max|w[:, n]| / 7, q = clip(round(w / s), -8, 7)."""
    scale = w.abs().amax(dim=0).clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(w / scale[None, :]), -8, 7).to(torch.int8)
    return pack_int4(q), scale.to(torch.float32)


def dequantize_int4(packed: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The port's packed [N, K/2] -> W^T [N, K] in `dtype` (unscaled)."""
    return unpack_int4(packed.t(), dtype).t()


def int4_matmul_reference(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version (quant.py:151-156): fp32 unpack, x in fp32, the
    scale on the fp32 product, then the cast. x [.., K]; packed [N, K/2]."""
    out_dtype = out_dtype or x.dtype
    w = dequantize_int4(packed, torch.float32)                      # [N, K]
    y = torch.matmul(x.float(), w.t()) * scale.float()
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/int4_matmul.cu)
# ---------------------------------------------------------------------------

ROUTES = ("stream", "wgmma", "mma")
# The constants of the rule below were read from rows of chip_smoke.py on an
# NVIDIA H100 80GB HBM3 at its 700 W limit (device time).
# Rows of x the streaming form takes: one mma row tile, the serving batcher's
# 16 slots. Each of its warps keeps its share of x in registers (64 a lane
# at 16 rows), which is what frees shared memory for a deep ring; a second
# row tile does not fit.
STREAM_MAX_M = 16
# The K/2 the streaming form takes: its 16 warps own 128 packed bytes of a row
# each, and it reads whole rows. Cutting a longer K in slices that meet through
# scratch was slower than the first kernel (down, K/2 = 7168, at 16 rows:
# 0.035 ms against 0.022 in the `kernel` rows of that draft).
STREAM_MAX_K2 = 2048
# Rows of x from which the wgmma form runs. Its block computes 128 rows of x
# whatever M is, so below ~48 rows the first kernel, whose work grows with M,
# is ahead (`int4_crossover` rows: gate/up at M 32 0.031 ms on "mma" against
# 0.043 on "wgmma", at M 48 0.048 against 0.035).
WGMMA_MIN_M = 48


def int4_route(dtype: torch.dtype, M: int, K2: int, aligned: bool) -> str:
    """The kernel an int4 matmul of M <= 1024 rows takes on the card.
    "stream": bf16 x, M <= 16 and K/2 <= 2048 (decode: whole rows streamed
    through a deep TMA ring, x in registers). "wgmma": bf16 x, M >= 48
    (prefill: the tensor cores bound it). Both want K/2 a multiple of 16
    and x and packed 16-byte aligned (`aligned`): a TMA row pitch. "mma":
    everything else (fp32 x, ragged K/2, unaligned pointers, 17..47 rows,
    up to 16 rows with a longer K), the first kernel, which masks every edge
    itself."""
    if dtype != torch.bfloat16 or not aligned or K2 % 16:
        return "mma"
    if M <= STREAM_MAX_M:
        return "stream" if K2 <= STREAM_MAX_K2 else "mma"
    return "wgmma" if M >= WGMMA_MIN_M else "mma"


def stream_plan(N: int, sms: int) -> Tuple[int, int]:
    """(column tiles, blocks) of the streaming form: tiles of 16 output
    columns, dealt in contiguous runs to one block an SM."""
    tiles = -(-N // 16)
    return tiles, min(tiles, sms)


def wgmma_plan(M: int, N: int, K2: int, sms: int) -> Tuple[int, int]:
    """(K slices, output tiles) of the wgmma form: 128 x 128 output tiles, K
    cut in slices (of at least 4 k tiles of 64 packed bytes) while the tiles
    alone would leave SMs without a block."""
    tiles = -(-N // 128) * -(-M // 128)
    kt = -(-K2 // 64)
    slices = max(1, min(sms // tiles, kt // 4))
    kt_slice = -(-kt // slices)
    return -(-kt // kt_slice), tiles


_FNS = None
# Per (device, stream): the wgmma form's counters and fp32 scratch for
# partial tiles (``launch.stream_buffers``).
_COUNTERS = {}
_SCRATCH = {}


def _functions():
    global _FNS
    if _FNS is None:
        from spider_tpu_torch.ops import cuda_build

        lib = cuda_build.load("int4_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.spider_int4_matmul.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.spider_int4_matmul_stream.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.spider_int4_matmul_wgmma.argtypes = [p] * 6 + [i] * 5 + [p]
        for fn in (lib.spider_int4_matmul, lib.spider_int4_matmul_stream,
                   lib.spider_int4_matmul_wgmma):
            fn.restype = i
        _FNS = (lib.spider_int4_matmul, lib.spider_int4_matmul_stream,
                lib.spider_int4_matmul_wgmma)
    return _FNS


def int4_matmul_kernel(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None,
                       route: Optional[str] = None) -> torch.Tensor:
    """Launch csrc/int4_matmul.cu through the kernel ``int4_route`` names or
    the one the caller does, and add one to ``int4_matmul.launches`` and to
    the route's entry of ``int4_matmul.route_launches``. Raises on anything
    the kernel does not take: another device, x not bf16 or fp32, an
    out_dtype other than bf16 or fp32, packed not int8 [N, K/2], scale not
    fp32 [N], non-contiguous operands, M outside 1..1024, or a named
    "stream" or "wgmma" on an input the rule does not send there."""
    out_dtype = out_dtype or x.dtype
    device = x.device
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"int4 kernel takes bf16 or fp32 x and out_dtype, got {x.dtype} "
                        f"and {out_dtype}")
    if packed.dtype != torch.int8 or packed.dim() != 2:
        raise TypeError(f"packed must be int8 [N, K/2], got {packed.dtype} "
                        f"{tuple(packed.shape)}")
    N, K2 = packed.shape
    K = x.shape[-1]
    if K != 2 * K2 or N == 0 or K2 == 0:
        raise ValueError(f"x [.., {K}] does not match packed [{N}, {K2}] (K = 2 * K/2)")
    if scale.dtype != torch.float32 or scale.dim() != 1 or scale.shape[0] != N:
        raise TypeError(f"scale must be fp32 [{N}], got {scale.dtype} {tuple(scale.shape)}")
    if packed.device != device or scale.device != device:
        raise ValueError(f"packed is on {packed.device}, scale on {scale.device}, x on {device}")
    if not (x.is_contiguous() and packed.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x, packed and scale must be contiguous")
    M = x.numel() // K
    if not 1 <= M <= MAX_KERNEL_M:
        raise ValueError(f"int4 kernel takes 1..{MAX_KERNEL_M} rows, got {M}")
    x_ptr, w_ptr = x.data_ptr(), packed.data_ptr()
    ruled = int4_route(x.dtype, M, K2, (x_ptr | w_ptr) % 16 == 0)
    if route is None:
        route = ruled
    elif route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    elif route != "mma" and route != ruled:
        raise ValueError(f"the {route} route does not take {x.dtype} x with M={M}, K/2={K2} "
                         f"(the rule sends it to {ruled!r})")
    if device.type != "cuda":
        raise ValueError(f"int4 kernel runs on CUDA tensors, got {device}")
    out = torch.empty((*x.shape[:-1], N), dtype=out_dtype, device=device)
    mma, stream_fn, wgmma_fn = _functions()
    index = device.index
    current = torch.cuda.current_device()
    if index != current:                     # the launch goes to the current device
        torch.cuda.set_device(index)
    try:
        stream = current_stream_handle(index)
        out_fp32 = int(out_dtype == torch.float32)
        if route == "mma":
            err = mma(x_ptr, w_ptr, scale.data_ptr(), out.data_ptr(), M, N, K2,
                      int(x.dtype == torch.float32), out_fp32, stream)
        elif route == "stream":
            err = stream_fn(x_ptr, w_ptr, scale.data_ptr(), out.data_ptr(), M, N, K2,
                            stream_plan(N, sm_count(index))[1], out_fp32, stream)
        else:
            slices, tiles = wgmma_plan(M, N, K2, sm_count(index))
            counters, part = stream_buffers(_COUNTERS, _SCRATCH, device, stream, tiles,
                                            slices * tiles * 128 * 128 if slices > 1 else 1)
            err = wgmma_fn(x_ptr, w_ptr, scale.data_ptr(), out.data_ptr(), part.data_ptr(),
                           counters.data_ptr(), M, N, K2, slices, out_fp32, stream)
    finally:
        if index != current:
            torch.cuda.set_device(current)
    if err != 0:
        raise RuntimeError(f"int4 matmul ({route}) launch failed with error {err}")
    count_launch(int4_matmul, route)
    return out


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [.., K] @ dequant(packed [N, K/2], scale [N]) -> [.., N] in out_dtype
    (default x's dtype). CPU tensors take int4_matmul_reference; CUDA
    tensors with M <= 1024 rows launch the kernel (one more in
    ``int4_matmul.launches``); CUDA tensors with more rows dequantise and
    call torch.matmul, the JAX wrapper's routing for a long prefill."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu" or _mode() == "plain":
        return int4_matmul_reference(x, packed, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cpu or cuda tensors, got {x.device}")
    M = x.numel() // max(x.shape[-1], 1)
    if M > MAX_KERNEL_M:
        # quant.py:114-122: dequantise in x's dtype, one dot, the scale in
        # x's dtype on its output.
        w = dequantize_int4(packed, x.dtype)
        y = torch.matmul(x, w.t()) * scale.to(x.dtype)
        return y.to(out_dtype)
    return int4_matmul_kernel(x, packed, scale, out_dtype)


int4_matmul.launches = 0
int4_matmul.route_launches = dict.fromkeys(ROUTES, 0)
