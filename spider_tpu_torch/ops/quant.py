"""Weight-only int4 matmul: the plain PyTorch version and the CUDA kernel.

Counterpart of spider_tpu/ops/quant.py, the int4 serving path of the 8B
decoder. Decode reads every weight once per token, so packing two 4-bit
weights per byte reads a quarter of the bf16 bytes, if the unpack happens
inside the matmul. ``int4_matmul`` launches the hand-written kernel
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
M = rows of x up to 4 * block_m = 1024 launch the kernel; longer inputs
(a long-prompt prefill) dequantise the weight and call ``torch.matmul``,
where the product is bound by the tensor cores and the unpack amortises
over thousands of rows. That is the reference's routing, not a fallback.
The JAX wrapper also sends a K/2 that no block divides to XLA; the CUDA
kernel masks the ragged edge itself, so ragged K takes the kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
from contextvars import ContextVar
from typing import Optional, Tuple

import torch

# Rows of x up to which the kernel runs (the JAX wrapper's M <= 4 * block_m).
MAX_KERNEL_M = 1024
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Routing override for A/B checks on the card: "auto" = the rule above;
# "plain" = int4_matmul_reference everywhere.
_MODE = ContextVar("int4_matmul_mode", default="auto")


@contextlib.contextmanager
def int4_matmul_config(mode: str):
    if mode not in ("auto", "plain"):
        raise ValueError(mode)
    tok = _MODE.set(mode)
    try:
        yield
    finally:
        _MODE.reset(tok)


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
# CUDA kernel (csrc/int4_matmul.cu)
# ---------------------------------------------------------------------------

def _library():
    from spider_tpu_torch.ops import cuda_build

    fn = cuda_build.load("int4_matmul").spider_int4_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def int4_matmul_kernel(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch csrc/int4_matmul.cu and add one to ``int4_matmul.launches``.
    Raises on anything the kernel does not take: another device, x not bf16
    or fp32, an out_dtype other than bf16 or fp32, packed not int8 [N, K/2],
    scale not fp32 [N], non-contiguous operands, or M outside 1..1024."""
    out_dtype = out_dtype or x.dtype
    if x.device.type != "cuda":
        raise ValueError(f"int4 kernel runs on CUDA tensors, got {x.device}")
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
    if scale.dtype != torch.float32 or tuple(scale.shape) != (N,):
        raise TypeError(f"scale must be fp32 [{N}], got {scale.dtype} {tuple(scale.shape)}")
    for name, t in (("x", x), ("packed", packed), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lead = x.shape[:-1]
    M = x.numel() // K
    if not 1 <= M <= MAX_KERNEL_M:
        raise ValueError(f"int4 kernel takes 1..{MAX_KERNEL_M} rows, got {M}")
    out = torch.empty((*lead, N), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):   # the launch goes to the current device
        err = _library()(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
                         M, N, K2, int(x.dtype == torch.float32),
                         int(out_dtype == torch.float32),
                         torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spider_int4_matmul launch failed with cudaError_t {err}")
    int4_matmul.launches += 1
    return out


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [.., K] @ dequant(packed [N, K/2], scale [N]) -> [.., N] in out_dtype
    (default x's dtype). CPU tensors take int4_matmul_reference; CUDA
    tensors with M <= 1024 rows launch the kernel (one more in
    ``int4_matmul.launches``); CUDA tensors with more rows dequantise and
    call torch.matmul, the JAX wrapper's routing for a long prefill."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu" or _MODE.get() == "plain":
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
