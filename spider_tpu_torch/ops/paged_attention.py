"""Single-token decode attention over a block-paged KV pool: the plain
PyTorch version and the CUDA kernel.

Counterpart of spider_tpu/ops/paged_attention.py. ``paged_decode_attention``
launches the hand-written kernel (csrc/paged_decode.cu) on CUDA tensors and
takes ``paged_decode_reference`` on CPU tensors. On a CUDA tensor it
launches the kernel or raises; it never falls back.

Layouts: q [B, Hq, D]; pool_k, pool_v [N_blocks, page, Hkv, D];
page_table [B, max_pages] (slot b's logical page i lives in pool block
page_table[b, i]); kv_len [B]; output [B, Hq, D] in q's dtype.

Slots with kv_len = 0: the kernel returns 0, as the TPU kernel does; the
plain version, like the reference's gather route, returns the mean of V
(ROADMAP C2). Neither the model nor the batcher asks for such a row.
"""

from __future__ import annotations

import contextlib
import ctypes
from contextvars import ContextVar
from typing import Optional

import torch

from spider_tpu_torch.ops.attention import mha_reference

MAX_HEAD_DIM = 256
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Routing override for A/B checks on the card: "auto" = the kernel on CUDA
# tensors; "plain" = paged_decode_reference everywhere.
_MODE = ContextVar("paged_decode_mode", default="auto")


@contextlib.contextmanager
def paged_decode_config(mode: str):
    if mode not in ("auto", "plain"):
        raise ValueError(mode)
    tok = _MODE.set(mode)
    try:
        yield
    finally:
        _MODE.reset(tok)


def paged_decode_reference(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                           page_table: torch.Tensor, kv_len: torch.Tensor,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """The plain version, the reference's gather route (llama.py:295-302):
    gather every slot's max_pages blocks, view them as one window of
    max_pages * page keys, and run mha_reference masked by kv_len."""
    B, Hq, D = q.shape
    _, page, Hkv, _ = pool_k.shape
    idx = page_table.long()
    gk = pool_k[idx].reshape(B, -1, Hkv, D)          # [B, MP * page, Hkv, D]
    gv = pool_v[idx].reshape(B, -1, Hkv, D)
    out = mha_reference(q[:, None], gk.to(q.dtype), gv.to(q.dtype), causal=False,
                        sm_scale=sm_scale, kv_len=kv_len)
    return out[:, 0]


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/paged_decode.cu)
# ---------------------------------------------------------------------------

def _library():
    from spider_tpu_torch.ops import cuda_build

    fn = cuda_build.load("paged_decode").spider_paged_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def paged_decode_kernel(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                        page_table: torch.Tensor, kv_len: torch.Tensor,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Launch csrc/paged_decode.cu and add one to
    ``paged_decode_attention.launches``. Raises on anything the kernel does
    not take: another device, q and pools not of one dtype (bf16 or fp32),
    non-contiguous q or pools, Hq not a multiple of Hkv, or a head dim that
    is not a multiple of 8 up to 256; a launch the card refuses (more shared
    memory than a block may have, at very large Hq/Hkv or max_pages) raises
    with its CUDA error. The table and kv_len are cast to int32, as the JAX
    wrapper casts them."""
    if q.dim() != 3 or pool_k.dim() != 4 or pool_v.shape != pool_k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} pool_k {tuple(pool_k.shape)} "
                         f"pool_v {tuple(pool_v.shape)}")
    B, Hq, D = q.shape
    _, page, Hkv, Dk = pool_k.shape
    if Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q [B, {Hq}, {D}] does not fit pools [N, page, {Hkv}, {Dk}]")
    if D % 8 or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"paged kernel takes head dims that are multiples of 8 up to "
                         f"{MAX_HEAD_DIM}, got {D}")
    if page_table.dim() != 2 or page_table.shape[0] != B or kv_len.shape != (B,):
        raise ValueError(f"page_table must be [{B}, max_pages] and kv_len [{B}], got "
                         f"{tuple(page_table.shape)} and {tuple(kv_len.shape)}")
    MP = page_table.shape[1]
    if B == 0 or MP == 0:
        raise ValueError(f"empty batch or table: B={B} max_pages={MP}")
    if q.dtype not in _KERNEL_DTYPES or pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError(f"paged kernel takes bf16 or fp32 q and pools of one dtype, got "
                        f"{q.dtype}/{pool_k.dtype}/{pool_v.dtype}")
    if q.device.type != "cuda":
        raise ValueError(f"paged kernel runs on CUDA tensors, got {q.device}")
    for name, x in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("page_table", page_table), ("kv_len", kv_len)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    for name, x in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    table = page_table.to(torch.int32).contiguous()
    lens = kv_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    with torch.cuda.device(q.device):   # the launch goes to the current device
        err = _library()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(),
                         lens.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, page, MP,
                         float(scale), int(q.dtype == torch.float32),
                         torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spider_paged_decode launch failed with cudaError_t {err}")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                           page_table: torch.Tensor, kv_len: torch.Tensor, *,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, D]; pool_k/v [N_blocks, page, Hkv, D]; page_table
    [B, max_pages]; kv_len [B] -> out [B, Hq, D].

    CPU tensors take paged_decode_reference; CUDA tensors launch the kernel
    and add one to ``paged_decode_attention.launches``."""
    if q.device.type == "cpu" or _MODE.get() == "plain":
        return paged_decode_reference(q, pool_k, pool_v, page_table, kv_len, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cpu or cuda tensors, got {q.device}")
    return paged_decode_kernel(q, pool_k, pool_v, page_table, kv_len, sm_scale)


paged_decode_attention.launches = 0
