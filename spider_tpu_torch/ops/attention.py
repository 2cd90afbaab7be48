"""Multi-head attention: the plain PyTorch reference and the flash kernel.

Counterpart of spider_tpu/ops/attention.py. ``flash_attention`` and
``flash_attention_with_lse`` launch the hand-written CUDA kernel
(csrc/flash_fwd.cu) on CUDA tensors and take the plain ``mha_reference``
forms on CPU tensors, so the CPU tests check the arithmetic the kernel is
held to on the card. On a CUDA tensor the wrapper launches the kernel or
raises; it never falls back.

Layouts: q [B, T, Hq, D]; k, v [B, S, Hkv, D]; output [B, T, Hq, D];
lse [B, Hq, T] fp32. Hq is a multiple of Hkv (grouped-query attention).

Position conventions for causal masking (as in the JAX package):
  * kv_len is None: queries are the LAST T positions of the window
    (suffix continuation; offset S - T).
  * kv_len given, q_offset None: queries start at position 0
    (right-padded prefill over a padded cache).
  * q_offset given ([B] or scalar): explicit global position of q row 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

IntLike = Union[int, torch.Tensor]


def _live_and_offset(B: int, T: int, S: int, kv_len: Optional[torch.Tensor],
                     q_offset: Optional[IntLike], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B] live kv lengths, [B] global position of q row 0), int32."""
    if kv_len is None:
        live = torch.full((B,), S, dtype=torch.int32, device=device)
    else:
        live = torch.as_tensor(kv_len, device=device).to(torch.int32).reshape(-1).expand(B)
    if q_offset is None:
        off = torch.full((B,), S - T if kv_len is None else 0, dtype=torch.int32,
                         device=device)
    else:
        off = torch.as_tensor(q_offset, device=device).to(torch.int32).reshape(-1).expand(B)
    return live.contiguous(), off.contiguous()


def _mask(B: int, T: int, S: int, causal: bool, kv_len, q_offset, device) -> torch.Tensor:
    """[B, T, S] bool: key s is live for query row t."""
    live, off = _live_and_offset(B, T, S, kv_len, q_offset, device)
    k_pos = torch.arange(S, device=device)
    mask = (k_pos[None, None, :] < live[:, None, None]).expand(B, T, S)
    if causal:
        q_pos = torch.arange(T, device=device)[None, :, None] + off[:, None, None]
        mask = mask & (q_pos >= k_pos[None, None, :])
    return mask


def _logits(q, k, causal, sm_scale, kv_len, q_offset):
    B, T, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    assert Hq % Hkv == 0, (Hq, Hkv)
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, T, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) * scale
    mask = _mask(B, T, S, causal, kv_len, q_offset, q.device)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(DEFAULT_MASK_VALUE, device=q.device))
    return logits, mask


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, sm_scale: Optional[float] = None,
                  kv_len: Optional[torch.Tensor] = None,
                  q_offset: Optional[IntLike] = None) -> torch.Tensor:
    """Plain attention in fp32, cast back to q's dtype."""
    B, T, Hq, D = q.shape
    logits, _ = _logits(q, k, causal, sm_scale, kv_len, q_offset)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)


def mha_reference_with_lse(q, k, v, causal: bool = True,
                           sm_scale: Optional[float] = None,
                           kv_len: Optional[torch.Tensor] = None,
                           q_offset: Optional[IntLike] = None):
    """(out [B,T,Hq,D], lse [B,Hq,T]); lse is -inf on rows with no live key."""
    B, T, Hq, D = q.shape
    logits, mask = _logits(q, k, causal, sm_scale, kv_len, q_offset)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgts,bshd->bthgd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0]                      # [B, Hkv, g, T]
    row_dead = ~mask.any(dim=-1)                          # [B, T]
    lse = torch.where(row_dead[:, None, None], float("-inf"), lse)
    return out.reshape(B, T, Hq, D).to(q.dtype), lse.reshape(B, Hq, T)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/flash_fwd.cu)
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 128


def _library():
    from spider_tpu_torch.ops import cuda_build

    lib = cuda_build.load("flash_fwd")
    fn = lib.spider_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _flash_cuda(q, k, v, causal, sm_scale, kv_len, q_offset):
    B, T, Hq, D = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    S, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if not (0 < D <= MAX_HEAD_DIM):
        raise ValueError(f"flash kernel takes head dims 1..{MAX_HEAD_DIM}, got {D}")
    if T == 0 or S == 0:
        raise ValueError(f"empty sequence: T={T} S={S}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes bf16 or fp32 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    live, off = _live_and_offset(B, T, S, kv_len, q_offset, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    with torch.cuda.device(q.device):   # the launch goes to the current device
        err = _library()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         lse.data_ptr(), live.data_ptr(), off.data_ptr(),
                         B, T, S, Hq, Hkv, D, float(scale), int(bool(causal)),
                         int(q.dtype == torch.float32),
                         torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spider_flash_fwd launch failed with cudaError_t {err}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, sm_scale: Optional[float] = None,
                             kv_len: Optional[torch.Tensor] = None,
                             q_offset: Optional[IntLike] = None):
    """(out [B,T,Hq,D], lse [B,Hq,T] fp32). On CUDA the kernel's lse stays
    finite on rows with no live key, where the CPU reference gives -inf."""
    if q.device.type == "cpu":
        return mha_reference_with_lse(q, k, v, causal=causal, sm_scale=sm_scale,
                                      kv_len=kv_len, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    return _flash_cuda(q, k, v, causal, sm_scale, kv_len, q_offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    q_offset: Optional[IntLike] = None) -> torch.Tensor:
    """Fused attention. q [B,T,Hq,D]; k,v [B,S,Hkv,D] -> [B,T,Hq,D].

    CPU tensors take mha_reference; CUDA tensors launch the kernel and add
    one to ``flash_attention.launches``."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                             kv_len=kv_len, q_offset=q_offset)
    return flash_attention_with_lse(q, k, v, causal=causal, sm_scale=sm_scale,
                                    kv_len=kv_len, q_offset=q_offset)[0]


flash_attention.launches = 0
