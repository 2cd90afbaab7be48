"""Multi-head attention: the plain PyTorch reference and the flash kernels.

Counterpart of spider_tpu/ops/attention.py. ``flash_attention`` and
``flash_attention_with_lse`` launch the hand-written CUDA kernels on CUDA
tensors (csrc/flash_fwd.cu forward; csrc/flash_bwd.cu for the gradients of
q, k and v, through a ``torch.autograd.Function``) and take the plain
``mha_reference`` forms, under ordinary autograd, on CPU tensors, so the CPU
tests check the arithmetic the kernels are held to on the card. On a CUDA
tensor a wrapper launches its kernel or raises; it never falls back.

The forward and the two backward kernels (dq; dk/dv) each have two forms, and ``flash_route``
names the one a call takes from its dtype and head dim alone: "wgmma" (TMA
staging and warpgroup products, csrc/hopper.cuh) for bf16 with D a multiple
of 8, "mma" (the general mma.sync form) for fp32 inputs and other head dims.
Each route counts its launches in ``route_launches`` beside ``launches``.

``attention`` and ``attention_with_lse`` take [B, T, C] projections, as the
UNets, the story bank, Grounding DINO's decoder and SAM's mask decoder hold
them, and send a call to the flash kernel or to ``plain_attention`` by
``spatial_flash_predicate``: the one place that decides where such a call
runs.

Rows with no live key: the forward kernel returns the mean of V and a
finite lse there (``mha_reference_with_lse`` gives -inf). The backward
kernels and ``flash_backward_reference`` mask P to exactly zero, so such a
row takes and gives zero gradient, as the TPU kernels do; autograd through
``mha_reference`` spreads its gradient over V instead. Compare live rows
only across these paths.

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
import functools
from typing import Optional, Tuple, Union

import torch

from spider_tpu_torch.common import profiler
from spider_tpu_torch.ops.launch import count_launch, current_stream_handle, scoped_mode

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

IntLike = Union[int, torch.Tensor]


@functools.lru_cache(maxsize=256)
def _default_live_and_offset(B: int, T: int, S: int, device):
    """The two vectors of a call that gives neither kv_len nor q_offset
    (every UNet call): read-only, so one pair serves every such call of a
    shape and the wrapper launches no fill kernels for them. They are handed
    to every stream, so the fills are finished before the pair is returned:
    another stream reading them orders nothing after this one's fills."""
    pair = (torch.full((B,), S, dtype=torch.int32, device=device),
            torch.full((B,), S - T, dtype=torch.int32, device=device))
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return pair


def _live_and_offset(B: int, T: int, S: int, kv_len: Optional[torch.Tensor],
                     q_offset: Optional[IntLike], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B] live kv lengths, [B] global position of q row 0), int32."""
    if kv_len is None and q_offset is None:
        return _default_live_and_offset(B, T, S, torch.device(device))
    if kv_len is None:
        live = torch.full((B,), S, dtype=torch.int32, device=device)
    else:
        live = torch.as_tensor(kv_len, device=device).to(torch.int32).reshape(-1).expand(B)
    if q_offset is None or isinstance(q_offset, int):
        # filled on the device: a Python int through as_tensor is a host copy
        start = q_offset if q_offset is not None else (S - T if kv_len is None else 0)
        off = torch.full((B,), start, dtype=torch.int32, device=device)
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


def _delta(g, out, g_lse):
    """[B, Hq, T] fp32: rowsum(dO * O), less the lse cotangent where given
    (d lse / d s = p, so it folds into the row term of dS)."""
    delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def flash_backward_reference(q, k, v, out, lse, g, causal: bool = True,
                             sm_scale: Optional[float] = None,
                             kv_len: Optional[torch.Tensor] = None,
                             q_offset: Optional[IntLike] = None,
                             g_lse: Optional[torch.Tensor] = None):
    """The flash backward in plain fp32 torch, step by step as the kernels
    take it: P recomputed from q, k and the saved lse, masked to zero.

    q, out, g [B,T,Hq,D]; k, v [B,S,Hkv,D]; lse, g_lse [B,Hq,T].
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, T, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, T, Hkv, G, D)
    gf = g.float().reshape(B, T, Hkv, G, D)
    kf, vf = k.float(), v.float()
    mask = _mask(B, T, S, causal, kv_len, q_offset, q.device)[:, None, None]
    s = torch.einsum("bthgd,bshd->bhgts", qf, kf) * scale
    rows = lambda x: x.float().reshape(B, Hkv, G, T, 1)
    p = torch.where(mask, torch.exp(s - rows(lse)), torch.zeros((), device=q.device))
    dp = torch.einsum("bthgd,bshd->bhgts", gf, vf)
    ds = p * (dp - rows(_delta(g, out, g_lse))) * scale
    dq = torch.einsum("bhgts,bshd->bthgd", ds, kf).reshape(B, T, Hq, D)
    dv = torch.einsum("bhgts,bthgd->bshd", p, gf)
    dk = torch.einsum("bhgts,bthgd->bshd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu)
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 128
ROUTES = ("wgmma", "mma")


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a flash forward, dq or dk/dv backward call takes on the card.

    "wgmma": bf16 q/k/v with a head dim that is a multiple of 8 (a TMA
    tensor map needs 16-byte row strides) up to 128: every shape of the main
    paths (the 8B model at D 128, SD-1.5 and ZeroScope at D 40 and 80,
    AudioLDM at D 16). "mma": what the other does not take, fp32 inputs
    (rounded to bf16 in shared memory) and any other head dim up to 128. What
    neither takes (fp16, D > 128) raises in the wrapper."""
    if dtype == torch.bfloat16 and 0 < head_dim <= MAX_HEAD_DIM and head_dim % 8 == 0:
        return "wgmma"
    return "mma"


def _resolve_route(route: Optional[str], tensors) -> str:
    """The rule's route, or the caller's own choice of it (tests and timing
    name one): "mma" takes everything, "wgmma" only what the rule sends it,
    from 16-byte aligned storage."""
    q = tensors[0]
    ruled = flash_route(q.dtype, q.shape[-1])
    if route is None:
        route = ruled
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "wgmma":
        if ruled != "wgmma":
            raise ValueError(f"the wgmma route takes bf16 with a head dim that is a multiple "
                             f"of 8, got {q.dtype} with D={q.shape[-1]}")
        if any(x.data_ptr() % 16 for x in tensors):
            raise ValueError("the wgmma route reads through TMA: q, k, v (and dO) must be "
                             "16-byte aligned")
    return route


def _library():
    from spider_tpu_torch.ops import cuda_build

    lib = cuda_build.load("flash_fwd")
    if lib.spider_flash_fwd.argtypes is None:
        head = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int]
        lib.spider_flash_fwd.argtypes = head + [ctypes.c_int, ctypes.c_void_p]
        lib.spider_flash_fwd.restype = ctypes.c_int
        lib.spider_flash_fwd_wgmma.argtypes = head + [ctypes.c_void_p]
        lib.spider_flash_fwd_wgmma.restype = ctypes.c_int
    return lib


def _flash_cuda(q, k, v, causal, sm_scale, kv_len, q_offset, route=None):
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
    route = _resolve_route(route, (q, k, v))
    live, off = _live_and_offset(B, T, S, kv_len, q_offset, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            live.data_ptr(), off.data_ptr(), B, T, S, Hq, Hkv, D, float(scale),
            int(bool(causal)))
    with torch.cuda.device(q.device):   # the launch goes to the current device
        stream = current_stream_handle(q.device.index)
        if route == "wgmma":
            err = _library().spider_flash_fwd_wgmma(*args, stream)
        else:
            err = _library().spider_flash_fwd(*args, int(q.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"flash forward ({route}) launch failed with error {err}")
    count_launch(flash_attention, route,
                 dict(B=B, T=T, S=S, Hq=Hq, Hkv=Hkv, D=D, causal=bool(causal),
                      elem_bytes=q.element_size()) if profiler.recording_on() else None)
    return out, lse


_BWD_COMMON = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]


def _bwd_library():
    from spider_tpu_torch.ops import cuda_build

    lib = cuda_build.load("flash_bwd")
    if lib.spider_flash_bwd_dq.argtypes is None:
        lib.spider_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 9 + _BWD_COMMON
        lib.spider_flash_bwd_dq.restype = ctypes.c_int
        lib.spider_flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 10 + _BWD_COMMON
        lib.spider_flash_bwd_dkv.restype = ctypes.c_int
        # no is_fp32: the wgmma form takes bf16 only
        lib.spider_flash_bwd_dkv_wgmma.argtypes = ([ctypes.c_void_p] * 10 + _BWD_COMMON[:-2]
                                                   + [ctypes.c_void_p])
        lib.spider_flash_bwd_dkv_wgmma.restype = ctypes.c_int
        lib.spider_flash_bwd_dq_wgmma.argtypes = ([ctypes.c_void_p] * 9 + _BWD_COMMON[:-2]
                                                  + [ctypes.c_void_p])
        lib.spider_flash_bwd_dq_wgmma.restype = ctypes.c_int
    return lib


def _check_bwd(q, k, v, g, lse, delta):
    B, T, Hq, D = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[2]}")
    if not (0 < D <= MAX_HEAD_DIM):
        raise ValueError(f"flash kernels take head dims 1..{MAX_HEAD_DIM}, got {D}")
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} does not match q {tuple(q.shape)}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernels take bf16 or fp32, got {q.dtype}")
    for name, x, dtype, shape in (("q", q, q.dtype, None), ("k", k, q.dtype, None),
                                  ("v", v, q.dtype, None), ("g", g, q.dtype, None),
                                  ("lse", lse, torch.float32, (B, Hq, T)),
                                  ("delta", delta, torch.float32, (B, Hq, T))):
        if x.device != q.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {q.device}, got "
                             f"{x.dtype} on {x.device}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")


def _bwd_scalars(q, k, causal, sm_scale):
    B, T, Hq, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    return (B, T, k.shape[1], Hq, k.shape[2], D, float(scale), int(bool(causal)),
            int(q.dtype == torch.float32), current_stream_handle(q.device.index))


def flash_bwd_dq(q, k, v, g, lse, delta, live, off, causal, sm_scale, route=None):
    """dq [B,T,Hq,D] on the card (csrc/flash_bwd.cu), through the kernel
    ``flash_route`` names, or the one the caller does. live, off: [B] int32
    from ``_live_and_offset``; delta from ``_delta``."""
    _check_bwd(q, k, v, g, lse, delta)
    route = _resolve_route(route, (q, k, v, g))
    dq = torch.empty_like(q)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), live.data_ptr(), off.data_ptr())
    scalars = _bwd_scalars(q, k, causal, sm_scale)
    with torch.cuda.device(q.device):
        if route == "wgmma":
            err = _bwd_library().spider_flash_bwd_dq_wgmma(*pointers, *scalars[:-2],
                                                           scalars[-1])
        else:
            err = _bwd_library().spider_flash_bwd_dq(*pointers, *scalars)
    if err != 0:
        raise RuntimeError(f"flash backward dq ({route}) launch failed with error {err}")
    count_launch(flash_bwd_dq, route)
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, live, off, causal, sm_scale, route=None):
    """(dk, dv) [B,S,Hkv,D] on the card, summed over each GQA group inside
    the kernel; through the kernel ``flash_route`` names, or the one the
    caller does."""
    _check_bwd(q, k, v, g, lse, delta)
    route = _resolve_route(route, (q, k, v, g))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), live.data_ptr(),
                off.data_ptr())
    scalars = _bwd_scalars(q, k, causal, sm_scale)
    with torch.cuda.device(q.device):
        if route == "wgmma":
            err = _bwd_library().spider_flash_bwd_dkv_wgmma(*pointers, *scalars[:-2],
                                                            scalars[-1])
        else:
            err = _bwd_library().spider_flash_bwd_dkv(*pointers, *scalars)
    if err != 0:
        raise RuntimeError(f"flash backward dk/dv ({route}) launch failed with error {err}")
    count_launch(flash_bwd_dkv, route)
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dq.route_launches = dict.fromkeys(ROUTES, 0)
flash_bwd_dkv.launches = 0
flash_bwd_dkv.route_launches = dict.fromkeys(ROUTES, 0)


def flash_backward(q, k, v, out, lse, g, *, causal: bool = True,
                   sm_scale: Optional[float] = None,
                   kv_len: Optional[torch.Tensor] = None,
                   q_offset: Optional[IntLike] = None,
                   g_lse: Optional[torch.Tensor] = None, route: Optional[str] = None):
    """(dq, dk, dv) of flash attention from its saved (out, lse) and the
    cotangents g of out and, optionally, g_lse of lse. CPU tensors take
    ``flash_backward_reference``; CUDA tensors launch the two kernels, each
    by ``flash_route`` unless `route` names the kernels' form."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, out, lse, g, causal, sm_scale, kv_len,
                                        q_offset, g_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward runs on cpu or cuda tensors, got {q.device}")
    B, T = q.shape[:2]
    live, off = _live_and_offset(B, T, k.shape[1], kv_len, q_offset, q.device)
    args = (q, k, v, g, lse, _delta(g, out, g_lse), live, off, causal, sm_scale)
    return (flash_bwd_dq(*args, route=route),) + flash_bwd_dkv(*args, route=route)


class _FlashFunction(torch.autograd.Function):
    """(out, lse) on CUDA tensors, differentiable in both: the forward kernel
    saves q, k, v, out, lse; the backward launches the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, kv_len, q_offset, route):
        out, lse = _flash_cuda(q, k, v, causal, sm_scale, kv_len, q_offset, route)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len, q_offset=q_offset,
                      route=route)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g is None:                      # only lse was used
            g = torch.zeros_like(out)
        # g arrives as a view of the output projection's input gradient
        dq, dk, dv = flash_backward(q, k, v, out, lse, g.contiguous(), g_lse=g_lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, sm_scale: Optional[float] = None,
                             kv_len: Optional[torch.Tensor] = None,
                             q_offset: Optional[IntLike] = None,
                             route: Optional[str] = None):
    """(out [B,T,Hq,D], lse [B,Hq,T] fp32), differentiable in both outputs.
    On CUDA the kernel's lse stays finite on rows with no live key, where
    the CPU reference gives -inf. `route` names the kernel ("wgmma" or
    "mma") where a test or a timing wants one; by default ``flash_route``
    does."""
    if q.device.type == "cpu":
        return mha_reference_with_lse(q, k, v, causal=causal, sm_scale=sm_scale,
                                      kv_len=kv_len, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    return _FlashFunction.apply(q, k, v, causal, sm_scale, kv_len, q_offset, route)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    q_offset: Optional[IntLike] = None,
                    route: Optional[str] = None) -> torch.Tensor:
    """Fused attention. q [B,T,Hq,D]; k,v [B,S,Hkv,D] -> [B,T,Hq,D].

    CPU tensors take mha_reference; CUDA tensors launch the kernel and add
    one to ``flash_attention.launches`` and to its route's entry of
    ``flash_attention.route_launches`` (its backward adds one each to
    ``flash_bwd_dq.launches`` and ``flash_bwd_dkv.launches``)."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                             kv_len=kv_len, q_offset=q_offset)
    return flash_attention_with_lse(q, k, v, causal=causal, sm_scale=sm_scale,
                                    kv_len=kv_len, q_offset=q_offset, route=route)[0]


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)


# ---------------------------------------------------------------------------
# Attention on [B, T, C] projections: the UNets', the story bank's, Grounding
# DINO's decoder and SAM's mask decoder
# ---------------------------------------------------------------------------

# Routing override for A/B checks: "auto" = the predicate below; "einsum" =
# plain_attention everywhere.
spatial_flash_config, _spatial_mode = scoped_mode("spatial_flash", ("auto", "einsum"), "auto")

# The wgmma forward's work item is (128 query rows, head, batch), one
# persistent block an SM. With fewer items than this, over more keys than
# FLASH_FEW_ITEMS_MAX_KEYS, a few SMs walk every key alone (SAM's
# token-to-image at batch 1: 8 items over 4096 keys).
FLASH_MIN_ITEMS = 16
FLASH_FEW_ITEMS_MAX_KEYS = 1024


def spatial_flash_predicate(B: int, T: int, S: int, heads: int, D: int) -> bool:
    """Where attention on projections goes to the flash kernel on the card:
    every head dim the kernel takes, D <= 128, except a call with fewer than
    FLASH_MIN_ITEMS work items (B x heads x ceil(T / 128)) over more than
    FLASH_FEW_ITEMS_MAX_KEYS keys, which stays on the einsum. Every UNet
    shape has at least 16 items and goes to the kernel.

    The reference's rule for its TPU kernel (unet2d.py:163-165: T >= 4096 or,
    for D >= 64, fp32 logits over 512 MiB) kept the plain einsum at every
    level but the first of SD-1.5 and AudioLDM and at all of ZeroScope. On an
    H100 the rows of ``chip_smoke.py``'s phase ``unet_routing`` (flash against
    ``plain_attention``, device time in ms, bf16, CFG batch 2, ZeroScope's 16
    frames in the batch; NVIDIA H100 80GB HBM3, 700 W) put the kernel ahead at
    every UNet shape it takes, self- and cross-attention alike, down to
    T = 128, and at the grounding shapes but one, which the rule's exception
    keeps on the einsum:

      SD-1.5 512px     L0 T 4096 D 40: self 0.178 / 3.41, cross (S 77) 0.018 / 0.115
                       L1 T 1024 D 80: self 0.020 / 0.261, cross 0.010 / 0.057
      AudioLDM 5 s     L0 T 8192 D 16: self 0.596 / 14.3, cross (S 1) 0.015 / 0.041
                       L1 T 2048 D 32: self 0.045 / 0.857, cross 0.007 / 0.031
                       L2 T 512 D 48: self 0.010 / 0.072, cross 0.005 / 0.025
                       L3, mid T 128 D 80: self 0.007 / 0.034, cross 0.006 / 0.024
      ZeroScope 576x320x16  L0 T 2880 D 40 (B 32): self 1.39 / 27.7, cross 0.156 / 1.13
                       L1 T 720 D 80: self 0.165 / 1.88, cross 0.059 / 0.389
      SDXL story 768px (B 8: 4 frames, batched CFG; chip_smoke.py story, same card)
                       L1 T 2304 D 64: self 0.289 / 5.92, cross 0.048 / 0.349
                       L2, mid T 576 D 64: self 0.069 / 0.766, cross 0.030 / 0.183
      Grounding DINO 512px (B 1, 8 heads; chip_smoke.py grounding, same card)
                       decoder self T 900 D 32: 0.0155 / 0.104 (SDPA 0.0157)
      SAM ViT-H mask decoder, 8 heads, the 64 x 64 grid (S or T 4096)
                       box prompt, B 1: self T 7 D 32 0.0043 / 0.0193,
                       image-to-token T 4096 S 7 D 16 0.0063 / 0.0274,
                       token-to-image T 7 S 4096 D 16 0.0433 / 0.0281 (8 items:
                       the einsum's)
                       MASK train step, B 4: self T 6 0.0043 / 0.0286,
                       image-to-token 0.0150 / 0.0551, token-to-image T 6
                       0.0450 / 0.0636 (32 items)

    As single calls with the host's time in them, the large shapes rank the
    same way and the small ones are host-bound on either side (0.07-0.2 ms
    for the one-launch wrapper, 0.15-0.47 ms for the einsum's eight launches).
    SD-1.5's and ZeroScope's levels 2 and mid have D = 160, which no flash
    kernel here takes: they stay on the einsum (T <= 256, 0.04-0.29 ms)."""
    items = B * heads * -(-T // 128)
    return D <= 128 and not (items < FLASH_MIN_ITEMS and S > FLASH_FEW_ITEMS_MAX_KEYS)


def _projection_flash(q: torch.Tensor, k: torch.Tensor, heads: int) -> bool:
    """Whether a call on projections q [B, T, C], k [B, S, C] takes the flash
    kernel: outside ``spatial_flash_config("einsum")``, on CUDA tensors, where
    ``spatial_flash_predicate`` holds."""
    B, T, C = q.shape
    return (_spatial_mode() == "auto" and q.is_cuda
            and spatial_flash_predicate(B, T, k.shape[1], heads, C // heads))


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Softmax attention on [B, T, C] projections: the reference's einsum
    in the input dtype with an fp32 softmax. The aligners, ImageBind and
    PhotoMaker's ID encoder call it directly: their attention (T <= 257, fp32
    in the aligners) is no UNet's and stays off the flash kernel."""
    B, T, C = q.shape
    S = k.shape[1]
    D = C // heads
    q = q.reshape(B, T, heads, D).transpose(1, 2)
    k = k.reshape(B, S, heads, D).transpose(1, 2)
    v = v.reshape(B, S, heads, D).transpose(1, 2)
    logits = torch.einsum("bhtd,bhsd->bhts", q, k).float() / (D ** 0.5)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bhsd->bhtd", probs, v)
    return out.transpose(1, 2).reshape(B, T, C)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Softmax attention on [B, T, C] projections: the UNets' spatial
    attention, Grounding DINO's decoder self-attention and SAM's mask
    decoder.

    Routed to the flash kernel on CUDA tensors where
    ``spatial_flash_predicate`` holds: at SD-1.5 512px and ZeroScope levels 0
    and 1 (D = 40, 80), at AudioLDM every level (D = 16 to 80; S = 1 in
    cross-attention), self- and cross-attention; Grounding DINO's decoder
    self-attention and SAM's mask decoder, but for its token-to-image
    attention at batch 1. The kernel masks the ragged edges and takes those
    head dims itself, so none of the reference's padding is needed.
    Elsewhere (D = 160, CPU tensors, the "einsum" override):
    ``plain_attention``.
    """
    if not _projection_flash(q, k, heads):
        return plain_attention(q, k, v, heads)
    B, T, C = q.shape
    S = k.shape[1]
    D = C // heads
    out = flash_attention(q.reshape(B, T, heads, D), k.reshape(B, S, heads, D),
                          v.reshape(B, S, heads, D), causal=False, sm_scale=1.0 / (D ** 0.5))
    return out.reshape(B, T, C)


def attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int):
    """``attention`` that also returns the logsumexp of each row's scaled
    logits, lse [B, heads, T] fp32, so that two partial attentions over
    disjoint key sets merge exactly (the story bank).

    Routed as ``attention`` is, to ``flash_attention_with_lse``. Elsewhere
    (CPU tensors, the "einsum" override): the reference's plain form, fp32
    logits with m + log(l)."""
    B, T, C = q.shape
    S = k.shape[1]
    D = C // heads
    if _projection_flash(q, k, heads):
        out, lse = flash_attention_with_lse(
            q.reshape(B, T, heads, D), k.reshape(B, S, heads, D), v.reshape(B, S, heads, D),
            causal=False, sm_scale=1.0 / (D ** 0.5))
        return out.reshape(B, T, C), lse
    qt = q.reshape(B, T, heads, D).transpose(1, 2)
    kt = k.reshape(B, S, heads, D).transpose(1, 2)
    vt = v.reshape(B, S, heads, D).transpose(1, 2)
    logits = torch.einsum("bhtd,bhsd->bhts", qt, kt).float() / (D ** 0.5)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhts,bhsd->bhtd", (p / l).to(vt.dtype), vt)
    return out.transpose(1, 2).reshape(B, T, C), (m + torch.log(l))[..., 0]
