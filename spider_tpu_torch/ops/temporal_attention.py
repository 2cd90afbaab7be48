"""Per-pixel frame attention: the UNet3D temporal-attention core.

Counterpart of spider_tpu/ops/temporal_attention.py. ``temporal_attention``
launches the hand-written CUDA kernel (csrc/tattn_fwd.cu) on CUDA tensors
exactly where the reference launches its Pallas kernel (its predicate, with
"on CUDA" for "on a TPU") and takes the plain einsum form,
``temporal_attention_reference``, everywhere else. On a CUDA tensor inside
the predicate it launches the kernel or raises; it never falls back. The
kernel call is differentiable: its backward recomputes the einsum form and
takes that form's vector-Jacobian product, as the reference's custom_vjp does
(spider_tpu/ops/temporal_attention.py:126-146), and launches no kernel.

Layouts: q, k, v [B, F, P, C] ("bfpc", what UNet3D uses) or [B, P, F, C]
("bpfc"), C = heads * head_dim; attention runs over F independently at every
(pixel, head), and the output comes back in the layout it was given.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from spider_tpu_torch.common import profiler
from spider_tpu_torch.ops.launch import count_launch, current_stream_handle, scoped_mode

LAYOUTS = ("bfpc", "bpfc")
MAX_FRAMES = 32
MAX_HEAD_DIM = 256
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Routing override for A/B checks: "auto" = the reference's predicate;
# "plain" = the einsum form everywhere.
temporal_attention_config, _mode = scoped_mode("temporal_attention_mode", ("auto", "plain"),
                                               "auto")


def _dims(q: torch.Tensor, layout: str):
    """(B, F, P, C) of a q in `layout`."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if q.dim() != 4:
        raise ValueError(f"q must be 4-D, got {tuple(q.shape)}")
    if layout == "bpfc":
        B, P, F, C = q.shape
    else:
        B, F, P, C = q.shape
    return B, F, P, C


def temporal_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 heads: int, *, scale: Optional[float] = None,
                                 layout: str = "bfpc") -> torch.Tensor:
    """The reference's einsum form: logits [B, H, F, F, P] times scale,
    softmax over the key frames in fp32, probs cast to v's dtype, then
    probs . v. The logits are accumulated and kept in fp32, as the TPU
    kernel keeps them (``preferred_element_type=jnp.float32``); for fp32
    inputs this is the reference's einsum exactly."""
    if layout == "bpfc":
        _dims(q, layout)
        out = temporal_attention_reference(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), heads, scale=scale)
        return out.transpose(1, 2)
    B, F, P, C = _dims(q, layout)
    H, D = heads, C // heads
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    q4, k4, v4 = (x.reshape(B, F, P, H, D) for x in (q, k, v))
    logits = torch.einsum("bfphd,bgphd->bhfgp", q4.float(), k4.float()) * scale
    probs = torch.softmax(logits, dim=3).to(v.dtype)
    out = torch.einsum("bhfgp,bgphd->bfphd", probs, v4)
    return out.reshape(B, F, P, C)


ROUTES = ("ring", "simple")


def tattn_route(dtype: torch.dtype) -> str:
    """The kernel a temporal-attention call takes on the card, by dtype
    alone. "ring": bf16, what UNet3D runs: persistent blocks that stream
    their tiles through a ring of shared-memory stages by bulk copies and
    take the products on the tensor cores. "simple": fp32 inputs, on the
    first, synchronous form with its arithmetic in fp32 on the CUDA cores
    (exact for them); it takes bf16 too when a call names it."""
    return "ring" if dtype == torch.bfloat16 else "simple"


def _library():
    from spider_tpu_torch.ops import cuda_build

    lib = cuda_build.load("tattn_fwd")
    if lib.spider_tattn_fwd.argtypes is None:
        head = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
        lib.spider_tattn_fwd.argtypes = head + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.spider_tattn_fwd.restype = ctypes.c_int
        # no is_fp32: the ring form takes bf16 only
        lib.spider_tattn_fwd_ring.argtypes = head + [ctypes.c_float, ctypes.c_void_p]
        lib.spider_tattn_fwd_ring.restype = ctypes.c_int
    return lib


def _frame_pixel_strides(x: torch.Tensor, layout: str):
    """Element strides of the (b, f, p) axes."""
    s = x.stride()
    return (s[0], s[2], s[1]) if layout == "bpfc" else (s[0], s[1], s[2])


def temporal_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                              *, scale: Optional[float] = None, layout: str = "bfpc",
                              route: Optional[str] = None) -> torch.Tensor:
    """Launch csrc/tattn_fwd.cu on CUDA tensors, whatever the routing
    predicate says, through the kernel ``tattn_route`` names or the one the
    caller does, and add one to ``temporal_attention.launches`` and to the
    route's entry of ``temporal_attention.route_launches``. Raises on
    anything the kernel does not take: another device or dtype, F > 32, a
    head dim that is not a multiple of 8 up to 256, mismatched strides, rows
    that are not 16-byte aligned, or a named "ring" on fp32."""
    B, F, P, C = _dims(q, layout)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if heads <= 0 or C % heads:
        raise ValueError(f"C={C} is not a multiple of heads={heads}")
    D = C // heads
    if F > MAX_FRAMES or D % 8 or D > MAX_HEAD_DIM or min(B, F, P) == 0:
        raise ValueError(f"temporal kernel takes 0 < F <= {MAX_FRAMES} and head dims that "
                         f"are multiples of 8 up to {MAX_HEAD_DIM}; got B={B} F={F} P={P} "
                         f"D={D}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"temporal kernel takes bf16 or fp32 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    ruled = tattn_route(q.dtype)
    if route is None:
        route = ruled
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "ring" and ruled != "ring":
        raise ValueError(f"the ring route takes bf16, got {q.dtype}")
    if q.device.type != "cuda":
        raise ValueError(f"temporal kernel runs on CUDA tensors, got {q.device}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride() != q.stride():
            raise ValueError(f"{name} strides {x.stride()} differ from q's {q.stride()}")
        if x.stride(3) != 1 or any(s % vec for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{name} needs unit channel stride and 16-byte aligned rows, "
                             f"got strides {x.stride()}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, F, P, heads, D,
            *_frame_pixel_strides(q, layout), *_frame_pixel_strides(out, layout), float(scale))
    with torch.cuda.device(q.device):   # the launch goes to the current device
        stream = current_stream_handle(q.device.index)
        if route == "ring":
            err = _library().spider_tattn_fwd_ring(*args, stream)
        else:
            err = _library().spider_tattn_fwd(*args, int(q.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"temporal attention ({route}) launch failed with cudaError_t {err}")
    count_launch(temporal_attention, route,
                 dict(B=B, F=F, P=P, C=C, heads=heads, elem_bytes=q.element_size())
                 if profiler.recording_on() else None)
    return out


def kernel_predicate(heads: int, F: int, P: int, C: int) -> bool:
    """Where the reference takes its Pallas kernel
    (temporal_attention.py:181-183), minus its "on a TPU" clause."""
    H = heads
    return (H * F >= 64 and H * F <= 1024 and P >= 32 and C % H == 0
            and (H * F) % 8 == 0 and (C // H) % 8 == 0)


class TemporalAttentionFunction(torch.autograd.Function):
    """The kernel's forward with the einsum form's gradient: the forward
    launches ``temporal_attention_kernel`` on the route ``tattn_route``
    names; the backward recomputes ``temporal_attention_reference`` on the
    saved q, k, v and returns its vector-Jacobian product (the reference's
    ``_tattn_pallas_vjp_bwd``), launching no temporal kernel."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale, layout):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(heads=heads, scale=scale, layout=layout)
        return temporal_attention_kernel(q, k, v, heads, scale=scale, layout=layout)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        kw = ctx.kw
        with torch.enable_grad():
            out = temporal_attention_reference(q, k, v, kw["heads"], scale=kw["scale"],
                                               layout=kw["layout"])
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *,
                       scale: Optional[float] = None, layout: str = "bfpc",
                       pixels: Optional[int] = None) -> torch.Tensor:
    """Frame-axis attention at every pixel. CPU tensors, and CUDA tensors
    outside the reference's predicate, take the einsum form; CUDA tensors
    inside it launch the kernel through ``TemporalAttentionFunction``
    (differentiable in q, k and v) and add one to
    ``temporal_attention.launches``. `pixels` is the P the predicate reads
    (q's by default): a call on one rank's share of a frame's pixels passes
    the whole frame's, as the reference decides on the global array."""
    B, F, P, C = _dims(q, layout)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"temporal_attention runs on cpu or cuda tensors, got {q.device}")
    if (q.device.type == "cuda" and _mode() == "auto"
            and kernel_predicate(heads, F, P if pixels is None else pixels, C)):
        return TemporalAttentionFunction.apply(q, k, v, heads, scale, layout)
    return temporal_attention_reference(q, k, v, heads, scale=scale, layout=layout)


temporal_attention.launches = 0
temporal_attention.route_launches = dict.fromkeys(ROUTES, 0)
