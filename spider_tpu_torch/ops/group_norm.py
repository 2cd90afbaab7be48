"""GroupNorm with an optional fused SiLU: the diffusion decoders' norms.

``group_norm(x, norm, silu=False)`` computes ``F.silu(norm(x))`` (or
``norm(x)``) for an ``nn.GroupNorm`` ``norm``, so modules, state dicts and
converters keep their ``nn.GroupNorm``. The route depends only on what the
call can see in its input:

  kernel: a bf16 CUDA tensor launches the hand-written kernel
      (csrc/group_norm.cu): each (sample, group) row's moments reduced over
      many blocks in Welford/Chan form, then the normalisation, the affine
      and the SiLU in one pass, the result rounded once. Contiguous and
      channels-last inputs are read in place and the output keeps the
      input's layout; other strides are copied to contiguous first. A weight
      or bias of another dtype is cast to bf16. Where a gradient is needed
      the kernel runs through ``GroupNormFunction``, whose backward is the
      plain form's.
  plain: CPU tensors, and CUDA tensors of other dtypes (the fp32 copies
      the card's checks hold the bf16 models to), take ``F.group_norm`` then
      ``F.silu``, the form the models had before, bit for bit.

Each kernel call adds one to ``group_norm.launches`` (its one route,
"split"); the plain form launches no kernel of this module and counts
nothing. ``group_norm_config("plain")`` sends every call to the plain form,
for A/B checks.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.common import profiler
from spider_tpu_torch.ops.launch import (count_launch, current_stream_handle, scoped_mode,
                                         sm_count)

ROUTES = ("split",)
VEC = 8                  # bf16 elements in a 16-byte vector
# The statistics pass aims at BLOCKS_PER_SM blocks an SM, so that a short
# last wave costs little, but gives no thread of a chunk fewer than
# MIN_PER_THREAD elements, so that a block's loads outweigh its merges, unless
# that would leave the card under WAVE_PER_SM blocks an SM; no thread gets
# fewer than 16 elements. (Chosen on an H100 by the device time summed over
# the norms of a ZeroScope UNet3D call and of an SD-1.5 UNet2D call.)
BLOCKS_PER_SM = 8
WAVE_PER_SM = 2
MIN_PER_THREAD = 64
# A channels-last block has a multiple of C / VEC working threads near
# CL_THREADS (each thread then always holds the same VEC channels), at most
# what the library allows; a contiguous block has the library's fixed count.
CL_THREADS = 256

# Routing override for A/B checks: "auto" = the rule above; "plain" = the
# plain form everywhere.
group_norm_config, _mode = scoped_mode("group_norm_mode", ("auto", "plain"), "auto")
_FN = None


def split_plan(rows: int, units: int, unit_elems: int, sms: int, threads: int,
               align: int = 1) -> Tuple[int, int]:
    """(chunks, units a chunk) that split each of `rows` rows of `units`
    units (an element, or a channels-last position of `unit_elems`
    elements) over blocks of `threads`, by the rule above; a chunk's units
    are a multiple of `align`, and every chunk holds some."""
    elems = units * unit_elems
    want = -(-BLOCKS_PER_SM * sms // rows)
    busy = elems // (MIN_PER_THREAD * threads)
    wave = min(-(-WAVE_PER_SM * sms // rows), elems // (16 * threads))
    chunks = max(1, min(want, max(busy, wave), units))
    per = -(-units // chunks)
    per = -(-per // align) * align
    return -(-units // per), per


def cl_workers(C: int) -> int:
    """Working threads of a channels-last block: a multiple of C / VEC, so
    that each thread always holds the same channels."""
    cvec = C // VEC
    return cvec * max(1, CL_THREADS // cvec)


def _dense(shape, stride, order) -> bool:
    """Whether the axes, innermost first in `order`, lie densely (axes of
    size 1 may have any stride)."""
    expect = 1
    for d in order:
        if shape[d] != 1 and stride[d] != expect:
            return False
        expect *= shape[d]
    return True


def channels_last(shape, stride) -> bool:
    """Whether x [N, C, *S] lies densely as [N, *S, C]."""
    return _dense(shape, stride, (1, *range(len(shape) - 1, 1, -1), 0))


@functools.lru_cache(maxsize=1024)
def launch_plan(shape: torch.Size, stride: Tuple[int, ...], groups: int, sms: int,
                threads: Tuple[int, int]) -> Tuple[bool, bool, int, int, int, int, int, int, int]:
    """(copy, channels_last, N, C, L, chunks, per, threads, workers) of a
    launch on a bf16 x [N, C, *S] of this shape and strides, `threads` the
    library's (contiguous block, most a channels-last block): `copy` where x
    has to be made contiguous first; a model gives a few shapes, so the plan
    is kept."""
    N, C = shape[0], shape[1]
    L = math.prod(shape[2:])
    contiguous = _dense(shape, stride, range(len(shape) - 1, -1, -1))
    cl = (not contiguous and C % VEC == 0 and C // VEC <= threads[1]
          and channels_last(shape, stride))
    if cl:
        workers = cl_workers(C)
        block = -(-workers // 32) * 32
        chunks, per = split_plan(N, L, C, sms, workers)
    else:
        block = workers = threads[0]
        chunks, per = split_plan(N * groups, C // groups * L, 1, sms, block, VEC)
    return not (contiguous or cl), cl, N, C, L, chunks, per, block, workers


def _function():
    """The kernel's entry point and its threads a block (contiguous, most
    channels-last)."""
    global _FN
    if _FN is None:
        from spider_tpu_torch.ops import cuda_build

        lib = cuda_build.load("group_norm")
        fn = lib.spider_group_norm
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.spider_group_norm_threads.argtypes = [ctypes.c_int]
        lib.spider_group_norm_threads.restype = ctypes.c_int
        _FN = fn, (lib.spider_group_norm_threads(0), lib.spider_group_norm_threads(1))
    return _FN


def _param(p: Optional[torch.Tensor], name: str, x: torch.Tensor) -> Optional[torch.Tensor]:
    """A weight or bias as the kernel reads it: C contiguous bf16 elements
    on x's device."""
    if p is None:
        return None
    C = x.shape[1]
    if p.numel() != C or p.device != x.device:
        raise ValueError(f"{name} must hold {C} elements on {x.device}, "
                         f"got {tuple(p.shape)} on {p.device}")
    if p.dtype != torch.bfloat16:
        p = p.to(torch.bfloat16)
    return p if p.is_contiguous() else p.contiguous()


def group_norm_kernel(x: torch.Tensor, num_groups: int, weight: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
                      silu: bool = False) -> torch.Tensor:
    """Launch csrc/group_norm.cu on a bf16 CUDA x [N, C, *S] and return y in
    x's layout (contiguous, or channels-last where x lies so); adds one to
    ``group_norm.launches``. Raises on what the kernel does not take:
    another device or dtype, fewer than 2 axes, no elements, C not a
    multiple of `num_groups`, or a weight or bias that is not C elements on
    x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"the GroupNorm kernel runs on CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the GroupNorm kernel takes bf16, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"GroupNorm needs a non-empty [N, C, ...] input, got {tuple(x.shape)}")
    if num_groups <= 0 or x.shape[1] % num_groups:
        raise ValueError(f"C={x.shape[1]} is not a multiple of num_groups={num_groups}")
    weight, bias = _param(weight, "weight", x), _param(bias, "bias", x)
    fn, limits = _function()
    index = x.device.index
    copy, cl, N, C, L, chunks, per, threads, workers = launch_plan(
        x.shape, x.stride(), num_groups, sm_count(index), limits)
    if copy:
        x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()      # fresh storage, same layout, 16-byte aligned
    y = torch.empty_like(x)
    part = torch.empty(N * num_groups * chunks * 3, dtype=torch.float32, device=x.device)
    current = torch.cuda.current_device()
    if index != current:                     # the launch goes to the current device
        torch.cuda.set_device(index)
    try:
        err = fn(x.data_ptr(), y.data_ptr(), None if weight is None else weight.data_ptr(),
                 None if bias is None else bias.data_ptr(), part.data_ptr(), int(cl), N, C,
                 num_groups, L, chunks, per, threads, workers, float(eps), int(bool(silu)),
                 current_stream_handle(index))
    finally:
        if index != current:
            torch.cuda.set_device(current)
    if err != 0:
        raise RuntimeError(f"GroupNorm kernel launch failed with cudaError_t {err}")
    count_launch(group_norm, "split",
                 dict(N=N, C=C, L=L, G=num_groups, silu=bool(silu), elem_bytes=x.element_size())
                 if profiler.recording_on() else None)
    return y


def _plain(x: torch.Tensor, num_groups: int, weight: Optional[torch.Tensor],
           bias: Optional[torch.Tensor], eps: float, silu: bool) -> torch.Tensor:
    y = F.group_norm(x, num_groups, weight, bias, eps)
    return F.silu(y) if silu else y


class GroupNormFunction(torch.autograd.Function):
    """The kernel's forward with the plain form's gradient: the backward
    recomputes ``F.group_norm`` (then ``F.silu``) on the saved x, weight and
    bias under autograd and returns its vector-Jacobian product, launching
    no GroupNorm kernel."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, silu):
        ctx.save_for_backward(x, weight, bias)
        ctx.kw = dict(num_groups=num_groups, eps=eps, silu=silu)
        return group_norm_kernel(x, num_groups, weight, bias, eps, silu=silu)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:3]
        x, weight, bias = (None if t is None else t.detach().requires_grad_(need)
                           for t, need in zip(ctx.saved_tensors, needs))
        with torch.enable_grad():
            # the forward's bf16 parameters, cast inside the graph
            w, b = (None if p is None else p.to(x.dtype) for p in (weight, bias))
            y = _plain(x, ctx.kw["num_groups"], w, b, ctx.kw["eps"], ctx.kw["silu"])
        wanted = [t for t, need in zip((x, weight, bias), needs) if need]
        grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if need else None for need in needs), None, None, None)


def kernel_takes(x: torch.Tensor) -> bool:
    """The kernel's rule: a bf16 CUDA tensor, outside ``group_norm_config("plain")``."""
    return x.is_cuda and x.dtype == torch.bfloat16 and _mode() == "auto"


def group_norm(x: torch.Tensor, norm: nn.GroupNorm, silu: bool = False) -> torch.Tensor:
    """``F.silu(norm(x))`` when `silu`, else ``norm(x)``: the kernel where
    ``kernel_takes`` says so, else the plain form."""
    weight, bias = norm.weight, norm.bias
    if not kernel_takes(x):
        return _plain(x, norm.num_groups, weight, bias, norm.eps, silu)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias)):
        return GroupNormFunction.apply(x, weight, bias, norm.num_groups, norm.eps, silu)
    return group_norm_kernel(x, norm.num_groups, weight, bias, norm.eps, silu=silu)


group_norm.launches = 0
group_norm.route_launches = dict.fromkeys(ROUTES, 0)
