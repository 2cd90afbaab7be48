"""Single-token decode attention over a block-paged KV pool: the plain
PyTorch version and the CUDA kernel.

Counterpart of spider_tpu/ops/paged_attention.py. ``paged_decode_attention``
launches a hand-written kernel (csrc/paged_decode.cu) on CUDA tensors and
takes ``paged_decode_reference`` on CPU tensors. On a CUDA tensor it
launches the kernel or raises; it never falls back.

Layouts: q [B, Hq, D]; pool_k, pool_v [N_blocks, page, Hkv, D];
page_table [B, max_pages] (slot b's logical page i lives in pool block
page_table[b, i]); kv_len [B]; output [B, Hq, D] in q's dtype.

Two kernels share the source, and ``paged_route`` names one by a stated rule:
"split" (bf16, a page that is a multiple of 16 keys, a head dim that is a
multiple of 16 up to 128: a slot's keys cut over several blocks by
``split_plan``, merged in split order) and "simple", the first kernel, for
everything else. ``route=`` on ``paged_decode_kernel`` names one for tests and
timings; ``paged_decode_attention.route_launches`` counts per route.
``paged_decode_reference_split`` is the split kernel's arithmetic in plain
PyTorch.

Slots with kv_len = 0: the kernels return 0, as the TPU kernel does; the
plain version, like the reference's gather route, returns the mean of V
(ROADMAP C2). Neither the model nor the batcher asks for such a row.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from spider_tpu_torch.ops.attention import mha_reference
from spider_tpu_torch.ops.launch import (count_launch, current_stream_handle, scoped_mode,
                                         sm_count, stream_buffers)

MAX_HEAD_DIM = 256
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Routing override for A/B checks on the card: "auto" = the kernel on CUDA
# tensors; "plain" = paged_decode_reference everywhere.
paged_decode_config, _mode = scoped_mode("paged_decode_mode", ("auto", "plain"), "auto")


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


def split_plan(max_pages: int, page: int, slots: int, kv_heads: int, sms: int,
               group: int = 1) -> Tuple[int, int]:
    """(splits, keys a split) of the split kernel: a pure function of the
    table's width, the page, the grid's other two dimensions and the card's
    SM count, never of kv_len. Split s covers keys [s * keys, (s + 1) * keys)
    of a slot's window of max_pages * page keys; keys is a multiple of the
    kernel's 16-key tile and at least one tile for each of a block's 4 warps,
    and the splits are as many as bring the grid to two blocks an SM."""
    tiles = max_pages * page // SPLIT_KEYS
    blocks = slots * kv_heads * -(-group // SPLIT_ROWS)
    want = -(-2 * sms // blocks)
    n_split = max(1, min(want, tiles // SPLIT_WARPS))
    tiles_per_split = -(-tiles // n_split)
    return -(-tiles // tiles_per_split), tiles_per_split * SPLIT_KEYS


def paged_decode_reference_split(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                                 page_table: torch.Tensor, kv_len: torch.Tensor,
                                 sm_scale: Optional[float] = None, *, n_split: int,
                                 keys_per_split: int) -> torch.Tensor:
    """The split kernel's arithmetic in plain PyTorch: each split's max, sum
    and accumulator over its own keys (a split that starts at or past kv_len
    is skipped), merged in split order with weights exp(max - overall max).
    fp32 throughout; a slot with kv_len = 0 gives 0, as the kernel does."""
    B, Hq, D = q.shape
    _, page, Hkv, _ = pool_k.shape
    MP = page_table.shape[1]
    G = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    idx = page_table.long()
    gk = pool_k[idx].reshape(B, MP * page, Hkv, D).float()
    gv = pool_v[idx].reshape(B, MP * page, Hkv, D).float()
    qg = q.float().reshape(B, Hkv, G, D)
    live = kv_len.long().clamp(0, MP * page)
    parts = []
    for s in range(n_split):
        lo, hi = s * keys_per_split, min((s + 1) * keys_per_split, MP * page)
        if lo >= hi:
            break
        logits = torch.einsum("bhgd,bkhd->bhgk", qg, gk[:, lo:hi]) * scale
        dead = (lo + torch.arange(hi - lo, device=q.device))[None, :] >= live[:, None]
        logits = logits.masked_fill(dead[:, None, None, :], float("-inf"))
        m = logits.amax(dim=-1)                                   # -inf for a skipped split
        p = torch.exp(logits - m.clamp_min(torch.finfo(torch.float32).min)[..., None])
        p = p.masked_fill(dead[:, None, None, :], 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bhgk,bkhd->bhgd", p, gv[:, lo:hi])))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(m_all)
    acc = torch.zeros_like(parts[0][2])
    for m, ls, a in parts:
        w = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - m_all))
        l = l + ls * w
        acc = acc + a * w[..., None]
    out = torch.where(l[..., None] > 0, acc / l[..., None].clamp_min(1e-38), torch.zeros_like(acc))
    return out.reshape(B, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/paged_decode.cu)
# ---------------------------------------------------------------------------

ROUTES = ("split", "simple")
SPLIT_KEYS = 16        # keys of the split kernel's tile
SPLIT_WARPS = 4        # warps of its block
SPLIT_ROWS = 16        # query heads of a block, padded
SPLIT_MAX_HEAD_DIM = 128


def paged_route(dtype: torch.dtype, page: int, D: int) -> str:
    """The kernel a paged decode call takes on the card. "split": bf16, a
    page that is a multiple of the 16-key tile, D a multiple of 16 up to 128
    (what the batcher and the models give it): a slot's keys split over
    blocks, the products on the tensor cores. "simple": everything else the
    first kernel takes (fp32 pools, other pages, other head dims)."""
    if (dtype == torch.bfloat16 and page % SPLIT_KEYS == 0 and D % 16 == 0
            and 0 < D <= SPLIT_MAX_HEAD_DIM):
        return "split"
    return "simple"


_FNS = None
_COUNTERS = {}
_SCRATCH = {}


def _functions():
    global _FNS
    if _FNS is None:
        from spider_tpu_torch.ops import cuda_build

        lib = cuda_build.load("paged_decode")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.spider_paged_decode.argtypes = [p] * 6 + [i] * 6 + [ctypes.c_float, i, p]
        lib.spider_paged_decode_split.argtypes = [p] * 8 + [i] * 8 + [ctypes.c_float, p]
        lib.spider_paged_decode.restype = lib.spider_paged_decode_split.restype = i
        _FNS = (lib.spider_paged_decode, lib.spider_paged_decode_split)
    return _FNS


def paged_decode_kernel(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                        page_table: torch.Tensor, kv_len: torch.Tensor,
                        sm_scale: Optional[float] = None,
                        route: Optional[str] = None) -> torch.Tensor:
    """Launch csrc/paged_decode.cu through the kernel ``paged_route`` names
    or the one the caller does, and add one to
    ``paged_decode_attention.launches`` and to the route's entry of
    ``paged_decode_attention.route_launches``. Raises on anything the kernel
    does not take: another device, q and pools not of one dtype (bf16 or
    fp32), non-contiguous q or pools, Hq not a multiple of Hkv, a head dim
    that is not a multiple of 8 up to 256, or a named "split" on an input
    the rule does not send there; a launch the card refuses (more shared
    memory than a block may have, at very large Hq/Hkv or max_pages) raises
    with its CUDA error. A table or kv_len that is not int32 is cast, as the
    JAX wrapper casts them."""
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
    dtype, device = q.dtype, q.device
    if dtype not in _KERNEL_DTYPES or pool_k.dtype != dtype or pool_v.dtype != dtype:
        raise TypeError(f"paged kernel takes bf16 or fp32 q and pools of one dtype, got "
                        f"{dtype}/{pool_k.dtype}/{pool_v.dtype}")
    if not (pool_k.device == pool_v.device == page_table.device == kv_len.device == device):
        raise ValueError(f"q, the pools, page_table and kv_len must be on one device, got "
                         f"{device}, {pool_k.device}, {pool_v.device}, {page_table.device}, "
                         f"{kv_len.device}")
    q_ptr, k_ptr, v_ptr = q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr()
    if (not (q.is_contiguous() and pool_k.is_contiguous() and pool_v.is_contiguous())
            or (q_ptr | k_ptr | v_ptr) % 16):
        raise ValueError("q, pool_k and pool_v must be contiguous and 16-byte aligned")
    ruled = paged_route(dtype, page, D)
    if route is None:
        route = ruled
    elif route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    elif route == "split" and ruled != "split":
        raise ValueError(f"the split route takes bf16, pages that are multiples of "
                         f"{SPLIT_KEYS} and head dims that are multiples of 16 up to "
                         f"{SPLIT_MAX_HEAD_DIM}; got {dtype}, page {page}, D {D}")
    if device.type != "cuda":
        raise ValueError(f"paged kernel runs on CUDA tensors, got {device}")
    table = page_table
    if table.dtype != torch.int32 or not table.is_contiguous():
        table = table.to(torch.int32).contiguous()
    lens = kv_len
    if lens.dtype != torch.int32 or not lens.is_contiguous():
        lens = lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    scale = float(sm_scale) if sm_scale is not None else 1.0 / (D ** 0.5)
    simple_fn, split_fn = _functions()
    index = device.index
    current = torch.cuda.current_device()
    if index != current:                     # the launch goes to the current device
        torch.cuda.set_device(index)
    try:
        stream = current_stream_handle(index)
        if route == "split":
            n_split, keys = split_plan(MP, page, B, Hkv, sm_count(index), Hq // Hkv)
            units = B * Hkv * -(-(Hq // Hkv) // SPLIT_ROWS)
            counters, part = stream_buffers(_COUNTERS, _SCRATCH, device, stream, units,
                                            units * n_split * SPLIT_ROWS * (D + 2))
            err = split_fn(q_ptr, k_ptr, v_ptr, table.data_ptr(), lens.data_ptr(),
                           out.data_ptr(), part.data_ptr(), counters.data_ptr(), B, Hq, Hkv, D,
                           page, MP, n_split, keys, scale, stream)
        else:
            err = simple_fn(q_ptr, k_ptr, v_ptr, table.data_ptr(), lens.data_ptr(),
                            out.data_ptr(), B, Hq, Hkv, D, page, MP, scale,
                            int(dtype == torch.float32), stream)
    finally:
        if index != current:
            torch.cuda.set_device(current)
    if err != 0:
        raise RuntimeError(f"paged decode ({route}) launch failed with cudaError_t {err}")
    count_launch(paged_decode_attention, route)
    return out


def paged_decode_attention(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                           page_table: torch.Tensor, kv_len: torch.Tensor, *,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, D]; pool_k/v [N_blocks, page, Hkv, D]; page_table
    [B, max_pages]; kv_len [B] -> out [B, Hq, D].

    CPU tensors take paged_decode_reference; CUDA tensors launch the kernel
    and add one to ``paged_decode_attention.launches``."""
    if q.device.type == "cpu" or _mode() == "plain":
        return paged_decode_reference(q, pool_k, pool_v, page_table, kv_len, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cpu or cuda tensors, got {q.device}")
    return paged_decode_kernel(q, pool_k, pool_v, page_table, kv_len, sm_scale)


paged_decode_attention.launches = 0
paged_decode_attention.route_launches = dict.fromkeys(ROUTES, 0)
