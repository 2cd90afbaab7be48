"""Collectives over groups of a ``DeviceMesh``, and the differentiable ones
the parallel forms need (the JAX package gets these from ``shard_map`` and
jax AD: ``ppermute``, ``psum``, ``all_to_all``, an all-gather).

Each autograd form states the meaning of its backward:
  * ``shift_right``: x goes to rank r + 1 of the group; its backward sends
    the cotangent to the left (ppermute and its transpose).
  * ``all_to_all``: chunk j of dim 0 goes to rank j; the backward is the
    same exchange of the cotangent (the _AllToAll pair of torchscale).
  * ``sum_to_all``: the sum over the group, held by every rank as one
    replicated value; the backward hands each rank the cotangent of that
    value unchanged (psum under ``shard_map`` with a replicated output).
  * ``gather``: the concatenation over the group along a dim; the backward
    sums the cotangents of every rank's copy and returns each rank its own
    slice. A loss that every rank computes alike from the gathered tensor is
    therefore counted n times: weight it 1/n.
  * ``split_replicated`` and ``gather_replicated``, for a tensor that every
    rank of the group holds alike and whose cotangent is alike on every rank
    (the ranks compute the same loss): the split keeps this rank's chunk and
    its backward gathers the chunks' cotangents into the whole; the gather
    concatenates the chunks and its backward keeps this rank's chunk of the
    cotangent, unsummed. Between the two, each rank works on its chunk only
    and every gradient outside comes out whole on every rank.

Without autograd, for the sharded video denoise (inference only):
``frames_to_pixels`` / ``pixels_to_frames`` (an
all-to-all between a frame split and a pixel split that may be uneven, with
dense, zero-padded buffers) and ``frame_halo``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F


def group_of(mesh, axes: Sequence[str]):
    """The process group of the ranks that share this rank's coordinates on
    every mesh axis outside `axes` (None for no mesh); a rank's place in it
    runs over `axes` in the mesh's order, the last fastest. Collective on
    first use: every rank must ask for the same axes in the same order. The
    groups are kept on the mesh, and live as long as it does."""
    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in names if a in axes)
    groups = mesh.__dict__.setdefault("_axis_groups", {})
    if axes not in groups:
        ranks = mesh.mesh
        inner = [names.index(a) for a in axes]
        outer = [i for i in range(len(names)) if i not in inner]
        size = 1
        for i in inner:
            size *= ranks.shape[i]
        lists = ranks.permute(*outer, *inner).reshape(-1, size).tolist()
        groups[axes], _ = dist.new_subgroups_by_enumeration(lists)
    return groups[axes]


def size_of(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank_in(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_sum_(tensors: List[torch.Tensor], group) -> None:
    """In-place SUM of each tensor over the group (no autograd)."""
    if size_of(group) == 1:
        return
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def exchange(tensors: Sequence[torch.Tensor], group, send_to: int, recv_from: int):
    """Start sending each tensor to group rank `send_to` and receiving one
    of its shape from `recv_from`; returns (received, works). The received
    tensors are valid, and the sent ones free to change, after every work
    of the list has been waited on."""
    tensors = [t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, recv):
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, send_to), group))
        ops.append(dist.P2POp(dist.irecv, r, dist.get_global_rank(group, recv_from), group))
    return recv, dist.batch_isend_irecv(ops)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    n, r = size_of(group), rank_in(group)
    if n == 1:
        return x
    (out,), works = exchange([x], group, (r + step) % n, (r - step) % n)
    for w in works:
        w.wait()
    return out


class _ShiftRight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -1), None


def shift_right(x: torch.Tensor, group) -> torch.Tensor:
    """Rank r's x arrives at rank r + 1 (mod n); differentiable."""
    return _ShiftRight.apply(x, group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    if size_of(group) == 1:
        return x
    x = x.contiguous()           # empty_like keeps a view's strides; the collective
    out = torch.empty_like(x)    # writes a dense buffer
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of dim 0 (n equal chunks) goes to rank j; rank j's chunk i
    arrives at position j of rank i's output; differentiable."""
    return _AllToAll.apply(x, group)


class _SumToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        all_reduce_sum_([out], group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The SUM over the group, replicated; see the module docstring for its
    backward."""
    return _SumToAll.apply(x, group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size_of(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)   # reduced in place
        all_reduce_sum_([g], ctx.group)
        r = rank_in(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size), None, None


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The concatenation of every rank's x along `dim` (equal shapes);
    differentiable, with the backward of the module docstring."""
    if size_of(group) == 1:
        return x
    return _Gather.apply(x, group, dim)


class _SplitReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = size_of(group)
        return x.chunk(n, dim)[rank_in(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(size_of(ctx.group))]
        dist.all_gather(parts, g, group=ctx.group)
        return torch.cat(parts, dim=ctx.dim), None, None


def split_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk along `dim` (n equal chunks) of a tensor every rank
    holds alike; differentiable, its backward the whole cotangent gathered
    from the chunks'."""
    if size_of(group) == 1:
        return x
    if x.shape[dim] % size_of(group):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{size_of(group)} ranks")
    return _SplitReplicated.apply(x, group, dim)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size_of(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, rank_in(ctx.group) * ctx.size, ctx.size), None, None


def gather_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The concatenation of every rank's chunk along `dim`, for a result
    every rank then uses alike; differentiable, its backward this rank's
    chunk of the (alike) cotangent, not summed over the ranks."""
    if size_of(group) == 1:
        return x
    return _GatherReplicated.apply(x, group, dim)


def frames_to_pixels(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's frames of every pixel, x [B, F_local, P, C], -> every
    frame of this rank's pixels, [B, n * F_local, Pc, C] with Pc =
    ceil(P / n): rank r the pixels r*Pc .., zero rows past P (the split may
    be uneven). Frames in rank order. No autograd."""
    n = size_of(group)
    if n == 1:
        return x
    B, Fl, P, C = x.shape
    Pc = -(-P // n)
    x = F.pad(x, (0, 0, 0, Pc * n - P))
    send = x.reshape(B, Fl, n, Pc, C).permute(2, 0, 1, 3, 4)        # [n (pixels), B, Fl, Pc, C]
    recv = _all_to_all(send, group)                                  # [n (frames), ...]
    return recv.permute(1, 0, 2, 3, 4).reshape(B, n * Fl, Pc, C)


def pixels_to_frames(x: torch.Tensor, group, pixels: int) -> torch.Tensor:
    """The inverse of ``frames_to_pixels``: [B, F, Pc, C] (every frame of
    this rank's pixels) -> [B, F / n, pixels, C] (this rank's frames of
    every pixel), the padding dropped. No autograd."""
    n = size_of(group)
    if n == 1:
        return x[:, :, :pixels]
    B, Fr, Pc, C = x.shape
    send = x.reshape(B, n, Fr // n, Pc, C).transpose(0, 1)           # [n (frames), B, Fl, Pc, C]
    recv = _all_to_all(send, group)                                  # [n (pixels), ...]
    return recv.permute(1, 2, 0, 3, 4).reshape(B, Fr // n, n * Pc, C)[:, :, :pixels]


def frame_halo(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """x with one frame more at each end of `dim`: the last frame of the
    rank before and the first of the rank after, zeros where there is none
    (the first and the last rank), so a kernel-3 conv over the result with
    no padding is the conv of the whole frame axis with zero padding. No
    autograd."""
    n, r = size_of(group), rank_in(group)
    first = x.narrow(dim, 0, 1).contiguous()
    last = x.narrow(dim, x.shape[dim] - 1, 1).contiguous()
    left, right = torch.zeros_like(first), torch.zeros_like(last)
    ops = []
    if r > 0:
        peer = dist.get_global_rank(group, r - 1)
        ops += [dist.P2POp(dist.isend, first, peer, group),
                dist.P2POp(dist.irecv, left, peer, group)]
    if r < n - 1:
        peer = dist.get_global_rank(group, r + 1)
        ops += [dist.P2POp(dist.isend, last, peer, group),
                dist.P2POp(dist.irecv, right, peer, group)]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return torch.cat([left, x, right], dim=dim)
