"""Ring attention: exact attention with the sequence split over the ranks
of a ``context`` group (counterpart of spider_tpu/ops/ring_attention.py).

Each rank holds q, k and v for T_local = T / n consecutive positions (rank r
the rows r*T_local ...). Over n steps the K/V blocks travel around the
ring: at step i rank ``my`` holds the block of rank ``src = (my - i) % n``,
starts sending it to ``my + 1`` (``batch_isend_irecv``; on CUDA the NCCL
work runs on its own stream, so the next block's copy overlaps this block's
kernel), attends to it with ``q_offset = rel = (my - src) * T_local``, and
merges the block's normalised output into a running one by logsumexp, as
the JAX package does (ring_attention.py:111-123). Past blocks (rel >=
T_local) pass the whole causal mask, the diagonal (rel 0) is the triangle,
and blocks after it (rel <= -T_local) have no live key on any row.

Per block, CUDA tensors launch the flash kernels: the forward
(``flash_attention_with_lse``'s kernel) and, in the backward, the dq and
dk/dv kernels (``flash_bwd_dq``, ``flash_bwd_dkv``) with the GLOBAL lse of
the merged output and ``delta = rowsum(dO * O)``: the classic ring
backward. dK and dV accumulate in fp32 buffers that travel around the ring
with their block and reach their owner after n steps. CPU tensors take the
plain block form (``mha_reference_with_lse`` with the same q_offset, the
counterpart of ``_block_attn``; ``flash_backward_reference``).

Rows with no live key: on the CPU the block's lse is -inf and the merge's
``isfinite`` guards drop it; the CUDA kernel returns a finite lse of about
-0.7 * FLT_MAX there (and the mean of V), which the merge weighs by
exp(-huge) = 0 exactly, so a dead block leaves the running output and lse
bit for bit as they were, as long as the running lse is finite: step 0 is
the diagonal, where every row has a live key. In the backward both paths
set P to exactly zero on dead pairs.

``ring_step_forward`` and ``ring_step_backward`` are one rank's work on one
block, plain functions of (the blocks it holds, rel); ``RingAttentionFunction``
calls them between its exchanges, and ``ring_attention_ranks`` runs every
rank of a ring in one process with no communicator (tests, chip_smoke.py).
The split is the JAX package's contiguous one, so the last rank does n - 1
past blocks and the diagonal while rank 0 does the diagonal alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from spider_tpu_torch.ops import attention as A
from spider_tpu_torch.parallel.collectives import exchange, rank_in, size_of


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def ring_block(q, k_blk, v_blk, rel: int, causal: bool, sm_scale: Optional[float] = None):
    """(out [B,T,Hq,D] in q's dtype, lse [B,Hq,T] fp32) of q against one
    block whose row 0 sits `rel` positions before q's row 0: the flash
    forward kernel on CUDA tensors, the plain block form on the CPU."""
    sm_scale = _scale(q, sm_scale)
    q_offset = rel if causal else None
    if q.device.type == "cpu":
        return A.mha_reference_with_lse(q, k_blk, v_blk, causal=causal, sm_scale=sm_scale,
                                        q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"ring attention runs on cpu or cuda tensors, got {q.device}")
    return A._flash_cuda(q, k_blk, v_blk, causal, sm_scale, None, q_offset)


def merge(o_run: torch.Tensor, lse_run: torch.Tensor, o_b: torch.Tensor, lse_b: torch.Tensor):
    """Logsumexp merge of two normalised partials: o [B,T,Hq,D] fp32 and
    lse [B,Hq,T] fp32; returns the merged pair."""
    m_new = torch.maximum(lse_run, lse_b)
    finite = torch.isfinite(m_new)
    m_safe = torch.where(finite, m_new, torch.zeros_like(m_new))
    zero = torch.zeros_like(m_new)
    wa = torch.where(torch.isfinite(lse_run), torch.exp(lse_run - m_safe), zero)
    wb = torch.where(torch.isfinite(lse_b), torch.exp(lse_b - m_safe), zero)
    wsum = torch.clamp(wa + wb, min=1e-30)
    rows = lambda w: (w / wsum).transpose(1, 2)[..., None]          # [B,T,Hq,1]
    o = o_run * rows(wa) + o_b.float() * rows(wb)
    lse = torch.where(finite, m_safe + torch.log(wsum), torch.full_like(m_new, float("-inf")))
    return o, lse


def ring_step_forward(q, k_blk, v_blk, o_run, lse_run, rel: int, causal: bool = True,
                      sm_scale: Optional[float] = None):
    """One rank's forward step: attend to the block it holds and merge it
    into (o_run, lse_run); returns the new pair."""
    o_b, lse_b = ring_block(q, k_blk, v_blk, rel, causal, sm_scale)
    return merge(o_run, lse_run, o_b, lse_b)


def ring_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """[B,Hq,T] fp32 rowsum(dO * O) of the merged output."""
    return A._delta(g, out, None)


def ring_step_backward(q, k_blk, v_blk, out, lse, delta, g, rel: int, causal: bool = True,
                       sm_scale: Optional[float] = None):
    """One rank's backward step on the block it holds: (dq, dk, dv) of this
    block's pairs, from the merged output's global lse and delta. CUDA
    tensors launch the dq and dk/dv kernels; the CPU takes the plain form."""
    sm_scale = _scale(q, sm_scale)
    q_offset = rel if causal else None
    if q.device.type == "cpu":
        return A.flash_backward_reference(q, k_blk, v_blk, out, lse, g, causal, sm_scale,
                                          q_offset=q_offset)
    B, T = q.shape[:2]
    live, off = A._live_and_offset(B, T, k_blk.shape[1], None, q_offset, q.device)
    args = (q, k_blk, v_blk, g, lse, delta, live, off, causal, sm_scale)
    return (A.flash_bwd_dq(*args),) + A.flash_bwd_dkv(*args)


def _initial(q: torch.Tensor):
    B, T, Hq, D = q.shape
    return (torch.zeros((B, T, Hq, D), dtype=torch.float32, device=q.device),
            torch.full((B, Hq, T), float("-inf"), dtype=torch.float32, device=q.device))


class RingAttentionFunction(torch.autograd.Function):
    """out = attention of the whole sequence, this rank's rows, over the
    ranks of `group` (each holding q, k, v [B, T_local, H, D])."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        n, my = size_of(group), rank_in(group)
        T_local = q.shape[1]
        o_run, lse_run = _initial(q)
        k_blk, v_blk = k, v
        for i in range(n):
            src = (my - i) % n
            works = ()
            if i < n - 1:       # rotate first: the copy overlaps this block's kernel
                (k_next, v_next), works = exchange([k_blk, v_blk], group, (my + 1) % n,
                                                   (my - 1) % n)
            o_run, lse_run = ring_step_forward(q, k_blk, v_blk, o_run, lse_run,
                                               (my - src) * T_local, causal, sm_scale)
            for w in works:
                w.wait()
            if i < n - 1:
                k_blk, v_blk = k_next, v_next
        out = o_run.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse_run)
        ctx.group, ctx.causal, ctx.sm_scale = group, causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, sm_scale = ctx.group, ctx.causal, ctx.sm_scale
        n, my = size_of(group), rank_in(group)
        T_local = q.shape[1]
        g = g.contiguous()
        delta = ring_delta(out, g)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for i in range(n):
            src = (my - i) % n
            works = ()
            if i < n - 1:
                (k_next, v_next), works = exchange([k_blk, v_blk], group, (my + 1) % n,
                                                   (my - 1) % n)
            dq_b, dk_b, dv_b = ring_step_backward(q, k_blk, v_blk, out, lse, delta, g,
                                                  (my - src) * T_local, causal, sm_scale)
            dq += dq_b.float()
            dk += dk_b.float()
            dv += dv_b.float()
            if n > 1:           # the gradients travel with their block: home after n moves
                (dk, dv), dworks = exchange([dk, dv], group, (my + 1) % n, (my - 1) % n)
                works = tuple(works) + tuple(dworks)
            for w in works:
                w.wait()
            if i < n - 1:
                k_blk, v_blk = k_next, v_next
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None, *,
                   causal: bool = True, sm_scale: Optional[float] = None) -> torch.Tensor:
    """q [B,T_local,Hq,D], k/v [B,T_local,Hkv,D]: this rank's rows of the
    sequence split over `group` (None: a ring of one) -> this rank's rows
    of the output, differentiable in q, k and v. A ring of one is one call
    of the flash kernel, ``flash_attention``'s bits."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"ring attention holds equal q and k/v rows, got {q.shape[1]} "
                         f"and {k.shape[1]}")
    return RingAttentionFunction.apply(q.contiguous(), k.contiguous(), v.contiguous(), group,
                                       causal, sm_scale)


def ring_attention_ranks(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor], gs: Optional[Sequence[torch.Tensor]] = None,
                         *, causal: bool = True, sm_scale: Optional[float] = None):
    """Every rank of an n-ring in one process, in the order the ring takes
    (the same merges and the same sums, so the same bits): qs, ks, vs are
    the n ranks' blocks. Returns (outs, lses) and, given the output
    cotangents gs, also (dqs, dks, dvs), each a list over the ranks."""
    n, T_local = len(qs), qs[0].shape[1]
    outs, lses = [], []
    for my in range(n):
        o_run, lse_run = _initial(qs[my])
        for i in range(n):
            src = (my - i) % n
            o_run, lse_run = ring_step_forward(qs[my], ks[src], vs[src], o_run, lse_run,
                                               (my - src) * T_local, causal, sm_scale)
        outs.append(o_run.to(qs[my].dtype))
        lses.append(lse_run)
    if gs is None:
        return outs, lses
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dvs = [torch.zeros_like(d) for d in dks]
    deltas = [ring_delta(o, g.contiguous()) for o, g in zip(outs, gs)]
    for i in range(n):              # step i: rank my holds block (my - i) % n
        for my in range(n):
            src = (my - i) % n
            dq_b, dk_b, dv_b = ring_step_backward(qs[my], ks[src], vs[src], outs[my], lses[my],
                                                  deltas[my], gs[my].contiguous(),
                                                  (my - src) * T_local, causal, sm_scale)
            dqs[my] += dq_b.float()
            dks[src] += dk_b.float()
            dvs[src] += dv_b.float()
    cast = lambda xs, like: [x.to(t.dtype) for x, t in zip(xs, like)]
    return outs, lses, cast(dqs, qs), cast(dks, ks), cast(dvs, vs)
