"""Mixture-of-experts FFN (counterpart of spider_tpu/parallel/moe.py):
capacity-based top-1/top-2 gating in fp32 and one-hot dispatch and combine
einsums, the arithmetic of torchscale's xmoe (routing.py top1gating /
top2gating) as the JAX package writes it; on one device
(``moe_ffn_local``), with the experts split over the ranks of an
``expert`` group (``moe_ffn_expert_parallel``: two all-to-alls, each the
other's backward), or over a training mesh (``moe_ffn_sharded``, what the
MoE Llama runs under ``shard_model``).

One gating body, ``topk_gating``, serves all three: given where this
rank's tokens sit in the global batch (``TokenShards``), it gates them as
part of it. ``moe_ffn_sharded`` gives each token what ``moe_ffn_local``
gives it on the whole global batch, as the JAX package's ``LlamaMoEMLP``
computes it on the global array under jit: the capacity comes from the global token count,
and a token's place in its expert's queue counts every token before it in
the global [B*T] order (b outermost) and the earlier rounds' global
occupancy. The ranks of data x fsdp hold whole rows and those of context a
T-slice of every row, so one all-gather of per-(row, expert) counts a round
gives each rank the picks before each of its rows. The aux term takes both
means over the global tokens. Ranks that differ only in ``expert`` hold the
same tokens and gate alike; each runs its E/n experts on its own tokens'
slots and the experts' outputs are gathered over the group
(``split_replicated`` / ``gather_replicated``: every gradient outside the
experts comes out whole on each expert peer).

A token past its expert's capacity gets a zero combine weight, so the FFN
gives it exactly zero. The expert FFN is ``gelu(x W1) W2`` with the tanh
form of GELU, which is what ``jax.nn.gelu`` computes by default.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from spider_tpu_torch.common import dist
from spider_tpu_torch.parallel.collectives import (all_to_all, gather, gather_replicated,
                                                   group_of, size_of, split_replicated,
                                                   sum_to_all)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    d_model: int = 512
    d_ff: int = 2048
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 2.0
    top_k: int = 1                      # 1 or 2 (Top1Gate / Top2Gate)
    dtype: torch.dtype = torch.float32


def init_moe_params(cfg: MoEConfig, generator: torch.Generator, device=None
                    ) -> Dict[str, torch.Tensor]:
    """wg [M, E] fp32 ~ N(0, 1/M); w1 [E, M, F] ~ N(0, 1/M) and w2 [E, F, M]
    ~ N(0, 1/F) in cfg.dtype, drawn from `generator`."""
    def normal(shape, std, dtype):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    E, M, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {"wg": normal((M, E), 1.0 / math.sqrt(M), torch.float32),
            "w1": normal((E, M, Fd), 1.0 / math.sqrt(M), cfg.dtype),
            "w2": normal((E, Fd, M), 1.0 / math.sqrt(Fd), cfg.dtype)}


def _capacity(num_tokens: int, num_experts: int, factor: float, top_k: int) -> int:
    return max(4, int(math.ceil(num_tokens * top_k / num_experts * factor)))


@dataclasses.dataclass(frozen=True)
class TokenShards:
    """Where this rank's [B_local, T_local] tokens sit in the global [B, T]
    batch: data-parallel rank d holds rows d*B_local .., context rank c the
    columns c*T_local .. of each; ``group`` holds every rank with other
    tokens (data x fsdp x context), its rank d * cp_size + c."""
    group: object = None
    dp_rank: int = 0
    dp_size: int = 1
    cp_rank: int = 0
    cp_size: int = 1

    @staticmethod
    def of(mesh) -> "TokenShards":
        if mesh is None:
            return TokenShards()
        return TokenShards(group_of(mesh, (dist.AXIS_DATA, dist.AXIS_FSDP, dist.AXIS_CONTEXT)),
                           *dist.data_parallel_rank(mesh), *dist.context_rank(mesh))

    def picks_before(self, counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """counts [B_local, E] int64, this rank's picks of each expert in
        each of its rows -> (before [B_local, E]: the picks of every token
        before each row's first in global order; total [E]: all picks). One
        all-gather over the group."""
        B, E = counts.shape
        every = gather(counts[None], self.group, 0)             # [dp * cp, B, E]
        # global order: row (d, b) outermost, then the context slices c
        seg = every.reshape(self.dp_size, self.cp_size, B, E).transpose(1, 2).reshape(-1, E)
        before = seg.cumsum(0) - seg
        mine = ((self.dp_rank * B + torch.arange(B, device=counts.device)) * self.cp_size
                + self.cp_rank)
        return before[mine], seg.sum(0)


def topk_gating(logits: torch.Tensor, capacity: int, top_k: int,
                shards: TokenShards = TokenShards(), slots: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [T, E] fp32, or this rank's [B_local, T_local, E] of a global
    batch laid out as `shards` says -> (combine [N, E, slots] fp32, dispatch
    bool [N, E, slots], aux_loss fp32 scalar), N the tokens of `logits`,
    `slots` by default `capacity`. Each of the top_k rounds picks every
    token's best remaining expert and queues it behind the tokens before it
    in the global [B*T] order (b outermost) and the earlier rounds' global
    occupancy; a token whose place is at or past `capacity` is dropped in
    that round. A kept token's slot among this rank's `slots` of its expert
    is the count of this rank's tokens kept there before it (its place, when
    the rank holds the whole batch). With top_k > 1 the kept gates of a
    token are normalised to sum to 1. aux_loss is the load-balancing term of
    the first round, E * sum(mean prob * mean share) with both means over
    the global tokens, alike on every rank; its backward reaches this rank's
    tokens only (``sum_to_all``)."""
    E = logits.shape[-1]
    rows_shape = logits.shape[:-1] if logits.dim() == 3 else (1, logits.shape[0])
    N = logits.numel() // E
    share = 1 / (shards.dp_size * shards.cp_size)       # of the global tokens
    slots = capacity if slots is None else slots
    probs = torch.softmax(logits.reshape(N, E), dim=-1)
    dev = logits.device
    combine = torch.zeros((N, E, slots), dtype=torch.float32, device=dev)
    masked = probs
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    gates_sum = torch.zeros((N,), dtype=torch.float32, device=dev)
    occupancy = torch.zeros((E,), dtype=torch.int64, device=dev)    # global, kept so far
    used = torch.zeros((E,), dtype=torch.int64, device=dev)         # this rank's slots
    for k in range(top_k):
        idx = masked.argmax(dim=-1)                                     # [N]
        onehot = F.one_hot(idx, E)                                      # [N, E] int64
        rows = onehot.reshape(*rows_shape, E)
        before, total = shards.picks_before(rows.sum(1))
        if k == 0:
            means = sum_to_all(torch.stack([probs.mean(dim=0), onehot.float().mean(dim=0)])
                               * share, shards.group)
            aux = (means[0] * means[1]).sum() * E
        place = rows.cumsum(1) - rows + before[:, None] + occupancy
        pos = (place.reshape(N, E) * onehot).sum(-1)
        keep = pos < capacity
        kept_oh = onehot * keep[:, None]
        slot = ((kept_oh.cumsum(0) - kept_oh + used) * onehot).sum(-1)
        gate = probs.gather(1, idx[:, None])[:, 0]
        gate = torch.where(keep, gate, torch.zeros_like(gate))
        gates_sum = gates_sum + gate
        slot_oh = F.one_hot(torch.where(keep, slot, torch.full_like(slot, slots)),
                            slots + 1).float()[:, :slots]
        combine = combine + gate[:, None, None] * onehot.float()[:, :, None] * slot_oh[:, None, :]
        # the round's picks of an expert take the places after its occupancy
        occupancy = torch.clamp(occupancy + total, max=capacity)
        used = used + kept_oh.sum(0)
        masked = masked.masked_fill(onehot.bool(), float("-inf"))
    if top_k > 1:
        combine = combine / gates_sum.clamp_min(1e-9)[:, None, None]
    return combine, combine > 0, aux


def moe_ffn_local(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig,
                  train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, M] -> (out [T, M] in x's dtype, aux_loss fp32 scalar). params:
    wg [M, E] fp32, w1 [E, M, F], w2 [E, F, M] in x's dtype. Capacity from
    the T tokens of this call and capacity_factor (eval_capacity_factor when
    not `train`): ``moe_ffn_sharded`` with no mesh."""
    if not train:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.eval_capacity_factor)
    out, aux = moe_ffn_sharded(params, x[None], cfg, None)
    return out[0], aux


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (differentiable); a plain tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def moe_ffn_expert_parallel(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig,
                            group=None, train: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN with the experts split over the n ranks of `group`: this
    rank's tokens x [T_local, M] -> (out [T_local, M], aux_loss averaged
    over the group). params: wg [M, E] (replicated) and this rank's experts
    of w1 and w2, [E/n, M, F] and [E/n, F, M] (rank j holds experts
    j*E/n ..), either as local tensors or as the DTensors the partition
    rules ``mlp/w1`` and ``mlp/w2`` place (sharded on the expert dim).

    Gating and capacity are this rank's, over its T_local tokens, as under
    the JAX package's shard_map, so the result is ``moe_ffn_local`` on each
    rank's tokens. The dispatched [E, cap, M] slab goes out by one
    all-to-all (chunk j to the owner of experts j*E/n ..), the experts run
    on [E/n, n*cap, M], and a second all-to-all brings each token's outputs
    home; both are differentiable, each the other's backward."""
    n = size_of(group)
    E = cfg.num_experts
    if E % n:
        raise ValueError(f"{E} experts do not split over {n} ranks")
    e_local = E // n
    wg, w1, w2 = _local(params["wg"]), _local(params["w1"]), _local(params["w2"])
    if w1.shape[0] != e_local or w2.shape[0] != e_local:
        raise ValueError(f"expected {e_local} local experts, got w1 {tuple(w1.shape)} "
                         f"w2 {tuple(w2.shape)}")
    T_local, M = x.shape
    cap = _capacity(T_local, E, cfg.capacity_factor if train else cfg.eval_capacity_factor,
                    cfg.top_k)
    combine, dispatch, aux = topk_gating(x.float() @ wg, cap, cfg.top_k)
    xe = torch.einsum("tec,tm->ecm", dispatch.to(x.dtype), x)       # [E, cap, M]
    # chunk j (experts of rank j) goes to rank j; arrives as [n(src), e_local, cap, M]
    xe = all_to_all(xe.reshape(n, e_local, cap, M).contiguous(), group)
    xe = xe.transpose(0, 1).reshape(e_local, n * cap, M)
    h = F.gelu(torch.einsum("ecm,emf->ecf", xe, w1), approximate="tanh")
    ye = torch.einsum("ecf,efm->ecm", h, w2)                        # [e_local, n*cap, M]
    ye = ye.reshape(e_local, n, cap, M).transpose(0, 1).contiguous()
    ye = all_to_all(ye, group).reshape(E, cap, M)                  # [owner, e_local, ..]
    out = torch.einsum("tec,ecm->tm", combine.to(ye.dtype), ye)
    return out, sum_to_all(aux, group) / n


def moe_ffn_sharded(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN of this rank's tokens x [B_local, T_local, M] of a global
    batch laid over `mesh` (the five-axis training mesh; None: x is the whole
    batch, and the result ``moe_ffn_local``'s on it) -> (out [B_local,
    T_local, M], aux_loss fp32 scalar, the global batch's, alike on every
    rank): what ``moe_ffn_local`` gives these tokens on the whole batch (see
    the module docstring). params: wg [M, E] replicated; w1, w2 this expert
    rank's E/n experts (local tensors, or the DTensors
    ``partition.parallelize_experts`` places). Capacity from
    capacity_factor, as the MoE Llama always gates (train=True)."""
    shards = TokenShards.of(mesh)
    group = group_of(mesh, (dist.AXIS_EXPERT,))
    E = cfg.num_experts
    if E % size_of(group):
        raise ValueError(f"{E} experts do not split over {size_of(group)} ranks")
    e_local = E // size_of(group)
    w1, w2 = _local(params["w1"]), _local(params["w2"])
    if w1.shape[0] != e_local or w2.shape[0] != e_local:
        raise ValueError(f"expected {e_local} local experts, got w1 {tuple(w1.shape)} "
                         f"w2 {tuple(w2.shape)}")
    B, T, M = x.shape
    cap = _capacity(B * T * shards.dp_size * shards.cp_size, E, cfg.capacity_factor, cfg.top_k)
    logits = x.float() @ _local(params["wg"])
    # a rank keeps at most its own B*T tokens in an expert's slots
    split = shards.dp_size * shards.cp_size > 1
    combine, dispatch, aux = topk_gating(logits, cap, cfg.top_k, shards,
                                         slots=min(B * T, cap) if split else cap)
    x = x.reshape(B * T, M)
    xe = torch.einsum("tec,tm->ecm", dispatch.to(x.dtype), x)       # [E, S, M]
    xe = split_replicated(xe, group, 0)                             # this rank's experts
    h = F.gelu(torch.einsum("ecm,emf->ecf", xe, w1), approximate="tanh")
    ye = gather_replicated(torch.einsum("ecf,efm->ecm", h, w2), group, 0)
    out = torch.einsum("tec,ecm->tm", combine.to(ye.dtype), ye)
    return out.reshape(B, T, M), aux
