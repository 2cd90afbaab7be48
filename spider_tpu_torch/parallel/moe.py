"""Mixture-of-experts FFN (counterpart of spider_tpu/parallel/moe.py):
capacity-based top-1/top-2 gating in fp32 and one-hot dispatch and combine
einsums, the arithmetic of torchscale's xmoe (routing.py top1gating /
top2gating) as the JAX package writes it; on one device
(``moe_ffn_local``) or with the experts split over the ranks of an
``expert`` group (``moe_ffn_expert_parallel``: two all-to-alls, each the
other's backward).

A token past its expert's capacity gets a zero combine weight, so the FFN
gives it exactly zero. The expert FFN is ``gelu(x W1) W2`` with the tanh
form of GELU, which is what ``jax.nn.gelu`` computes by default.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from spider_tpu_torch.parallel.collectives import all_to_all, size_of, sum_to_all


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


def topk_gating(logits: torch.Tensor, capacity: int, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [T, E] fp32 -> (combine [T, E, capacity] fp32, dispatch bool
    [T, E, capacity], aux_loss fp32 scalar). Each of the top_k rounds picks
    every token's best remaining expert and queues it behind the tokens
    before it and the earlier rounds' occupancy; a token whose place is at
    or past `capacity` is dropped in that round. With top_k > 1 the kept
    gates of a token are normalised to sum to 1. aux_loss is the
    load-balancing term of the first round: E * sum(mean prob * mean share)."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    combine = torch.zeros((T, E, capacity), dtype=torch.float32, device=logits.device)
    masked = probs
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    gates_sum = torch.zeros((T,), dtype=torch.float32, device=logits.device)
    occupancy = torch.zeros((E,), dtype=torch.int64, device=logits.device)
    for k in range(top_k):
        idx = masked.argmax(dim=-1)                                     # [T]
        onehot = F.one_hot(idx, E)                                      # [T, E] int64
        if k == 0:
            aux = (probs.mean(dim=0) * onehot.float().mean(dim=0)).sum() * E
        pos_in_expert = torch.cumsum(onehot, dim=0) - onehot + occupancy[None, :]
        pos = (pos_in_expert * onehot).sum(dim=-1)                      # [T]
        keep = pos < capacity
        gate = probs.gather(1, idx[:, None])[:, 0]
        gate = torch.where(keep, gate, torch.zeros_like(gate))
        gates_sum = gates_sum + gate
        pos_oh = F.one_hot(torch.where(keep, pos, torch.full_like(pos, capacity)),
                           capacity + 1).float()[:, :capacity]
        combine = combine + gate[:, None, None] * onehot.float()[:, :, None] * pos_oh[:, None, :]
        occupancy = occupancy + (onehot * keep[:, None]).sum(dim=0)
        masked = masked.masked_fill(onehot.bool(), float("-inf"))
    if top_k > 1:
        combine = combine / gates_sum.clamp_min(1e-9)[:, None, None]
    return combine, combine > 0, aux


def moe_ffn_local(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig,
                  train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, M] -> (out [T, M] in x's dtype, aux_loss fp32 scalar). params:
    wg [M, E] fp32, w1 [E, M, F], w2 [E, F, M] in x's dtype. Capacity from
    the T tokens of this call and capacity_factor (eval_capacity_factor when
    not `train`)."""
    T, _ = x.shape
    cap = _capacity(T, cfg.num_experts,
                    cfg.capacity_factor if train else cfg.eval_capacity_factor, cfg.top_k)
    logits = x.float() @ params["wg"]
    combine, dispatch, aux = topk_gating(logits, cap, cfg.top_k)
    xe = torch.einsum("tec,tm->ecm", dispatch.to(x.dtype), x)
    h = F.gelu(torch.einsum("ecm,emf->ecf", xe, params["w1"]), approximate="tanh")
    ye = torch.einsum("ecf,efm->ecm", h, params["w2"])
    out = torch.einsum("tec,ecm->tm", combine.to(ye.dtype), ye)
    return out, aux


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
