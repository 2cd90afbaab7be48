"""The optimizer and the LM training step (counterpart of
spider_tpu/runners/train_step.py), on one device or sharded over a mesh.

``build_optimizer`` returns an ``Optimizer`` that does, in this order, what
the reference's optax chain does: accumulate (average) gradients over
``grad_accum_steps`` calls; clip the average by its global norm; AdamW (b1
0.9, b2 0.999, eps 1e-8 outside the root, bias-corrected, weight decay added
to the Adam direction before the learning rate); zero the update of the first
``num_frozen_embed_rows`` vocabulary rows of ``embed_tokens`` and
``lm_head``, so those rows see neither the step nor the decay; apply. The
learning rate is the schedule at the number of updates applied so far.

Parameters whose name matches none of ``trainable_patterns`` are left out of
the optimizer: they get no update at all and count in no norm. (The
reference wraps its chain in ``optax.masked``, which hands the raw gradient of
a masked-out leaf through as its update; that is not carried over.)

Sharded (``shard_model`` over a ``DeviceMesh``, the counterpart of
``init_sharded_state`` and ``make_jitted_train_step``): tensor parallelism
over ``model`` (``partition.parallelize_llama``), then FSDP2 ``fully_shard``
of each block and embedding over (data, fsdp), which is HSDP: parameters
and optimizer state sharded over fsdp, replicated over data. Each rank of
data x fsdp draws its own batch and each rank of ``context`` holds T / n of
its sequences. One step serves one process and a mesh alike: the model's
``shards`` (``parallel/loss_shards.py``; over no mesh, the whole batch)
cut the batch, weight the loss by tokens across ranks (each rank's sum over
its live targets divided by the GLOBAL count, so the sum over the ranks is
the loss of the whole batch, as the JAX step computes it on the global
array) and sum the gradients over data, fsdp and context (FSDP's reduction
with its divide factor 1, then the context group; a parameter FSDP does not
hold is summed over all three). The optimizer works on each rank's local
shards (AdamW is elementwise); where the parameters are DTensors the
clipping norm is reduced over every rank, each shard counted once, and
frozen vocabulary rows are masked by their global index.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from spider_tpu_torch.common import dist
from spider_tpu_torch.models.llama import LlamaForCausalLM, LlamaMoEMLP
from spider_tpu_torch.parallel import partition
from spider_tpu_torch.parallel.loss_shards import LOCAL, LossShards

B1, B2, EPS = 0.9, 0.999, 1e-8


def _path(name: str) -> str:
    """'llm.model.layers.0.q_proj.lora_a' -> 'llm/model/layers/0/q_proj/lora_a',
    the form the reference's patterns are written against."""
    return name.replace(".", "/")


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its storage: in-place writes reach the
    DTensor); a plain tensor as it is."""
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _shard_count(t: torch.Tensor) -> int:
    """Into how many distinct shards a DTensor is cut (1 for a plain tensor)."""
    if not hasattr(t, "placements"):
        return 1
    n = 1
    for i, p in enumerate(t.placements):
        if getattr(p, "dim", None) is not None:     # Shard, and FSDP's _StridedShard over TP
            n *= t.device_mesh.size(i)
    return n


def _world(tensors: Sequence[torch.Tensor]) -> int:
    """The world the tensors are pieces of: all ranks where any is a
    DTensor (a sharded model's), else this rank alone."""
    return dist.get_world_size() if any(hasattr(t, "device_mesh") for t in tensors) else 1


def _norm(local: Sequence[torch.Tensor], shard_counts: Sequence[int],
          world: int) -> torch.Tensor:
    """The L2 norm over `world` ranks of tensors given as this rank's
    pieces: piece i is one of shard_counts[i] distinct shards, each held
    alike by world / shard_counts[i] ranks, so its square is weighted by the
    inverse."""
    if world == 1:
        if not local:
            return torch.zeros(())
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(local))))
    total = torch.zeros((), dtype=torch.float64, device=local[0].device)
    for t, n in zip(local, shard_counts):
        total += t.float().pow(2).sum().double() * (n / world)
    torch.distributed.all_reduce(total)
    return total.sqrt().float()


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all the tensors together. Where they are DTensors it
    is the world's, each shard counted once and a plain tensor taken as
    held alike by every rank."""
    return _norm([_local(t) for t in tensors], [_shard_count(t) for t in tensors],
                 _world(tensors))


class Optimizer:
    """AdamW with clipping, frozen vocabulary rows, a trainable-name filter
    and gradient accumulation over ``params``, a {name: parameter} dict.
    A DTensor parameter is updated through its local shard, and its state
    (mu, nu, the accumulator) is that shard's; the clipping norm is then
    the world's."""

    def __init__(self, params: Dict[str, nn.Parameter],
                 learning_rate: Union[float, Callable[[int], float]], *,
                 weight_decay: float = 0.0, max_grad_norm: float = 1.0,
                 grad_accum_steps: int = 1, num_frozen_embed_rows: int = 0,
                 trainable_patterns: Optional[Sequence[str]] = None):
        if trainable_patterns is not None:
            params = {n: p for n, p in params.items()
                      if any(re.search(pat, _path(n)) for pat in trainable_patterns)}
        self.params = dict(params)
        self.schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.grad_accum_steps = max(int(grad_accum_steps), 1)
        self.world = _world(list(self.params.values()))
        # the frozen rows by global index: (count, global row of local row 0)
        self.frozen_rows = {n: (num_frozen_embed_rows, partition.global_row_offset(self.params[n]))
                            for n in partition.frozen_row_names(list(self.params),
                                                                num_frozen_embed_rows)}
        self.shard_counts = [_shard_count(p) for p in self.params.values()]
        self.count = 0          # updates applied
        self.mini_step = 0      # calls since the last update
        local = {n: _local(p) for n, p in self.params.items()}
        self.mu = {n: torch.zeros_like(p) for n, p in local.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in local.items()}
        self.acc: Dict[str, torch.Tensor] = {}
        if self.grad_accum_steps > 1:
            self.acc = {n: torch.zeros_like(p) for n, p in local.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One call of the chain on the gradients {name: tensor} (a missing
        or None entry counts as zero). Every ``grad_accum_steps``-th call
        applies an update."""
        names = list(self.params)
        zero = lambda n: torch.zeros_like(_local(self.params[n]))
        g = [_local(grads[n]) if grads.get(n) is not None else zero(n) for n in names]
        if self.grad_accum_steps > 1:
            acc = [self.acc[n] for n in names]
            # running mean over the calls so far: acc += (g - acc) / (i + 1)
            torch._foreach_sub_(g, acc)
            torch._foreach_add_(acc, g, alpha=1.0 / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.grad_accum_steps:
                return
            g = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
            self.mini_step = 0
        else:
            g = [x.to(self.params[n].dtype) for n, x in zip(names, g)]
        if self.max_grad_norm:
            norm = _norm(g, self.shard_counts, self.world)
            torch._foreach_mul_(g, self.max_grad_norm / torch.clamp(norm, min=self.max_grad_norm))
        p = [_local(self.params[n]) for n in names]
        mu = [self.mu[n] for n in names]
        nu = [self.nu[n] for n in names]
        lr = float(self.schedule(self.count))
        t = self.count + 1
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, g, alpha=1 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, g, g, value=1 - B2)
        denom = torch._foreach_sqrt(nu)
        torch._foreach_div_(denom, (1 - B2 ** t) ** 0.5)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(mu, denom)
        torch._foreach_div_(upd, 1 - B1 ** t)
        if self.weight_decay:
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
        for n, u in zip(names, upd):
            if n in self.frozen_rows:
                partition.freeze_embedding_rows(u, *self.frozen_rows[n])
        torch._foreach_add_(p, upd, alpha=-lr)
        self.count = t

    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which `local` is parameter `name`'s shard
        (collective for a DTensor parameter)."""
        p = self.params[name]
        if not hasattr(p, "device_mesh"):
            return local
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, p.device_mesh, p.placements, shape=p.shape,
                                  stride=p.stride(), run_check=False).full_tensor()

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor laid out as parameter `name`."""
        p = self.params[name]
        if not hasattr(p, "device_mesh"):
            return full
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(full.to(_local(p).device), p.device_mesh,
                                 p.placements).to_local()

    def state_dict(self) -> Dict:
        """Whole tensors on every rank (sharded state is gathered)."""
        whole = lambda d: {n: self.full(n, t) for n, t in d.items()}
        return dict(count=self.count, mini_step=self.mini_step, mu=whole(self.mu),
                    nu=whole(self.nu), acc=whole(self.acc))

    def load_state_dict(self, state: Dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"]),
                             (self.acc, state["acc"])):
            if set(mine) != set(theirs):
                raise KeyError("optimizer state does not match the trainable parameters")
            for n, t in theirs.items():
                mine[n].copy_(self.shard(n, t))


def build_optimizer(learning_rate, *, params: Dict[str, nn.Parameter],
                    weight_decay: float = 0.0, max_grad_norm: float = 1.0,
                    grad_accum_steps: int = 1, num_frozen_embed_rows: int = 0,
                    trainable_patterns: Optional[Sequence[str]] = None) -> Optimizer:
    """AdamW + clipping (+ frozen-row masking, trainable patterns,
    accumulation) over ``params`` ({name: parameter})."""
    return Optimizer(params, learning_rate, weight_decay=weight_decay,
                     max_grad_norm=max_grad_norm, grad_accum_steps=grad_accum_steps,
                     num_frozen_embed_rows=num_frozen_embed_rows,
                     trainable_patterns=trainable_patterns)


def backward_and_step(loss: torch.Tensor, optimizer: Optimizer,
                      shards: LossShards = LOCAL) -> torch.Tensor:
    """Backpropagate `loss` (this rank's share) into the optimizer's
    parameters, sum the gradients over the ranks (``shards.reduce_grads``),
    hand them to ``optimizer.step`` and clear them; returns their global
    norm (before clipping)."""
    for p in optimizer.params.values():
        p.grad = None
    loss.backward()
    shards.reduce_grads(optimizer.params)
    grads = {n: p.grad for n, p in optimizer.params.items()}
    norm = global_norm([g for g in grads.values() if g is not None])
    optimizer.step(grads)
    for p in optimizer.params.values():
        p.grad = None
    return norm


def make_lm_train_step(model: LlamaForCausalLM, optimizer: Optimizer):
    """Returns step(batch) -> metrics of the whole batch (loss, gen_acc,
    grad_norm as tensors; with experts also moe_aux, the mean of the
    layers' load-balancing terms). batch: input_ids, labels [B, T] (labels
    -100 outside answer spans); under a mesh (``shard_model``) this
    data-parallel rank's whole sequences, of which the step keeps this
    context rank's rows. With experts the loss is cross entropy +
    moe_aux_weight * moe_aux, as the JAX step adds it. Under a mesh each MoE
    layer gates over the global batch (capacity, queue places and the aux
    term: ``parallel.moe.moe_ffn_sharded``), so moe_aux is the whole batch's
    value, alike on every rank; its backward reaches each rank's own tokens
    only, so every rank adds it whole to the loss it backpropagates and the
    sum of the ranks' gradients counts it once. The metrics are shares summed
    over the batch group: moe_aux enters them times ``shards.share``."""

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        shards = model.shards
        ids = shards.cut(torch.as_tensor(batch["input_ids"])).to(model.device)
        targets = shards.cut(shards.shift(torch.as_tensor(batch["labels"])))
        logits, _, _ = model(input_ids=ids)
        loss, acc = shards.token_loss(logits, targets)
        out = dict(loss=loss, gen_acc=acc)
        aux = model.moe_aux_losses()
        if aux is not None:
            weight = model.config.moe_aux_weight
            aux = aux.mean()
            out["moe_aux"] = aux * shards.share
            out["loss"] = loss + weight * out["moe_aux"]
            loss = loss + weight * aux
        grad_norm = backward_and_step(loss, optimizer, shards)
        metrics = shards.reduce_metrics(out)
        metrics["grad_norm"] = grad_norm
        return metrics

    return step


# ---------------------------------------------------------------------------
# Sharded training over a DeviceMesh
# ---------------------------------------------------------------------------

def _fsdp_units(model: nn.Module) -> List[nn.Module]:
    """The modules FSDP2 wraps, each one whose forward the training step
    calls: every decoder block, the embedding, lm_head, the decoder (its
    final norm), and a Spider's input projection and aligners. Whatever
    else trains (a Spider's logit_scale, SAM's mask decoder) stays
    replicated, its gradient summed by ``LossShards.reduce_grads``."""
    llm = model if isinstance(model, LlamaForCausalLM) else model.llm
    units = list(llm.model.layers) + [llm.embed_tokens]
    if not llm.config.tie_word_embeddings:
        units.append(llm.lm_head)
    units.append(llm.model)
    if llm is model:
        units.append(llm)
    else:
        for name in ("llama_proj", "moe_aligner"):
            if getattr(model, name, None) is not None:
                units.append(getattr(model, name))
        units.extend(model.aligners.values())
    return units


def shard_model(model: nn.Module, mesh, rules=None) -> nn.Module:
    """Shard a LlamaForCausalLM or a Spider (its LLM) over `mesh`, in place:
    tensor parallelism over ``model`` (``partition.parallelize_llama``,
    read from the rules), the experts of a MoE Llama over ``expert``
    (``partition.parallelize_experts``), ring attention over ``context``
    when it is > 1, the mesh on every MoE layer (gating over the global
    batch), then FSDP2 over (data, fsdp), HSDP, with gradient
    sums (divide factor 1); ``model.shards`` becomes this rank's
    ``LossShards``. Parameters that must not train are to be frozen before:
    FSDP2 needs one dtype among a unit's trainable parameters."""
    from torch.distributed.fsdp import fully_shard

    llm = model if isinstance(model, LlamaForCausalLM) else model.llm
    if dist.axis_size(mesh, dist.AXIS_MODEL) > 1:
        partition.parallelize_llama(llm, mesh[dist.AXIS_MODEL],
                                    rules or partition.LLAMA_RULES)
    if dist.axis_size(mesh, dist.AXIS_EXPERT) > 1:
        partition.parallelize_experts(llm, mesh[dist.AXIS_EXPERT], rules or partition.LLAMA_RULES)
    if dist.axis_size(mesh, dist.AXIS_CONTEXT) > 1:
        llm.replace_config(llm.config.with_context_parallel(mesh, dist.AXIS_CONTEXT))
    for mod in llm.modules():
        if isinstance(mod, LlamaMoEMLP):
            mod.mesh = mesh
    dp_mesh = mesh[(dist.AXIS_DATA, dist.AXIS_FSDP)]
    for unit in _fsdp_units(model):
        fully_shard(unit, mesh=dp_mesh)
        unit.set_gradient_divide_factor(1.0)
        # plain SUM reductions: gloo has no pre-multiplied sum
        unit.set_force_sum_reduction_for_comms(True)
    model.shards = LossShards(mesh)
    return model
