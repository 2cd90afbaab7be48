"""The optimizer and the LM training step on one device (counterpart of
spider_tpu/runners/train_step.py without its mesh and sharding parts, which
wait for the multi-card slice).

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
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Sequence, Union

import torch
from torch import nn

from spider_tpu_torch.models.llama import LlamaForCausalLM, cross_entropy_loss

B1, B2, EPS = 0.9, 0.999, 1e-8
# Parameters whose leading axis is the vocabulary (the port keeps lm_head as
# [vocab, hidden], where flax has [hidden, vocab]).
ROW_PARAM_PATTERNS = (r"embed_tokens/weight$", r"lm_head/weight$")


def _path(name: str) -> str:
    """'llm.model.layers.0.q_proj.lora_a' -> 'llm/model/layers/0/q_proj/lora_a',
    the form the reference's patterns are written against."""
    return name.replace(".", "/")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class Optimizer:
    """AdamW with clipping, frozen vocabulary rows, a trainable-name filter
    and gradient accumulation over ``params``, a {name: parameter} dict."""

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
        self.frozen_rows = {n: num_frozen_embed_rows for n in self.params
                            if num_frozen_embed_rows
                            and any(re.search(pat, _path(n)) for pat in ROW_PARAM_PATTERNS)}
        self.count = 0          # updates applied
        self.mini_step = 0      # calls since the last update
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.acc: Dict[str, torch.Tensor] = {}
        if self.grad_accum_steps > 1:
            self.acc = {n: torch.zeros_like(p) for n, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One call of the chain on the gradients {name: tensor} (a missing
        or None entry counts as zero). Every ``grad_accum_steps``-th call
        applies an update."""
        names = list(self.params)
        zero = lambda n: torch.zeros_like(self.params[n])
        g = [grads[n] if grads.get(n) is not None else zero(n) for n in names]
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
            norm = global_norm(g)
            torch._foreach_mul_(g, self.max_grad_norm / torch.clamp(norm, min=self.max_grad_norm))
        p = [self.params[n] for n in names]
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
            rows = self.frozen_rows.get(n)
            if rows:
                u[:rows] = 0
        torch._foreach_add_(p, upd, alpha=-lr)
        self.count = t

    def state_dict(self) -> Dict:
        return dict(count=self.count, mini_step=self.mini_step, mu=self.mu, nu=self.nu,
                    acc=self.acc)

    def load_state_dict(self, state: Dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"]),
                             (self.acc, state["acc"])):
            if set(mine) != set(theirs):
                raise KeyError("optimizer state does not match the trainable parameters")
            for n, t in theirs.items():
                mine[n].copy_(t)


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


def backward_and_step(loss: torch.Tensor, optimizer: Optimizer) -> torch.Tensor:
    """Backpropagate `loss` into the optimizer's parameters, hand the
    gradients to ``optimizer.step`` and clear them; returns their global
    norm (before clipping)."""
    for p in optimizer.params.values():
        p.grad = None
    loss.backward()
    grads = {n: p.grad for n, p in optimizer.params.items()}
    norm = global_norm([g for g in grads.values() if g is not None])
    optimizer.step(grads)
    for p in optimizer.params.values():
        p.grad = None
    return norm


def make_lm_train_step(model: LlamaForCausalLM, optimizer: Optimizer):
    """Returns step(batch) -> metrics (loss, gen_acc, grad_norm as tensors;
    with experts also moe_aux, the mean of the layers' load-balancing
    terms). batch: input_ids, labels [B, T] (labels -100 outside answer
    spans). With experts the loss is cross entropy + moe_aux_weight *
    moe_aux, as the JAX step adds it."""

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        ids = torch.as_tensor(batch["input_ids"]).to(model.device)
        logits, _, _ = model(input_ids=ids)
        loss, acc = cross_entropy_loss(logits, torch.as_tensor(batch["labels"]))
        aux = model.moe_aux_losses()
        if aux is not None:
            aux = aux.mean()
            loss = loss + model.config.moe_aux_weight * aux
        grad_norm = backward_and_step(loss, optimizer)
        out = dict(loss=loss.detach(), gen_acc=acc, grad_norm=grad_norm)
        if aux is not None:
            out["moe_aux"] = aux.detach()
        return out

    return step
