"""This rank's piece of a training batch, as the loss and the gradients see
it (``LossShards``), one form for one process and for a mesh.

Ranks of data x fsdp hold different sequences, ranks of context different
rows of them (rank r the rows r*T_local ..); model and expert ranks are
replicas. Targets are shifted on the whole sequence before the cut
(``cut(shift(labels))``), so each rank scores its own rows. Every term of
the loss is a SHARE: summed over the batch group (data, fsdp, context) it
is the whole batch's value, as the JAX step computes it on the global
array. The token loss divides this rank's sum by the global count of live
targets; a term computed alike on every rank from gathered tensors
(``full_sequence``, ``full_batch``, whose backward sums over the ranks) is
weighted by ``share`` = 1 / the batch group's size.

Over no mesh (``LOCAL``) every group is None: the cut keeps the whole
sequence, ``share`` is 1 and the collectives do nothing.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from spider_tpu_torch.common import dist
from spider_tpu_torch.parallel import collectives as C


class LossShards:
    def __init__(self, mesh=None):
        self.mesh = mesh
        self.batch_group = C.group_of(mesh, (dist.AXIS_DATA, dist.AXIS_FSDP,
                                             dist.AXIS_CONTEXT))
        self.dp_group = C.group_of(mesh, (dist.AXIS_DATA, dist.AXIS_FSDP))
        self.cp_group = C.group_of(mesh, (dist.AXIS_CONTEXT,))
        self.dp_rank, self.dp_size = dist.data_parallel_rank(mesh)
        self.cp_rank, self.cp_size = dist.context_rank(mesh)
        self.share = 1.0 / (self.dp_size * self.cp_size)

    def cut(self, a):
        """This context rank's columns of [B, T, ...] (T % size == 0)."""
        T = a.shape[1]
        if T % self.cp_size:
            raise ValueError(f"sequence length {T} does not split over {self.cp_size} "
                             "context ranks")
        n = T // self.cp_size
        return a[:, self.cp_rank * n:(self.cp_rank + 1) * n]

    @staticmethod
    def shift(labels, ignore_index: int = -100):
        """labels [B, T] (numpy or torch) -> targets [B, T] of the same
        kind: row t scores token t + 1; the last row scores nothing."""
        full = np.full_like if isinstance(labels, np.ndarray) else torch.full_like
        out = full(labels, ignore_index)
        out[:, :-1] = labels[:, 1:]
        return out

    def token_loss(self, logits: torch.Tensor, targets: torch.Tensor,
                   ignore_index: int = -100):
        """(loss share, accuracy share) of this rank's rows: logits [B, T, V]
        scored against already shifted targets, each sum divided by the
        batch's global count of live targets (at least 1). Log-softmax in
        fp32."""
        targets = targets.to(logits.device)
        mask = targets != ignore_index
        count = mask.sum().to(torch.float32)
        C.all_reduce_sum_([count], self.batch_group)
        denom = count.clamp_min(1)
        logits = logits.float()
        # F.cross_entropy fuses the fp32 log-softmax with the gather: at a
        # 128k vocabulary the log-probabilities are never a tensor of their own.
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                               ignore_index=ignore_index, reduction="sum") / denom
        acc = ((logits.argmax(-1) == targets) & mask).sum() / denom
        return loss, acc

    def full_sequence(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T_local, ...] -> [B, T, ...] over the context group."""
        return C.gather(x, self.cp_group, 1)

    def full_batch(self, x: torch.Tensor) -> torch.Tensor:
        """[B_local, ...] -> [B_global, ...] over data x fsdp."""
        return C.gather(x, self.dp_group, 0)

    def reduce_grads(self, params: Dict[str, torch.Tensor]) -> None:
        """Sum the gradients FSDP has not: a sharded (DTensor) gradient over
        the context group (FSDP summed it over data x fsdp), a replicated one
        over the whole batch group."""
        grads = [p.grad for p in params.values() if p.grad is not None]
        C.all_reduce_sum_([g._local_tensor for g in grads if hasattr(g, "_local_tensor")],
                          self.cp_group)
        C.all_reduce_sum_([g for g in grads if not hasattr(g, "_local_tensor")],
                          self.batch_group)

    def reduce_metrics(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each share summed over the batch group: the whole batch's values,
        alike on every rank."""
        names = list(out)
        vals = torch.stack([out[n].detach().float().reshape(()) for n in names])
        C.all_reduce_sum_([vals], self.batch_group)
        return dict(zip(names, vals))


LOCAL = LossShards(None)        # one process: the whole batch, no collectives
