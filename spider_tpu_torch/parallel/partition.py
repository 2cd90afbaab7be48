"""Parameter sharding rules over the (data, fsdp, model, expert, context)
mesh (counterpart of spider_tpu/parallel/partition.py).

The rule tables are the JAX package's, in its order, first match wins. A
rule's path is the port's parameter name in '/' form
(``runners.train_step._path``: 'llm.model.layers.0.self_attn.q_proj.weight'
-> 'llm/model/layers/0/self_attn/q_proj/weight') with its last part named
as the JAX tree names that leaf (``convert._unleaf``: a dense or conv
``weight`` is ``kernel``, an embedding's ``embedding``, a norm's ``scale``),
so 'llm/model/layers/0/self_attn/q_proj/kernel'.

A rule's spec is written for the JAX layout, and is carried onto the port's
tensor through the converter's layout rules (the ones
``convert.load_jax_params`` applies): a leaf under k ``nn.ModuleList``s
has k leading layer axes in the JAX tree (``nn.scan`` stacks them), which
the port does not hold, and a dense kernel [in, out] is the port's weight
[out, in]. So q_proj's P(None, 'fsdp', 'model') over [L, in, out] is
('model', 'fsdp') over the port's [out, in]. ``_validate_spec`` then drops
an axis from a dim it does not divide, as the JAX package does.

Placements: a spec becomes one DTensor placement per mesh dim (``Shard(d)``
where the spec names that axis on tensor dim d, else ``Replicate()``);
``shard_params`` puts a module's parameters and buffers on the mesh with
them. The tensor-parallel plan of the Llama is read from the same table
(``tensor_parallel_plan``): a projection whose spec puts ``model`` on its
output dim is column-wise, on its input dim row-wise, and the embedding,
sharded on its vocabulary, is vocabulary-parallel; ``parallelize_llama``
applies it with ``parallelize_module``. An int4 projection is sharded by hand
(``_shard_int4``), since the int4 kernel takes local tensors: each rank keeps
plain local shards, a column-wise one its output channels, a row-wise one
its contiguous input columns, repacked (a packed byte holds input columns
i and i + in/2, so a contiguous split of the packed axis would not give a
rank the contiguous columns its activations hold).

``freeze_embedding_rows`` zeroes the update of the first rows of the
vocabulary matrices by their GLOBAL row index, so a shard holding rows
r0 .. of the vocabulary masks only the frozen rows among its own.
``trainable_mask`` keeps the port's meaning (C4): a parameter outside the
patterns is not in the optimizer at all.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from spider_tpu_torch.common.dist import AXIS_EXPERT, AXIS_MODEL
from spider_tpu_torch.models import convert

Spec = Tuple                  # entries: None, an axis name, or a tuple of names

# (path regex, spec in the JAX layout): the JAX package's LLAMA_RULES.
LLAMA_RULES: List[Tuple[str, Spec]] = [
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)/kernel(_q)?$", (None, "fsdp", "model")),
    (r"(o_proj|down_proj)/kernel(_q)?$", (None, "model", "fsdp")),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)/kernel_scale$", (None, "model")),
    (r"(o_proj|down_proj)/kernel_scale$", (None, "fsdp")),
    (r"lora_a$", (None, "fsdp", None)),
    (r"lora_b$", (None, None, "model")),
    (r"mlp/w1$", (None, "expert", "fsdp", "model")),
    (r"mlp/w2$", (None, "expert", "model", "fsdp")),
    (r"mlp/wg$", (None, "fsdp", None)),
    (r"embed_tokens/embedding$", (("fsdp", "model"), None)),
    (r"lm_head/kernel(_q)?$", ("fsdp", "model")),
    (r"lm_head/kernel_scale$", ("model",)),
    (r".*", ()),
]

# The whole trainable Spider: the LLM's rules, aligners replicated, the
# projection's and SAM's kernels sharded on their last JAX dim over fsdp.
SPIDER_RULES: List[Tuple[str, Spec]] = LLAMA_RULES[:-1] + [
    (r"(aligners|moe_aligner)/", ()),
    (r"(llama_proj|sam)/.*(kernel|embedding)$", (None, "fsdp")),
    (r".*", ()),
]


def _path(name: str) -> str:
    return name.replace(".", "/")


def _names(entry, axis: str) -> bool:
    """Whether a spec entry (None, an axis, a tuple of axes) names `axis`."""
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def _owner(root: nn.Module, name: str) -> Tuple[nn.Module, str, int]:
    """(the module holding tensor `name`, its leaf name, the number of
    ``nn.ModuleList`` levels above it)."""
    mod, stacked = root, 0
    parts = name.split(".")
    for part in parts[:-1]:
        if isinstance(mod, nn.ModuleList):
            stacked += 1
        mod = getattr(mod, part) if not part.isdigit() else mod[int(part)]
    return mod, parts[-1], stacked


def _layout(mod: nn.Module, leaf: str, ndim: int) -> Tuple[str, Tuple[int, ...]]:
    """(the JAX leaf name, perm): port dim i holds the JAX leaf's dim
    perm[i] (layer axes not counted), read off ``convert._unleaf``."""
    sizes = tuple(range(2, 2 + ndim))             # distinct sizes, one per dim
    key, arr = convert._unleaf(mod, leaf, np.empty(sizes, np.float32))
    return key, tuple(arr.shape.index(s) for s in sizes)


def rule_path(root: nn.Module, name: str) -> str:
    """The path the rules match for tensor `name` of `root`."""
    mod, leaf, _ = _owner(root, name)
    key, _ = _layout(mod, leaf, getattr(mod, leaf).dim())
    return _rule_path(name, key)


def _rule_path(name: str, key: str) -> str:
    return "/".join(_path(name).split("/")[:-1] + [key])


def spec_for(path: str, rules: List[Tuple[str, Spec]], ndim: int) -> Spec:
    """The first matching rule's spec trimmed or padded to `ndim` entries
    (the JAX package's rule)."""
    for pattern, spec in rules:
        if re.search(pattern, path):
            entries = tuple(spec)
            if len(entries) > ndim:
                entries = entries[-ndim:] if ndim > 0 else ()
            elif len(entries) < ndim:
                entries = (None,) * (ndim - len(entries)) + entries
            return entries
    return (None,) * ndim


def param_spec(root: nn.Module, name: str, rules: List[Tuple[str, Spec]]) -> Spec:
    """Tensor `name`'s spec in the port's layout: the JAX-layout spec of its
    rule with the layer axes dropped and the dims carried over."""
    mod, leaf, stacked = _owner(root, name)
    ndim = getattr(mod, leaf).dim()
    key, perm = _layout(mod, leaf, ndim)
    jax_spec = spec_for(_rule_path(name, key), rules, ndim + stacked)[stacked:]
    return tuple(jax_spec[perm[i]] for i in range(ndim))


def tensor_names(root: nn.Module) -> List[str]:
    """Every parameter and persistent buffer (the state dict's names)."""
    return list(root.state_dict().keys())


def tree_partition_specs(root: nn.Module, rules: Optional[List[Tuple[str, Spec]]] = None
                         ) -> Dict[str, Spec]:
    """{name: spec in the port's layout} for every parameter and persistent
    buffer of `root` (int8 kernels and their scales included)."""
    rules = rules or LLAMA_RULES
    return {n: param_spec(root, n, rules) for n in tensor_names(root)}


def mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _validate_spec(spec: Spec, shape, mesh) -> Spec:
    """Replace axis entries that do not divide their dim with None."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = int(np.prod([sizes[a] for a in axes]))
        out.append(entry if dim % size == 0 else None)
    return tuple(out)


def placements(spec: Spec, mesh) -> List:
    """One DTensor placement per mesh dim: Shard(d) where the spec names
    that axis on tensor dim d (an entry of several axes shards the dim over
    each, in mesh order), else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec) if _names(e, axis)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def tree_placements(root: nn.Module, mesh, rules: Optional[List[Tuple[str, Spec]]] = None
                    ) -> Dict[str, List]:
    """{name: placements on `mesh`} for every tensor of `root`, from its
    spec validated against the mesh and the tensor's shape."""
    specs = tree_partition_specs(root, rules)
    state = root.state_dict()
    return {n: placements(_validate_spec(s, state[n].shape, mesh), mesh)
            for n, s in specs.items()}


def shard_params(root: nn.Module, mesh, rules: Optional[List[Tuple[str, Spec]]] = None
                 ) -> nn.Module:
    """Put every parameter and persistent buffer of `root` on the mesh as a
    DTensor with its rule's placements (in place; returns `root`)."""
    from torch.distributed.tensor import distribute_tensor

    for name, place in tree_placements(root, mesh, rules).items():
        mod, leaf, _ = _owner(root, name)
        t = getattr(mod, leaf)
        d = distribute_tensor(t.detach(), mesh, place)
        if isinstance(t, nn.Parameter):
            setattr(mod, leaf, nn.Parameter(d, requires_grad=t.requires_grad))
        else:
            mod.register_buffer(leaf, d)
    return root


# ---------------------------------------------------------------------------
# Frozen vocabulary rows and the trainable mask
# ---------------------------------------------------------------------------

# Parameters whose leading axis is the vocabulary (the port keeps lm_head as
# [vocab, hidden], where flax has [hidden, vocab]).
ROW_PARAM_PATTERNS = (r"embed_tokens/weight$", r"lm_head/weight$")


def global_row_offset(t: torch.Tensor) -> int:
    """The global index of a tensor's local row 0 (0 for a plain tensor)."""
    if not hasattr(t, "to_local"):
        return 0
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    _, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return int(offset[0])


def freeze_embedding_rows(update: torch.Tensor, num_frozen_rows: int, row0: int = 0) -> None:
    """Zero (in place) the rows of `update` whose GLOBAL vocabulary index,
    row0 + local index, is below num_frozen_rows. The port holds both
    vocabulary matrices with the vocabulary first ([V, H]), where flax holds
    lm_head as [H, V]."""
    stop = min(max(num_frozen_rows - row0, 0), update.shape[0])
    if stop:
        update[:stop] = 0


def frozen_row_names(names: Sequence[str], num_frozen_rows: int) -> List[str]:
    """The names whose rows ``freeze_embedding_rows`` masks."""
    if not num_frozen_rows:
        return []
    return [n for n in names if any(re.search(p, _path(n)) for p in ROW_PARAM_PATTERNS)]


def trainable_mask(root: nn.Module, trainable_patterns: Sequence[str]) -> Dict[str, bool]:
    """{parameter name: True where its '/' path matches a pattern}; the
    optimizer holds exactly the True ones (C4)."""
    return {n: any(re.search(p, _path(n)) for p in trainable_patterns)
            for n, _ in root.named_parameters()}


# ---------------------------------------------------------------------------
# Tensor parallelism of the Llama, read from the rules
# ---------------------------------------------------------------------------

def tensor_parallel_plan(model: nn.Module, rules: Optional[List[Tuple[str, Spec]]] = None,
                         prefix: str = "") -> Dict[str, str]:
    """{module name: 'colwise' | 'rowwise' | 'vocab'} for every projection
    and embedding of `model` whose weight's spec names the ``model`` axis:
    on its output dim (0 of [out, in]) column-wise, on its input dim
    row-wise; an embedding so sharded is vocabulary-parallel."""
    from spider_tpu_torch.models.llama import LoraDense

    rules = rules or LLAMA_RULES
    plan = {}
    for mname, mod in model.named_modules(prefix=prefix.rstrip(".")):
        if isinstance(mod, nn.Embedding):
            leaf = "weight"
        elif isinstance(mod, LoraDense):
            leaf = "weight" if mod.quantization is None else "kernel_q"
        else:
            continue
        name = f"{mname}.{leaf}" if mname else leaf
        rel = name[len(prefix):] if prefix and name.startswith(prefix) else name
        spec = param_spec(model, rel, rules)
        dims = [d for d, e in enumerate(spec) if _names(e, AXIS_MODEL)]
        if not dims:
            continue
        if isinstance(mod, nn.Embedding):
            plan[mname] = "vocab"
        else:
            plan[mname] = "colwise" if dims[0] == 0 else "rowwise"
    return plan


def _lora_style(kind: str, rules, root, prefix: str, gather_output: bool):
    """A ParallelStyle for a LoraDense: its tensors distributed over the 1-D
    model mesh by their rule placements; the input made a DTensor
    (replicated for column-wise, sharded on its last dim for row-wise), the
    forward run in DTensor arithmetic, the output handed back local: the
    column shard (or, for gather_output, the whole row), or for row-wise the
    sum over the ranks."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard, distribute_module,
                                          distribute_tensor)
    from torch.distributed.tensor.parallel import ParallelStyle

    class LoraParallel(ParallelStyle):
        def _apply(self, module, device_mesh):
            def partition(name, mod, mesh):
                for leaf, t in list(mod._parameters.items()) + list(mod._buffers.items()):
                    if t is None or leaf not in mod.state_dict():
                        continue
                    spec = tuple(AXIS_MODEL if _names(e, AXIS_MODEL) else None
                                 for e in param_spec(root, prefix + leaf, rules))
                    place = placements(_validate_spec(spec, t.shape, mesh), mesh)
                    d = distribute_tensor(t.detach(), mesh, place)
                    if leaf in mod._parameters:
                        mod._parameters[leaf] = nn.Parameter(d, requires_grad=t.requires_grad)
                    else:
                        mod._buffers[leaf] = d

            def prepare_input(mod, inputs, mesh):
                x = inputs[0]
                layout = Replicate() if kind == "colwise" else Shard(-1)
                return (DTensor.from_local(x, mesh, [layout], run_check=False),)

            def prepare_output(mod, out, mesh):
                want = Replicate() if (kind == "rowwise" or gather_output) else Shard(-1)
                return out.redistribute(mesh, [want]).to_local()

            return distribute_module(module, device_mesh, partition, prepare_input,
                                     prepare_output)

    return LoraParallel()


def _shard_int4(mod: nn.Module, kind: str, group, gather_output: bool) -> None:
    """An int4 LoraDense made tensor-parallel over `group` in place, with
    plain local tensors (the int4 kernel takes no DTensor). Column-wise:
    rank r keeps output channels r*out/n .. of kernel_q, kernel_scale, the
    bias and lora_b, and its output is that slice of the features (all of
    them gathered, for gather_output). Row-wise: rank r keeps the input
    columns r*in/n .. that its activations hold, kernel_q unpacked, sliced
    and packed again (split-half over the local columns) and lora_a's rows;
    its output, a partial sum, is summed over the group. For serving: the
    shards are not DTensors, so an optimizer would not see them as shards."""
    from spider_tpu_torch.ops.quant import pack_int4, unpack_int4
    from spider_tpu_torch.parallel.collectives import (gather_replicated, rank_in, size_of,
                                                       sum_to_all)

    n, r = size_of(group), rank_in(group)
    out_f, packed = mod.kernel_q.shape
    take = lambda t, dim, size: t.narrow(dim, r * size, size).clone()
    if kind == "colwise":
        if out_f % n:
            raise ValueError(f"{out_f} output channels do not split over {n} model ranks")
        m = out_f // n
        mod.kernel_q = take(mod.kernel_q, 0, m)
        mod.kernel_scale = take(mod.kernel_scale, 0, m)
        if mod.bias is not None:
            mod.bias = nn.Parameter(take(mod.bias.detach(), 0, m),
                                    requires_grad=mod.bias.requires_grad)
        if mod.lora_scale:
            mod.lora_b = nn.Parameter(take(mod.lora_b.detach(), 1, m),
                                      requires_grad=mod.lora_b.requires_grad)
        if gather_output:
            mod.register_forward_hook(lambda _m, _i, y: gather_replicated(y, group, y.dim() - 1))
        return
    if mod.bias is not None:
        raise ValueError("a row-wise int4 projection with a bias is not sharded")
    in_f = 2 * packed
    if in_f % (2 * n):
        raise ValueError(f"{in_f} input columns do not split into even pieces over {n} ranks")
    k = in_f // n
    cols = unpack_int4(mod.kernel_q.t(), torch.int8)            # [in, out], split-half order
    mod.kernel_q = pack_int4(take(cols, 0, k)).t().contiguous()
    if mod.lora_scale:
        mod.lora_a = nn.Parameter(take(mod.lora_a.detach(), 0, k),
                                  requires_grad=mod.lora_a.requires_grad)
    mod.register_forward_hook(lambda _m, _i, y: sum_to_all(y, group))


def parallelize_llama(model: nn.Module, model_mesh, rules: Optional[List[Tuple[str, Spec]]] = None
                      ) -> nn.Module:
    """Tensor-parallel LlamaForCausalLM over the 1-D ``model`` mesh, by
    ``tensor_parallel_plan``: q/k/v/gate/up column-wise, o/down row-wise,
    the embedding vocabulary-parallel, lm_head column-wise with its logits
    gathered. Each attention keeps its Hq/n and Hkv/n local heads (the
    config's head counts become the local ones; both must divide). int4
    projections are sharded by ``_shard_int4`` into plain local tensors,
    the rest into DTensors. In place; returns the model."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import RowwiseParallel, parallelize_module

    from spider_tpu_torch.models.llama import LoraDense

    rules = rules or LLAMA_RULES
    cfg = model.config
    n = model_mesh.size()
    if cfg.num_attention_heads % n or cfg.num_key_value_heads % n:
        raise ValueError(f"{cfg.num_attention_heads}/{cfg.num_key_value_heads} heads do not "
                         f"split over {n} model ranks")
    plan = {}
    for name, kind in tensor_parallel_plan(model, rules).items():
        mod = model.get_submodule(name)
        if kind == "vocab":
            plan[name] = RowwiseParallel(input_layouts=Replicate(), output_layouts=Replicate())
        elif isinstance(mod, LoraDense) and mod.quantization == "int4":
            _shard_int4(mod, kind, model_mesh.get_group(), gather_output=name == "lm_head")
        else:
            plan[name] = _lora_style(kind, rules, model, name + ".",
                                     gather_output=name == "lm_head")
    parallelize_module(model, model_mesh, plan)
    local = dataclasses.replace(cfg, num_attention_heads=cfg.num_attention_heads // n,
                                num_key_value_heads=cfg.num_key_value_heads // n,
                                head_dim=cfg.head_dim_)
    model.replace_config(local)
    return model


def parallelize_experts(model: nn.Module, expert_mesh,
                        rules: Optional[List[Tuple[str, Spec]]] = None) -> nn.Module:
    """Split the experts of every MoE layer of a LlamaForCausalLM over the
    1-D ``expert`` mesh: each parameter whose rule names ``expert`` on a dim
    (``mlp/w1``, ``mlp/w2``: the expert dim) becomes a DTensor sharded
    there, rank r holding experts r*E/n ..; ``parallel.moe.moe_ffn_sharded``
    runs that rank's experts. In place; returns the model."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from spider_tpu_torch.models.llama import LlamaMoEMLP

    rules = rules or LLAMA_RULES
    n = expert_mesh.size()
    for mname, mod in model.named_modules():
        if not isinstance(mod, LlamaMoEMLP):
            continue
        for leaf, p in list(mod.named_parameters(recurse=False)):
            spec = param_spec(model, f"{mname}.{leaf}", rules)
            dims = [d for d, e in enumerate(spec) if _names(e, AXIS_EXPERT)]
            if not dims:
                continue
            if p.shape[dims[0]] % n:
                raise ValueError(f"{p.shape[dims[0]]} experts of {mname}.{leaf} do not split "
                                 f"over {n} expert ranks")
            d = distribute_tensor(p.detach(), expert_mesh, [Shard(dims[0])])
            setattr(mod, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return model
