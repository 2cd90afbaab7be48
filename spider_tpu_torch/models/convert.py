"""Fill the port's modules from checkpoints: HF/diffusers state dicts
(without JAX) and the JAX package's parameter trees.

**HF and diffusers checkpoints.** ``load_torch_state_dict(path)`` reads
``.safetensors`` (the port's own reader, models/checkpoint_io.py) and
``.bin``/``.pth``/``.pt`` files into torch tensors in their stored dtype, by
the file rule of spider_tpu/models/convert.py::load_torch_state_dict
(checkpoint_io's docstring has it). Each family has a rule set, a list of
``Rule(names, keys, op)``: the port state-dict names a rule fills, the
checkpoint keys it reads and the operation between them; the rule sets
follow spider_tpu/models/convert.py function by function and name for name
(the port names its submodules after the JAX tree). Torch layouts are the
port's layouts, so the reference's transposes are gone, and the ops left are:

  * ``copy``    as stored (the loader casts to the parameter's dtype)
  * ``linear``  a Linear weight, or a 1x1 Conv2d weight [out, in, 1, 1] -> [out, in]
  * ``tconv``   UNet3D's temporal Conv3d [out, in, 3, 1, 1] -> the port's
                (3, 1) Conv2d [out, in, 3, 1]
  * ``qkv``     a fused in_proj [3C, ...] -> q, k, v
  * ``row``     ImageBind's cls token -> [1, 1, C]
  * ``wn``      weight norm folded: g * v / max(|v|, 1e-12), the norm over
                every axis but the first, in numpy float32 as the reference does
  * ``int8``    [out, in] -> int8 ``kernel_q`` [out, in] and fp32
                ``kernel_scale`` [out] (``quantize_int8``)
  * ``tflip``   SAM's ConvTranspose2d [in, out, kh, kw] flipped in kh and kw:
                the reference maps it to flax's kernel without a flip, and
                flax applies that kernel unflipped, so this is the torch
                module that computes what the reference computes
  * ``cat``     rows stored as separate tensors [1, D] -> one [N, D]
  * ``k1``      a kernel-1 Conv1d weight [out, in, 1] -> a Linear's [out, in]
  * ``flat``    a patch embedding [out, C, t, p, p] -> a Linear's [out, C*t*p*p]
                (the rule's ``shapes`` keep the stored shape for the inverse)
  * ``zeros``   no checkpoint key: zeros of the rule's ``shapes`` (BERT's
                pooler where a checkpoint has none, as the reference fills it)

``convert_<family>_state_dict(sd, cfg)`` returns the port module's state dict
(``module.load_state_dict(..., strict=True)`` takes it); ``load_converted``
streams the same rules into a module already on its device, one tensor at a
time, and raises on a missing key, a name the module lacks, a shape that
differs or a module tensor left unfilled. ``export_state_dict`` inverts a
rule set (not ``int8``): a port state dict in the checkpoint's layout.

**JAX trees.** ``load_jax_params(module, params)`` takes the tree that a JAX
module's ``init`` returns, as numpy or JAX arrays, and copies it into the
port's module. The port names its submodules after the JAX tree, so this is
one generic walk with per-leaf layout rules:

  * Dense ``kernel`` [in, out]     -> ``weight`` [out, in] (transpose)
  * Conv ``kernel`` HWIO           -> ``weight`` OIHW; this also carries
    UNet3D's frame-axis conv, [3, 1, Cin, Cout], onto the port's
    ``nn.Conv2d`` with a (3, 1) kernel over (frames, pixels)
  * Conv3d ``kernel`` [kd, kh, kw, in, out] -> ``weight`` [out, in, kd, kh, kw]
  * Conv1d ``kernel`` [k, in, out] -> ``weight`` [out, in, k]
  * ConvTranspose1dTorch ``kernel`` [k, in, out] -> ``weight`` [in, out, k],
    no flip (the JAX module flips it in its forward pass, torch's
    ConvTranspose1d applies the weight as is)
  * ConvTranspose ``kernel`` [kh, kw, in, out] -> ``weight`` [in, out, kh, kw]
    flipped in kh and kw (flax's ``nn.ConvTranspose`` applies its kernel
    unflipped; torch's ConvTranspose2d flips the weight)
  * int8 ``kernel_q`` [in, out]    -> ``kernel_q`` [out, in]; ``kernel_scale`` as is
  * Embed ``embedding``            -> ``weight``
  * LayerNorm/GroupNorm ``scale``  -> ``weight``
  * a scanned ``layers`` subtree with a leading L axis -> one slice per
    entry of an ``nn.ModuleList``
  * anything else (biases, raw parameters such as ``input_layernorm``,
    CLAP's ``position_embedding``, HiFi-GAN's ``mean`` and ``scale``)
    -> the attribute of the same name, as is.

Every JAX leaf must land on a parameter or buffer of the same shape, and
every parameter and persistent buffer of the module must be filled.

``load_jax_spider`` fills a whole port ``Spider`` from the JAX ``Spider``'s
``trainable_params()`` tree (and, optionally, its ImageBind params);
``spider_trainable_to_jax`` is the inverse for the trainable leaves, back to
numpy in the JAX layout, so a test can compare parameters after some steps.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Collection, Dict, Iterable, List, Mapping, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

from spider_tpu_torch.models import llama as L
from spider_tpu_torch.models.checkpoint_io import open_state_dict


def _as_numpy(x) -> np.ndarray:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":   # ml_dtypes bfloat16 has no torch view
        arr = arr.astype(np.float32)
    return arr


def _slice_layer(node, i: int):
    if isinstance(node, Mapping):
        return {k: _slice_layer(v, i) for k, v in node.items()}
    return _as_numpy(node)[i]


def _leaf(mod: nn.Module, key: str, arr: np.ndarray):
    if key == "kernel":
        if isinstance(mod, nn.ConvTranspose2d):
            return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        if isinstance(mod, nn.Conv3d):
            return "weight", arr.transpose(4, 3, 0, 1, 2)
        if isinstance(mod, nn.Conv2d):
            return "weight", arr.transpose(3, 2, 0, 1)
        if isinstance(mod, nn.ConvTranspose1d):
            return "weight", arr.transpose(1, 2, 0)
        if isinstance(mod, nn.Conv1d):
            return "weight", arr.transpose(2, 1, 0)
        return "weight", arr.T
    if key == "kernel_q":
        return "kernel_q", arr.T
    if key == "embedding":
        return "weight", arr
    if key == "scale" and isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
        return "weight", arr
    return key, arr


def _walk(mod: nn.Module, node: Mapping, prefix: str, filled: Set[str]) -> None:
    for key, val in node.items():
        if isinstance(val, Mapping):
            child = getattr(mod, key, None)
            if key == "params" and child is None:
                # a flax variables dict nested inside a larger tree (a whole
                # Spider's trainable tree holds one per component)
                _walk(mod, val, prefix, filled)
                continue
            if not isinstance(child, nn.Module):
                raise KeyError(f"no submodule {prefix}{key} for the JAX subtree")
            if isinstance(child, nn.ModuleList):
                for i, layer in enumerate(child):
                    _walk(layer, _slice_layer(val, i), f"{prefix}{key}.{i}.", filled)
                n = {_as_numpy(v).shape[0] for v in _leaves(val)}
                if n != {len(child)}:
                    raise ValueError(f"{prefix}{key}: layer axis {n} vs {len(child)} layers")
            else:
                _walk(child, val, f"{prefix}{key}.", filled)
            continue
        name, arr = _leaf(mod, key, _as_numpy(val))
        target = getattr(mod, name, None)
        if not isinstance(target, torch.Tensor):
            raise KeyError(f"no parameter {prefix}{name} for JAX leaf {prefix}{key}")
        if tuple(target.shape) != arr.shape:
            raise ValueError(f"{prefix}{name}: shape {tuple(target.shape)} vs JAX "
                             f"{prefix}{key} {arr.shape}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.array(arr, order="C")))
        filled.add(prefix + name)


def _leaves(node):
    if isinstance(node, Mapping):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def state_names(module: nn.Module) -> Set[str]:
    """Names of every parameter and persistent buffer of `module`."""
    return set(module.state_dict().keys())


def load_jax_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX parameter tree into `module` (in place); returns it.
    Takes either the ``params`` collection or the whole variables dict that
    ``init`` returns (other collections, such as sown activations, are
    ignored)."""
    if "params" in params:
        params = params["params"]
    filled: Set[str] = set()
    _walk(module, params, "", filled)
    missing = state_names(module) - filled
    if missing:
        raise KeyError(f"not filled from the JAX tree: {sorted(missing)[:10]}")
    return module


def load_jax_spider(spider: nn.Module, trainable_tree: Mapping[str, Any],
                    encoder_params: Optional[Mapping[str, Any]] = None) -> nn.Module:
    """Fill the port's ``Spider`` from the JAX Spider's ``trainable_params()``
    tree ({'llm': variables, 'logit_scale', 'llama_proj': {kernel, bias},
    'aligners': {modality: variables} | 'moe_aligner': variables}) and, when
    given, the ImageBind encoder's variables. Everything outside the encoder
    must be filled; the encoder too when `encoder_params` is given."""
    filled: Set[str] = set()
    _walk(spider, trainable_tree, "", filled)
    if encoder_params is not None:
        _walk(spider.encoder, encoder_params.get("params", encoder_params), "encoder.", filled)
    missing = {n for n in state_names(spider) - filled
               if encoder_params is not None or not n.startswith("encoder.")}
    if missing:
        raise KeyError(f"not filled from the JAX tree: {sorted(missing)[:10]}")
    return spider


def _unleaf(mod: nn.Module, name: str, arr: np.ndarray):
    """The inverse of ``_leaf`` for the layers a trainable Spider holds."""
    if name == "weight":
        if isinstance(mod, nn.Embedding):
            return "embedding", arr
        if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            return "scale", arr
        if isinstance(mod, nn.ConvTranspose2d):
            return "kernel", arr.transpose(2, 3, 0, 1)[::-1, ::-1]
        if arr.ndim != 2:
            raise NotImplementedError(f"no JAX layout rule for a {type(mod).__name__} weight")
        return "kernel", arr.T
    if name == "kernel_q":
        return "kernel_q", arr.T
    return name, arr


def to_jax_tree(module: nn.Module) -> Dict[str, Any]:
    """The module's parameters that require grad, as a numpy tree in the JAX
    layout (an ``nn.ModuleList`` becomes one subtree with a leading layer
    axis, as ``nn.scan`` stacks it)."""
    out: Dict[str, Any] = {}
    for name, p in module.named_parameters(recurse=False):
        if p.requires_grad:
            key, arr = _unleaf(module, name, p.detach().float().cpu().numpy())
            out[key] = np.array(arr, order="C")
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            sub = _stack([to_jax_tree(c) for c in child])
        else:
            sub = to_jax_tree(child)
        if sub:
            out[name] = sub
    return out


def _stack(trees):
    if not trees or not isinstance(trees[0], dict):
        return np.stack(trees) if trees else {}
    return {k: _stack([t[k] for t in trees]) for k in trees[0]}


def spider_trainable_to_jax(spider: nn.Module) -> Dict[str, Any]:
    """The port Spider's trainable parameters in the layout of the JAX
    Spider's ``trainable_params()`` tree."""
    tree: Dict[str, Any] = {"llm": {"params": to_jax_tree(spider.llm)},
                            "logit_scale": spider.logit_scale.detach().cpu().numpy()}
    if spider.sam is not None:                   # the mask decoder, the SAM part that trains
        tree["sam"] = {"params": to_jax_tree(spider.sam)}
    if spider.llama_proj is not None:
        tree["llama_proj"] = to_jax_tree(spider.llama_proj)
    if spider.moe_aligner is not None:
        tree["moe_aligner"] = {"params": to_jax_tree(spider.moe_aligner)}
    else:
        tree["aligners"] = {m: {"params": to_jax_tree(a)} for m, a in spider.aligners.items()}
    return tree


# ---------------------------------------------------------------------------
# HF / diffusers checkpoints
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a checkpoint file or directory, in its stored dtype
    (``.safetensors`` tensors are views of the mapped file)."""
    with open_state_dict(path) as sd:
        return dict(sd.items())


@dataclasses.dataclass(frozen=True)
class Rule:
    """Fill the port state-dict entries `names` from checkpoint keys `keys`
    by `op` (see the module docstring)."""
    names: Tuple[str, ...]
    keys: Tuple[str, ...]
    op: str = "copy"
    shapes: Tuple[Tuple[int, ...], ...] = ()      # of op "zeros"


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, in] -> (int8 [out, in], fp32 scale [out]), the reference's
    per-output-channel rule (spider_tpu/models/convert.py:69-75) in fp32 on
    `w`'s device: scale = max(max |w| over in / 127, 1e-8), q =
    clip(round_half_even(w / scale), -127, 127). IEEE division and
    ``torch.round`` give numpy's bits."""
    w = w.float()
    amax = w.abs().amax(dim=1)
    # A tensor divisor, not the number 127: CUDA divides by a host scalar as
    # a product with its reciprocal, which is not IEEE division.
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-8)
    q = torch.round(w / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    g = g.detach().to("cpu", torch.float32).numpy()
    v = v.detach().to("cpu", torch.float32).numpy()
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return torch.from_numpy(g * v / np.maximum(norm, 1e-12))


def _linear(w: torch.Tensor) -> torch.Tensor:
    if w.dim() == 4:                    # a 1x1 conv stored [out, in, 1, 1]
        if tuple(w.shape[2:]) != (1, 1):
            raise ValueError(f"a dense weight stored as a conv must be 1x1, got {tuple(w.shape)}")
        return w[:, :, 0, 0]
    return w


def _temporal(w: torch.Tensor) -> torch.Tensor:
    if w.dim() != 5 or tuple(w.shape[3:]) != (1, 1):
        raise ValueError(f"a temporal conv weight is [out, in, k, 1, 1], got {tuple(w.shape)}")
    return w[..., 0]


def _k1(w: torch.Tensor) -> torch.Tensor:
    if w.dim() != 3 or w.shape[-1] != 1:
        raise ValueError(f"a kernel-1 Conv1d weight is [out, in, 1], got {tuple(w.shape)}")
    return w[..., 0]


def _split3(w: torch.Tensor):
    if w.shape[0] % 3:
        raise ValueError(f"a fused q/k/v tensor needs 3 equal parts, got {tuple(w.shape)}")
    return w.chunk(3, dim=0)


_OPS: Dict[str, Callable[..., Tuple[torch.Tensor, ...]]] = {
    "copy": lambda t: (t,),
    "linear": lambda t: (_linear(t),),
    "tconv": lambda t: (_temporal(t),),
    "qkv": _split3,
    "row": lambda t: (t.reshape(1, 1, -1),),
    "wn": lambda g, v: (_fold_weight_norm(g, v),),
    "int8": quantize_int8,
    "tflip": lambda t: (t.flip(2, 3),),
    "cat": lambda *ts: (torch.cat(ts, dim=0),),
    "k1": lambda t: (_k1(t),),
    "flat": lambda t: (t.reshape(t.shape[0], -1),),
}


def _weight_norm_parts(w: torch.Tensor):
    v = w.detach().float()
    g = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return g, v


# Checkpoint tensors from port tensors, for export_state_dict.
_INVERSE: Dict[str, Callable[..., Tuple[torch.Tensor, ...]]] = {
    "copy": lambda t: (t,),
    "linear": lambda t: (t,),
    "tconv": lambda t: (t[..., None],),
    "qkv": lambda q, k, v: (torch.cat([q, k, v], dim=0),),
    "row": lambda t: (t,),
    "wn": _weight_norm_parts,
    "tflip": lambda t: (t.flip(2, 3),),
    "cat": lambda t: tuple(t[i: i + 1] for i in range(t.shape[0])),
    "zeros": lambda *ts: (),
    "k1": lambda t: (t[..., None],),
}


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    return torch.from_numpy(x if x.flags.writeable else x.copy())


def apply_rule(rule: Rule, tensors) -> Tuple[torch.Tensor, ...]:
    if rule.op == "zeros":
        return tuple(torch.zeros(s) for s in rule.shapes)
    outs = _OPS[rule.op](*tensors)
    if len(outs) != len(rule.names):
        raise ValueError(f"{rule.op} gives {len(outs)} tensors for {rule.names}")
    return outs


def convert_state_dict(rules: Iterable[Rule], sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port state dict a rule set makes of checkpoint `sd` (numpy or
    torch values), on the devices and in the dtypes the checkpoint has."""
    out: Dict[str, torch.Tensor] = {}
    for rule in rules:
        out.update(zip(rule.names, apply_rule(rule, [_as_tensor(sd[k]) for k in rule.keys])))
    return out


def export_state_dict(rules: Iterable[Rule], state: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The checkpoint a rule set reads, made from a port state dict: the
    inverse of ``convert_state_dict`` (weight norm split as g = |w|, v = w;
    int8 has no inverse)."""
    out: Dict[str, torch.Tensor] = {}
    for rule in rules:
        if rule.op == "flat":
            out[rule.keys[0]] = state[rule.names[0]].reshape(rule.shapes[0])
            continue
        if rule.op not in _INVERSE:
            raise ValueError(f"op {rule.op!r} has no inverse ({rule.names})")
        out.update(zip(rule.keys, _INVERSE[rule.op](*(state[n] for n in rule.names))))
    return out


def load_converted(module: nn.Module, rules: Iterable[Rule], sd: Mapping[str, Any], *,
                   skip: Collection[str] = (),
                   hook: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                   ) -> nn.Module:
    """Stream checkpoint `sd` into `module` (in place; returns it), one rule
    at a time: the rule's tensors go to the device of the entry they fill,
    are converted there (``wn`` on the host, in numpy) and copied into the
    entry in its dtype, and are dropped before the next rule's are read (a
    lazy `sd`, checkpoint_io.LazyStateDict, then holds about one tensor in
    host memory). `hook(name, tensor)` may replace a converted tensor before
    it is copied. Every parameter and persistent buffer must be filled,
    except the names in `skip`."""
    state = module.state_dict()
    filled: Set[str] = set()
    for rule in rules:
        missing = [n for n in rule.names if n not in state]
        if missing:
            raise KeyError(f"{type(module).__name__} has no {missing} for checkpoint "
                           f"key(s) {list(rule.keys)}")
        targets = [state[n] for n in rule.names]
        ins = [_as_tensor(sd[k]) for k in rule.keys]
        if rule.op != "wn":
            ins = [t.to(targets[0].device) for t in ins]
        for name, target, out in zip(rule.names, targets, apply_rule(rule, ins)):
            if hook is not None:
                out = hook(name, out)
            if tuple(out.shape) != tuple(target.shape):
                raise ValueError(f"{name}: the module holds {tuple(target.shape)}, checkpoint "
                                 f"key(s) {list(rule.keys)} give {tuple(out.shape)}")
            with torch.no_grad():
                target.copy_(out)
            filled.add(name)
        ins = out = None                # drop this rule's tensors before the next read
    unfilled = set(state) - filled - set(skip)
    if unfilled:
        raise KeyError(f"{type(module).__name__}: not filled from the checkpoint: "
                       f"{sorted(unfilled)[:10]} ({len(unfilled)} in all)")
    return module


def load_checkpoint(module: nn.Module, rules_fn: Callable[[Collection[str], Any], List[Rule]],
                    path: str, **kwargs) -> nn.Module:
    """Stream the checkpoint at `path` into `module` through the rule set
    ``rules_fn(keys, module.config)``."""
    with open_state_dict(path) as sd:
        return load_converted(module, rules_fn(sd, module.config), sd, **kwargs)


class _Rules(list):
    """A rule list built against the checkpoint's key set (optional keys,
    such as a bias, are read only where the checkpoint has them)."""

    def __init__(self, keys: Collection[str]):
        super().__init__()
        self.keys = keys

    def add(self, name: str, key: str, op: str = "copy") -> None:
        self.append(Rule((name,), (key,), op))

    def first(self, *candidates: str) -> str:
        for c in candidates:
            if c in self.keys:
                return c
        raise KeyError(f"none of {candidates} in the checkpoint ({len(self.keys)} keys)")

    def norm(self, name: str, key: str) -> None:            # _gn
        self.add(f"{name}.weight", f"{key}.weight")
        self.add(f"{name}.bias", f"{key}.bias")

    def conv(self, name: str, key: str) -> None:            # _c
        self.add(f"{name}.weight", f"{key}.weight")
        if f"{key}.bias" in self.keys:
            self.add(f"{name}.bias", f"{key}.bias")

    def dense(self, name: str, key: str) -> None:           # _d
        self.add(f"{name}.weight", f"{key}.weight", "linear")
        if f"{key}.bias" in self.keys:
            self.add(f"{name}.bias", f"{key}.bias")


# ---- Llama / DeepSeek-R1-Distill-Llama ------------------------------------

def llama_rules(keys: Collection[str], cfg: L.LlamaConfig,
                quantize: Optional[str] = None) -> List[Rule]:
    """HF LlamaForCausalLM names -> the port's LlamaForCausalLM
    (spider_tpu/models/convert.py:59-107); with quantize='int8' every
    projection and the lm_head become ``kernel_q``/``kernel_scale``. With
    ``cfg.attention_bias`` (Qwen2) the q/k/v ``.bias`` keys are read as
    stored; with ``cfg.tie_word_embeddings`` there is no lm_head, and an
    ``lm_head.weight`` in the checkpoint is not read."""
    if quantize not in (None, "int8"):
        raise NotImplementedError(f"quantize={quantize!r}: checkpoints quantise to int8 "
                                  "only, as the reference converter does")
    r = _Rules(keys)

    def proj(name: str, key: str) -> None:
        if quantize == "int8":
            r.append(Rule((f"{name}.kernel_q", f"{name}.kernel_scale"), (key,), "int8"))
        else:
            r.add(f"{name}.weight", key)

    r.add("embed_tokens.weight", "model.embed_tokens.weight")
    for i in range(cfg.num_hidden_layers):
        b = f"model.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            proj(f"{b}self_attn.{n}", f"{b}self_attn.{n}.weight")
        if cfg.attention_bias:
            for n in ("q_proj", "k_proj", "v_proj"):
                r.add(f"{b}self_attn.{n}.bias", f"{b}self_attn.{n}.bias")
        for n in ("gate_proj", "up_proj", "down_proj"):
            proj(f"{b}mlp.{n}", f"{b}mlp.{n}.weight")
        r.add(f"{b}input_layernorm", f"{b}input_layernorm.weight")
        r.add(f"{b}post_attention_layernorm", f"{b}post_attention_layernorm.weight")
    r.add("model.norm", "model.norm.weight")
    if "lm_head.weight" in keys and not cfg.tie_word_embeddings:
        proj("lm_head", "lm_head.weight")
    return r


def convert_llama_state_dict(sd: Mapping[str, Any], cfg: L.LlamaConfig,
                             quantize: Optional[str] = None) -> Dict[str, torch.Tensor]:
    return convert_state_dict(llama_rules(sd, cfg, quantize), sd)


def read_llama_config(path: str, quantize: Optional[str] = None, **overrides) -> L.LlamaConfig:
    """The port's LlamaConfig of the HF ``config.json`` in `path`, field for
    field as spider_tpu/models/convert.py:117-149 reads it: ``rope_type``
    dropped from ``rope_scaling``; q/k/v biases where ``attention_bias`` says
    so or, without it, where ``model_type`` is 'qwen2'; tied embeddings where
    ``tie_word_embeddings`` says so."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    rope_scaling = hf.get("rope_scaling")
    if rope_scaling and "rope_type" in rope_scaling:
        rope_scaling = {k: v for k, v in rope_scaling.items() if k != "rope_type"}
    return L.LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        rope_scaling=rope_scaling,
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        quantization=quantize,
        attention_bias=hf.get("attention_bias", hf.get("model_type") == "qwen2"),
        **overrides)


def convert_llama_checkpoint(path: str, quantize: Optional[str] = None, *, device="cuda",
                             param_dtype: torch.dtype = torch.float32):
    """HF checkpoint dir (config.json + weights) -> (LlamaConfig, the port's
    LlamaForCausalLM on `device`), streamed tensor by tensor: each lands in
    its final dtype (`param_dtype` for embeddings and norms, and for the
    projections unless `quantize` is 'int8') on the device as it is read."""
    cfg = read_llama_config(path, quantize, param_dtype=param_dtype)
    model = L.LlamaForCausalLM(cfg, device).eval()
    return cfg, load_checkpoint(model, lambda keys, c: llama_rules(keys, c, quantize), path)


def extend_embedding_rows(name: str, w: torch.Tensor, new_vocab_size: int) -> torch.Tensor:
    """``embed_tokens.weight`` or ``lm_head.weight`` [V, H] grown to
    [new_vocab_size, H] in fp32 with the reference's rows
    (spider_tpu/models/convert.py:152-174): new embedding rows
    N(0, 0.02) from ``np.random.default_rng(0)`` plus the old rows' mean,
    taken in numpy float32; new lm_head rows N(0, 0.02) from
    ``default_rng(1)``, drawn [H, new] in the reference's kernel layout."""
    V, H = w.shape
    if new_vocab_size <= V:
        return w
    if name == "embed_tokens.weight":
        emb = np.ascontiguousarray(w.detach().to("cpu", torch.float32).numpy())
        extra = np.random.default_rng(0).normal(
            0, 0.02, (new_vocab_size - V, H)).astype(np.float32) + emb.mean(0)
    elif name == "lm_head.weight":
        extra = np.random.default_rng(1).normal(
            0, 0.02, (H, new_vocab_size - V)).astype(np.float32).T
    else:
        raise KeyError(f"{name} is not an embedding matrix")
    return torch.cat([w.float(), torch.from_numpy(np.ascontiguousarray(extra)).to(w.device)])


def extend_llama_embeddings(state: Mapping[str, torch.Tensor],
                            new_vocab_size: int) -> Dict[str, torch.Tensor]:
    """resize_token_embeddings analogue on a port state dict: a new dict
    with ``embed_tokens.weight`` and ``lm_head.weight`` (if present)
    grown by ``extend_embedding_rows``."""
    out = dict(state)
    for name in ("embed_tokens.weight", "lm_head.weight"):
        if name in out:
            out[name] = extend_embedding_rows(name, out[name], new_vocab_size)
    return out


# ---- CLIP and CLAP text encoders ------------------------------------------

def clip_text_rules(keys: Collection[str], cfg) -> List[Rule]:
    """openai/clip-vit-* ``text_model.*`` names (spider_tpu/models/convert.py:181-211)."""
    pre = "text_model." if any(k.startswith("text_model.") for k in keys) else ""
    r = _Rules(keys)
    r.add("token_embedding.weight", f"{pre}embeddings.token_embedding.weight")
    r.add("position_embedding", f"{pre}embeddings.position_embedding.weight")
    r.norm("final_layer_norm", f"{pre}final_layer_norm")
    for i in range(cfg.num_hidden_layers):
        b, p = f"{pre}encoder.layers.{i}.", f"layers_{i}."
        r.norm(p + "layer_norm1", b + "layer_norm1")
        r.norm(p + "layer_norm2", b + "layer_norm2")
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            r.add(f"{p}{n}.weight", f"{b}self_attn.{n}.weight")
            r.add(f"{p}{n}.bias", f"{b}self_attn.{n}.bias")
        for n in ("fc1", "fc2"):
            r.add(f"{p}{n}.weight", f"{b}mlp.{n}.weight")
            r.add(f"{p}{n}.bias", f"{b}mlp.{n}.bias")
    if "text_projection.weight" in keys and cfg.projection_dim:
        r.add("text_projection.weight", "text_projection.weight")
    return r


def convert_clip_text_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return convert_state_dict(clip_text_rules(sd, cfg), sd)


def clap_text_rules(keys: Collection[str], cfg) -> List[Rule]:
    """HF laion/clap text branch: RoBERTa body + 2-layer projection
    (spider_tpu/models/convert.py:804-833)."""
    pre = "text_model." if any(k.startswith("text_model.") for k in keys) else ""
    r = _Rules(keys)
    r.add("token_embedding.weight", f"{pre}embeddings.word_embeddings.weight")
    r.add("position_embedding", f"{pre}embeddings.position_embeddings.weight")
    r.norm("embed_ln", f"{pre}embeddings.LayerNorm")
    r.dense("proj_fc1", "text_projection.linear1")
    r.dense("proj_fc2", "text_projection.linear2")
    for i in range(cfg.num_hidden_layers):
        b = f"{pre}encoder.layer.{i}."
        r.dense(f"l{i}_q", b + "attention.self.query")
        r.dense(f"l{i}_k", b + "attention.self.key")
        r.dense(f"l{i}_v", b + "attention.self.value")
        r.dense(f"l{i}_out", b + "attention.output.dense")
        r.norm(f"l{i}_ln1", b + "attention.output.LayerNorm")
        r.dense(f"l{i}_fc1", b + "intermediate.dense")
        r.dense(f"l{i}_fc2", b + "output.dense")
        r.norm(f"l{i}_ln2", b + "output.LayerNorm")
    return r


def convert_clap_text_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return convert_state_dict(clap_text_rules(sd, cfg), sd)


# ---- diffusers AutoencoderKL ----------------------------------------------

def _vae_resnet(r: _Rules, name: str, key: str) -> None:
    r.norm(f"{name}.norm1", f"{key}.norm1")
    r.conv(f"{name}.conv1", f"{key}.conv1")
    r.norm(f"{name}.norm2", f"{key}.norm2")
    r.conv(f"{name}.conv2", f"{key}.conv2")
    if f"{key}.conv_shortcut.weight" in r.keys:
        r.conv(f"{name}.conv_shortcut", f"{key}.conv_shortcut")


def _vae_attn(r: _Rules, name: str, key: str) -> None:
    r.norm(f"{name}.norm", f"{key}.group_norm")
    for n, k in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj_out", "to_out.0")):
        r.dense(f"{name}.{n}", f"{key}.{k}")


def vae_rules(keys: Collection[str], cfg) -> List[Rule]:
    """diffusers AutoencoderKL names (spider_tpu/models/convert.py:304-336)."""
    r = _Rules(keys)
    n = len(cfg.block_out_channels)
    r.conv("encoder.conv_in", "encoder.conv_in")
    r.norm("encoder.norm_out", "encoder.conv_norm_out")
    r.conv("encoder.conv_out", "encoder.conv_out")
    r.conv("encoder.quant_conv", "quant_conv")
    for i in range(n):
        for j in range(cfg.layers_per_block):
            _vae_resnet(r, f"encoder.down_{i}_res_{j}", f"encoder.down_blocks.{i}.resnets.{j}")
        if i < n - 1:
            r.conv(f"encoder.down_{i}_downsample", f"encoder.down_blocks.{i}.downsamplers.0.conv")
    for side in ("encoder", "decoder"):
        _vae_resnet(r, f"{side}.mid_res_0", f"{side}.mid_block.resnets.0")
        _vae_resnet(r, f"{side}.mid_res_1", f"{side}.mid_block.resnets.1")
        _vae_attn(r, f"{side}.mid_attn", f"{side}.mid_block.attentions.0")
    r.conv("decoder.conv_in", "decoder.conv_in")
    r.norm("decoder.norm_out", "decoder.conv_norm_out")
    r.conv("decoder.conv_out", "decoder.conv_out")
    r.conv("decoder.post_quant_conv", "post_quant_conv")
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            _vae_resnet(r, f"decoder.up_{i}_res_{j}", f"decoder.up_blocks.{i}.resnets.{j}")
        if i < n - 1:
            r.conv(f"decoder.up_{i}_upsample", f"decoder.up_blocks.{i}.upsamplers.0.conv")
    return r


def convert_vae_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return convert_state_dict(vae_rules(sd, cfg), sd)


# ---- diffusers UNet2DConditionModel ---------------------------------------

def _unet_resnet(r: _Rules, name: str, key: str) -> None:
    _vae_resnet(r, name, key)
    r.dense(f"{name}.time_emb_proj", f"{key}.time_emb_proj")


def _unet_attn(r: _Rules, name: str, key: str, depth: int) -> None:
    r.norm(f"{name}.norm", f"{key}.norm")
    r.dense(f"{name}.proj_in", f"{key}.proj_in")
    r.dense(f"{name}.proj_out", f"{key}.proj_out")
    for k in range(depth):
        b, p = f"{key}.transformer_blocks.{k}", f"{name}.block_{k}"
        for n in ("norm1", "norm2", "norm3"):
            r.norm(f"{p}.{n}", f"{b}.{n}")
        for a in ("attn1", "attn2"):
            for n, s in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                         ("to_out", "to_out.0")):
                r.dense(f"{p}.{a}.{n}", f"{b}.{a}.{s}")
        r.dense(f"{p}.ff.proj_in", f"{b}.ff.net.0.proj")
        r.dense(f"{p}.ff.proj_out", f"{b}.ff.net.2")


def unet2d_rules(keys: Collection[str], cfg) -> List[Rule]:
    """diffusers UNet2DConditionModel names, SD-1.5, SDXL (text_time) and
    AudioLDM layouts (spider_tpu/models/convert.py:373-417)."""
    r = _Rules(keys)
    n = len(cfg.block_out_channels)
    r.conv("conv_in", "conv_in")
    r.dense("time_embed_1", "time_embedding.linear_1")
    r.dense("time_embed_2", "time_embedding.linear_2")
    r.norm("norm_out", "conv_norm_out")
    r.conv("conv_out", "conv_out")
    if cfg.addition_embed_type == "text_time":
        r.dense("add_embed_1", "add_embedding.linear_1")
        r.dense("add_embed_2", "add_embedding.linear_2")
    elif cfg.addition_embed_type == "class_embed":
        r.dense("class_embed_1", "class_embedding.linear_1")
        r.dense("class_embed_2", "class_embedding.linear_2")
    for i in range(n):
        for j in range(cfg.layers_per_block):
            _unet_resnet(r, f"down_{i}_res_{j}", f"down_blocks.{i}.resnets.{j}")
            if cfg.cross_attn_blocks[i] and cfg.transformer_layers_per_block[i]:
                _unet_attn(r, f"down_{i}_attn_{j}", f"down_blocks.{i}.attentions.{j}",
                           cfg.transformer_layers_per_block[i])
        if i < n - 1:
            r.conv(f"down_{i}_downsample", f"down_blocks.{i}.downsamplers.0.conv")
    _unet_resnet(r, "mid_res_0", "mid_block.resnets.0")
    _unet_resnet(r, "mid_res_1", "mid_block.resnets.1")
    if "mid_block.attentions.0.norm.weight" in keys:
        _unet_attn(r, "mid_attn", "mid_block.attentions.0",
                   max(cfg.transformer_layers_per_block[-1], 1))
    rev_attn = list(reversed(cfg.cross_attn_blocks))
    rev_depth = list(reversed(cfg.transformer_layers_per_block))
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            _unet_resnet(r, f"up_{i}_res_{j}", f"up_blocks.{i}.resnets.{j}")
            if rev_attn[i] and rev_depth[i]:
                _unet_attn(r, f"up_{i}_attn_{j}", f"up_blocks.{i}.attentions.{j}", rev_depth[i])
        if i < n - 1:
            r.conv(f"up_{i}_upsample", f"up_blocks.{i}.upsamplers.0.conv")
    return r


def convert_unet2d_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return convert_state_dict(unet2d_rules(sd, cfg), sd)


# ---- diffusers UNet3DConditionModel (ZeroScope) ---------------------------

def _temporal_conv(r: _Rules, name: str, key: str) -> None:
    for i in range(1, 5):
        # Sequential(GroupNorm, SiLU[, Dropout], Conv3d): the conv is at
        # index 2 for conv1, 3 for the others.
        idx = 2 if i == 1 else 3
        r.norm(f"{name}.norm{i}", f"{key}.conv{i}.0")
        r.add(f"{name}.conv{i}.weight", f"{key}.conv{i}.{idx}.weight", "tconv")
        r.add(f"{name}.conv{i}.bias", f"{key}.conv{i}.{idx}.bias")


def _temporal_transformer(r: _Rules, name: str, key: str, depth: int = 1) -> None:
    r.norm(f"{name}.norm", f"{key}.norm")
    r.dense(f"{name}.proj_in", f"{key}.proj_in")
    r.dense(f"{name}.proj_out", f"{key}.proj_out")
    for k in range(depth):
        b, p = f"{key}.transformer_blocks.{k}", f"{name}.block_{k}"
        for a in ("attn1", "attn2"):
            for n, s in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("out", "to_out.0")):
                r.dense(f"{p}.{a}_{n}", f"{b}.{a}.{s}")
        for n in ("norm1", "norm2", "norm3"):
            r.norm(f"{p}.{n}", f"{b}.{n}")
        r.dense(f"{p}.ff_proj_in", f"{b}.ff.net.0.proj")
        r.dense(f"{p}.ff_proj_out", f"{b}.ff.net.2")


def unet3d_rules(keys: Collection[str], cfg) -> List[Rule]:
    """diffusers UNet3DConditionModel names, the ZeroScope layout
    (spider_tpu/models/convert.py:749-796)."""
    r = _Rules(keys)
    n = len(cfg.block_out_channels)
    r.conv("conv_in", "conv_in")
    r.dense("time_embed_1", "time_embedding.linear_1")
    r.dense("time_embed_2", "time_embedding.linear_2")
    r.norm("norm_out", "conv_norm_out")
    r.conv("conv_out", "conv_out")
    _temporal_transformer(r, "transformer_in", "transformer_in")
    for i in range(n):
        for j in range(cfg.layers_per_block):
            _unet_resnet(r, f"down_{i}_res_{j}", f"down_blocks.{i}.resnets.{j}")
            _temporal_conv(r, f"down_{i}_tconv_{j}", f"down_blocks.{i}.temp_convs.{j}")
            if cfg.cross_attn_blocks[i]:
                _unet_attn(r, f"down_{i}_attn_{j}", f"down_blocks.{i}.attentions.{j}", 1)
                _temporal_transformer(r, f"down_{i}_tattn_{j}",
                                      f"down_blocks.{i}.temp_attentions.{j}")
        if i < n - 1:
            r.conv(f"down_{i}_downsample", f"down_blocks.{i}.downsamplers.0.conv")
    _unet_resnet(r, "mid_res_0", "mid_block.resnets.0")
    _temporal_conv(r, "mid_tconv_0", "mid_block.temp_convs.0")
    _unet_attn(r, "mid_attn", "mid_block.attentions.0", 1)
    _temporal_transformer(r, "mid_tattn", "mid_block.temp_attentions.0")
    _unet_resnet(r, "mid_res_1", "mid_block.resnets.1")
    _temporal_conv(r, "mid_tconv_1", "mid_block.temp_convs.1")
    rev_attn = list(reversed(cfg.cross_attn_blocks))
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            _unet_resnet(r, f"up_{i}_res_{j}", f"up_blocks.{i}.resnets.{j}")
            _temporal_conv(r, f"up_{i}_tconv_{j}", f"up_blocks.{i}.temp_convs.{j}")
            if rev_attn[i]:
                _unet_attn(r, f"up_{i}_attn_{j}", f"up_blocks.{i}.attentions.{j}", 1)
                _temporal_transformer(r, f"up_{i}_tattn_{j}",
                                      f"up_blocks.{i}.temp_attentions.{j}")
        if i < n - 1:
            r.conv(f"up_{i}_upsample", f"up_blocks.{i}.upsamplers.0.conv")
    return r


def convert_unet3d_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return convert_state_dict(unet3d_rules(sd, cfg), sd)


# ---- SpeechT5 HiFi-GAN vocoder --------------------------------------------

def hifigan_rules(keys: Collection[str], cfg) -> List[Rule]:
    """HF SpeechT5HifiGan names (spider_tpu/models/convert.py:674-701); a
    conv stored weight-normed (``weight_g``/``weight_v``) is folded. The
    ConvTranspose1d weights [in, out, k] are torch's layout as they are."""
    r = _Rules(keys)

    def conv(name: str, key: str) -> None:
        if f"{key}.weight" in keys:
            r.add(f"{name}.weight", f"{key}.weight")
        else:
            r.append(Rule((f"{name}.weight",), (f"{key}.weight_g", f"{key}.weight_v"), "wn"))
        r.add(f"{name}.bias", f"{key}.bias")

    conv("conv_pre", "conv_pre")
    conv("conv_post", "conv_post")
    if cfg.normalize_before:
        r.add("mean", "mean")
        r.add("scale", "scale")
    n_kernels = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        conv(f"up_{i}", f"upsampler.{i}")
        for j in range(n_kernels):
            b = f"resblocks.{i * n_kernels + j}."
            for d in range(len(cfg.resblock_dilation_sizes[j])):
                conv(f"res_{i}_{j}.conv1_{d}", f"{b}convs1.{d}")
                conv(f"res_{i}_{j}.conv2_{d}", f"{b}convs2.{d}")
    return r


def convert_hifigan_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return convert_state_dict(hifigan_rules(sd, cfg), sd)


# ---- ImageBind (imagebind_huge.pth) ---------------------------------------

def imagebind_rules(keys: Collection[str], cfg) -> List[Rule]:
    """The official ImageBind checkpoint, vision and audio trunks and heads
    (spider_tpu/models/convert.py:536-601, alternative key names included).
    The vision stem's Conv3d [W, 3, F, k, k] is the port's layout."""
    r = _Rules(keys)
    r.add("vision_patch.weight", r.first(
        "modality_preprocessors.vision.rgbt_stem.proj.1.weight",
        "modality_preprocessors.vision.rgbt_stem.proj.weight"))
    r.add("audio_patch.weight", r.first(
        "modality_preprocessors.audio.rgbt_stem.proj.weight",
        "modality_preprocessors.audio.audio_stem.proj.weight"))
    for m, layers in (("vision", cfg.vision.layers), ("audio", cfg.audio.layers)):
        t = f"{m}_trunk"
        r.add(f"{t}.cls_token", r.first(f"modality_preprocessors.{m}.cls_token"), "row")
        r.add(f"{t}.pos_embed", r.first(
            f"modality_preprocessors.{m}.pos_embedding_helper.pos_embed",
            f"modality_preprocessors.{m}.pos_embed"))
        pre = f"modality_trunks.{m}.pre_transformer_layer.0"
        if f"{pre}.weight" in keys:
            r.norm(f"{t}.pre_ln", pre)
        for i in range(layers):
            b, p = f"modality_trunks.{m}.blocks.{i}.", f"{t}.block_{i}."
            r.norm(p + "ln1", b + "norm_1")
            r.norm(p + "ln2", b + "norm_2")
            for part in ("weight", "bias"):
                r.append(Rule(tuple(f"{p}{x}.{part}" for x in "qkv"),
                              (r.first(f"{b}attn.in_proj_{part}"),), "qkv"))
            r.dense(p + "proj", b + "attn.out_proj")
            r.dense(p + "fc1", b + "mlp.fc1")
            r.dense(p + "fc2", b + "mlp.fc2")
        # heads: Sequential(LayerNorm, SelectElement, Linear(bias=False))
        r.norm(f"{m}_head_ln", f"modality_heads.{m}.0")
        r.add(f"{m}_head.weight", r.first(f"modality_heads.{m}.2.weight"))
    return r


def convert_imagebind_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return convert_state_dict(imagebind_rules(sd, cfg), sd)


# ---- PhotoMaker ID encoder (photomaker-v1.bin's "id_encoder") -------------

def photomaker_rules(keys: Collection[str], cfg) -> List[Rule]:
    """StoryDiffusion utils/model.py PhotoMakerIDEncoder names
    (spider_tpu/models/convert.py:1202-1252). Pass the inner dict of the
    checkpoint's "id_encoder" key (the file also carries "lora_weights" for
    the UNet, applied separately)."""
    r = _Rules(keys)
    vm, p = "vision_model.", "vision_model."
    r.add(p + "patch_embedding.weight", vm + "embeddings.patch_embedding.weight")
    r.add(p + "class_embedding", vm + "embeddings.class_embedding")
    r.add(p + "position_embedding", vm + "embeddings.position_embedding.weight")
    r.norm(p + "pre_layrnorm", vm + "pre_layrnorm")
    r.norm(p + "post_layernorm", vm + "post_layernorm")
    for i in range(cfg.num_hidden_layers):
        b, q = f"{vm}encoder.layers.{i}.", f"{p}layers_{i}."
        r.norm(q + "layer_norm1", b + "layer_norm1")
        r.norm(q + "layer_norm2", b + "layer_norm2")
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            r.dense(q + n, f"{b}self_attn.{n}")
        r.dense(q + "fc1", b + "mlp.fc1")
        r.dense(q + "fc2", b + "mlp.fc2")
    r.dense("visual_projection", "visual_projection")
    r.dense("visual_projection_2", "visual_projection_2")
    for m in ("mlp1", "mlp2"):
        r.norm(f"fuse_module.{m}.layernorm", f"fuse_module.{m}.layernorm")
        r.dense(f"fuse_module.{m}.fc1", f"fuse_module.{m}.fc1")
        r.dense(f"fuse_module.{m}.fc2", f"fuse_module.{m}.fc2")
    r.norm("fuse_module.layer_norm", "fuse_module.layer_norm")
    return r


def convert_photomaker_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return convert_state_dict(photomaker_rules(sd, cfg), sd)


# ---- BERT, Swin, SAM and Grounding DINO ------------------------------------

def _bert(r: _Rules, name: str, pre: str, cfg) -> None:
    """HF BertModel keys under `pre` -> the port's BertModel under `name`."""
    r.add(f"{name}word_embeddings.weight", f"{pre}embeddings.word_embeddings.weight")
    r.add(f"{name}position_embeddings.weight", f"{pre}embeddings.position_embeddings.weight")
    r.add(f"{name}token_type_embeddings.weight",
          f"{pre}embeddings.token_type_embeddings.weight")
    r.norm(f"{name}embed_ln", f"{pre}embeddings.LayerNorm")
    if f"{pre}pooler.dense.weight" in r.keys:
        r.dense(f"{name}pooler", f"{pre}pooler.dense")
    else:
        H = cfg.hidden_size
        r.append(Rule((f"{name}pooler.weight", f"{name}pooler.bias"), (), "zeros",
                      shapes=((H, H), (H,))))
    for i in range(cfg.num_hidden_layers):
        b, p = f"{pre}encoder.layer.{i}.", f"{name}layer_{i}."
        for n, k in (("query", "attention.self.query"), ("key", "attention.self.key"),
                     ("value", "attention.self.value"), ("attn_out", "attention.output.dense"),
                     ("intermediate", "intermediate.dense"), ("output", "output.dense")):
            r.dense(p + n, b + k)
        r.norm(p + "attn_ln", b + "attention.output.LayerNorm")
        r.norm(p + "out_ln", b + "output.LayerNorm")


def bert_rules(keys: Collection[str], cfg) -> List[Rule]:
    """bert-base-uncased names, with or without the ``bert.`` prefix
    (spider_tpu/models/convert.py:218-260); without a pooler in the
    checkpoint the pooler is zero, as the reference fills it."""
    r = _Rules(keys)
    _bert(r, "", "bert." if any(k.startswith("bert.") for k in keys) else "", cfg)
    return r


def convert_bert_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return convert_state_dict(bert_rules(sd, cfg), sd)


def _fused_qkv(r: _Rules, names: Tuple[str, str, str], key: str, suffix: str = "") -> None:
    """A fused [3C, ...] projection and its bias -> three Linears."""
    for part in ("weight", "bias"):
        r.append(Rule(tuple(f"{n}.{part}" for n in names), (f"{key}{part}{suffix}",), "qkv"))


def _swin(r: _Rules, name: str, pre: str, cfg) -> None:
    r.conv(f"{name}patch_embed", f"{pre}patch_embed.projection")
    r.norm(f"{name}patch_norm", f"{pre}patch_embed.norm")
    for s, depth in enumerate(cfg.depths):
        for b in range(depth):
            base, p = f"{pre}stages.{s}.blocks.{b}.", f"{name}stage{s}_block{b}."
            r.norm(p + "norm1", base + "norm1")
            r.norm(p + "norm2", base + "norm2")
            _fused_qkv(r, (p + "q", p + "k", p + "v"), base + "attn.w_msa.qkv.")
            r.dense(p + "proj", base + "attn.w_msa.proj")
            r.add(p + "rel_pos_bias", base + "attn.w_msa.relative_position_bias_table")
            r.dense(p + "fc1", base + "ffn.layers.0.0")
            r.dense(p + "fc2", base + "ffn.layers.1")
        if s < len(cfg.depths) - 1:
            r.norm(f"{name}merge{s}.norm", f"{pre}stages.{s}.downsample.norm")
            r.add(f"{name}merge{s}.reduction.weight", f"{pre}stages.{s}.downsample.reduction.weight",
                  "linear")
        if s in cfg.out_indices:
            r.norm(f"{name}out_norm{s}", f"{pre}norm{s}")


def swin_rules(keys: Collection[str], cfg, prefix: str = "backbone.") -> List[Rule]:
    """mmdet SwinTransformer names (spider_tpu/models/convert.py:609-651):
    the fused qkv split, the relative-position bias table as stored."""
    r = _Rules(keys)
    _swin(r, "", prefix, cfg)
    return r


def convert_swin_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return convert_state_dict(swin_rules(sd, cfg), sd)


def sam_rules(keys: Collection[str], cfg) -> List[Rule]:
    """Official SAM checkpoint names (spider_tpu/models/convert.py:429-533):
    the fused qkv split, the four point embeddings stacked, the upscaling
    ConvTranspose2d weights flipped (``tflip``, so the port computes what the
    reference's converter and module compute). mask_downscaling (mask-input
    prompts) is not read, as in the reference."""
    r = _Rules(keys)
    e, ie = "image_encoder.", "image_encoder."
    r.conv(e + "patch_embed", ie + "patch_embed.proj")
    r.add(e + "pos_embed", ie + "pos_embed")
    r.add(e + "neck_conv1.weight", ie + "neck.0.weight")
    r.norm(e + "neck_ln1", ie + "neck.1")
    r.add(e + "neck_conv2.weight", ie + "neck.2.weight")
    r.norm(e + "neck_ln2", ie + "neck.3")
    for i in range(cfg.encoder_layers):
        b, p = f"{ie}blocks.{i}.", f"{e}block_{i}."
        r.norm(p + "ln1", b + "norm1")
        r.norm(p + "ln2", b + "norm2")
        _fused_qkv(r, (p + "q", p + "k", p + "v"), b + "attn.qkv.")
        r.dense(p + "proj", b + "attn.proj")
        r.dense(p + "fc1", b + "mlp.lin1")
        r.dense(p + "fc2", b + "mlp.lin2")
        if b + "attn.rel_pos_h" in keys:
            r.add(p + "rel_pos_h", b + "attn.rel_pos_h")
            r.add(p + "rel_pos_w", b + "attn.rel_pos_w")
    pe = "prompt_encoder."
    r.add(pe + "pe_gaussian", pe + "pe_layer.positional_encoding_gaussian_matrix")
    r.append(Rule((pe + "point_embeddings",),
                  tuple(f"{pe}point_embeddings.{i}.weight" for i in range(4)), "cat"))
    r.add(pe + "not_a_point", pe + "not_a_point_embed.weight")
    r.add(pe + "no_mask_embed", pe + "no_mask_embed.weight")
    md = "mask_decoder."
    r.add(md + "iou_token", md + "iou_token.weight")
    r.add(md + "mask_tokens", md + "mask_tokens.weight")
    for n, k in (("upscale_1", "output_upscaling.0"), ("upscale_2", "output_upscaling.3")):
        r.add(f"{md}{n}.weight", f"{md}{k}.weight", "tflip")
        r.add(f"{md}{n}.bias", f"{md}{k}.bias")
    r.norm(md + "upscale_ln", md + "output_upscaling.1")
    t = md + "transformer."
    for part in ("q", "k", "v", "out"):
        r.dense(f"{md}final_{part}", f"{t}final_attn_token_to_image.{part}_proj")
    r.norm(md + "final_ln", t + "norm_final_attn")
    for i in range(cfg.decoder_depth):
        b, p = f"{t}layers.{i}.", f"{md}block_{i}."
        for name, key in (("self", "self_attn"), ("cross_qk", "cross_attn_token_to_image"),
                          ("cross_kq", "cross_attn_image_to_token")):
            for part in ("q", "k", "v", "out"):
                r.dense(f"{p}{name}_{part}", f"{b}{key}.{part}_proj")
        for j in range(1, 5):
            r.norm(f"{p}ln{j}", f"{b}norm{j}")
        r.dense(p + "fc1", b + "mlp.lin1")
        r.dense(p + "fc2", b + "mlp.lin2")
    for i in range(cfg.num_multimask_outputs + 1):
        h = f"{md}output_hypernetworks_mlps.{i}.layers."
        for j, n in enumerate(("fc0", "fc1", "out")):
            r.dense(f"{md}hyper_{i}_{n}", f"{h}{j}")
    for j, n in enumerate(("iou_fc0", "iou_fc1", "iou_out")):
        r.dense(md + n, f"{md}iou_prediction_head.layers.{j}")
    return r


def convert_sam_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return convert_state_dict(sam_rules(sd, cfg), sd)


# The HF BERT inside an mm_grounding_dino checkpoint.
DINO_BERT_PREFIX = "language_model.language_backbone.body.model."


def grounding_dino_rules(keys: Collection[str], cfg) -> List[Rule]:
    """mmdet GroundingDINO names (spider_tpu/models/convert.py:869-963):
    the Swin backbone under ``backbone.``, HF BERT under
    ``language_model.language_backbone.body.model.``, nn.MultiheadAttention's
    fused in_proj split; ContrastiveEmbed's scalar biases: the last decoder
    branch's is ``cls_bias``, the extra (encoder, two-stage) branch's
    ``enc_cls_bias``; the extra box branch is ``enc_box_head``."""
    r = _Rules(keys)
    L = cfg.dec_layers
    r.add("cls_bias", f"bbox_head.cls_branches.{L - 1}.bias")
    r.add("enc_cls_bias", f"bbox_head.cls_branches.{L}.bias")
    _swin(r, "backbone.", "backbone.", cfg.backbone)
    bert_pre = DINO_BERT_PREFIX + ("bert." if f"{DINO_BERT_PREFIX}bert.embeddings.LayerNorm.weight"
                                   in keys else "")
    _bert(r, "bert.", bert_pre, cfg.bert)
    r.dense("text_proj", "text_feat_map")
    r.add("level_embed", "level_embed")
    r.add("query_embedding", "query_embedding.weight")
    r.dense("enc_out_proj", "memory_trans_fc")
    r.norm("enc_out_ln", "memory_trans_norm")
    r.norm("decoder_norm", "decoder.norm")
    r.dense("ref_point_fc1", "decoder.ref_point_head.layers.0")
    r.dense("ref_point_fc2", "decoder.ref_point_head.layers.1")
    for i in range(cfg.num_levels - 1):
        r.conv(f"neck_in{i}", f"neck.convs.{i}.conv")
        r.norm(f"neck_gn{i}", f"neck.convs.{i}.gn")
    r.conv("neck_extra", "neck.extra_convs.0.conv")
    r.norm("neck_extra_gn", "neck.extra_convs.0.gn")

    def msda(name: str, key: str) -> None:
        for n in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            r.dense(f"{name}.{n}", f"{key}.{n}")

    def mha(name: str, key: str, parts: Tuple[str, str, str, str]) -> None:
        _fused_qkv(r, tuple(f"{name}.{p}" for p in parts[:3]), f"{key}.in_proj_")
        r.dense(f"{name}.{parts[3]}", f"{key}.out_proj")

    for i in range(cfg.enc_layers):
        img, txt, fus, p = (f"encoder.layers.{i}.", f"encoder.text_layers.{i}.",
                            f"encoder.fusion_layers.{i}.", f"enc_{i}")
        msda(f"{p}.msda", img + "self_attn")
        mha(p, txt + "self_attn.attn", ("txt_q", "txt_k", "txt_v", "txt_attn_out"))
        for side, key in (("img", img), ("txt", txt)):
            r.norm(f"{p}.{side}_ln1", key + "norms.0")
            r.norm(f"{p}.{side}_ln2", key + "norms.1")
            r.dense(f"{p}.{side}_fc1", key + "ffn.layers.0.0")
            r.dense(f"{p}.{side}_fc2", key + "ffn.layers.1")
        f = f"{p}.fusion."
        r.norm(f + "ln_img", fus + "layer_norm_v")
        r.norm(f + "ln_txt", fus + "layer_norm_l")
        for n, k in (("img_q", "v_proj"), ("txt_k", "l_proj"), ("img_v", "values_v_proj"),
                     ("txt_v", "values_l_proj"), ("img_out", "out_v_proj"),
                     ("txt_out", "out_l_proj")):
            r.dense(f + n, f"{fus}attn.{k}")
        r.add(f + "gamma_img", fus + "gamma_v")
        r.add(f + "gamma_txt", fus + "gamma_l")
    for i in range(L):
        d, p = f"decoder.layers.{i}.", f"dec_{i}"
        mha(p, d + "self_attn.attn", ("self_q", "self_k", "self_v", "self_out"))
        mha(p, d + "cross_attn_text.attn", ("txt_q", "txt_k", "txt_v", "txt_out"))
        msda(f"{p}.msda", d + "cross_attn")
        for j in range(4):
            r.norm(f"{p}.ln{j + 1}", f"{d}norms.{j}")
        r.dense(f"{p}.fc1", d + "ffn.layers.0.0")
        r.dense(f"{p}.fc2", d + "ffn.layers.1")
    for name, branch in [(f"dec_box_head_{i}", i) for i in range(L)] + [("enc_box_head", L)]:
        for n, j in (("fc0", 0), ("fc1", 2), ("out", 4)):
            r.dense(f"{name}.{n}", f"bbox_head.reg_branches.{branch}.{j}")
    return r


def convert_grounding_dino_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return convert_state_dict(grounding_dino_rules(sd, cfg), sd)


# ---- Qwen2.5-Omni: thinker towers, talker, token2wav ------------------------

def _prefixed(rules: Iterable[Rule], prefix: str) -> List[Rule]:
    """The rules with `prefix` put before every checkpoint key."""
    return [dataclasses.replace(r, keys=tuple(prefix + k for k in r.keys)) for r in rules]


def _key_prefix(keys: Collection[str], prefix: str) -> str:
    """`prefix` where a full-Omni checkpoint has it on its keys, else ''."""
    return prefix if any(k.startswith(prefix) for k in keys) else ""


def _inner_keys(keys: Collection[str], prefix: str) -> Set[str]:
    return {k[len(prefix):] for k in keys if k.startswith(prefix)}


def omni_audio_rules(keys: Collection[str], cfg, prefix: str = "audio_tower.") -> List[Rule]:
    """Qwen2_5OmniAudioEncoder names -> the port's OmniAudioEncoder
    (spider_tpu/models/convert.py:971-1003). The conv weights are torch's
    layout as stored; ``audio_bos_eos_token`` (unused at inference) and the
    sinusoid table (recomputed) are not read."""
    r = _Rules(keys)
    for n in ("conv1", "conv2"):
        r.add(f"{n}.weight", f"{prefix}{n}.weight")
        r.add(f"{n}.bias", f"{prefix}{n}.bias")
    r.norm("ln_post", prefix + "ln_post")
    r.dense("proj", prefix + "proj")
    for i in range(cfg.num_layers):
        b, p = f"{prefix}layers.{i}.", f"layer_{i}."
        r.norm(p + "self_attn_layer_norm", b + "self_attn_layer_norm")
        r.norm(p + "final_layer_norm", b + "final_layer_norm")
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            r.dense(f"{p}self_attn.{n}", f"{b}self_attn.{n}")
        r.dense(p + "fc1", b + "fc1")
        r.dense(p + "fc2", b + "fc2")
    return r


def omni_vision_rules(keys: Collection[str], cfg, prefix: str = "visual.") -> List[Rule]:
    """Qwen2_5OmniVisionEncoder names -> the port's OmniVisionEncoder
    (spider_tpu/models/convert.py:1006-1037): the bias-free Conv3d patch
    embedding flattened to a Linear over (C, tp, p, p) vectors (``flat``),
    the blocks' RMSNorm scales as raw parameters, the merger's MLP."""
    r = _Rules(keys)
    r.append(Rule(("patch_embed.weight",), (prefix + "patch_embed.proj.weight",), "flat",
                  shapes=((cfg.hidden_size, cfg.in_channels, cfg.temporal_patch_size,
                           cfg.patch_size, cfg.patch_size),)))
    r.add("ln_q", prefix + "merger.ln_q.weight")
    r.dense("merge_fc1", prefix + "merger.mlp.0")
    r.dense("merge_fc2", prefix + "merger.mlp.2")
    for i in range(cfg.depth):
        b, p = f"{prefix}blocks.{i}.", f"block_{i}."
        r.add(p + "norm1", b + "norm1.weight")
        r.add(p + "norm2", b + "norm2.weight")
        for n in ("q", "k", "v", "proj"):
            r.dense(f"{p}attn.{n}", f"{b}attn.{n}")
        for n, k in (("mlp_gate", "gate_proj"), ("mlp_up", "up_proj"), ("mlp_down", "down_proj")):
            r.dense(p + n, f"{b}mlp.{k}")
    return r


def omni_thinker_rules(keys: Collection[str], audio_cfg, vision_cfg, llm_cfg
                       ) -> Tuple[List[Rule], List[Rule], List[Rule]]:
    """(audio, vision, llm) rule sets of a thinker checkpoint, bare or with
    the full Omni's ``thinker.`` prefix (spider_tpu/models/convert.py:1040-1053):
    the towers under ``audio_tower.`` and ``visual.``, the Qwen2 decoder's
    ``model.*`` and ``lm_head.*`` through ``llama_rules``."""
    pre = _key_prefix(keys, "thinker.")
    inner = _inner_keys(keys, pre)
    return (_prefixed(omni_audio_rules(inner, audio_cfg), pre),
            _prefixed(omni_vision_rules(inner, vision_cfg), pre),
            _prefixed(llama_rules({k for k in inner if k.startswith(("model.", "lm_head."))},
                                  llm_cfg), pre))


def omni_talker_rules(keys: Collection[str], cfg, prefix: str = "talker.") -> List[Rule]:
    """Qwen2_5OmniTalkerForConditionalGeneration names -> the port's
    OmniTalker (spider_tpu/models/convert.py:1056-1077): the Qwen2 body's
    ``model.*`` through ``llama_rules`` (its embedding is the codec
    embedding), ``thinker_to_talker_proj`` and ``codec_head``; bare or
    ``talker.``-prefixed."""
    pre = _key_prefix(keys, prefix)
    inner = _inner_keys(keys, pre)
    r = _Rules(inner)
    r.extend(llama_rules({k for k in inner if k.startswith("model.")}, cfg.as_llama()))
    r.dense("thinker_to_talker_proj", "thinker_to_talker_proj")
    r.add("codec_head.weight", "codec_head.weight")
    return _prefixed(r, pre)


def _tdnn(r: _Rules, name: str, key: str) -> None:
    r.add(f"{name}.conv.weight", f"{key}.conv.weight")
    r.add(f"{name}.conv.bias", f"{key}.conv.bias")


def _k1_dense(r: _Rules, name: str, key: str) -> None:
    r.add(f"{name}.weight", f"{key}.weight", "k1")
    if f"{key}.bias" in r.keys:
        r.add(f"{name}.bias", f"{key}.bias")


def omni_dit_rules(keys: Collection[str], cfg,
                   prefix: str = "token2wav.code2wav_dit_model.") -> List[Rule]:
    """Qwen2_5OmniToken2WavDiTModel names -> the port's DiTModel
    (spider_tpu/models/convert.py:1094-1142): the ECAPA encoder's kernel-1
    convolutions that the port holds as Linears (``k1``); the rotary table
    ``rotary_embed.inv_freq`` (recomputed) is not read."""
    pre = _key_prefix(keys, prefix)
    r = _Rules(_inner_keys(keys, pre))
    e, enc = "spk_encoder.", "input_embed.spk_encoder."
    _tdnn(r, e + "block_0", enc + "blocks.0")
    _tdnn(r, e + "mfa", enc + "mfa")
    _tdnn(r, e + "asp.tdnn", enc + "asp.tdnn")
    _k1_dense(r, e + "asp.conv", enc + "asp.conv")
    _k1_dense(r, e + "fc", enc + "fc")
    for i in range(1, len(cfg.enc_channels) - 1):
        b, p = f"{enc}blocks.{i}.", f"{e}block_{i}."
        _tdnn(r, p + "tdnn1", b + "tdnn1")
        _tdnn(r, p + "tdnn2", b + "tdnn2")
        for j in range(cfg.enc_res2net_scale - 1):
            _tdnn(r, f"{p}res2net_block.block_{j}", f"{b}res2net_block.blocks.{j}")
        _k1_dense(r, p + "se_block.conv1", b + "se_block.conv1")
        _k1_dense(r, p + "se_block.conv2", b + "se_block.conv2")
    r.dense("time_mlp_in", "time_embed.time_mlp.0")
    r.dense("time_mlp_out", "time_embed.time_mlp.2")
    r.add("codec_embed.weight", "text_embed.codec_embed.weight")
    r.dense("input_proj", "input_embed.proj")
    r.dense("norm_out_linear", "norm_out.linear")
    r.dense("proj_out", "proj_out")
    for i in range(cfg.num_hidden_layers):
        b, p = f"transformer_blocks.{i}.", f"layer_{i}."
        r.dense(p + "attn_norm_linear", b + "attn_norm.linear")
        for n, k in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0")):
            r.dense(f"{p}attn.{n}", f"{b}attn.{k}")
        r.dense(p + "ff_in", b + "ff.ff.0")
        r.dense(p + "ff_out", b + "ff.ff.3")
    return _prefixed(r, pre)


def omni_bigvgan_rules(keys: Collection[str], cfg,
                       prefix: str = "token2wav.code2wav_bigvgan_model.") -> List[Rule]:
    """Qwen2_5OmniToken2WavBigVGANModel names -> the port's BigVGAN
    (spider_tpu/models/convert.py:1145-1187): AMP block i*R+j as ``res_<i>_<j>``,
    its SnakeBeta pairs ``activations.2m``/``2m+1`` as ``act1_<m>``/``act2_<m>``;
    the ConvTranspose1d weights [in, out, k] are the port's layout as stored."""
    pre = _key_prefix(keys, prefix)
    r = _Rules(_inner_keys(keys, pre))

    def snake(name: str, key: str) -> None:
        r.add(f"{name}.alpha", f"{key}.alpha")
        r.add(f"{name}.beta", f"{key}.beta")

    r.add("conv_pre.weight", "conv_pre.weight")
    r.add("conv_pre.bias", "conv_pre.bias")
    snake("activation_post", "activation_post.act")
    r.add("conv_post.weight", "conv_post.weight")
    R = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        r.add(f"up_{i}.weight", f"ups.{i}.0.weight")
        r.add(f"up_{i}.bias", f"ups.{i}.0.bias")
        for j in range(R):
            b, p = f"resblocks.{i * R + j}.", f"res_{i}_{j}."
            for m in range(len(cfg.resblock_dilation_sizes[j])):
                for n, k in ((f"conv1_{m}", f"convs1.{m}"), (f"conv2_{m}", f"convs2.{m}")):
                    r.add(f"{p}{n}.weight", f"{b}{k}.weight")
                    r.add(f"{p}{n}.bias", f"{b}{k}.bias")
                snake(f"{p}act1_{m}", f"{b}activations.{2 * m}.act")
                snake(f"{p}act2_{m}", f"{b}activations.{2 * m + 1}.act")
    return _prefixed(r, pre)


# config.json node and key -> the port's config field, for each part
_OMNI_CONFIG_FIELDS = {
    "llm": (("thinker_config", "text_config"), {
        "vocab_size": "vocab_size", "hidden_size": "hidden_size",
        "intermediate_size": "intermediate_size", "num_hidden_layers": "num_hidden_layers",
        "num_attention_heads": "num_attention_heads",
        "num_key_value_heads": "num_key_value_heads", "rope_theta": "rope_theta",
        "rms_norm_eps": "rms_norm_eps"}),
    "audio": (("thinker_config", "audio_config"), {
        "num_mel_bins": "num_mel_bins", "d_model": "d_model", "encoder_layers": "num_layers",
        "encoder_attention_heads": "num_heads", "encoder_ffn_dim": "ffn_dim",
        "n_window": "n_window", "max_source_positions": "max_positions",
        "output_dim": "output_dim"}),
    "vision": (("thinker_config", "vision_config"), {
        "depth": "depth", "hidden_size": "hidden_size", "intermediate_size": "intermediate_size",
        "num_heads": "num_heads", "in_channels": "in_channels", "patch_size": "patch_size",
        "spatial_merge_size": "spatial_merge_size",
        "temporal_patch_size": "temporal_patch_size", "window_size": "window_size",
        "out_hidden_size": "out_hidden_size", "fullatt_block_indexes": "fullatt_block_indexes"}),
    "talker": (("talker_config",), {
        "vocab_size": "vocab_size", "embedding_size": "embedding_size",
        "hidden_size": "hidden_size", "intermediate_size": "intermediate_size",
        "num_hidden_layers": "num_hidden_layers", "num_attention_heads": "num_attention_heads",
        "num_key_value_heads": "num_key_value_heads", "head_dim": "head_dim",
        "rope_theta": "rope_theta", "rms_norm_eps": "rms_norm_eps",
        "tts_codec_start_token_id": "codec_bos", "tts_codec_end_token_id": "codec_eos",
        "tts_codec_pad_token_id": "codec_pad", "tts_codec_mask_token_id": "codec_mask",
        "tts_text_start_token_id": "text_bos", "tts_text_end_token_id": "text_eos",
        "tts_text_pad_token_id": "text_pad"}),
}


def read_omni_config(path: Optional[str]) -> Dict[str, Dict[str, Any]]:
    """What an HF Qwen2.5-Omni ``config.json`` in `path` states of each part
    ({'llm', 'audio', 'vision', 'talker'}: {port config field: value}), {}
    where there is none. The builders replace their ``*_full`` preset's
    fields with these, so a checkpoint's widths and depths are followed
    (``talker_full`` is transformers' class default, not necessarily the
    talker a checkpoint holds); what the file leaves out stays the preset's."""
    if not path or not os.path.isfile(os.path.join(path, "config.json")):
        return {}
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    out: Dict[str, Dict[str, Any]] = {}
    for part, (where, fields) in _OMNI_CONFIG_FIELDS.items():
        node = hf
        for key in where:
            node = node.get(key, {})
        got = {field: tuple(node[key]) if isinstance(node[key], list) else node[key]
               for key, field in fields.items() if key in node}
        section = (node.get("rope_scaling") or {}).get("mrope_section")
        if section is not None and part in ("llm", "talker"):
            got["mrope_section"] = tuple(section)
        if got:
            out[part] = got
    return out


def load_omni_thinker(path: str, audio: nn.Module, vision: nn.Module, llm: nn.Module) -> None:
    """Stream a thinker checkpoint (a Qwen2.5-Omni directory or file) into
    the three modules on their devices, in their dtypes."""
    with open_state_dict(path) as sd:
        ra, rv, rl = omni_thinker_rules(sd, audio.config, vision.config, llm.config)
        for module, rules in ((audio, ra), (vision, rv), (llm, rl)):
            load_converted(module, rules, sd)


def load_omni_speech(path: str, talker: nn.Module, dit: nn.Module, vocoder: nn.Module) -> None:
    """Stream a Qwen2.5-Omni checkpoint's talker and token2wav keys into
    the three modules."""
    with open_state_dict(path) as sd:
        for module, rules in ((talker, omni_talker_rules(sd, talker.config)),
                              (dit, omni_dit_rules(sd, dit.config)),
                              (vocoder, omni_bigvgan_rules(sd, vocoder.config))):
            load_converted(module, rules, sd)
