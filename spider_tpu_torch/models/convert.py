"""Fill the port's modules from the JAX package's parameter trees.

``load_jax_params(module, params)`` takes the tree that a JAX module's
``init`` returns (or the output of spider_tpu/models/convert.py for real
HF/diffusers checkpoints), as numpy or JAX arrays, and copies it into the
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

from typing import Any, Dict, Mapping, Optional, Set

import numpy as np
import torch
from torch import nn


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
        if arr.ndim != 2:
            raise NotImplementedError(f"no JAX layout rule for a {type(mod).__name__} weight")
        return "kernel", arr.T
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
    if spider.llama_proj is not None:
        tree["llama_proj"] = to_jax_tree(spider.llama_proj)
    if spider.moe_aligner is not None:
        tree["moe_aligner"] = {"params": to_jax_tree(spider.moe_aligner)}
    else:
        tree["aligners"] = {m: {"params": to_jax_tree(a)} for m, a in spider.aligners.items()}
    return tree
