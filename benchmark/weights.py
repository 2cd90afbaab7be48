"""Random weights from the seed, made on the device in one draw.

``fill(specs, seed, device, dtype)`` takes {name: shape} and returns {name:
tensor} of views into one buffer: a norm's weight 1 and its bias 0 (a name
whose module, the part before the last dot, holds "norm"), every other
tensor N(0, 0.02), drawn by one ``torch.randn`` from a generator on the
device seeded from the seed, in the dtype the model is served in. The same
seed gives the same values in the program's modules and in the reference,
which takes them in fp32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

STD = 0.02


def derive_seed(*parts: int) -> int:
    """A 63-bit seed from whole numbers of any size and sign (the run's seed
    and an index), the same on every machine."""
    zigzag = [2 * int(p) if int(p) >= 0 else -2 * int(p) - 1 for p in parts]
    words = np.random.SeedSequence(zigzag).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def is_norm(name: str) -> bool:
    module = name.rsplit(".", 1)[0]
    return "norm" in module.rsplit(".", 1)[-1]


def fill(specs: Dict[str, Tuple[int, ...]], seed: int, device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    total = sum(int(np.prod(s)) for s in specs.values())
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 0))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device).mul_(STD)
    out, at = {}, 0
    for name in sorted(specs):
        shape = tuple(specs[name])
        n = int(np.prod(shape))
        t = flat[at:at + n].view(shape)
        at += n
        if is_norm(name):
            t.fill_(1.0 if name.endswith(".weight") else 0.0)
        out[name] = t
    return out


def module_specs(modules: Dict[str, torch.nn.Module]) -> Dict[str, Tuple[int, ...]]:
    """{prefix.name: shape} of every parameter and persistent buffer of each
    module, under its prefix."""
    specs = {}
    for prefix, module in modules.items():
        for name, t in module.state_dict().items():
            specs[f"{prefix}.{name}"] = tuple(t.shape)
    return specs


@torch.no_grad()
def load_into(modules: Dict[str, torch.nn.Module], values: Dict[str, torch.Tensor]) -> None:
    """Copy values into the modules' tensors, every one of them, in place."""
    for prefix, module in modules.items():
        for name, t in module.state_dict(keep_vars=True).items():
            t.copy_(values[f"{prefix}.{name}"])
