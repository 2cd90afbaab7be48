"""1-D convolution helpers (counterpart of spider_tpu/ops/convs.py).

The JAX package writes ``ConvTranspose1dTorch`` as an explicit dilated
convolution because flax's own transposed convolution crops differently;
what it emulates is torch's ``nn.ConvTranspose1d`` with
padding (kernel_size - stride) // 2, so here it is that module. Its JAX
kernel is [k, in, out], applied time-flipped; the torch weight is
[in, out, k], applied as is, so ``convert.load_jax_params`` carries it over
with a transpose and no flip.

``UpsampleNearestConv`` is not ported: no decoder uses it.
"""

from __future__ import annotations

from torch import nn


class ConvTranspose1dTorch(nn.ConvTranspose1d):
    """torch.nn.ConvTranspose1d(in_channels, features, kernel_size, stride,
    padding=(kernel_size - stride) // 2) on [B, C, T]. The output has
    (T - 1) * stride + kernel_size - 2 * padding steps: stride * T, plus one
    where kernel_size - stride is odd."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int,
                 bias: bool = True, dtype=None, device=None):
        super().__init__(in_channels, features, kernel_size, stride=stride,
                         padding=(kernel_size - stride) // 2, bias=bias, dtype=dtype,
                         device=device)
