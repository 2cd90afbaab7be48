"""The SD VAE's decoder, plain fp32: scaled latents [N, h, w, 4] -> images
[N, H, W, 3] in the decoder's raw range. GroupNorm eps 1e-6 throughout, a
single-head attention at the lowest resolution, nearest 2x upsampling.
Parameter names are those of the weights the benchmark fills
(``decoder.up_0_res_1.conv1``, ...)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import Conv, Lin, attention


class Resnet(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class AttnBlock(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (Lin(ch, ch) for _ in range(4))

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_out(attention(self.q(h), self.k(h), self.v(h), 1))
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        chs, g, lc = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["latent_channels"]
        self.layers = cfg["layers_per_block"]
        self.n = len(chs)
        self.post_quant_conv = Conv(lc, lc, 1)
        cur = chs[-1]
        self.conv_in = Conv(lc, cur, 3, padding=1)
        self.mid_res_0 = Resnet(cur, cur, g)
        self.mid_attn = AttnBlock(cur, g)
        self.mid_res_1 = Resnet(cur, cur, g)
        for i, ch in enumerate(reversed(chs)):
            for j in range(self.layers + 1):
                self.add_module(f"up_{i}_res_{j}", Resnet(cur, ch, g))
                cur = ch
            if i < self.n - 1:
                self.add_module(f"up_{i}_upsample", Conv(ch, ch, 3, padding=1))
        self.norm_out = nn.GroupNorm(g, cur, eps=1e-6)
        self.conv_out = Conv(cur, cfg["out_channels"], 3, padding=1)

    def forward(self, z):
        x = self.conv_in(self.post_quant_conv(z))
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        for i in range(self.n):
            for j in range(self.layers + 1):
                x = getattr(self, f"up_{i}_res_{j}")(x)
            if i < self.n - 1:
                x = getattr(self, f"up_{i}_upsample")(F.interpolate(x, scale_factor=2,
                                                                    mode="nearest"))
        return self.conv_out(F.silu(self.norm_out(x)))


class VAEDecode(nn.Module):
    """decode(latents [N, h, w, C]) -> [N, H, W, 3]: latents divided by the
    scaling factor, through the decoder."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.scaling_factor = cfg["scaling_factor"]
        self.decoder = Decoder(cfg)

    def forward(self, z):
        x = self.decoder((z / self.scaling_factor).permute(0, 3, 1, 2))
        return x.permute(0, 2, 3, 1)
