"""StyleGAN2 discriminator with minibatch stddev on NCHW tensors (counterpart
of gen_adversarial_tpu/models/stylegan2/discriminator.py; the reference's
StyleGan_Trans/models/stylegan2/model.py:616-674): a 1 x 1 `conv_in`, one
downsampling ResBlock `res_{i}` per resolution 2^i from the input's down to
8 px, the minibatch-stddev channel, `final_conv` at 4 px, then
`final_linear0` (with the fused activation) and `final_linear1` to one
logit.

Every ResBlock blurs twice before its stride-2 convolutions, through K2 on a
CUDA tensor (models/stylegan2/layers.py): at pad (2, 2) before the 3 x 3
conv2 and at pad (1, 1) before the 1 x 1 skip, at (C, H) = (in channels, the
block's resolution); a 1024-px forward launches it 16 times and its input
gradient 16 more.

The stddev follows the reference's NCHW grouping
`view(group, -1, f, c // f, h, w)` (the JAX NHWC reshape and its
channel-major flatten exist to match it).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gen_adversarial_tpu_torch.models.stylegan2.generator import generator_channels
from gen_adversarial_tpu_torch.models.stylegan2.layers import ConvLayer, EqualLinear, ResBlock


class Discriminator(nn.Module):
    def __init__(self, size: int, channel_multiplier: int = 2, stddev_group: int = 4,
                 stddev_feat: int = 1, device=None):
        super().__init__()
        ch = generator_channels(channel_multiplier)
        self.stddev_group, self.stddev_feat = stddev_group, stddev_feat
        self.conv_in = ConvLayer(3, ch[size], 1, device=device)
        in_ch = ch[size]
        self.blocks = []
        for i in range(int(math.log2(size)), 2, -1):
            out_ch = ch[2 ** (i - 1)]
            self.add_module(f"res_{i}", ResBlock(in_ch, out_ch, device=device))
            self.blocks.append(f"res_{i}")
            in_ch = out_ch
        self.final_conv = ConvLayer(in_ch + stddev_feat, ch[4], 3, device=device)
        self.final_linear0 = EqualLinear(ch[4] * 4 * 4, ch[4], activation=True, device=device)
        self.final_linear1 = EqualLinear(ch[4], 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """images (B, 3, size, size) -> logits (B, 1)."""
        y = self.conv_in(x.contiguous(memory_format=torch.channels_last))
        for name in self.blocks:
            y = getattr(self, name)(y)
        b, c, h, w = y.shape
        group, f = min(b, self.stddev_group), self.stddev_feat
        std = y.reshape(group, -1, f, c // f, h, w)
        std = torch.sqrt(std.var(0, unbiased=False) + 1e-8)
        std = std.mean((2, 3, 4), keepdim=True).squeeze(2)  # (B / group, f, 1, 1)
        y = torch.cat([y, std.repeat(group, 1, h, w)], 1)
        y = self.final_conv(y)
        return self.final_linear1(self.final_linear0(y.reshape(b, -1)))
