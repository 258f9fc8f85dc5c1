"""StyleGAN2 generator on NCHW tensors (counterpart of
gen_adversarial_tpu/models/stylegan2/generator.py): the 8-layer equalized-lr
style MLP, the constant 4x4 input, the up-sampling StyledConv trunk, the
ToRGB skip pyramid and the fixed per-layer noise buffers `noise_{i}`
(randomize_noise=False), at the configuration the E4E and Style-Transformer
purifiers use: 512-wide styles, an 8-layer MLP at lr_mul 0.01, channel
multiplier 2. The defense's decode feeds it w codes directly
(input_is_latent=True with one (B, n_latent, 512) tensor), which is the one
mode this module runs.

Only the logical layout is ported: the JAX generator's phase-domain top
block (space-to-depth, `phase_min_res` / `phase_rgb`) is a TPU
reformulation of the same math.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gen_adversarial_tpu_torch.models.stylegan2.layers import (
    STYLE_DIM, EqualLinear, StyledConv, ToRGB, pixel_norm)

N_MLP = 8
LR_MLP = 0.01
# channels per resolution at channel multiplier 2
GENERATOR_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 512, 128: 256, 256: 128,
                      512: 64, 1024: 32}


class Generator(nn.Module):
    def __init__(self, size: int, device=None):
        super().__init__()
        self.size = size
        ch = GENERATOR_CHANNELS
        self.style = nn.ModuleList(
            EqualLinear(STYLE_DIM, STYLE_DIM, lr_mul=LR_MLP, activation=True, device=device)
            for _ in range(N_MLP))
        self.const_input = nn.Parameter(torch.empty(1, ch[4], 4, 4, device=device))
        self.conv1 = StyledConv(ch[4], ch[4], device=device)
        self.to_rgb1 = ToRGB(ch[4], device=device)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = ch[4]
        for i in range(3, self.log_size + 1):
            out_ch = ch[2 ** i]
            self.convs.append(StyledConv(in_ch, out_ch, upsample=True, device=device))
            self.convs.append(StyledConv(out_ch, out_ch, device=device))
            self.to_rgbs.append(ToRGB(out_ch, device=device))
            in_ch = out_ch
        for i in range(self.num_layers):
            r = 2 ** ((i + 5) // 2)
            self.register_buffer(f"noise_{i}", torch.empty(1, 1, r, r, device=device))

    @property
    def log_size(self) -> int:
        return int(math.log2(self.size))

    @property
    def num_layers(self) -> int:
        return (self.log_size - 2) * 2 + 1

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2

    def run_style(self, z: torch.Tensor) -> torch.Tensor:
        """The style MLP: z (B, 512) -> w."""
        z = pixel_norm(z)
        for layer in self.style:
            z = layer(z)
        return z

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """latent: w codes (B, n_latent, 512) -> images (B, 3, size, size),
        with the fixed noise buffers."""
        noise = [getattr(self, f"noise_{i}") for i in range(self.num_layers)]
        out = self.const_input.expand(latent.shape[0], -1, -1, -1)
        out = self.conv1(out, latent[:, 0], noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for j in range(0, len(self.convs), 2):
            out = self.convs[j](out, latent[:, i], noise[j + 1])
            out = self.convs[j + 1](out, latent[:, i + 1], noise[j + 2])
            skip = self.to_rgbs[j // 2](out, latent[:, i + 2], skip)
            i += 2
        return skip
