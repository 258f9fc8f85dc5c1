"""StyleGAN2 generator on NCHW tensors (counterpart of
gen_adversarial_tpu/models/stylegan2/generator.py): the 8-layer equalized-lr
style MLP, the constant 4x4 input, the up-sampling StyledConv trunk, the
ToRGB skip pyramid and the fixed per-layer noise buffers `noise_{i}`, with
512-wide styles, the MLP at lr_mul 0.01 and channels by
`generator_channels(channel_multiplier)` (2 for the E4E and
Style-Transformer purifiers).

The forward is the JAX one: styles are z (through the style MLP) or w
(input_is_latent), truncated towards a truncation_latent, mixed at an
explicit inject_index where there are two; noise is the stored buffers
(randomize_noise=False, the defenses' decode), given maps, or fresh maps
from explicit draws (`noise_draws`: a torch.Generator, or the maps replayed
in layer order), never drawn implicitly; per-layer weights_deltas reach the
modulated convolutions. Randomness is explicit as in the JAX package, where
the reference draws at call time.

Only the logical layout is ported: the JAX generator's phase-domain top
block (space-to-depth, `phase_min_res` / `phase_rgb`) is a TPU
reformulation of the same math.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
from torch import nn

from gen_adversarial_tpu_torch.models.nvae.distributions import as_draws
from gen_adversarial_tpu_torch.models.stylegan2.layers import (
    STYLE_DIM, EqualLinear, StyledConv, ToRGB, pixel_norm)

N_MLP = 8
LR_MLP = 0.01


def generator_channels(channel_multiplier: int = 2) -> dict:
    """Channels per resolution."""
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * channel_multiplier,
            128: 128 * channel_multiplier, 256: 64 * channel_multiplier,
            512: 32 * channel_multiplier, 1024: 16 * channel_multiplier}


GENERATOR_CHANNELS = generator_channels(2)


class Generator(nn.Module):
    def __init__(self, size: int, channel_multiplier: int = 2, device=None):
        super().__init__()
        self.size = size
        ch = generator_channels(channel_multiplier)
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

    def _noise_shape(self, i: int, b: int = 1) -> tuple:
        r = 2 ** ((i + 5) // 2)
        return (b, 1, r, r)

    def make_noise(self, draws) -> list[torch.Tensor]:
        """Fresh per-layer noise maps (1, 1, r, r) from `draws` (a
        torch.Generator or the maps replayed in order)."""
        draws = as_draws(draws)
        return [draws.normal(self._noise_shape(i), self.const_input)
                for i in range(self.num_layers)]

    def mean_latent(self, n_latent: int, draws) -> torch.Tensor:
        """The mean w of n_latent z ~ N(0, 1) from `draws`, (1, 512)."""
        z = as_draws(draws).normal((n_latent, STYLE_DIM), self.const_input)
        return self.run_style(z).mean(0, keepdim=True)

    def forward(self, styles: Sequence[torch.Tensor], input_is_latent: bool = False,
                inject_index: int | None = None, truncation: float = 1.0,
                truncation_latent: torch.Tensor | None = None,
                noise: Sequence[torch.Tensor] | None = None, randomize_noise: bool = True,
                noise_draws=None, weights_deltas: Sequence | None = None,
                return_latents: bool = False):
        """(images (B, 3, size, size), the latents (B, n_latent, 512) if
        return_latents else None).

        styles: a list of (B, 512) codes or one (B, n_latent, 512) tensor.
        randomize_noise=False takes the stored buffers; True draws each
        layer's (B, 1, r, r) map from noise_draws (required; the maps in
        layer order when replayed). weights_deltas: one per modulated
        convolution (conv1, to_rgb1, then each block's two convolutions and
        ToRGB), each None or (B, out, in, k, k)."""
        total_convs = len(self.convs) + len(self.to_rgbs) + 2
        if weights_deltas is None:
            weights_deltas = [None] * total_convs
        if not input_is_latent:
            styles = [self.run_style(s) for s in styles]
        draws = None
        if noise is None:
            if randomize_noise:
                if noise_draws is None:
                    raise ValueError("randomize_noise=True needs noise_draws (pass "
                                     "randomize_noise=False to use the stored buffers)")
                draws = as_draws(noise_draws)
            else:
                noise = [getattr(self, f"noise_{i}") for i in range(self.num_layers)]
        if truncation < 1:
            styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]

        if len(styles) < 2:
            latent = styles[0]
            if latent.dim() < 3:
                latent = latent[:, None].expand(-1, self.n_latent, -1)
        else:
            if inject_index is None:
                raise ValueError("style mixing needs an explicit inject_index (the reference "
                                 "draws random.randint at call time)")
            latent = torch.cat([
                styles[0][:, None].expand(-1, inject_index, -1),
                styles[1][:, None].expand(-1, self.n_latent - inject_index, -1)], 1)

        b = latent.shape[0]

        def layer_noise(i):
            if draws is None:
                return noise[i]
            return draws.normal(self._noise_shape(i, b), self.const_input)

        out = self.const_input.expand(b, -1, -1, -1)
        out = self.conv1(out, latent[:, 0], layer_noise(0), weights_deltas[0])
        skip = self.to_rgb1(out, latent[:, 1], weights_delta=weights_deltas[1])
        i, widx = 1, 2
        for j in range(0, len(self.convs), 2):
            out = self.convs[j](out, latent[:, i], layer_noise(j + 1), weights_deltas[widx])
            out = self.convs[j + 1](out, latent[:, i + 1], layer_noise(j + 2),
                                    weights_deltas[widx + 1])
            skip = self.to_rgbs[j // 2](out, latent[:, i + 2], skip,
                                        weights_delta=weights_deltas[widx + 2])
            i += 2
            widx += 3
        return skip, (latent if return_latents else None)
