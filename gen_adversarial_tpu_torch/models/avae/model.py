"""The A-VAE competitor on NCHW tensors (counterpart of
gen_adversarial_tpu/models/avae/model.py): a StyleGAN-like VAE purifier
(encoder, styled progression with an encoder skip, 4-layer style MLP) and
its WGAN critic.

Equalized learning rate is applied at call time: conv and linear weights
are scaled by sqrt(2 / fan_in), a noise weight by sqrt(2 / C). Weights keep
the JAX names and are stored in torch layouts: `AEqualConv2d.weight` and
`FusedDownsample.weight` (out, in, k, k), `FusedUpsample.weight` (in, out,
k, k) (the layout of `conv_transpose2d`), `AEqualLinear.weight` (out, in),
`ANoiseInjection.weight` (1, C, 1, 1), `const_input` (1, C, 4, 4);
core/convert.py maps them. `FLAX_INIT` names the flax initializer of each
leaf (core/init.py).

As in the JAX package, `EncodeConvBlock` has no norm: the reference computes
an InstanceNorm there and discards its result.

Random draws come from a `Draws` source (models/nvae/distributions.py): the
noise maps first, one (B, 1, 4 * 2**i, 4 * 2**i) map per progression step
(both noise injections of a step share it), then the latent's eps of the
mean's shape (B, 512, 4, 4).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gen_adversarial_tpu_torch.models.nvae.distributions import as_draws
from gen_adversarial_tpu_torch.models.stylegan2.layers import pixel_norm

STYLE_DIM = 512
LATENT_CHANNELS = 512
INFERENCE_TEMPERATURE = 0.6

BINOMIAL3 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 16.0


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


@contextlib.contextmanager
def leaky_relu_branches(masks=None):
    """Within the block every leaky ReLU of this module appends its branch
    (input > 0) to the list it yields, in call order; given `masks` from such
    a run, each takes its branch from them, in the same order, instead of
    from its input's sign, and appends the number of elements whose branch
    that changed.

    A float32 run and a float64 run of the same inputs take different slopes
    where an input lies within rounding of 0, and the gradient then differs
    by 0.8 of that element's cotangent; a float64 run on the float32 run's
    branches differs from it by rounding alone."""
    global _lrelu
    plain, taken = _lrelu, []
    replay = None if masks is None else iter(masks)

    def branched(x):
        if replay is None:
            taken.append(x.detach() > 0)
            return plain(x)
        mask = next(replay, None)
        if mask is None or mask.shape != x.shape:
            raise ValueError(f"no recorded branch of shape {tuple(x.shape)} left")
        mask = mask.to(x.device)
        taken.append(torch.count_nonzero(mask != (x.detach() > 0)))
        return torch.where(mask, x, 0.2 * x)

    _lrelu = branched
    try:
        yield taken
    finally:
        _lrelu = plain


def _equal_weight(out_ch: int, in_ch: int, k: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(out_ch, in_ch, k, k, device=device))


class AEqualConv2d(nn.Module):
    """Equalized-lr convolution: weight * sqrt(2 / fan_in) at call."""

    FLAX_INIT = {"weight": "normal", "bias": "zeros"}

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.mult = math.sqrt(2.0 / (in_ch * kernel_size * kernel_size))
        self.weight = _equal_weight(out_ch, in_ch, kernel_size, device)
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x):
        return F.conv2d(x, self.weight * self.mult, self.bias, self.stride, self.padding)


class AEqualLinear(nn.Module):
    FLAX_INIT = {"weight": "normal", "bias": "zeros"}

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.mult = math.sqrt(2.0 / in_dim)
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, device=device))
        self.bias = nn.Parameter(torch.empty(out_dim, device=device))

    def forward(self, x):
        return F.linear(x, self.weight * self.mult, self.bias)


def _smooth4(w):
    """pad 1 + the mean of 4 shifted copies over the last two dims: the
    k -> k + 1 smoothing of the fused up- and down-sampling kernels."""
    w = F.pad(w, (1, 1, 1, 1))
    return (w[..., 1:, 1:] + w[..., :-1, 1:] + w[..., 1:, :-1] + w[..., :-1, :-1]) / 4.0


class FusedUpsample(nn.Module):
    """Stride-2 transposed convolution with the smoothed kernel. The JAX
    package writes it as a convolution of the 2x-dilated input with the
    flipped kernel, which is what `conv_transpose2d` computes."""

    FLAX_INIT = {"weight": "normal", "bias": "zeros"}

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, padding: int = 0,
                 device=None):
        super().__init__()
        self.padding = padding
        self.mult = math.sqrt(2.0 / (in_ch * kernel_size * kernel_size))
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel_size, kernel_size,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x):
        return F.conv_transpose2d(x, _smooth4(self.weight * self.mult), self.bias,
                                  stride=2, padding=self.padding)


class FusedDownsample(nn.Module):
    """Stride-2 convolution with the smoothed kernel."""

    FLAX_INIT = {"weight": "normal", "bias": "zeros"}

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, padding: int = 0,
                 device=None):
        super().__init__()
        self.padding = padding
        self.mult = math.sqrt(2.0 / (in_ch * kernel_size * kernel_size))
        self.weight = _equal_weight(out_ch, in_ch, kernel_size, device)
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x):
        return F.conv2d(x, _smooth4(self.weight * self.mult), self.bias, stride=2,
                        padding=self.padding)


def blur3(x):
    """The fixed 3x3 binomial depthwise blur."""
    c = x.shape[1]
    k = torch.as_tensor(BINOMIAL3, dtype=x.dtype, device=x.device)
    return F.conv2d(x, k.expand(c, 1, 3, 3), padding=1, groups=c)


def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm2d without affine: each map to mean 0, biased variance 1."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = torch.square(x - mean).mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class AdaptiveInstanceNorm(nn.Module):
    """InstanceNorm, then a per-channel affine from the style."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.style = AEqualLinear(STYLE_DIM, 2 * channels, device=device)

    def forward(self, x, style):
        gamma, beta = self.style(style)[:, :, None, None].chunk(2, dim=1)
        return gamma * instance_norm(x) + beta


class ANoiseInjection(nn.Module):
    """image + (weight * sqrt(2 / C)) * noise."""

    FLAX_INIT = {"weight": "zeros"}

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.mult = math.sqrt(2.0 / channels)
        self.weight = nn.Parameter(torch.empty(1, channels, 1, 1, device=device))

    def forward(self, image, noise):
        return image + (self.weight * self.mult) * noise


class StyledConvBlock(nn.Module):
    """One progression step: the constant input (initial), or a nearest or
    fused x2 upsample (then the blur), or a conv; noise, leaky ReLU, AdaIN;
    conv, the same noise, leaky ReLU, AdaIN."""

    FLAX_INIT = {"const_input": "normal"}

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, padding: int = 1,
                 initial: bool = False, upsample: bool = False, fused: bool = False,
                 device=None):
        super().__init__()
        self.initial, self.upsample, self.fused = initial, upsample, fused
        if initial:
            self.const_input = nn.Parameter(torch.empty(1, out_ch, 4, 4, device=device))
        elif upsample and fused:
            self.conv1_fused = FusedUpsample(in_ch, out_ch, kernel_size, padding, device)
        else:
            self.conv1 = AEqualConv2d(in_ch, out_ch, kernel_size, padding=padding,
                                      device=device)
        self.noise1 = ANoiseInjection(out_ch, device)
        self.adain1 = AdaptiveInstanceNorm(out_ch, device)
        self.conv2 = AEqualConv2d(out_ch, out_ch, kernel_size, padding=padding, device=device)
        self.noise2 = ANoiseInjection(out_ch, device)
        self.adain2 = AdaptiveInstanceNorm(out_ch, device)

    def forward(self, x, style, noise):
        if self.initial:
            out = self.const_input.expand(x.shape[0], -1, -1, -1)
        elif self.upsample and self.fused:
            out = blur3(self.conv1_fused(x))
        elif self.upsample:
            out = blur3(self.conv1(F.interpolate(x, scale_factor=2, mode="nearest")))
        else:
            out = self.conv1(x)
        out = self.adain1(_lrelu(self.noise1(out, noise)), style)
        out = self.conv2(out)
        return self.adain2(_lrelu(self.noise2(out, noise)), style)


class EncodeConvBlock(nn.Module):
    """conv3x3, leaky ReLU, stride-2 conv3x3, leaky ReLU (no norm)."""

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.conv1 = AEqualConv2d(in_ch, out_ch, 3, padding=1, device=device)
        self.conv2 = AEqualConv2d(out_ch, out_ch, 3, stride=2, padding=1, device=device)

    def forward(self, x):
        return _lrelu(self.conv2(_lrelu(self.conv1(x))))


class AVAEEncoder(nn.Module):
    """Three stride-2 blocks -> (skip, mu, logvar)."""

    def __init__(self, out_channels: int = LATENT_CHANNELS, device=None):
        super().__init__()
        self.out_channels = out_channels
        self.conv2 = EncodeConvBlock(3, out_channels // 2, device)
        self.conv3 = EncodeConvBlock(out_channels // 2, out_channels, device)
        self.conv4 = EncodeConvBlock(out_channels, 2 * out_channels, device)

    def forward(self, x):
        x1 = self.conv2(x)
        x = self.conv4(self.conv3(x1))
        return x1, x[:, :self.out_channels], x[:, self.out_channels:]


def avae_generator_plan(output_size: int):
    """(in_ch, out_ch, initial, upsample, fused) per progression step."""
    base = [(512, 512, True, False, False),
            (512, 512, False, True, False),
            (512, 512, False, True, False),
            (512 + 256, 256, False, True, True)]
    if output_size == 64:
        tail = [(256, 128, False, True, True)]
    elif output_size == 128:
        tail = [(256, 256, False, True, True), (256, 128, False, True, True)]
    elif output_size == 256:
        tail = [(256, 256, False, True, True), (256, 256, False, True, True),
                (256, 128, False, True, True)]
    else:
        raise NotImplementedError(output_size)
    return base + tail


def noise_shapes(output_size: int, batch: int) -> list[tuple[int, int, int, int]]:
    """NCHW shapes of the noise maps, in draw order."""
    return [(batch, 1, 4 * 2 ** i, 4 * 2 ** i)
            for i in range(len(avae_generator_plan(output_size)))]


class AVAEGenerator(nn.Module):
    """The styled progression, concatenating the encoder's skip at the step
    whose input has its resolution, then a 1x1 to RGB."""

    def __init__(self, output_size: int, device=None):
        super().__init__()
        self.progression = nn.ModuleList(
            StyledConvBlock(in_ch, out_ch, 3, 1, initial=initial, upsample=upsample,
                            fused=fused, device=device)
            for in_ch, out_ch, initial, upsample, fused in avae_generator_plan(output_size))
        self.to_rgb = AEqualConv2d(128, 3, 1, device=device)

    def forward(self, x_skip, out, style, noise):
        for i, block in enumerate(self.progression):
            if out.shape[2] == x_skip.shape[2]:
                out = torch.cat([out, x_skip], dim=1)
            out = block(out, style, noise[i])
        return self.to_rgb(out)


class StyledGenerator(nn.Module):
    """Encoder + generator + style MLP (pixel norm, 4 equalized linears with
    leaky ReLU) of the latent flattened channel-major."""

    def __init__(self, output_size: int = 128, device=None):
        super().__init__()
        self.output_size = output_size
        self.encoder = AVAEEncoder(LATENT_CHANNELS, device)
        self.generator = AVAEGenerator(output_size, device)
        self.style_layers = nn.ModuleList(
            AEqualLinear(LATENT_CHANNELS * 16 if i == 0 else STYLE_DIM, STYLE_DIM,
                         device=device) for i in range(4))

    def style_fn(self, z):
        z = pixel_norm(z)
        for layer in self.style_layers:
            z = _lrelu(layer(z))
        return z

    def forward(self, x, draws, inference: bool = False):
        """x: (B, 3, H, W) in [-1, 1], pooled -> the image (inference), or
        (mu, logvar, image). The latent's temperature is 0.6 at inference
        and 1 in training."""
        draws = as_draws(draws)
        noise = [draws.normal(s, x) for s in noise_shapes(self.output_size, x.shape[0])]
        x_skip, m, v = self.encoder(x)
        temp = INFERENCE_TEMPERATURE if inference else 1.0
        z = m + draws.normal(m.shape, m) * (torch.exp(v * 0.5) * temp)
        img = self.generator(x_skip, z, self.style_fn(z.reshape(z.shape[0], -1)), noise)
        return img if inference else (m, v, img)


def _discriminator_plan(initial_res: int):
    """(out_ch, downsample, fused, norm) per block."""
    if initial_res == 64:
        return [(128, True, True, True), (256, True, True, True),
                (512, True, False, True), (512, True, False, True),
                (512, False, False, False)]
    if initial_res == 128:
        return [(128, True, True, True), (256, True, True, True),
                (512, True, False, True), (512, True, False, True),
                (512, True, False, True), (512, False, False, False)]
    if initial_res == 256:
        return [(128, True, True, True), (256, True, True, True),
                (256, True, False, True), (512, True, False, True),
                (512, True, False, True), (512, True, False, True),
                (512, False, False, False)]
    raise NotImplementedError(initial_res)


class AVAEDiscriminator(nn.Module):
    """The WGAN critic: 1x1 from RGB, then blocks of conv3x3 (InstanceNorm)
    leaky ReLU, blur + stride-2 (fused) or conv + 2x2 mean, (InstanceNorm)
    leaky ReLU; the last block a 4x4 valid conv; a linear to one score. The
    blocks' modules keep their flax names (`block{i}_conv1`,
    `block{i}_conv2f` or `block{i}_conv2`)."""

    def __init__(self, initial_res: int = 128, device=None):
        super().__init__()
        self.plan = _discriminator_plan(initial_res)
        self.from_rgb = AEqualConv2d(3, 64, 1, device=device)
        in_ch = 64
        for i, (out_ch, downsample, fused, _) in enumerate(self.plan):
            last = i == len(self.plan) - 1
            k2, p2 = (4, 0) if last else (3, 1)
            self.add_module(f"block{i}_conv1",
                            AEqualConv2d(in_ch, out_ch, 3, padding=1, device=device))
            if downsample and fused:
                self.add_module(f"block{i}_conv2f",
                                FusedDownsample(out_ch, out_ch, k2, p2, device))
            else:
                self.add_module(f"block{i}_conv2",
                                AEqualConv2d(out_ch, out_ch, k2, padding=p2, device=device))
            in_ch = out_ch
        self.linear = AEqualLinear(512, 1, device=device)

    def forward(self, x):
        y = self.from_rgb(x)
        for i, (_, downsample, fused, norm) in enumerate(self.plan):
            y = getattr(self, f"block{i}_conv1")(y)
            if norm:
                y = instance_norm(y)
            y = _lrelu(y)
            if downsample and fused:
                y = getattr(self, f"block{i}_conv2f")(blur3(y))
            elif downsample:
                y = F.avg_pool2d(getattr(self, f"block{i}_conv2")(blur3(y)), 2)
            else:
                y = getattr(self, f"block{i}_conv2")(y)
            if norm:
                y = instance_norm(y)
            y = _lrelu(y)
        return self.linear(y.reshape(y.shape[0], -1))

