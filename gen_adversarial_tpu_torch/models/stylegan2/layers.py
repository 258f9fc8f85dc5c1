"""StyleGAN2 building blocks on NCHW tensors (counterpart of
gen_adversarial_tpu/models/stylegan2/layers.py): what the generator's
forward uses.

As in the JAX package, ModulatedConv2d runs in the shared-weight form:
scale the input channels by the style, convolve with the one shared weight,
scale the output channels by the demodulation factor; this equals the
reference's per-sample grouped convolution. Every blur with up = down = 1
goes through the K2 kernel (ops/upfirdn.py) on a CUDA tensor and through its
plain version on a CPU tensor. The ToRGB skip upsample (up = 2) is plain
upfirdn2d.

Parameters keep the JAX names and are stored in torch layouts:
`EqualLinear.weight` (out, in), `ModulatedConv2d.weight` (out, in, k, k),
`ToRGB.bias` (1, 3, 1, 1); core/convert.py maps them. Not ported yet (not on
the generator's forward): ConvLayer, ResBlock, EqualConv2d, the downsample
branch and the per-sample `weights_delta` path.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gen_adversarial_tpu_torch.ops.fused_act import fused_leaky_relu
from gen_adversarial_tpu_torch.ops.upfirdn import upfirdn_blur
from gen_adversarial_tpu_torch.ops.upfirdn2d import upfirdn2d


STYLE_DIM = 512
BLUR_KERNEL = (1, 3, 3, 1)  # the FIR taps of every blur and upsample


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x ** 2, dim=-1, keepdim=True) + 1e-8)


def _norm1d(k) -> np.ndarray:
    k = np.asarray(k, np.float32)
    return k / k.sum()


def blur(x: torch.Tensor, kernel_1d, pad, upsample_factor: int = 1) -> torch.Tensor:
    """Blur module: separable FIR with up = down = 1 through K2; the kernel
    is scaled by factor^2 (split over the two passes) after an upsampling
    convolution."""
    k = _norm1d(kernel_1d)
    if upsample_factor > 1:
        k = k * np.float32(upsample_factor)
    return upfirdn_blur(x, k, pad)


def upsample_fir(x: torch.Tensor, kernel_1d, factor: int = 2) -> torch.Tensor:
    """Upsample module: zero insertion and FIR (plain upfirdn2d, up=2)."""
    k1 = torch.tensor(_norm1d(kernel_1d) * np.float32(factor))
    p = len(kernel_1d) - factor
    return upfirdn2d(x, k1, up=factor, down=1, pad=((p + 1) // 2 + factor - 1, p // 2))


class EqualLinear(nn.Module):
    """Equalized-lr linear: weight stored at unit variance / lr_mul, scaled by
    lr_mul / sqrt(in) at call time; optional fused bias + leaky ReLU."""

    def __init__(self, in_dim: int, out_dim: int, bias_init: float = 0.0,
                 lr_mul: float = 1.0, activation: bool = False, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, device=device))
        self.bias = nn.Parameter(torch.empty(out_dim, device=device))
        self.bias_init = bias_init  # where the bias starts (used by random inits)
        self.lr_mul = lr_mul
        self.scale = lr_mul / math.sqrt(in_dim)
        self.activation = activation

    def forward(self, x):
        out = x @ (self.weight * self.scale).t()
        if self.activation:
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class ModulatedConv2d(nn.Module):
    """Style-modulated convolution with demodulation:
    y = demod(style, W) * conv(x * style, scale * W). The upsample form is a
    stride-2 transposed convolution (the JAX dilated convolution with
    flipped weights), then the blur with pad (1, 1) and factor 2."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, demodulate: bool = True,
                 upsample: bool = False, device=None):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, device=device))
        self.modulation = EqualLinear(STYLE_DIM, in_ch, bias_init=1.0, device=device)
        self.scale = 1.0 / math.sqrt(in_ch * k ** 2)
        self.kernel_size = k
        self.demodulate = demodulate
        self.upsample = upsample

    def forward(self, x, style):
        style = self.modulation(style)  # (B, in)
        w = self.weight * self.scale
        k = self.kernel_size
        # the scaled input is a temporary: at 1024 px it is 8.6 GB on the
        # EoT-32 batch of 2 images
        if self.upsample:
            y = F.conv_transpose2d(x * style[:, :, None, None], w.transpose(0, 1), stride=2)
        else:
            y = F.conv2d(x * style[:, :, None, None], w, padding=k // 2)
        if self.demodulate:
            # d[b, o] = rsqrt(sum_{i,k} (scale * W[o, i, k] * s[b, i])^2 + 1e-8)
            demod = torch.rsqrt(style ** 2 @ (w ** 2).sum((2, 3)).t() + 1e-8)
            y = y * demod[:, :, None, None]
        if self.upsample:
            factor = 2
            p = (len(BLUR_KERNEL) - factor) - (k - 1)
            y = blur(y, BLUR_KERNEL, ((p + 1) // 2 + factor - 1, p // 2 + 1),
                     upsample_factor=factor)
        return y


class NoiseInjection(nn.Module):
    """image + weight * noise, the noise a fixed (1, 1, H, W) map."""

    def __init__(self, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, device=device))

    def forward(self, image, noise):
        return image + self.weight * noise


class StyledConv(nn.Module):
    """3x3 ModulatedConv2d + NoiseInjection + fused bias and leaky ReLU."""

    def __init__(self, in_ch: int, out_ch: int, upsample: bool = False, device=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, 3, upsample=upsample, device=device)
        self.noise = NoiseInjection(device=device)
        self.activate_bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x, style, noise):
        return fused_leaky_relu(self.noise(self.conv(x, style), noise), self.activate_bias)


class ToRGB(nn.Module):
    """1x1 modulated convolution to RGB (no demodulation), plus the
    upsampled skip of the previous resolution."""

    def __init__(self, in_ch: int, device=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, demodulate=False, device=device)
        self.bias = nn.Parameter(torch.empty(1, 3, 1, 1, device=device))

    def forward(self, x, style, skip=None):
        y = self.conv(x, style) + self.bias
        if skip is not None:
            y = y + upsample_fir(skip, BLUR_KERNEL)
        return y
