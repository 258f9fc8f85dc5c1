"""StyleGAN2 building blocks on NCHW tensors (counterpart of
gen_adversarial_tpu/models/stylegan2/layers.py): the generator's layers and
the discriminator's (EqualConv2d, ConvLayer, ResBlock).

As in the JAX package, ModulatedConv2d runs in the shared-weight form:
scale the input channels by the style, convolve with the one shared weight,
scale the output channels by the demodulation factor; this equals the
reference's per-sample grouped convolution. With a per-sample
`weights_delta` (E4E's hypernetwork editing) it runs that grouped
convolution of per-sample weights. Every blur with up = down = 1 goes
through the K2 kernel (ops/upfirdn.py) on a CUDA tensor and through its
plain version on a CPU tensor: after an up-convolution at pad (1, 1), and
before a stride-2 convolution (ConvLayer's and ModulatedConv2d's downsample)
at pad (2, 2) for 3 x 3 and (1, 1) for 1 x 1. The ToRGB skip upsample
(up = 2) and `downsample_fir` (down = 2) are plain upfirdn2d, as in JAX.

Parameters keep the JAX names and are stored in torch layouts:
`EqualLinear.weight` (out, in), `ModulatedConv2d.weight` and
`EqualConv2d.weight` (out, in, k, k), `ToRGB.bias` (1, 3, 1, 1);
core/convert.py maps them. A `weights_delta` is (B, out, in, k, k), the
reference's layout (JAX's is (B, k, k, in, out)). The TPU's phase-layout
paths (`phase_in`, `phase_out`, `phase_rgb`) are not carried over.
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


def downsample_fir(x: torch.Tensor, kernel_1d, factor: int = 2) -> torch.Tensor:
    """Downsample module: FIR and keep every factor-th sample (plain
    upfirdn2d, down=2)."""
    k1 = torch.tensor(_norm1d(kernel_1d))
    p = len(kernel_1d) - factor
    return upfirdn2d(x, k1, up=1, down=factor, pad=((p + 1) // 2, p // 2))


def _down_blur(x: torch.Tensor, k: int) -> torch.Tensor:
    """The blur before a stride-2 k x k convolution: pad ((p + 1) // 2,
    p // 2), p = taps - 2 + k - 1, so (2, 2) for k = 3 and (1, 1) for k = 1."""
    p = (len(BLUR_KERNEL) - 2) + (k - 1)
    return blur(x, BLUR_KERNEL, ((p + 1) // 2, p // 2))


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope) * math.sqrt(2.0)


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


class EqualConv2d(nn.Module):
    """Equalized-lr convolution: weight stored at unit variance, scaled by
    1 / sqrt(in * k^2) at call time."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, device=None):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device)) if bias else None
        self.scale = 1.0 / math.sqrt(in_ch * k ** 2)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, self.bias, stride=self.stride,
                        padding=self.padding)


class ModulatedConv2d(nn.Module):
    """Style-modulated convolution with demodulation:
    y = demod(style, W) * conv(x * style, scale * W). The upsample form is a
    stride-2 transposed convolution (the JAX dilated convolution with
    flipped weights), then the blur with pad (1, 1) and factor 2; the
    downsample form the blur (`_down_blur`), then a stride-2 convolution.
    With `weights_delta` (B, out, in, k, k) each sample convolves with its
    own weight scale * W * (1 + delta) * style, demodulated, as one grouped
    convolution (the reference's form; the blurs as above)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, demodulate: bool = True,
                 upsample: bool = False, downsample: bool = False, device=None):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, device=device))
        self.modulation = EqualLinear(STYLE_DIM, in_ch, bias_init=1.0, device=device)
        self.scale = 1.0 / math.sqrt(in_ch * k ** 2)
        self.kernel_size = k
        self.demodulate = demodulate
        self.upsample = upsample
        self.downsample = downsample

    def forward(self, x, style, weights_delta=None):
        style = self.modulation(style)  # (B, in)
        if weights_delta is not None:
            return self._per_sample(x, style, weights_delta)
        w = self.weight * self.scale
        k = self.kernel_size
        # the scaled input is a temporary: at 1024 px it is 8.6 GB on the
        # EoT-32 batch of 2 images
        xs = x * style[:, :, None, None]
        if self.upsample:
            y = F.conv_transpose2d(xs, w.transpose(0, 1), stride=2)
        elif self.downsample:
            y = F.conv2d(_down_blur(xs, k), w, stride=2)
        else:
            y = F.conv2d(xs, w, padding=k // 2)
        if self.demodulate:
            # d[b, o] = rsqrt(sum_{i,k} (scale * W[o, i, k] * s[b, i])^2 + 1e-8)
            demod = torch.rsqrt(style ** 2 @ (w ** 2).sum((2, 3)).t() + 1e-8)
            y = y * demod[:, :, None, None]
        if self.upsample:
            y = self._up_blur(y)
        return y

    def _up_blur(self, y):
        factor = 2
        p = (len(BLUR_KERNEL) - factor) - (self.kernel_size - 1)
        return blur(y, BLUR_KERNEL, ((p + 1) // 2 + factor - 1, p // 2 + 1),
                    upsample_factor=factor)

    def _per_sample(self, x, style, weights_delta):
        b, in_ch = style.shape
        k = self.kernel_size
        w = self.scale * self.weight[None] * (1 + weights_delta) * style[:, None, :, None, None]
        if self.demodulate:
            w = w * torch.rsqrt((w ** 2).sum((2, 3, 4)) + 1e-8)[:, :, None, None, None]
        out_ch = w.shape[1]
        if self.downsample:
            x = _down_blur(x, k)
        x = x.reshape(1, b * in_ch, *x.shape[2:])
        if self.upsample:
            y = F.conv_transpose2d(x, w.transpose(1, 2).reshape(b * in_ch, out_ch, k, k),
                                   stride=2, groups=b)
        elif self.downsample:
            y = F.conv2d(x, w.reshape(b * out_ch, in_ch, k, k), stride=2, groups=b)
        else:
            y = F.conv2d(x, w.reshape(b * out_ch, in_ch, k, k), padding=k // 2, groups=b)
        y = y.reshape(b, out_ch, *y.shape[2:]).contiguous(memory_format=torch.channels_last)
        return self._up_blur(y) if self.upsample else y


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

    def forward(self, x, style, noise, weights_delta=None):
        y = self.conv(x, style, weights_delta)
        return fused_leaky_relu(self.noise(y, noise), self.activate_bias)


class ToRGB(nn.Module):
    """1x1 modulated convolution to RGB (no demodulation), plus the
    upsampled skip of the previous resolution."""

    def __init__(self, in_ch: int, device=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, demodulate=False, device=device)
        self.bias = nn.Parameter(torch.empty(1, 3, 1, 1, device=device))

    def forward(self, x, style, skip=None, weights_delta=None):
        y = self.conv(x, style, weights_delta) + self.bias
        if skip is not None:
            y = y + upsample_fir(skip, BLUR_KERNEL)
        return y


class ConvLayer(nn.Module):
    """[blur] -> EqualConv2d -> [fused bias + leaky ReLU | scaled leaky
    ReLU]. downsample: the blur (`_down_blur`, through K2), then a stride-2
    convolution without padding; else stride 1, padding k // 2. The
    convolution has its own bias only where there is no activation; an
    activated layer with a bias adds it as `activate_bias` in the fused
    activation."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, downsample: bool = False,
                 bias: bool = True, activate: bool = True, device=None):
        super().__init__()
        k = kernel_size
        self.downsample, self.activate, self.kernel_size = downsample, activate, k
        self.conv = EqualConv2d(in_ch, out_ch, k, stride=2 if downsample else 1,
                                padding=0 if downsample else k // 2,
                                bias=bias and not activate, device=device)
        self.activate_bias = (nn.Parameter(torch.empty(out_ch, device=device))
                              if activate and bias else None)

    def forward(self, x):
        if self.downsample:
            x = _down_blur(x, self.kernel_size)
        x = self.conv(x)
        if not self.activate:
            return x
        if self.activate_bias is not None:
            return fused_leaky_relu(x, self.activate_bias)
        return scaled_leaky_relu(x)


class ResBlock(nn.Module):
    """Residual downsampling block: two 3 x 3 ConvLayers (the second
    downsampling) beside a 1 x 1 downsampling skip without activation or
    bias, summed and divided by sqrt(2)."""

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, in_ch, 3, device=device)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=True, device=device)
        self.skip = ConvLayer(in_ch, out_ch, 1, downsample=True, activate=False, bias=False,
                              device=device)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2.0)
