"""Gaussian blur of NHWC images, separable and reflect-padded, with
kornia's normalization (counterpart of gen_adversarial_tpu/ops/blur.py,
which replaces the reference's kornia.filters.gaussian_blur2d). Plain
PyTorch: no TPU kernel sits behind it."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_kernel1d(kernel_size: int, sigma: float, device=None,
                      dtype=torch.float32) -> torch.Tensor:
    """1-D gaussian taps, normalized to sum 1 (for even sizes the window is
    shifted by half a sample, as kornia's)."""
    x = torch.arange(kernel_size, device=device, dtype=torch.float32) - kernel_size // 2
    if kernel_size % 2 == 0:
        x = x + 0.5
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).to(dtype)


def gaussian_blur2d(x: torch.Tensor, kernel_size: int, sigma: float = 1.0) -> torch.Tensor:
    """x: (B, H, W, C) -> the same shape, blurred: reflect padding of
    ((k - 1) // 2, k // 2) on each spatial axis, then a vertical and a
    horizontal depthwise pass."""
    c = x.shape[-1]
    k = gaussian_kernel1d(kernel_size, sigma, x.device, x.dtype)
    lo, hi = (kernel_size - 1) // 2, kernel_size // 2
    y = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi), mode="reflect")
    y = F.conv2d(y, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    y = F.conv2d(y, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    return y.permute(0, 2, 3, 1)
