"""Image ops on NCHW tensors (counterpart of gen_adversarial_tpu/ops/image.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clamp01(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] clamp. torch.clamp's backward passes the cotangent on the
    inclusive in-range mask, which is the convention the JAX `clamp01`
    reproduces on purpose."""
    return torch.clamp(x, 0.0, 1.0)


def upsample_bilinear2x(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear resize with align_corners=True (NVAE `SkipUp`)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def adaptive_avg_pool_general(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch AdaptiveAvgPool2d, whose windows [floor(i*in/out),
    ceil((i+1)*in/out)) the JAX function reproduces, for output sizes
    smaller or larger than the input (VGG pools 2x2 up to 7x7 at 64 px)."""
    return F.adaptive_avg_pool2d(x, (out_h, out_w))


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW images. align_corners=False is the half-pixel
    convention (torch F.interpolate's default, jax.image.resize);
    align_corners=True samples at i * (in - 1) / (out - 1), the convention of
    the E4E feature-pyramid upsample."""
    if tuple(x.shape[2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=align_corners)


def avg_pool2d(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Non-overlapping average pooling of NCHW images (F.avg_pool2d with
    stride=kernel), the A-VAE purifier's downsampling."""
    if kernel == 1:
        return x
    return F.avg_pool2d(x, kernel, kernel)
