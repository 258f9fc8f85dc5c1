"""NVAE building-block cells on NCHW tensors (counterpart of
gen_adversarial_tpu/models/nvae/cells.py), in eval mode: every BatchNorm uses
its running statistics.

Submodule names follow the JAX package's variable tree (`bn0`, `conv_expand`,
`conv_depthwise`, `se.linear_1`, `skip.conv`, ...), so `core/convert.py` maps
weights by name. The decoder cell's BN-SiLU-DW5x5-BN-SiLU segment goes
through the fused kernel `ops/depthwise.depthwise_silu_segment`.
`MaskedConv2d`, `NFCell` and `NFBlock` (normalizing-flow cells) are not on
the purify path of the supported configurations and are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gen_adversarial_tpu_torch.ops.depthwise import depthwise_silu_segment
from gen_adversarial_tpu_torch.ops.image import upsample_bilinear2x


def _bn(ch: int, device) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.05, device=device)


def bn_affine(bn: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm as a per-channel affine: s = gamma/sqrt(var+eps),
    b = beta - mean*s."""
    s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return s, bn.bias - bn.running_mean * s


class Conv1x1(nn.Conv2d):
    """1x1 convolution, optionally strided (a strided 1x1 conv is the
    JAX package's subsample-then-project)."""

    def __init__(self, in_ch: int, out_ch: int, use_bias: bool = True,
                 stride: int = 1, device=None):
        super().__init__(in_ch, out_ch, 1, stride=stride, bias=use_bias, device=device)


class SE(nn.Module):
    """Squeeze-and-excitation gate."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        hidden = max(channels // 16, 4)
        self.linear_1 = nn.Linear(channels, hidden, device=device)
        self.linear_2 = nn.Linear(hidden, channels, device=device)

    def forward(self, x):
        se = x.mean(dim=(2, 3))
        se = torch.sigmoid(self.linear_2(F.relu(self.linear_1(se))))
        return x * se[:, :, None, None]


class SkipDown(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, device=None):
        super().__init__()
        self.conv = Conv1x1(in_ch, out_ch, stride=stride, device=device)

    def forward(self, x):
        return self.conv(F.silu(x))


class SkipUp(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.conv = Conv1x1(in_ch, out_ch, device=device)

    def forward(self, x):
        return self.conv(upsample_bilinear2x(x))


class ResidualCellEncoder(nn.Module):
    """(BN-SiLU-conv3x3) x2 + SE, with a 0.1-scaled residual."""

    def __init__(self, in_ch: int, out_ch: int, downsampling: bool, use_se: bool,
                 device=None):
        super().__init__()
        stride = 2 if downsampling else 1
        self.bn0 = _bn(in_ch, device)
        self.conv0 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, device=device)
        self.bn1 = _bn(out_ch, device)
        self.conv1 = nn.Conv2d(out_ch, out_ch, 3, padding=1, device=device)
        self.se = SE(out_ch, device) if use_se else None
        self.skip = SkipDown(in_ch, out_ch, stride, device) if downsampling else None

    def forward(self, x):
        r = self.conv0(F.silu(self.bn0(x)))
        r = self.conv1(F.silu(self.bn1(r)))
        if self.se is not None:
            r = self.se(r)
        skip = self.skip(x) if self.skip is not None else x
        return skip + 0.1 * r


class ResidualCellDecoder(nn.Module):
    """MBConv-style cell: 1x1 expand -> fused BN-SiLU-DW5x5-BN-SiLU segment
    -> 1x1 project -> BN -> SE, optional nearest x2 upsampling, 0.1-scaled
    residual."""

    def __init__(self, in_ch: int, out_ch: int, upsampling: bool, use_se: bool,
                 hidden_mul: int = 6, device=None):
        super().__init__()
        hidden = in_ch * hidden_mul
        self.upsampling = upsampling
        self.bn0 = _bn(in_ch, device)
        self.conv_expand = Conv1x1(in_ch, hidden, use_bias=False, device=device)
        self.bn1 = _bn(hidden, device)
        # holds the depthwise taps as (C, 1, 5, 5); the segment applies them
        self.conv_depthwise = nn.Conv2d(hidden, hidden, 5, padding=2, groups=hidden,
                                        bias=False, device=device)
        self.bn2 = _bn(hidden, device)
        self.conv_project = Conv1x1(hidden, out_ch, use_bias=False, device=device)
        self.bn3 = _bn(out_ch, device)
        self.se = SE(out_ch, device) if use_se else None
        self.skip = SkipUp(in_ch, out_ch, device) if upsampling else None

    def segment_args(self):
        """(taps (5,5,C), s1, b1, s2, b2) for `depthwise_silu_segment`."""
        w = self.conv_depthwise.weight
        taps = w.reshape(w.shape[0], 25).t().reshape(5, 5, w.shape[0]).contiguous()
        return (taps, *bn_affine(self.bn1), *bn_affine(self.bn2))

    def forward(self, x):
        r = x
        if self.upsampling:
            r = F.interpolate(r, scale_factor=2, mode="nearest")
        r = self.conv_expand(self.bn0(r)).contiguous(memory_format=torch.channels_last)
        r = depthwise_silu_segment(r, *self.segment_args())
        r = self.bn3(self.conv_project(r))
        if self.se is not None:
            r = self.se(r)
        skip = self.skip(x) if self.skip is not None else x
        return skip + 0.1 * r


class EncCombinerCell(nn.Module):
    """x_enc + conv1x1(x_dec)."""

    def __init__(self, dec_ch: int, out_ch: int, device=None):
        super().__init__()
        self.conv = Conv1x1(dec_ch, out_ch, device=device)

    def forward(self, x_enc, x_dec):
        return x_enc + self.conv(x_dec)


class DecCombinerCell(nn.Module):
    """conv1x1(concat(x, z))."""

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.conv = Conv1x1(in_ch, out_ch, device=device)

    def forward(self, x, z):
        return self.conv(torch.cat([x, z], dim=1))
