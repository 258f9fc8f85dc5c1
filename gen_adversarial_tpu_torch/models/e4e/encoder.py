"""E4E Encoder4Editing on NCHW tensors (counterpart of
gen_adversarial_tpu/models/e4e/encoder.py): the IR-SE-50 trunk, the
feature-pyramid lateral layers and the GradualStyleBlock heads, in eval mode.

The w0 head runs on the deepest feature; the other styles add their deltas
with the coarse (3) / middle (4) / fine (rest) split, all active (the
inference stage). Submodule names follow the JAX variable tree
(`trunk.body_12`, `style_3.conv2`, `latlayer1`, ...) so core/convert.py maps
weights by name.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gen_adversarial_tpu_torch.models.stylegan2.layers import EqualLinear
from gen_adversarial_tpu_torch.ops.image import resize_bilinear


def _bn(ch: int, device) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5, device=device)


class PReLU(nn.Module):
    """Per-channel PReLU; the slope is the JAX leaf `alpha`."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(ch, device=device))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.view(1, -1, 1, 1) * x)


class SEModule(nn.Module):
    """ArcFace squeeze-excitation: mean -> 1x1 (C/16) -> ReLU -> 1x1 -> sigmoid
    gate."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.fc1 = nn.Conv2d(ch, ch // 16, 1, bias=False, device=device)
        self.fc2 = nn.Conv2d(ch // 16, ch, 1, bias=False, device=device)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class BottleneckIRSE(nn.Module):
    """bottleneck_IR_SE. The shortcut is a stride subsample when the width
    does not change, otherwise a strided 1x1 convolution + BN."""

    def __init__(self, in_ch: int, depth: int, stride: int, device=None):
        super().__init__()
        self.stride = stride
        if in_ch != depth:
            self.shortcut_conv = nn.Conv2d(in_ch, depth, 1, stride, bias=False, device=device)
            self.shortcut_bn = _bn(depth, device)
        self.bn0 = _bn(in_ch, device)
        self.conv1 = nn.Conv2d(in_ch, depth, 3, padding=1, bias=False, device=device)
        self.prelu = PReLU(depth, device=device)
        self.conv2 = nn.Conv2d(depth, depth, 3, stride, padding=1, bias=False, device=device)
        self.bn2 = _bn(depth, device)
        self.se = SEModule(depth, device=device)

    def forward(self, x):
        if hasattr(self, "shortcut_conv"):
            shortcut = self.shortcut_bn(self.shortcut_conv(x))
        else:
            shortcut = x[:, :, ::self.stride, ::self.stride]  # MaxPool2d(1, stride)
        r = self.conv2(self.prelu(self.conv1(self.bn0(x))))
        return self.se(self.bn2(r)) + shortcut


def irse50_blocks():
    """(in_ch, depth, stride) per bottleneck of IR-SE-50."""
    blocks = []
    for in_c, depth, n in [(64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)]:
        blocks += [(in_c, depth, 2)] + [(depth, depth, 1)] * (n - 1)
    return blocks


class IRSE50Trunk(nn.Module):
    """input layer + 24 bottlenecks; returns the features after blocks
    6, 20 and 23 (c1, c2, c3)."""

    def __init__(self, device=None):
        super().__init__()
        self.input_conv = nn.Conv2d(3, 64, 3, padding=1, bias=False, device=device)
        self.input_bn = _bn(64, device)
        self.input_prelu = PReLU(64, device=device)
        self.body = nn.ModuleList(BottleneckIRSE(i, d, s, device=device)
                                  for i, d, s in irse50_blocks())

    def forward(self, x):
        x = self.input_prelu(self.input_bn(self.input_conv(x)))
        taps = []
        for i, block in enumerate(self.body):
            x = block(x)
            if i in (6, 20, 23):
                taps.append(x)
        return tuple(taps)


class GradualStyleBlock(nn.Module):
    """log2(spatial) stride-2 3x3 convolutions (512 -> 512) with
    LeakyReLU(0.01), flatten, EqualLinear."""

    def __init__(self, spatial: int, device=None):
        super().__init__()
        self.num_pools = int(np.log2(spatial))
        for i in range(self.num_pools):
            self.add_module(f"conv{i}", nn.Conv2d(512, 512, 3, stride=2, padding=1,
                                                  device=device))
        self.linear = EqualLinear(512, 512, device=device)

    def forward(self, x):
        for i in range(self.num_pools):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.01)
        return self.linear(torch.flatten(x, 1))  # (B, 512) once spatial == 1


def upsample_add(x, y):
    """Bilinear (align_corners=True) upsample of x to y's size, + y."""
    return resize_bilinear(x, y.shape[2], y.shape[3], align_corners=True) + y


COARSE_IND = 3  # styles 0-2 read the 16x16 feature, 3-6 the 32x32, the rest 64x64
MIDDLE_IND = 7


class Encoder4Editing(nn.Module):
    def __init__(self, stylegan_size: int = 1024, device=None):
        super().__init__()
        self.style_count = int(2 * np.log2(stylegan_size) - 2)
        self.trunk = IRSE50Trunk(device=device)
        self.style = nn.ModuleList(
            GradualStyleBlock(16 if i < COARSE_IND else 32 if i < MIDDLE_IND else 64,
                              device=device)
            for i in range(self.style_count))
        self.latlayer1 = nn.Conv2d(256, 512, 1, device=device)
        self.latlayer2 = nn.Conv2d(128, 512, 1, device=device)

    def forward(self, x):
        """x: (B, 3, H, W) -> w codes (B, style_count, 512)."""
        c1, c2, c3 = self.trunk(x)
        w0 = self.style[0](c3)
        features, p2 = c3, None
        codes = [w0]
        for i in range(1, self.style_count):  # the inference stage: every delta
            if i == COARSE_IND:
                p2 = upsample_add(c3, self.latlayer1(c2))
                features = p2
            elif i == MIDDLE_IND:
                features = upsample_add(p2, self.latlayer2(c1))
            codes.append(w0 + self.style[i](features))
        return torch.stack(codes, dim=1)
