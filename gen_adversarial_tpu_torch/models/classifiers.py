"""VGG11-BN, ResNet50 and ResNeXt50-32x4d with the reference's projector
head, on NCHW tensors (counterpart of `VGG11BN`, `ResNetBackbone`,
`ResNet50`, `ResNeXt50` and `Projector` in
gen_adversarial_tpu/models/classifiers.py), built in eval mode.

Submodule names follow the JAX variable tree (`conv0`, `bn0`, ...,
`classifier.fc0/bn/fc1`; `layer2_0.downsample_conv`, `fc.fc0`) so
`core/convert.py` maps weights by name. Under `module.train()` every
BatchNorm, the projector's included, normalises with the batch's statistics
and updates its running ones as flax's `_bn` does (momentum 0.9 in flax's
terms, the biased variance; `models/batchnorm.py`).
"""

from __future__ import annotations

from collections.abc import Sequence
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from gen_adversarial_tpu_torch.models.batchnorm import BatchNorm1d, BatchNorm2d
from gen_adversarial_tpu_torch.ops.image import adaptive_avg_pool_general

# vgg11_bn feature plan: channel counts with 'M' maxpools between stages
VGG11_PLAN = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")


class Projector(nn.Module):
    """Linear(d, d, no bias) -> BatchNorm1d -> ReLU -> Linear(d, n_classes)."""

    def __init__(self, d: int, n_classes: int, device=None):
        super().__init__()
        self.fc0 = nn.Linear(d, d, bias=False, device=device)
        self.bn = BatchNorm1d(d, eps=1e-5, device=device)
        self.fc1 = nn.Linear(d, n_classes, device=device)

    def forward(self, x):
        return self.fc1(F.relu(self.bn(self.fc0(x))))


class VGG11BN(nn.Module):
    def __init__(self, n_classes: int, plan: Sequence = VGG11_PLAN, in_ch: int = 3,
                 device="cuda"):
        super().__init__()
        self.plan = tuple(plan)
        i = 0
        for item in self.plan:
            if item == "M":
                continue
            self.add_module(f"conv{i}", nn.Conv2d(in_ch, item, 3, padding=1, device=device))
            self.add_module(f"bn{i}", BatchNorm2d(item, eps=1e-5, device=device))
            in_ch = item
            i += 1
        self.classifier = Projector(in_ch * 7 * 7, n_classes, device=device)
        self.eval()

    def forward(self, x):
        """x: (B, 3, H, W) -> logits (B, n_classes)."""
        i = 0
        for item in self.plan:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
                i += 1
        # torchvision pools to 7x7 before the head (2x2 -> 7x7 at 64 px);
        # flatten is channel-major, as torch's NCHW view(b, -1)
        x = adaptive_avg_pool_general(x, 7, 7)
        return self.classifier(torch.flatten(x, 1))


class Bottleneck(nn.Module):
    """torchvision ResNet Bottleneck: 1x1 -> 3x3 (the stride and the groups
    are here) -> 1x1, with a strided 1x1 + BN shortcut when the shape
    changes."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64, device=None):
        super().__init__()
        width, out_ch = int(planes * (base_width / 64.0)) * groups, planes * 4
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False, device=device)
        self.bn1 = BatchNorm2d(width, eps=1e-5, device=device)
        self.conv2 = nn.Conv2d(width, width, 3, stride, padding=1, groups=groups,
                               bias=False, device=device)
        self.bn2 = BatchNorm2d(width, eps=1e-5, device=device)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False, device=device)
        self.bn3 = BatchNorm2d(out_ch, eps=1e-5, device=device)
        if in_ch != out_ch or stride != 1:
            self.downsample_conv = nn.Conv2d(in_ch, out_ch, 1, stride, bias=False,
                                             device=device)
            self.downsample_bn = BatchNorm2d(out_ch, eps=1e-5, device=device)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


class ResNetBackbone(nn.Module):
    """ResNet-50 family with the projector head: 7x7/2 stem, 3x3/2 max pool
    (padding 1), four stages of bottlenecks (`layers` of them), global mean;
    groups / base_width (32, 4) give ResNeXt50-32x4d."""

    def __init__(self, n_classes: int, layers: Sequence[int] = (3, 4, 6, 3),
                 groups: int = 1, base_width: int = 64, device="cuda"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False, device=device)
        self.bn1 = BatchNorm2d(64, eps=1e-5, device=device)
        self.blocks = []
        in_ch = 64
        for stage, n_blocks in enumerate(layers):
            planes = 64 * 2 ** stage
            for i in range(n_blocks):
                name = f"layer{stage + 1}_{i}"
                stride = 2 if stage > 0 and i == 0 else 1
                self.add_module(name, Bottleneck(in_ch, planes, stride, groups, base_width,
                                                 device=device))
                self.blocks.append(name)
                in_ch = planes * 4
        self.fc = Projector(in_ch, n_classes, device=device)
        self.eval()

    def forward(self, x):
        """x: (B, 3, H, W) -> logits (B, n_classes)."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.fc(x.mean((2, 3)))


ResNet50 = partial(ResNetBackbone, layers=(3, 4, 6, 3))
ResNeXt50 = partial(ResNetBackbone, layers=(3, 4, 6, 3), groups=32, base_width=4)


def make_classifier(model_type: str, n_classes: int, device="cuda") -> nn.Module:
    """The classifier of a model type ('resnet', 'resnext' or 'vgg')."""
    if model_type == "resnet":
        return ResNet50(n_classes, device=device)
    if model_type == "resnext":
        return ResNeXt50(n_classes, device=device)
    if model_type == "vgg":
        return VGG11BN(n_classes, device=device)
    raise ValueError(model_type)
