"""VGG11-BN with the reference's projector head, on NCHW tensors
(counterpart of `VGG11BN` and `Projector` in
gen_adversarial_tpu/models/classifiers.py), built in eval mode.

Submodule names follow the JAX variable tree (`conv0`, `bn0`, ...,
`classifier.fc0/bn/fc1`) so `core/convert.py` maps weights by name. ResNet50
and ResNeXt50 serve the StyleGAN2 families and come with their slice.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gen_adversarial_tpu_torch.ops.image import adaptive_avg_pool_general

# vgg11_bn feature plan: channel counts with 'M' maxpools between stages
VGG11_PLAN = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")


class Projector(nn.Module):
    """Linear(d, d, no bias) -> BatchNorm1d -> ReLU -> Linear(d, n_classes)."""

    def __init__(self, d: int, n_classes: int, device=None):
        super().__init__()
        self.fc0 = nn.Linear(d, d, bias=False, device=device)
        self.bn = nn.BatchNorm1d(d, eps=1e-5, device=device)
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
            self.add_module(f"bn{i}", nn.BatchNorm2d(item, eps=1e-5, device=device))
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
