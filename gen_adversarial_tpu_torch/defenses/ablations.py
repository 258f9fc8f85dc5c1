"""Ablation defenses (counterpart of gen_adversarial_tpu/defenses/ablations.py):
the purification is only L2-ball gaussian noise, or only the gaussian blur
with the reference's kernel size, followed by the classifier. Images are
NHWC in [0, 1].

As in the JAX package, they have no compute_dtype: core/precision's
defense_astype only rounds their weights to bfloat16 (`weights_only_cast`),
and they compute in float32, which is what the JAX package's dtype
promotion gives for float32 inputs and bfloat16 weights."""

from __future__ import annotations

from collections.abc import Callable

from torch import nn

from gen_adversarial_tpu_torch.defenses.base import (
    ClassifierDefense, add_l2_gaussian_noise, blur_kernel_size)
from gen_adversarial_tpu_torch.models.nvae.distributions import as_draws
from gen_adversarial_tpu_torch.ops.blur import gaussian_blur2d


class GaussianNoiseDefense(ClassifierDefense):
    """purify = noise with per-sample L2 norm eps, then the [0, 1] clamp
    (eps 2.0 for ids, 4.0 for gender and cars). One draw of the image's
    shape."""

    weights_only_cast = True

    def __init__(self, classifier: nn.Module, classifier_apply: Callable, eps: float = 4.0):
        super().__init__(classifier, classifier_apply)
        self.eps = eps

    def get_purified(self, x, draws):
        return add_l2_gaussian_noise(x, self.eps, as_draws(draws))


class GaussianBlurDefense(ClassifierDefense):
    """purify = the gaussian blur (sigma 1) with the 2**(sqrt(H)//2) - 1
    kernel; draws nothing."""

    weights_only_cast = True

    def __init__(self, classifier: nn.Module, classifier_apply: Callable,
                 image_size: int = 64):
        super().__init__(classifier, classifier_apply)
        self.image_size = image_size

    def get_purified(self, x, draws=None):
        return gaussian_blur2d(x, blur_kernel_size(self.image_size), 1.0)
