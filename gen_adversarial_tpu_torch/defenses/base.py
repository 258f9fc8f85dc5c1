"""The purify-based defense (counterpart of gen_adversarial_tpu/defenses/base.py):
L2-ball gaussian noise (or the unconditional clamp at eps 0) -> optional
(x - 0.5) / 0.5 -> purify -> optional * 0.5 + 0.5 -> classifier. Images are
NHWC in [0, 1], as in the JAX package. The NVAE family purifies [0, 1]
images (it normalizes inside: normalize_before_purify=False); the StyleGAN2
families purify in [-1, 1] (normalize_before_purify=True).

Random draws come from a `Draws` source (models/nvae/distributions.py): a
`torch.Generator`, or recorded tensors replayed in order. One call draws the
input noise first (NHWC, the image's shape; only when initial_noise_eps > 0),
then the purifier's draws (the NVAE's eps, or the E4E mix noise). Gaussian
blur, remat and compute_dtype are not used by the supported configurations
and are not ported yet.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch
from torch import nn

from gen_adversarial_tpu_torch.models.nvae.distributions import Draws, as_draws
from gen_adversarial_tpu_torch.ops.image import clamp01


def add_l2_gaussian_noise(x: torch.Tensor, eps: float, draws: Draws) -> torch.Tensor:
    """Noise with per-sample L2 norm exactly eps, then the [0, 1] clamp."""
    noise = draws.normal(x.shape, x)
    dims = tuple(range(1, x.dim()))
    norm = torch.sqrt(torch.sum(noise ** 2, dim=dims, keepdim=True))
    return clamp01(x + noise * (eps / norm))


class MLVGMDefense(nn.Module):
    """purify-based defense.

    purify_encode(x) -> state and purify_decode(alphas, state, draws) ->
    purified are the halves of the purifier (defenses/purify.py); the encode
    half draws nothing, so with initial_noise_eps == 0 an EoT wrapper runs it
    once for all draws (defenses/eot.py)."""

    def __init__(self, purifier: nn.Module, classifier: nn.Module, alphas: torch.Tensor,
                 purify_encode: Callable, purify_decode: Callable,
                 classifier_apply: Callable, initial_noise_eps: float = 0.0,
                 normalize_before_purify: bool = False):
        super().__init__()
        self.purifier = purifier
        self.classifier = classifier
        self.register_buffer("alphas", alphas)
        self.purify_encode = purify_encode
        self.purify_decode = purify_decode
        self.classifier_apply = classifier_apply
        self.initial_noise_eps = initial_noise_eps
        self.normalize_before_purify = normalize_before_purify

    def _normalize(self, x):
        return (x - 0.5) / 0.5 if self.normalize_before_purify else x

    def _denormalize(self, out):
        return out * 0.5 + 0.5 if self.normalize_before_purify else out

    def preprocess(self, x, draws: Draws | None):
        if self.initial_noise_eps > 0:
            return add_l2_gaussian_noise(x, self.initial_noise_eps, draws)
        # the reference adds its noise unconditionally: at eps 0 that is
        # still a clamp to [0, 1], which changes out-of-box inputs
        return clamp01(x)

    def purified(self, x, draws):
        draws = as_draws(draws)
        state = self.purify_encode(self._normalize(self.preprocess(x, draws)))
        return self._denormalize(self.purify_decode(self.alphas, state, draws))

    @property
    def supports_shared_encode(self) -> bool:
        """True when every EoT draw sees the same encode: deterministic
        preprocessing (initial_noise_eps == 0)."""
        return self.initial_noise_eps == 0

    def purify_state(self, x):
        """Preprocessing and the encode half, once. Only valid when
        supports_shared_encode."""
        if not self.supports_shared_encode:
            raise ValueError("shared encode needs initial_noise_eps == 0")
        return self.purify_encode(self._normalize(self.preprocess(x, None)))

    def purified_from_state(self, state, draws):
        return self._denormalize(self.purify_decode(self.alphas, state, as_draws(draws)))

    def state_call(self, state, draws):
        return self.classifier_apply(self.purified_from_state(state, draws)).float()

    def forward(self, x, draws):
        """x: (B, H, W, C) in [0, 1] -> logits (B, n_classes)."""
        return self.classifier_apply(self.purified(x, draws)).float()


def make_classifier_apply(model: nn.Module, mean: float | None = 0.5,
                          std: float = 0.5) -> Callable[[Any], torch.Tensor]:
    """Optional (x - mean) / std, then the classifier. Takes NHWC images."""

    def classifier_apply(x):
        if mean is not None:
            x = (x - mean) / std
        return model(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))

    return classifier_apply
