"""The competitor defenses and the TRADES loss (counterpart of
gen_adversarial_tpu/defenses/competitors.py; the reference's
a_vae/purification_model.py, nd_vae/purification_model.py and
trades/modules.py). Images are NHWC in [0, 1], as in every defense.

- `AVaeDefense`: average-pool the [-1, 1] image by `kernel_size`, decode it
  through the A-VAE at inference (temperature 0.6), map back to [0, 1],
  classify. Its draws are the generator's (models/avae/model.py).
- `NDVaeDefense`: add N(0, noise_std) noise (one draw of the image's
  shape), clamp to [0, 1], take the ND-VAE's purify (models/ndvae/model.py:
  one eps a sampler), classify.

Neither shares an encode between EoT draws (both draw before or inside
their encoder), so `defenses/eot.eot_wrap` folds the draws into the batch.
A deep copy owns its weights: the purifier, the classifier and the
classifier call (`ClassifierApply`, which holds the model) are copied
together.

bfloat16 (core/precision.defense_astype) follows what the JAX package
does. Its A-VAE raises at the first call (its equalized convolutions pass
lax.conv_general_dilated a float32 input and bfloat16 weights), so
`AVaeDefense.cast_error` makes the cast raise up front. Its ND-VAE's flax
layers promote the float32 input back to float32, so it computes in
float32 on weights rounded to bfloat16, but for each BatchNorm's
coefficient rsqrt(var + eps) * scale, which flax computes from the
bfloat16 statistics in bfloat16 (and which XLA's jit and JAX's op-by-op
run round differently). The port computes all of it in float32 on the
rounded weights (`weights_only_cast`).

The TRADES functions take `model_fn(x) -> logits` on NHWC images and their
draws from a `Draws` source; their gradients are `torch.autograd.grad`
with respect to the perturbation only.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F
from torch import nn

from gen_adversarial_tpu_torch.models.avae.model import StyledGenerator
from gen_adversarial_tpu_torch.models.ndvae.model import DefenceNVAE
from gen_adversarial_tpu_torch.models.nvae.distributions import Draws, as_draws
from gen_adversarial_tpu_torch.ops.image import avg_pool2d, clamp01


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class _CompetitorDefense(nn.Module):
    """purify -> classifier on NHWC images in [0, 1]; forward(x, draws,
    preds_only) as MLVGMDefense's."""

    supports_shared_encode = False

    def __init__(self, purifier: nn.Module, classifier: nn.Module,
                 classifier_apply: Callable):
        super().__init__()
        self.purifier = purifier
        self.classifier = classifier
        self.classifier_apply = classifier_apply

    def forward(self, x, draws, preds_only: bool = True):
        purified = self.get_purified(x, draws)
        logits = self.classifier_apply(purified).float()
        return logits if preds_only else (logits, purified)


class AVaeDefense(_CompetitorDefense):
    cast_error = ("the A-VAE does not run in bfloat16: the JAX package's raises "
                  "TypeError: lax.conv_general_dilated requires arguments to have the same "
                  "dtypes, got float32, bfloat16 (models/avae/model.py, AEqualConv2d)")

    def __init__(self, purifier: StyledGenerator, classifier: nn.Module,
                 classifier_apply: Callable, kernel_size: int = 4):
        super().__init__(purifier, classifier, classifier_apply)
        self.kernel_size = kernel_size

    def get_purified(self, x, draws):
        x = avg_pool2d(_nchw(x) * 2.0 - 1.0, self.kernel_size)
        out = self.purifier(x, as_draws(draws), inference=True)
        return _nhwc((out + 1.0) / 2.0)


class NDVaeDefense(_CompetitorDefense):
    weights_only_cast = True

    def __init__(self, purifier: DefenceNVAE, classifier: nn.Module,
                 classifier_apply: Callable, noise_std: float = 0.1):
        super().__init__(purifier, classifier, classifier_apply)
        self.noise_std = noise_std

    def get_purified(self, x, draws):
        draws = as_draws(draws)
        x = clamp01(x + draws.normal(x.shape, x) * self.noise_std)
        return _nhwc(self.purifier.purify(_nchw(x), draws))


def kl_div_sum(log_p_adv, p_nat):
    """torch nn.KLDivLoss(reduction='sum')(log_p_adv, p_nat), with 0 log 0 = 0."""
    return torch.sum(p_nat * (torch.log(torch.clamp(p_nat, min=1e-30)) - log_p_adv))


def _per_sample(v, like):
    """A per-sample vector (B,) shaped to broadcast against `like`."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def trades_inner_l2(model_fn: Callable, draws, x_natural, epsilon: float,
                    perturb_steps: int, normalization_function=lambda x: x):
    """TRADES' inner maximization, L2 variant: SGD (lr 2 * eps / steps) on the
    perturbation maximizing KL(adv || natural), each sample's gradient
    normalized (a random direction, drawn at every step, where a sample's
    gradient is 0), projected into the [0, 1] box and the eps ball. Draws:
    the initial perturbation (0.001 x N(0, 1)), then one a step."""
    draws = as_draws(draws)
    b = x_natural.shape[0]
    step_lr = epsilon / perturb_steps * 2
    x_natural = x_natural.detach()
    with torch.no_grad():
        p_nat = F.softmax(model_fn(normalization_function(x_natural)), dim=1)
    delta = 0.001 * draws.normal(x_natural.shape, x_natural)
    for _ in range(perturb_steps):
        delta.requires_grad_(True)
        log_p_adv = F.log_softmax(model_fn(normalization_function(x_natural + delta)), dim=1)
        g, = torch.autograd.grad(-kl_div_sum(log_p_adv, p_nat), delta)
        delta = delta.detach()
        norms = torch.sqrt(torch.sum(g.reshape(b, -1) ** 2, dim=1))
        rnd = draws.normal(g.shape, g)
        g = torch.where(_per_sample(norms == 0, g), rnd, g / _per_sample(norms, g))
        delta = delta - step_lr * g
        delta = torch.clamp(delta + x_natural, 0.0, 1.0) - x_natural
        dn = torch.sqrt(torch.sum(delta.reshape(b, -1) ** 2, dim=1))
        factor = torch.clamp(epsilon / torch.clamp(dn, min=1e-12), max=1.0)
        delta = delta * _per_sample(factor, delta)
    return torch.clamp(x_natural + delta, 0.0, 1.0)


def trades_inner_linf(model_fn: Callable, draws, x_natural, epsilon: float, step_size: float,
                      perturb_steps: int, normalization_function=lambda x: x):
    """The L-inf variant: sign steps up KL(adv || natural), projected into
    the eps box around x and into [0, 1]. Draws: the initial perturbation."""
    x_natural = x_natural.detach()
    with torch.no_grad():
        p_nat = F.softmax(model_fn(normalization_function(x_natural)), dim=1)
    x_adv = x_natural + 0.001 * as_draws(draws).normal(x_natural.shape, x_natural)
    for _ in range(perturb_steps):
        x_adv.requires_grad_(True)
        log_p_adv = F.log_softmax(model_fn(normalization_function(x_adv)), dim=1)
        g, = torch.autograd.grad(kl_div_sum(log_p_adv, p_nat), x_adv)
        x_adv = x_adv.detach() + step_size * torch.sign(g)
        x_adv = torch.minimum(torch.maximum(x_adv, x_natural - epsilon), x_natural + epsilon)
        x_adv = torch.clamp(x_adv, 0.0, 1.0)
    return x_adv


def trades_loss(model_fn: Callable, draws: Draws, x_natural, y, step_size: float = 0.003,
                epsilon: float = 0.031, perturb_steps: int = 10, beta: float = 1.0,
                distance: str = "l_inf", normalization_function=lambda x: x):
    """The outer TRADES objective, CE(natural) + beta x KL(adv || natural) / B,
    differentiable in the model's parameters; the adversary (either inner
    loop, or 0.001 x N(0, 1) noise for any other `distance`) is a constant."""
    if distance == "l_2":
        x_adv = trades_inner_l2(model_fn, draws, x_natural, epsilon, perturb_steps,
                                normalization_function)
    elif distance == "l_inf":
        x_adv = trades_inner_linf(model_fn, draws, x_natural, epsilon, step_size,
                                  perturb_steps, normalization_function)
    else:
        x_adv = torch.clamp(
            x_natural + 0.001 * as_draws(draws).normal(x_natural.shape, x_natural), 0.0, 1.0)
    x_adv = x_adv.detach()
    logits_nat = model_fn(normalization_function(x_natural))
    loss_natural = F.cross_entropy(logits_nat, y)
    log_p_adv = F.log_softmax(model_fn(normalization_function(x_adv)), dim=1)
    loss_robust = kl_div_sum(log_p_adv, F.softmax(logits_nat, dim=1)) / x_natural.shape[0]
    return loss_natural + beta * loss_robust
