"""FGSM, L2-projected (counterpart of gen_adversarial_tpu/attacks/fgsm.py):
one signed-gradient step, the sign normalized to unit L2 and scaled to the
bound, with the early exit for inputs already misclassified."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gen_adversarial_tpu_torch.attacks.utils import normalize
from gen_adversarial_tpu_torch.models.nvae.distributions import as_draws


def fgsm_attack(net, images: torch.Tensor, labels: torch.Tensor, generator,
                l2_bound: float):
    """Batched FGSM. net(x, draws) -> logits; returns (success, bound, adv)."""
    draws = as_draws(generator)
    labels = labels.long()
    x = images.detach().requires_grad_(True)
    with torch.enable_grad():
        # ONE stochastic forward gives both the already-wrong test and the
        # gradient: another draw could mask a sample this one classifies
        # correctly
        logits0 = net(x, draws)
        loss = -F.cross_entropy(logits0, labels, reduction="sum")
        (grad,) = torch.autograd.grad(loss, x)
    already_wrong = logits0.detach().argmax(-1) != labels
    x_adv = torch.clamp(images - normalize(torch.sign(grad)) * l2_bound, 0.0, 1.0)

    with torch.no_grad():
        succ = net(x_adv, draws).argmax(-1) != labels
    mask = already_wrong.reshape((-1,) + (1,) * (images.dim() - 1))
    adv = torch.where(mask, images, x_adv)
    success = already_wrong | succ
    bound = torch.where(already_wrong, 0.0, l2_bound).to(images.dtype)
    return success, bound, adv
