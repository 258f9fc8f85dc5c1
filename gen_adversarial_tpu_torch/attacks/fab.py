"""FAB, the Fast Adaptive Boundary attack, minimum-norm untargeted L2
(counterpart of gen_adversarial_tpu/attacks/fab.py): each step linearizes
every class from one forward and one batched backward over all C one-hot
cotangents (utils.class_grads), projects onto the closest boundary
intersected with the box (utils.projection_l2), keeps the smallest
adversarial point, and steps back towards the original where the iterate is
adversarial. A fixed number of steps, no host sync."""

from __future__ import annotations

import torch

from gen_adversarial_tpu_torch.attacks.utils import class_grads, l2_norm, projection_l2
from gen_adversarial_tpu_torch.models.nvae.distributions import as_draws


def fab_attack(net, images: torch.Tensor, labels: torch.Tensor, generator,
               n_iter: int = 128, alpha_max: float = 0.1, eta: float = 1.05,
               beta: float = 0.9, cotangent_chunk: int | None = None):
    """Returns (success, bound, adv). cotangent_chunk bounds the C-wide
    backward's memory (utils.class_grads)."""
    draws = as_draws(generator)
    labels = labels.long()
    b = images.shape[0]
    bdims = (-1,) + (1,) * (images.dim() - 1)
    rows = torch.arange(b, device=images.device)

    with torch.no_grad():
        already_wrong = net(images, draws).argmax(dim=1) != labels

    x_orig_flat = images.reshape(b, -1)
    x_i, x_adv = images, images
    bound = torch.full((b,), 1e10, dtype=images.dtype, device=images.device)
    succeed = torch.zeros(b, dtype=torch.bool, device=images.device)
    for _ in range(n_iter):
        logits, grads = class_grads(net, x_i, draws,  # (B, C), (C, B, ...)
                                    cotangent_chunk=cotangent_chunk)
        g2 = grads.movedim(0, 1).reshape(b, logits.shape[1], -1)  # (B, C, D)
        y_lab = torch.gather(logits, 1, labels[:, None])
        g_lab = g2[rows, labels][:, None]
        df = (logits - y_lab).scatter(1, labels[:, None], 1e10)
        dg = g2 - g_lab                                            # (B, C, D)

        dist = torch.abs(df) / (1e-12 + torch.sqrt(torch.sum(dg ** 2, dim=2)))
        closest = dist.argmin(dim=1)                               # (B,)

        dg2 = dg[rows, closest]                                    # (B, D)
        x_i_flat = x_i.reshape(b, -1)
        b_coef = -df[rows, closest] + torch.sum(dg2 * x_i_flat, dim=1)

        d3 = projection_l2(torch.cat([x_i_flat, x_orig_flat]), torch.cat([dg2, dg2]),
                           torch.cat([b_coef, b_coef])[:, None])   # (2B, D)
        d1 = d3[:b].reshape(images.shape)
        d2 = d3[b:].reshape(images.shape)

        a0 = torch.sqrt(torch.sum(d3 ** 2, dim=1))
        a1 = torch.clamp(a0[:b], min=1e-8)
        a2 = torch.clamp(a0[b:], min=1e-8)
        alpha = torch.clamp(a1 / (a1 + a2), 0.0, alpha_max).reshape(bdims)

        x_i = torch.clamp((x_i + eta * d1) * (1 - alpha) + (images + d2 * eta) * alpha,
                          0.0, 1.0)

        with torch.no_grad():
            succ_i = net(x_i, draws).argmax(dim=1) != labels
        t = l2_norm(x_i - images)
        improved = succ_i & (t < bound)
        x_adv = torch.where(improved.reshape(bdims), x_i, x_adv)
        bound = torch.where(improved, t, bound)
        succeed = succeed | succ_i
        # a step back towards the original where adversarial
        x_i = torch.where(succ_i.reshape(bdims), (1 - beta) * images + beta * x_i, x_i)

    success = already_wrong | succeed
    bound = torch.where(already_wrong, 0.0, bound)
    adv = torch.where(already_wrong.reshape(bdims), images, x_adv)
    return success, bound, adv
