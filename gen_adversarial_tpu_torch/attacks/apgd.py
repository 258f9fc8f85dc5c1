"""APGD (AutoAttack's auto-PGD) with the CE or the DLR loss, L2-bounded,
untargeted (counterpart of gen_adversarial_tpu/attacks/apgd.py): the
momentum update (a = 0.75), the step-size halving at the checkpoints where
the loss stopped rising, and the restart from the best point, as masked
per-sample updates. The checkpoint schedule depends on n_iter alone and is
computed once on the host; only the halving decision is per sample."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gen_adversarial_tpu_torch.attacks.utils import l2_norm, normalize
from gen_adversarial_tpu_torch.models.nvae.distributions import as_draws


def dlr_loss(logits: torch.Tensor, labels: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Difference-of-Logits-Ratio loss, batched; undefined below 4 classes
    (the reference's AttributeError)."""
    if logits.shape[1] < 4:
        raise AttributeError("APGD_DLR is undefined for problems with less than 4 classes!")
    labels = labels.long()
    logits_sorted = torch.sort(logits, dim=1).values
    attack_failed = logits.argmax(dim=1) == labels
    correct_logit = torch.gather(logits, 1, labels[:, None])[:, 0]
    highest_wrong = torch.where(attack_failed, logits_sorted[:, -2], logits_sorted[:, -1])
    numerator = -(correct_logit - highest_wrong)
    normalizer = torch.where(logits_sorted[:, -3] != correct_logit,
                             logits_sorted[:, -3], logits_sorted[:, -4])
    return numerator / (logits_sorted[:, -1] - normalizer + eps)


def _check_schedule(n_iter: int) -> list[int]:
    """The lookback at each iteration, 0 where there is no checkpoint (the
    reference's counter arithmetic)."""
    initial = max(int(0.22 * n_iter), 1)
    min_it = max(int(0.06 * n_iter), 1)
    decr = max(int(0.03 * n_iter), 1)
    lookback = [0] * n_iter
    counter, sii = 0, initial
    for i in range(n_iter):
        counter += 1
        if counter == sii:
            lookback[i] = counter
            counter = 0
            sii = max(sii - decr, min_it)
    return lookback


def apgd_attack(net, images: torch.Tensor, labels: torch.Tensor, generator,
                n_iter: int, rho: float, max_bound: float, ce_loss: bool):
    """Batched APGD. Draws one (B, H, W, C) normal for its start, first.
    Returns (success, bound, adv)."""
    draws = as_draws(generator)
    labels = labels.long()
    b = images.shape[0]
    bdims = (-1,) + (1,) * (images.dim() - 1)

    def criterion(logits):
        if ce_loss:
            return F.cross_entropy(logits, labels, reduction="none")
        return dlr_loss(logits, labels)

    def loss_and_grad(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = criterion(net(x, draws))
            (grad,) = torch.autograd.grad(loss.sum(), x)
        return loss.detach(), grad

    def project(delta):
        return normalize(delta) * torch.clamp(l2_norm(delta, keepdim=True), max=max_bound)

    lookback = _check_schedule(n_iter)

    x_adv = torch.clamp(images + max_bound * normalize(draws.normal(images.shape, images)),
                        0.0, 1.0)
    loss, grad = loss_and_grad(x_adv)
    x_adv_old = x_adv
    step_size = torch.full((b,), 2.0 * max_bound, dtype=images.dtype, device=images.device)
    best_loss = prev_best_loss = prev_loss = loss
    x_best, grad_best = x_adv, grad
    reduced_last = torch.ones(b, dtype=torch.bool, device=images.device)
    cum_now = torch.zeros(b, dtype=torch.int32, device=images.device)
    cum_inc = []  # cum_now after each iteration

    for i in range(n_iter):
        a = 0.75 if i > 0 else 1.0
        grad2 = x_adv - x_adv_old
        x_old = x_adv

        new_adv = x_adv + step_size.reshape(bdims) * normalize(grad)
        new_adv = torch.clamp(images + project(new_adv - images), 0.0, 1.0)
        new_adv = x_adv + (new_adv - x_adv) * a + grad2 * (1 - a)
        x_adv = torch.clamp(images + project(new_adv - images), 0.0, 1.0)
        x_adv_old = x_old

        loss, grad = loss_and_grad(x_adv)

        if i > 0:
            cum_now = cum_now + (loss > prev_loss).to(torch.int32)
        cum_inc.append(cum_now)
        prev_loss = loss

        improved = loss > best_loss
        best_loss = torch.where(improved, loss, best_loss)
        x_best = torch.where(improved.reshape(bdims), x_adv, x_best)
        grad_best = torch.where(improved.reshape(bdims), grad, grad_best)

        lb = lookback[i]
        if lb:  # a checkpoint: halve the step where the loss stopped rising
            n_incr = cum_now - cum_inc[max(i - lb + 1, 0)]
            loss_not_increasing = n_incr.to(torch.float32) < lb * rho
            no_improvement = prev_best_loss >= best_loss
            reduce = loss_not_increasing | (no_improvement & ~reduced_last)
            step_size = torch.where(reduce, step_size / 2.0, step_size)
            x_adv = torch.where(reduce.reshape(bdims), x_best, x_adv)
            grad = torch.where(reduce.reshape(bdims), grad_best, grad)
            reduced_last = reduce
            prev_best_loss = best_loss

    with torch.no_grad():
        succeed = net(x_adv, draws).argmax(-1) != labels
    return succeed, l2_norm(x_adv - images), x_adv
