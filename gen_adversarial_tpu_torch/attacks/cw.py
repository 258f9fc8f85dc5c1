"""Carlini & Wagner L2 attack, Adam in tanh space (counterpart of
gen_adversarial_tpu/attacks/cw.py): FGSM + noise initialization, a
per-sample Adam on w = atanh(2x - 1), rolling-mean early stopping, and the
adaptive c across restarts (x1.2 on failure, x0.8 on a new best, x0.9 when
worse, clamped to [0.1, 1000]). Restarts are a Python loop (the JAX
`lax.scan`); the steps of a restart a loop over a per-sample active mask,
which ends when every sample has stopped early (one boolean read from the
device per step)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gen_adversarial_tpu_torch.attacks.fgsm import fgsm_attack
from gen_adversarial_tpu_torch.attacks.utils import l2_norm
from gen_adversarial_tpu_torch.models.nvae.distributions import as_draws


def cw_f(logits: torch.Tensor, labels: torch.Tensor, kappa: float) -> torch.Tensor:
    """The C&W f-function, batched."""
    one_hot = F.one_hot(labels.long(), logits.shape[1]).to(logits.dtype)
    real = torch.sum(one_hot * logits, dim=1)
    other = torch.max((1 - one_hot) * logits - one_hot * 1e4, dim=1).values
    return torch.clamp(real - other + kappa, min=0.0)


def cw_attack(net, images: torch.Tensor, labels: torch.Tensor, generator,
              c: float = 1.0, kappa: float = 0.0, steps: int = 64, lr: float = 1e-2,
              n_restarts: int = 1, early_stopping_steps: int = 16):
    """Returns (success, bound, adv). Each restart draws one (B, H, W, C)
    normal for its initial noise, after its FGSM."""
    draws = as_draws(generator)
    labels = labels.long()
    b = images.shape[0]
    dims = tuple(range(1, images.dim()))
    bdims = (-1,) + (1,) * (images.dim() - 1)
    # res from W of NHWC: the reference takes it from image.shape[-1], W in NCHW
    res = math.log2(images.shape[2])
    init_bound = 2.0 ** (res - 5)
    noise_norm = 2.0 ** (res - 8)
    f32 = images.dtype

    c_cur = torch.full((b,), c, dtype=f32, device=images.device)
    abs_succ = torch.zeros(b, dtype=torch.bool, device=images.device)
    abs_best_l2 = torch.zeros(b, dtype=f32, device=images.device)
    abs_best_adv = images
    for _ in range(n_restarts):
        _, _, fgsm_adv = fgsm_attack(net, images, labels, draws, init_bound)
        noise = draws.normal(images.shape, images)
        noise = noise * noise_norm / l2_norm(noise, keepdim=True)
        best_adv = torch.clamp(fgsm_adv + noise, 1e-6, 1.0 - 1e-6)
        best_l2 = l2_norm(best_adv - images)

        w = torch.atanh(best_adv * 2.0 - 1.0)
        m, v = torch.zeros_like(w), torch.zeros_like(w)
        t = torch.zeros(b, dtype=f32, device=images.device)
        active = torch.ones(b, dtype=torch.bool, device=images.device)
        rolling_mean = torch.zeros(b, dtype=f32, device=images.device)
        rolling_updates = torch.zeros(b, dtype=torch.int32, device=images.device)
        prev_succeed = torch.zeros(b, dtype=torch.bool, device=images.device)

        i = 0
        while i < steps and bool(active.any()):
            w_ = w.detach().requires_grad_(True)
            with torch.enable_grad():
                adv_ = 0.5 * (torch.tanh(w_) + 1.0)
                l2_loss = torch.sum((adv_ - images) ** 2, dim=dims)
                logits = net(adv_, draws)
                loss = l2_loss + c_cur * cw_f(logits, labels, kappa)
                (grad,) = torch.autograd.grad(loss.sum(), w_)
            adv, loss, logits = adv_.detach(), loss.detach(), logits.detach()

            # per-sample clip_grad_norm_(max_norm=1)
            gn = l2_norm(grad, keepdim=True)
            grad = grad * torch.clamp(1.0 / torch.clamp(gn, min=1e-12), max=1.0)

            # Adam, frozen for inactive samples
            act = active.reshape(bdims)
            t = t + active.to(f32)
            m = torch.where(act, 0.9 * m + 0.1 * grad, m)
            v = torch.where(act, 0.999 * v + 0.001 * grad ** 2, v)
            t_safe = torch.clamp(t, min=1.0).reshape(bdims)
            mhat = m / (1 - 0.9 ** t_safe)
            vhat = v / (1 - 0.999 ** t_safe)
            w = torch.where(act, w - lr * mhat / (torch.sqrt(vhat) + 1e-8), w)

            succeed = logits.argmax(-1) != labels

            # early stopping: succeeding but no longer converging
            stop_now = active & succeed & (loss > rolling_mean) & \
                (rolling_updates > early_stopping_steps)
            still = active & ~stop_now
            upd_roll = still & succeed
            lookback = torch.clamp(rolling_updates, max=early_stopping_steps).to(f32)
            rolling_mean = torch.where(upd_roll, (rolling_mean * lookback + loss) / (lookback + 1),
                                       rolling_mean)
            rolling_updates = rolling_updates + upd_roll.to(torch.int32)

            this_l2 = l2_norm(adv - images)
            upd = still & (~prev_succeed | (best_l2 > this_l2))
            best_adv = torch.where(upd.reshape(bdims), adv, best_adv)
            best_l2 = torch.where(upd, this_l2, best_l2)
            prev_succeed = torch.where(upd, succeed, prev_succeed)
            active = still
            i += 1

        # the restart's epilogue: evaluate, adapt c
        with torch.no_grad():
            succeed = net(best_adv, draws).argmax(-1) != labels
        new_best = succeed & (~abs_succ | (abs_succ & (abs_best_l2 > best_l2)))
        worse = succeed & abs_succ & (abs_best_l2 < best_l2)
        c_next = torch.where(~succeed, 1.2 * c_cur,
                             torch.where(new_best, 0.8 * c_cur,
                                         torch.where(worse, 0.9 * c_cur, c_cur)))
        c_cur = torch.clamp(c_next, 0.1, 1000.0)
        abs_best_adv = torch.where(new_best.reshape(bdims), best_adv, abs_best_adv)
        abs_best_l2 = torch.where(new_best, best_l2, abs_best_l2)
        abs_succ = abs_succ | succeed
    return abs_succ, abs_best_l2, abs_best_adv
