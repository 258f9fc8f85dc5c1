"""DeepFool (counterpart of gen_adversarial_tpu/attacks/deepfool.py):
iterative closest-hyperplane linearization over the top-K classes of the
first prediction. The class gradients of one step are one forward and one
batched backward over the K one-hot cotangents (utils.class_grads), and
the JAX `lax.while_loop` is a Python loop over a per-sample active mask:
it ends when no sample is active or after max_iter steps, reading one
boolean from the device per step.

Where no cotangent block is given, the port takes `utils.class_block(
num_classes, batch)` (the JAX package: one block); the result is the same,
and the backward's live memory falls: the flagship's 8 classes at the CLI's
batch of 8 and EoT-32 run out of an 80 GB card in one block."""

from __future__ import annotations

import torch

from gen_adversarial_tpu_torch.attacks.utils import class_block, class_grads, l2_norm
from gen_adversarial_tpu_torch.models.nvae.distributions import as_draws


def deepfool_attack(net, images: torch.Tensor, labels: torch.Tensor, generator,
                    num_classes: int = 10, overshoot: float = 0.02, max_iter: int = 50,
                    return_iters: bool = False, cotangent_chunk: int | None = None):
    """Returns (success, bound, adv), and the number of steps taken with
    return_iters. cotangent_chunk None: `utils.class_block`'s block."""
    draws = as_draws(generator)
    labels = labels.long()
    b = images.shape[0]
    if cotangent_chunk is None:
        cotangent_chunk = class_block(num_classes, b)
    bdims = (-1,) + (1,) * (images.dim() - 1)

    with torch.no_grad():
        logits0 = net(images, draws)
    order = torch.argsort(-logits0, dim=1, stable=True)[:, :num_classes]  # (B, K)
    label = order[:, 0]
    already_wrong = label != labels

    r_tot = torch.zeros_like(images)
    k_i = label
    active = ~already_wrong
    i = 0
    while i < max_iter and bool(active.any()):
        pert_image = images + (1.0 + overshoot) * r_tot
        fs, grads = class_grads(net, pert_image, draws, order,  # (B, C), (K, B, ...)
                                cotangent_chunk=cotangent_chunk)
        # the SAME forward is the previous step's exit test and this step's
        # linearization; the first step always steps
        k_i_cur = fs.argmax(dim=1)
        if i > 0:
            k_i = torch.where(active, k_i_cur, k_i)
            active = active & (k_i_cur == label)

        f_sel = torch.gather(fs, 1, order)                         # (B, K)
        w_k = grads[1:] - grads[0][None]                           # (K-1, B, ...)
        f_k = (f_sel[:, 1:] - f_sel[:, 0:1]).T                     # (K-1, B)
        w_norms = torch.sqrt(torch.sum(w_k ** 2, dim=tuple(range(2, w_k.dim()))))
        pert_k = torch.abs(f_k) / torch.clamp(w_norms, min=1e-30)  # (K-1, B)
        pert, kstar = torch.min(pert_k, dim=0)
        # torch.min's index is the first minimum, as jnp.argmin's
        w = w_k[kstar, torch.arange(b, device=images.device)]

        r_i = (pert.reshape(bdims) + 1e-4) * w / torch.clamp(l2_norm(w, keepdim=True),
                                                             min=1e-30)
        r_tot = torch.where(active.reshape(bdims), r_tot + r_i, r_tot)
        i += 1

    pert_image = images + (1.0 + overshoot) * r_tot
    # samples still active at the end took a last step whose forward has not
    # run yet
    with torch.no_grad():
        k_fin = net(pert_image, draws).argmax(dim=1)
    k_i = torch.where(active, k_fin, k_i)
    failed = k_i == labels  # never crossed the boundary
    bound = torch.where(failed, torch.inf, l2_norm((1.0 + overshoot) * r_tot))
    adv = torch.where(failed.reshape(bdims), images, pert_image)

    # inputs already misclassified: success with no perturbation
    success = already_wrong | ~failed
    bound = torch.where(already_wrong, 0.0, bound)
    adv = torch.where(already_wrong.reshape(bdims), images, adv)
    if return_iters:
        return success, bound, adv, i
    return success, bound, adv
