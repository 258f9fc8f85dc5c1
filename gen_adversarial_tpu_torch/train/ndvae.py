"""ND-VAE trainer (counterpart of gen_adversarial_tpu/train/ndvae.py; the
reference's NVAE_defense_training.py): Adamax over (adversarial -> clean)
pairs with the annealed balanced KL, and the FGSM adversarial-dataset
generator.

The optimizer is Adamax(lr, eps 1e-3) with weight decay 1e-2 added to the
gradient (`torch.optim.Adamax(weight_decay=1e-2)` is the JAX package's
`optax.chain(add_decayed_weights(1e-2), adamax(lr, eps=1e-3))`). The loss
is the mixture's negative log-likelihood of the clean image, taken of
`x_orig` in [0, 1] as the reference does (not rescaled to [-1, 1]), plus
beta(t) x the balanced KL: the square-schedule coefficients of
`kl_balancer_coeff(scales, scales)` (the reference passes the scale count
for both), of which the balancer uses all but the first. With one scale
that leaves none, and the reference and the JAX package fail; so does
`make_ndvae_train_step`, up front.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gen_adversarial_tpu_torch.attacks.fgsm import fgsm_attack
from gen_adversarial_tpu_torch.data import png
from gen_adversarial_tpu_torch.data.datasets import iterate_batches
from gen_adversarial_tpu_torch.models.ndvae.model import DefenceNVAE
from gen_adversarial_tpu_torch.models.nvae.distributions import DiscMixLogistic, as_draws
from gen_adversarial_tpu_torch.train.nvae import (
    KL_ANNEAL_PORTION, KL_CONST_COEFF, KL_CONST_PORTION, balanced_kl, kl_coeff)

# per-task hyperparameters (the reference's train_ndvae.py)
NDVAE_RECIPES = {
    "celeba256": dict(image_size=256, epochs=50, lr=1e-3, batch_size=32,
                      params=dict(x_channels=3, pre_proc_groups=2, encoding_channels=16,
                                  scales=2, groups=4, cells=2),
                      noise_max=0.1, use_noise=True),
    "celeba64": dict(image_size=64, epochs=400, lr=1e-4, batch_size=256,
                     params=dict(x_channels=3, pre_proc_groups=2, encoding_channels=8,
                                 scales=1, groups=2, cells=4),
                     noise_max=0.05, use_noise=True),
    "cars128": dict(image_size=128, epochs=100, lr=1e-3, batch_size=32,
                    params=dict(x_channels=3, pre_proc_groups=2, encoding_channels=16,
                                scales=2, groups=2, cells=4),
                    noise_max=0.1, use_noise=True),
}


def kl_balancer_coeff(num_scales: int, groups_per_scale: int) -> torch.Tensor:
    """The 'square' coefficients: (2**i)**2 / groups_per_scale, each
    repeated groups_per_scale times, for scales i."""
    parts = [np.square(2 ** i) / groups_per_scale * np.ones(groups_per_scale)
             for i in range(num_scales)]
    return torch.as_tensor(np.concatenate(parts), dtype=torch.float32)


def kl_balancer(kl_terms: list, beta: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """beta x the KL over the stacked per-sampler terms (B, L), balanced by
    alpha[1:] while beta < 1 (`train/nvae.balanced_kl`), else summed."""
    return balanced_kl(torch.stack(kl_terms, dim=1), beta, alpha[1:])


def ndvae_loss(model: DefenceNVAE, logits, x_orig, kl_all: list, global_step: int,
               num_total_iter: int):
    """(mean NELBO, recon (B,), balanced KL (B,)); x_orig (B, 3, H, W) in [0, 1]."""
    alpha = kl_balancer_coeff(model.scales, model.scales).to(logits.device)
    beta = kl_coeff(torch.tensor(global_step, dtype=torch.float32),
                    KL_ANNEAL_PORTION * num_total_iter, KL_CONST_PORTION * num_total_iter,
                    KL_CONST_COEFF)
    recon = -DiscMixLogistic(logits).log_prob(x_orig).sum(dim=(1, 2))
    kl = kl_balancer(kl_all, beta, alpha)
    return torch.mean(recon + kl), recon, kl


def make_ndvae_train_step(model: DefenceNVAE, lr: float, num_total_iter: int):
    """(optimizer, train_step). train_step(batch, draws, global_step) ->
    (loss, mean recon, mean balanced KL), device tensors, for a batch
    {'x_adv', 'x_orig'} of NHWC images; it updates the model's parameters
    and BatchNorm statistics in place. Raises at one scale (see the
    module)."""
    if model.scales < 2:
        raise ValueError(f"the ND-VAE's balanced KL needs at least 2 scales, got "
                         f"{model.scales}: it weights the KL terms by "
                         "kl_balancer_coeff(scales, scales)[1:], which is empty at 1 (so do "
                         "the reference and the JAX package)")
    optimizer = torch.optim.Adamax(model.parameters(), lr=lr, eps=1e-3, weight_decay=1e-2)
    def nchw01(images):
        x = torch.as_tensor(images, dtype=model.h.dtype, device=model.h.device)
        return torch.clamp(x, 0.0, 1.0).permute(0, 3, 1, 2)

    def train_step(batch, draws, global_step):
        x_adv, x_orig = nchw01(batch["x_adv"]), nchw01(batch["x_orig"])
        model.train()
        logits, _, _, kl_all = model(x_adv, as_draws(draws))
        loss, recon, kl = ndvae_loss(model, logits, x_orig, kl_all, global_step,
                                     num_total_iter)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), recon.mean().detach(), kl.mean().detach()

    return optimizer, train_step


def generate_fgsm_dataset(classifier_fn, dataset, l2_bound: float, out_dir: str,
                          batch_size: int = 32, seed: int = 0, device="cuda") -> None:
    """FGSM adversaries (attacks/fgsm.py) of a folder dataset against
    `classifier_fn(x) -> logits` (NHWC in [0, 1]), written as PNGs into class
    folders under `out_dir`, named after their sources with a .png suffix,
    pixels (adv * 255) truncated to uint8 as the JAX package writes them."""
    net = lambda x, draws: classifier_fn(x)  # noqa: E731
    idx = 0
    for batch in iterate_batches(dataset, batch_size, drop_last=False):
        images = torch.clamp(torch.as_tensor(batch["image"], device=device), 0.0, 1.0)
        labels = torch.as_tensor(batch["label"], device=device)
        _, _, adv = fgsm_attack(net, images, labels,
                                torch.Generator(device=device).manual_seed(seed), l2_bound)
        for img in adv.detach().cpu().numpy():
            f = dataset.files[idx]
            png.write(os.path.join(out_dir, f.parent.name, f.with_suffix(".png").name),
                      (img * 255).astype(np.uint8))
            idx += 1
