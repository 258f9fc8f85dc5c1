"""Small-scale NVAE trainer (counterpart of gen_adversarial_tpu/train/nvae.py,
the NVlabs recipe): Adamax(lr, eps=1e-3) with weight decay 1e-4 added to the
gradient (`torch.optim.Adamax(weight_decay=1e-4)` is the JAX package's
`optax.chain(add_decayed_weights(1e-4), adamax(lr, eps=1e-3))`), and the
loss recon (-log DiscMixLogistic) + beta(t) x balanced KL, beta annealed
linearly over the first 30 % of training from 1e-4 to 1; while beta < 1 the
per-group KL terms are rebalanced by their running magnitude x the config's
square-schedule `kl_alpha`.

The training forward computes the decoder cell's depthwise segment with
batch statistics, off K1 (`models/nvae/cells.py`); the trained model's eval
decodes (`reconstruct`, `sample`, the purify path) go through K1.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from gen_adversarial_tpu_torch.core.checkpoint import load_variables, save_variables
from gen_adversarial_tpu_torch.core.convert import from_jax_variables, to_jax_variables
from gen_adversarial_tpu_torch.core.init import flax_init_
from gen_adversarial_tpu_torch.data.datasets import iterate_batches
from gen_adversarial_tpu_torch.models.nvae.distributions import as_draws, position_generator
from gen_adversarial_tpu_torch.models.nvae.model import NVAE

# the JAX package's train/ndvae.py (NVAE.py:22-24 of the reference)
KL_ANNEAL_PORTION = 0.3
KL_CONST_PORTION = 0.0001
KL_CONST_COEFF = 0.0001


def kl_coeff(step, total_step, constant_step, min_kl_coeff):
    return torch.clamp((step - constant_step) / total_step, min_kl_coeff, 1.0)


def balanced_kl(kl_all: torch.Tensor, beta: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """beta x the KL over the stacked (B, L) per-group terms: while beta < 1
    each group weighted by its batch magnitude / alpha (normalized to mean
    1, no gradient through the weights), else the plain sum."""
    if float(beta) < 1.0:
        kl_mag = kl_all.abs().mean(0, keepdim=True) + 0.01
        c = kl_mag / alpha[None, :] * kl_mag.sum()
        c = c / c.mean(1, keepdim=True)
        kl = (kl_all * c.detach()).sum(1)
    else:
        kl = kl_all.sum(1)
    return beta.to(kl.device) * kl


def make_nvae_train_step(model: NVAE, lr: float, num_total_iter: int,
                         weight_decay: float = 1e-4, input_noise: float = 0.0):
    """(optimizer, train_step). train_step(batch, draws, global_step) ->
    (loss, mean recon, mean KL sum), device tensors; it updates the model's
    parameters and BatchNorm statistics in place. `input_noise`: the std of
    Gaussian noise added to the encoder's input (drawn first, clipped to
    [0, 1]); the ELBO's target stays the clean image."""
    optimizer = torch.optim.Adamax(model.parameters(), lr=lr, eps=1e-3,
                                   weight_decay=weight_decay)
    device = model.const_prior.device
    alpha = torch.tensor(model.cfg.kl_alpha(), dtype=torch.float32, device=device)

    def train_step(batch, draws, global_step):
        draws = as_draws(draws)
        x = torch.clamp(torch.as_tensor(batch["image"], dtype=torch.float32, device=device),
                        0.0, 1.0)
        x_in = x
        if input_noise > 0.0:
            x_in = torch.clamp(x + input_noise * draws.normal(x.shape, x), 0.0, 1.0)
        model.train()
        logits, kl_all = model(x_in, draws)
        recon = model.reconstruction_loss(x, logits)
        beta = kl_coeff(torch.tensor(global_step, dtype=torch.float32),
                        KL_ANNEAL_PORTION * num_total_iter,
                        KL_CONST_PORTION * num_total_iter, KL_CONST_COEFF)
        loss = torch.mean(recon + balanced_kl(kl_all, beta, alpha))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), recon.mean().detach(), kl_all.sum(1).mean().detach()

    return optimizer, train_step


def fit_nvae(model: NVAE, train_ds, epochs: int, lr: float, batch_size: int,
             seed: int = 0, log_fn=print, checkpoint_path: str | None = None,
             save_every_epochs: int = 5, input_noise: float = 0.0) -> NVAE:
    """Train `model` (fresh weights from a generator seeded `seed`, on the
    model's device) over a folder dataset; returns it, in eval mode.

    checkpoint_path: one msgpack file (`save_variables` of the flax tree,
    meta {'epoch', 'config'}) written every save_every_epochs epochs and at
    the last, and resumed from at the epoch after its meta's `epoch`, with
    cold optimizer moments as in the JAX package. Step s's draws come from a
    generator seeded (seed, s), so a resumed run draws what an
    uninterrupted one would."""
    device = model.const_prior.device
    flax_init_(model, torch.Generator(device=device).manual_seed(seed))
    steps_per_epoch = max(1, len(train_ds) // batch_size)
    _, train_step = make_nvae_train_step(model, lr, num_total_iter=epochs * steps_per_epoch,
                                         input_noise=input_noise)
    start_epoch = 0
    if checkpoint_path and Path(checkpoint_path).exists():
        variables, meta = load_variables(checkpoint_path)
        from_jax_variables(variables, model)
        start_epoch = int(meta["epoch"]) + 1
        log_fn(f"[resume] NVAE from {checkpoint_path} epoch {start_epoch}")

    gstep = start_epoch * steps_per_epoch
    for epoch in range(start_epoch, epochs):
        losses, recons, kls = [], [], []
        for batch in iterate_batches(train_ds, batch_size, shuffle=True, seed=seed + epoch):
            loss, recon, kl = train_step(batch, position_generator(device, seed, gstep), gstep)
            gstep += 1
            losses.append(loss)
            recons.append(recon)
            kls.append(kl)
        log_fn(f"[nvae epoch {epoch + 1}/{epochs}] "
               f"nelbo {float(torch.stack(losses).mean()):.2f} "
               f"recon {float(torch.stack(recons).mean()):.2f} "
               f"kl {float(torch.stack(kls).mean()):.2f}")
        if checkpoint_path and ((epoch + 1) % save_every_epochs == 0 or epoch == epochs - 1):
            save_variables(checkpoint_path, to_jax_variables(model),
                           {"epoch": epoch, "config": dataclasses.asdict(model.cfg)})
    return model.eval()
